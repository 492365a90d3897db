// 2-D grid stencil SpMV and fused-CG passes for Hopper (sm_90a).
//
// Hand-written CUDA ports of the Pallas TPU kernels in
// legionsolvers_tpu/ops/pallas/stencil2d.py.  Python wrappers, plain PyTorch
// versions and gates live in legionsolvers_tpu_torch/ops/cuda/stencil2d.py;
// the entry points below have a plain C interface and are loaded with ctypes
// (legionsolvers_tpu_torch/ops/cuda/build.py).
//
//   ls_stencil2d  K3  replaces _stencil_call (modes y, y_dot, pq, update)
//   ls_xpay_pq    K4  replaces grid2d_cg_xpay_pq
//   ls_gram2      K2  replaces _sstep_call mode gram2
//   ls_step2      K1  replaces _sstep_call mode step2
//
// What bounds them: bytes.  A 2-D stencil does ~2 flops per term per
// element, far below the card's ~20 flops per byte of HBM bandwidth.  K1
// moves 24 B per element per pass (reads x, r, p; writes x'', r'', p'') for
// two CG iterations; K2 8 B; K3 8 B (y, y_dot), 4 B (pq) or 20 B (update);
// K4 12 B.
//
// Design.  The Pallas kernels stream whole rows through a sequential grid
// and carry sums in SMEM from one grid step to the next.  CUDA blocks run in
// no order, so each block owns one TILE x TILE output tile instead:
//   * the block loads its inputs plus a halo into shared memory once, so
//     every input byte crosses HBM about once (halo re-reads cost
//     (TILE + 2h)^2 / TILE^2 - 1: 56% for K1's h = 4, 13% for h = 1);
//   * every intermediate of the chained stencil applications (K1: A p,
//     A u, A p'', A^2 p'', A r'') lives in shared memory on a shrinking
//     extension of the tile and never touches HBM; each is zeroed outside
//     the grid, which reproduces the JAX mask() chain, so chained
//     applications are true matrix powers;
//   * each block writes its partial dot products to a [blocks, k] scratch
//     and a second launch sums them in a fixed order: results are
//     deterministic, with no atomics;
//   * no kernel writes a buffer that another block reads with a halo: the
//     new r and p of K1 and the p of K4 go to separate buffers.
// Speed is for later work: the loads are plain (no TMA, no cp.async
// pipeline) and the tile is square.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K3: y = A x (mode 0), y and <x, A x> (1), <x, A x> (2),
//     update (3): xv += alpha x; rv -= alpha A x; <rv', rv'>  (x is p here)
// ---------------------------------------------------------------------------
template <int MODE>
__global__ void __launch_bounds__(LS_THREADS)
stencil_kernel(const float* __restrict__ x, const float* __restrict__ top,
               const float* __restrict__ bot, float* __restrict__ y,
               float* __restrict__ xv, float* __restrict__ rv,
               const float* __restrict__ alpha_p, float* __restrict__ partials,
               int R, int C, LsStencil st, int h) {
  __shared__ float w[kWinMax * kWinMax];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const int W = LS_TILE + 2 * h;
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  for (int e = tid(); e < W * W; e += LS_THREADS) {
    const int i = e / W, j = e % W;
    w[e] = load_halo(x, top, bot, R, C, r0 - h + i, c0 - h + j);
  }
  __syncthreads();
  const float alpha = MODE == 3 ? *alpha_p : 0.f;
  float acc[1] = {0.f};
  const int j = threadIdx.x, gc = c0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    const int gr = r0 + i;
    if (gr >= R || gc >= C) continue;
    const size_t idx = (size_t)gr * C + gc;
    const float xc = w[(i + h) * W + j + h];
    const float ax = apply_at(w, W, i + h, j + h, s);
    if (MODE == 0 || MODE == 1) y[idx] = ax;
    if (MODE == 1 || MODE == 2) acc[0] += xc * ax;
    if (MODE == 3) {
      xv[idx] = xv[idx] + alpha * xc;
      const float rn = rv[idx] - alpha * ax;
      rv[idx] = rn;
      acc[0] += rn * rn;
    }
  }
  if (MODE != 0) block_partials(acc, partials);
}

// ---------------------------------------------------------------------------
// K4: p = r + beta p_old (written to p_out) and <p, A p>; p's halo is
// r_halo + beta p_old_halo.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(LS_THREADS)
xpay_pq_kernel(const float* __restrict__ r, const float* __restrict__ p_old,
               const float* __restrict__ beta_p, const float* __restrict__ rt,
               const float* __restrict__ rb, const float* __restrict__ pt,
               const float* __restrict__ pb, float* __restrict__ p_out,
               float* __restrict__ partials, int R, int C, LsStencil st, int h) {
  __shared__ float w[kWinMax * kWinMax];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const float beta = *beta_p;
  const int W = LS_TILE + 2 * h;
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  for (int e = tid(); e < W * W; e += LS_THREADS) {
    const int gr = r0 - h + e / W, gc = c0 - h + e % W;
    w[e] = load_halo(r, rt, rb, R, C, gr, gc) +
           beta * load_halo(p_old, pt, pb, R, C, gr, gc);
  }
  __syncthreads();
  float acc[1] = {0.f};
  const int j = threadIdx.x, gc = c0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    const int gr = r0 + i;
    if (gr >= R || gc >= C) continue;
    const float pc = w[(i + h) * W + j + h];
    p_out[(size_t)gr * C + gc] = pc;
    acc[0] += pc * apply_at(w, W, i + h, j + h, s);
  }
  block_partials(acc, partials);
}

// ---------------------------------------------------------------------------
// K2 / K1 share the s-step layout: the tile plus an extension of e on each
// side is an array of width LS_TILE + 2e; local (i, j) of an extension-e
// array is global (r0 - e + i, c0 - e + j).  Stencil reach is 1, so one
// application shrinks the extension by one.
// ---------------------------------------------------------------------------
constexpr int W4 = LS_TILE + 8, W3 = LS_TILE + 6, W2 = LS_TILE + 4, W1 = LS_TILE + 2;

// Dirichlet load: zero outside the grid (zero-halo pass).
__device__ void load_ext(float* dst, int W, int e, const float* __restrict__ a,
                         int R, int C, int r0, int c0) {
  for (int k = tid(); k < W * W; k += LS_THREADS) {
    const int gr = r0 - e + k / W, gc = c0 - e + k % W;
    dst[k] = in_grid(gr, gc, R, C) ? a[(size_t)gr * C + gc] : 0.f;
  }
}

// The 10 Gram terms (GRAM_NAMES order) of one element.
__device__ __forceinline__ void gram_terms(float (&g)[10], float rb, float pb,
                                           float Apb, float A2pb, float Arb) {
  g[0] += rb * rb;    g[1] += pb * Apb;   g[2] += rb * Apb;
  g[3] += Apb * Apb;  g[4] += rb * Arb;   g[5] += Apb * Arb;
  g[6] += Apb * A2pb; g[7] += Arb * Arb;  g[8] += Arb * A2pb;
  g[9] += A2pb * A2pb;
}

__global__ void __launch_bounds__(LS_THREADS)
gram2_kernel(const float* __restrict__ r, const float* __restrict__ p,
             float* __restrict__ partials, int R, int C, LsStencil st) {
  __shared__ float p2[W2 * W2], r1[W1 * W1], Ap1[W1 * W1];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  load_ext(p2, W2, 2, p, R, C, r0, c0);
  load_ext(r1, W1, 1, r, R, C, r0, c0);
  __syncthreads();
  for (int k = tid(); k < W1 * W1; k += LS_THREADS) {
    const int i = k / W1, j = k % W1;
    Ap1[k] = in_grid(r0 - 1 + i, c0 - 1 + j, R, C)
                 ? apply_at(p2, W2, i + 1, j + 1, s) : 0.f;
  }
  __syncthreads();
  float g[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int j = threadIdx.x;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    if (r0 + i >= R || c0 + j >= C) continue;
    gram_terms(g, r1[(i + 1) * W1 + j + 1], p2[(i + 2) * W2 + j + 2],
               Ap1[(i + 1) * W1 + j + 1], apply_at(Ap1, W1, i + 1, j + 1, s),
               apply_at(r1, W1, i + 1, j + 1, s));
  }
  block_partials(g, partials);
}

// K1: u = c0 p + c1 r - c2 Ap; x'' = x + u; r'' = r - A u;
//     p'' = r'' + c3 r - c4 Ap + c5 p; Gram of (r'', p'').
// Extensions: p, r on 4; Ap, u on 3; r'', p'' on 2; A p'' on 1;
// A^2 p'' and A r'' on the tile itself.
__global__ void __launch_bounds__(LS_THREADS)
step2_kernel(float* __restrict__ x, const float* __restrict__ r,
             const float* __restrict__ p, const float* __restrict__ coef,
             float* __restrict__ r_out, float* __restrict__ p_out,
             float* __restrict__ partials, int R, int C, LsStencil st) {
  __shared__ float p4[W4 * W4], r4[W4 * W4];
  __shared__ float s3[W3 * W3], u3[W3 * W3];
  __shared__ float rn2[W2 * W2], pn2[W2 * W2];
  __shared__ float Apn1[W1 * W1];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const float c0 = coef[0], c1 = coef[1], c2 = coef[2];
  const float c3 = coef[3], c4 = coef[4], c5 = coef[5];
  const int r0 = blockIdx.y * LS_TILE, col0 = blockIdx.x * LS_TILE;
  load_ext(p4, W4, 4, p, R, C, r0, col0);
  load_ext(r4, W4, 4, r, R, C, r0, col0);
  __syncthreads();
  for (int k = tid(); k < W3 * W3; k += LS_THREADS) {
    const int i = k / W3, j = k % W3;
    const bool in = in_grid(r0 - 3 + i, col0 - 3 + j, R, C);
    const float ap = in ? apply_at(p4, W4, i + 1, j + 1, s) : 0.f;
    const int c4i = (i + 1) * W4 + j + 1;
    s3[k] = ap;
    u3[k] = in ? c0 * p4[c4i] + c1 * r4[c4i] - c2 * ap : 0.f;
  }
  __syncthreads();
  for (int k = tid(); k < W2 * W2; k += LS_THREADS) {
    const int i = k / W2, j = k % W2;
    const bool in = in_grid(r0 - 2 + i, col0 - 2 + j, R, C);
    const int c4i = (i + 2) * W4 + j + 2;
    const float rn = in ? r4[c4i] - apply_at(u3, W3, i + 1, j + 1, s) : 0.f;
    rn2[k] = rn;
    pn2[k] = in ? rn + c3 * r4[c4i] - c4 * s3[(i + 1) * W3 + j + 1] + c5 * p4[c4i]
                : 0.f;
  }
  __syncthreads();
  for (int k = tid(); k < W1 * W1; k += LS_THREADS) {
    const int i = k / W1, j = k % W1;
    Apn1[k] = in_grid(r0 - 1 + i, col0 - 1 + j, R, C)
                  ? apply_at(pn2, W2, i + 1, j + 1, s) : 0.f;
  }
  __syncthreads();
  float g[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int j = threadIdx.x, gc = col0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    const int gr = r0 + i;
    if (gr >= R || gc >= C) continue;
    const size_t idx = (size_t)gr * C + gc;
    const float rb = rn2[(i + 2) * W2 + j + 2], pb = pn2[(i + 2) * W2 + j + 2];
    x[idx] = x[idx] + u3[(i + 3) * W3 + j + 3];
    r_out[idx] = rb;
    p_out[idx] = pb;
    gram_terms(g, rb, pb, Apn1[(i + 1) * W1 + j + 1],
               apply_at(Apn1, W1, i + 1, j + 1, s),
               apply_at(rn2, W2, i + 2, j + 2, s));
  }
  block_partials(g, partials);
}

}  // namespace

extern "C" {

int ls_tile() { return LS_TILE; }
int ls_max_terms() { return LS_MAX_TERMS; }
const char* ls_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// mode: 0 y, 1 y_dot, 2 pq, 3 update.  Pointers unused by a mode may be
// null; halo pointers may be null (zeros).  partials: one float per tile.
int ls_stencil2d(int mode, const float* x, const float* top, const float* bot,
                 float* y, float* xv, float* rv, const float* alpha,
                 float* dot, float* partials, int R, int C,
                 const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, LS_MAX_REACH)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = reach_of(*st);
  switch (mode) {
    case 0: stencil_kernel<0><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, R, C, *st, h);
            return (int)cudaGetLastError();
    case 1: stencil_kernel<1><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, R, C, *st, h); break;
    case 2: stencil_kernel<2><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, R, C, *st, h); break;
    case 3: stencil_kernel<3><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, R, C, *st, h); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return finish(partials, grid.x * grid.y, 1, dot, stream);
}

int ls_xpay_pq(const float* r, const float* p_old, const float* beta,
               const float* rt, const float* rb, const float* pt,
               const float* pb, float* p_out, float* dot, float* partials,
               int R, int C, const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, LS_MAX_REACH)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  xpay_pq_kernel<<<grid, block, 0, stream>>>(r, p_old, beta, rt, rb, pt, pb,
                                             p_out, partials, R, C, *st,
                                             reach_of(*st));
  return finish(partials, grid.x * grid.y, 1, dot, stream);
}

int ls_gram2(const float* r, const float* p, float* g, float* partials,
             int R, int C, const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  gram2_kernel<<<grid, block, 0, stream>>>(r, p, partials, R, C, *st);
  return finish(partials, grid.x * grid.y, 10, g, stream);
}

int ls_step2(float* x, const float* r, const float* p, const float* coef,
             float* r_out, float* p_out, float* g, float* partials, int R,
             int C, const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  step2_kernel<<<grid, block, 0, stream>>>(x, r, p, coef, r_out, p_out,
                                           partials, R, C, *st);
  return finish(partials, grid.x * grid.y, 10, g, stream);
}

}  // extern "C"
