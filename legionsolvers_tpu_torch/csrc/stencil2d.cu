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
// Design of K2-K4.  The Pallas kernels stream whole rows through a
// sequential grid and carry sums in SMEM from one grid step to the next.
// CUDA blocks run in no order, so each block owns one TILE x TILE output
// tile instead:
//   * the block loads its inputs plus a halo into shared memory once, so
//     every input byte crosses HBM about once (halo re-reads cost
//     (TILE + 2h)^2 / TILE^2 - 1: 13% for h = 1, 27% for K2's h = 2);
//   * every intermediate of K2's chained applications (A p, A^2 p, A r)
//     lives in shared memory on a shrinking extension of the tile and is
//     zeroed outside the grid, which reproduces the JAX mask() chain, so
//     chained applications are true matrix powers;
//   * each block writes its partial dot products to a [blocks, k] scratch
//     and a second launch sums them in a fixed order: results are
//     deterministic, with no atomics;
//   * no kernel writes a buffer that another block reads with a halo: the
//     new r and p of K1 and the p of K4 go to separate buffers.
// K1, the main path's pass, marches down column strips in registers
// instead (see its note below) and folds its Gram sum into its last block.

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
constexpr int W2 = LS_TILE + 4, W1 = LS_TILE + 2;

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

// ---------------------------------------------------------------------------
// K1: u = c0 p + c1 r - c2 Ap; x'' = x + u; r'' = r - A u;
//     p'' = r'' + c3 r - c4 Ap + c5 p; Gram of (r'', p'').
//
// A vertical march in registers (the 2-D form of the TPU kernel's
// whole-row window and of march3d).  A warp owns a strip of 128 columns
// (four per lane, read as 16-byte vectors) and marches down a chunk of
// rows [a, b).  The chained applications shrink the strip by one column
// per side each, so its 120 middle columns (lanes 1..30) are the warp's
// output: 4 halo columns per side, read twice, instead of the 56% halo of
// a 32 x 32 tile.  Each step takes one new row of p, r (and x) and
// advances a five-stage pipeline by one row, every stage reading rows the
// earlier stages left in registers:
//   S1 at q-1: Ap, u; x += u          (p rows q-2..q)
//   S2 at q-2: r'' = r - A u, p''     (u rows q-3..q-1)
//   S3 at q-3: A p''                  (p'' rows q-4..q-2)
//   S4 at q-4: A^2 p'', A r'', Gram   (A p'', r'' rows q-5..q-3)
// Vertical neighbours come from registers, horizontal ones from the
// neighbouring lane (one shuffle per side per row).  Every intermediate is
// zeroed outside the grid, which reproduces the JAX mask() chain, so the
// chained applications are true matrix powers.  The next row's loads are
// issued before the current row's stages, so they overlap its compute.
// The 5-point cross (the Laplacian, in its stencil order) has its offsets
// fixed at compile time; any other reach-1 stencil runs its terms, in
// stencil order, through a warp-uniform switch over the 3x3 box.  The
// coefficients are kernel parameters.  The Gram terms are exact products
// of the f32 values accumulated in double (a lane sums a few hundred of
// them; in f32 that rounding would reach the s-step coefficients, which
// amplify it over the solve) and rounded to f32 once.  Each block writes
// its Gram partials and the last block to finish (a device counter) sums
// all partials in block order and resets the counter: deterministic, with
// no second launch.
// ---------------------------------------------------------------------------
#define LS_STEP2_WARPS 4
#define LS_STEP2_THREADS (32 * LS_STEP2_WARPS)
#define LS_STEP2_COLS 120    // output columns of one warp's strip
#define LS_STEP2_MIN_ROWS 16  // shortest row chunk
#define LS_STEP2_MIN_BLOCKS 3  // resident blocks per SM: <= 168 registers
// Warps one launch aims at: one wave of LS_STEP2_MIN_BLOCKS blocks on each
// of an H100 SXM's 132 SMs.  A constant, not the card's count, so that the
// row chunks, and with them the Gram's summation order, depend on (R, C)
// alone: every card gives the same bits.
#define LS_STEP2_TARGET_WARPS (132 * LS_STEP2_MIN_BLOCKS * LS_STEP2_WARPS)

// The stencil of K1: term k reads slot[k] = 3 (dy + 1) + (dx + 1) of the
// 3x3 box with coefficient v[k].
struct Step2Stencil {
  int n;
  int slot[LS_MAX_TERMS];
  float v[LS_MAX_TERMS];
};

// Four consecutive columns of one row, held by one lane.
struct Row4 {
  float v[4];
};

constexpr unsigned kFull = 0xffffffffu;

// A row's four columns with the neighbouring lanes' edge columns beside
// them: e[0] from lane l - 1, e[5] from lane l + 1.
__device__ __forceinline__ void row_ext(const Row4& a, float (&e)[6]) {
  e[0] = __shfl_up_sync(kFull, a.v[3], 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j + 1] = a.v[j];
  e[5] = __shfl_down_sync(kFull, a.v[0], 1);
}

// A applied at the middle row (up, mid, dn = rows i - 1, i, i + 1) for the
// lane's four columns; the columns beside them come from lanes l - 1 and
// l + 1 (a lane at a strip edge reads its own: those columns are halo).
template <bool CROSS>
__device__ __forceinline__ Row4 apply4(const Row4& up, const Row4& mid,
                                       const Row4& dn,
                                       const Step2Stencil& st) {
  Row4 o;
  if (CROSS) {  // (0,0), (-1,0), (1,0), (0,-1), (0,1)
    const float l = __shfl_up_sync(kFull, mid.v[3], 1);
    const float r = __shfl_down_sync(kFull, mid.v[0], 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float left = j ? mid.v[j - 1] : l;
      const float right = j < 3 ? mid.v[j + 1] : r;
      float acc = 0.f;
      acc += st.v[0] * mid.v[j];
      acc += st.v[1] * up.v[j];
      acc += st.v[2] * dn.v[j];
      acc += st.v[3] * left;
      acc += st.v[4] * right;
      o.v[j] = acc;
    }
    return o;
  }
  float e[3][6];
  row_ext(up, e[0]);
  row_ext(mid, e[1]);
  row_ext(dn, e[2]);
#pragma unroll
  for (int j = 0; j < 4; ++j) o.v[j] = 0.f;
  for (int k = 0; k < st.n; ++k) {
    const float c = st.v[k];
    switch (st.slot[k]) {
#define LS_TERM(S, I, D)                                        \
  case S:                                                       \
    for (int j = 0; j < 4; ++j) o.v[j] += c * e[I][j + D];      \
    break;
      LS_TERM(0, 0, 0) LS_TERM(1, 0, 1) LS_TERM(2, 0, 2)
      LS_TERM(3, 1, 0) LS_TERM(4, 1, 1) LS_TERM(5, 1, 2)
      LS_TERM(6, 2, 0) LS_TERM(7, 2, 1) LS_TERM(8, 2, 2)
#undef LS_TERM
    }
  }
  return o;
}

__device__ __forceinline__ void mask4(Row4& a, bool row_in,
                                      const bool (&cin)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a.v[j] = row_in && cin[j] ? a.v[j] : 0.f;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ dst, long long o,
                                       const Row4& a, const bool (&own)[4]) {
  if (VEC) {
    if (own[0])
      *reinterpret_cast<float4*>(dst + o) =
          make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (own[j]) dst[o + j] = a.v[j];
  }
}

// The 10 Gram terms (GRAM_NAMES order) of one element, each product exact
// in double and accumulated in double.
__device__ __forceinline__ void gram_terms_f64(double (&g)[10], float rb,
                                               float pb, float Apb, float A2pb,
                                               float Arb) {
  const double r = rb, p = pb, ap = Apb, a2p = A2pb, ar = Arb;
  g[0] = fma(r, r, g[0]);    g[1] = fma(p, ap, g[1]);
  g[2] = fma(r, ap, g[2]);   g[3] = fma(ap, ap, g[3]);
  g[4] = fma(r, ar, g[4]);   g[5] = fma(ap, ar, g[5]);
  g[6] = fma(ap, a2p, g[6]); g[7] = fma(ar, ar, g[7]);
  g[8] = fma(ar, a2p, g[8]); g[9] = fma(a2p, a2p, g[9]);
}

// Sum of v[k] over the block's threads into dst[k], in a fixed order: warp
// shuffles, then warps in index order.
__device__ __forceinline__ void step2_block_sum(
    double (&v)[10], double (&red)[LS_STEP2_WARPS][10],
    double* __restrict__ dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    double s = v[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < 10) {
    double s = 0.0;
    for (int w = 0; w < LS_STEP2_WARPS; ++w) s += red[w][threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

template <bool CROSS, bool VEC>
__global__ void __launch_bounds__(LS_STEP2_THREADS, LS_STEP2_MIN_BLOCKS)
step2_kernel(float* __restrict__ x, const float* __restrict__ r,
             const float* __restrict__ p, const float* __restrict__ coef,
             float* __restrict__ r_out, float* __restrict__ p_out,
             float* __restrict__ g_out, double* __restrict__ partials,
             unsigned* __restrict__ counter, int R, int C, int strips,
             int chunk_rows, int units, Step2Stencil st) {
  __shared__ double red[LS_STEP2_WARPS][10];
  __shared__ double total[10];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * LS_STEP2_WARPS + (threadIdx.x >> 5);
  double g[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (unit < units) {  // warp-uniform
    const int strip = unit % strips, chunk = unit / strips;
    const int c0 = strip * LS_STEP2_COLS - 4 + 4 * lane;
    const int a = chunk * chunk_rows;
    const int b = min(a + chunk_rows, R);
    const float k0 = coef[0], k1 = coef[1], k2 = coef[2];
    const float k3 = coef[3], k4 = coef[4], k5 = coef[5];
    bool cin[4], own[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cin[j] = c0 + j >= 0 && c0 + j < C;
      own[j] = cin[j] && lane >= 1 && lane <= 30;
    }
    // row q of p, r (zero outside the grid) and of x (rows [a, b) only)
    auto load_row = [&](int q, Row4& P, Row4& Rv, Row4& X) {
#pragma unroll
      for (int j = 0; j < 4; ++j) P.v[j] = Rv.v[j] = X.v[j] = 0.f;
      if (q < 0 || q >= R) return;
      const long long o = (long long)q * C + c0;
      const bool xrow = q >= a && q < b;
      if (VEC) {
        if (!cin[0]) return;
        const float4 pv = __ldg(reinterpret_cast<const float4*>(p + o));
        const float4 rv = __ldg(reinterpret_cast<const float4*>(r + o));
        P = Row4{{pv.x, pv.y, pv.z, pv.w}};
        Rv = Row4{{rv.x, rv.y, rv.z, rv.w}};
        if (xrow && own[0]) {
          const float4 xv = *reinterpret_cast<const float4*>(x + o);
          X = Row4{{xv.x, xv.y, xv.z, xv.w}};
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!cin[j]) continue;
          P.v[j] = __ldg(p + o + j);
          Rv.v[j] = __ldg(r + o + j);
          if (xrow && own[j]) X.v[j] = x[o + j];
        }
      }
    };
    // windows, named by row relative to the step's new row q
    const Row4 z = {{0.f, 0.f, 0.f, 0.f}};
    Row4 P2 = z, P1 = z, R2 = z, R1 = z, X1 = z;  // p, r, x rows q-2, q-1
    Row4 U3 = z, U2 = z, AP2 = z;                 // u rows q-3, q-2; Ap q-2
    Row4 RN5 = z, RN4 = z, RN3 = z;               // r'' rows q-5..q-3
    Row4 PN4 = z, PN3 = z;                        // p'' rows q-4, q-3
    Row4 APN5 = z, APN4 = z;                      // A p'' rows q-5, q-4
    Row4 Pn, Rn, Xn;  // row q + 1, loading while row q is computed
    load_row(a - 4, Pn, Rn, Xn);
    for (int q = a - 4; q < b + 4; ++q) {
      const Row4 P0 = Pn, R0 = Rn, X0 = Xn;
      load_row(q + 1, Pn, Rn, Xn);
      // S1 at row q - 1
      const int i1 = q - 1;
      const bool in1 = i1 >= 0 && i1 < R;
      Row4 AP1 = apply4<CROSS>(P2, P1, P0, st);
      mask4(AP1, in1, cin);
      Row4 U1;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        U1.v[j] = k0 * P1.v[j] + k1 * R1.v[j] - k2 * AP1.v[j];
      mask4(U1, in1, cin);
      if (i1 >= a && i1 < b) {
#pragma unroll
        for (int j = 0; j < 4; ++j) X1.v[j] = X1.v[j] + U1.v[j];
        store4<VEC>(x, (long long)i1 * C + c0, X1, own);
      }
      // S2 at row q - 2
      const int i2 = q - 2;
      const bool in2 = i2 >= 0 && i2 < R;
      const Row4 AU = apply4<CROSS>(U3, U2, U1, st);
      Row4 RN2, PN2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        RN2.v[j] = R2.v[j] - AU.v[j];
        PN2.v[j] = RN2.v[j] + k3 * R2.v[j] - k4 * AP2.v[j] + k5 * P2.v[j];
      }
      mask4(RN2, in2, cin);
      mask4(PN2, in2, cin);
      if (i2 >= a && i2 < b) {
        store4<VEC>(r_out, (long long)i2 * C + c0, RN2, own);
        store4<VEC>(p_out, (long long)i2 * C + c0, PN2, own);
      }
      // S3 at row q - 3
      const int i3 = q - 3;
      Row4 APN3 = apply4<CROSS>(PN4, PN3, PN2, st);
      mask4(APN3, i3 >= 0 && i3 < R, cin);
      // S4 at row q - 4
      const int i4 = q - 4;
      if (i4 >= a && i4 < b) {
        const Row4 A2 = apply4<CROSS>(APN5, APN4, APN3, st);
        const Row4 AR = apply4<CROSS>(RN5, RN4, RN3, st);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (own[j])
            gram_terms_f64(g, RN4.v[j], PN4.v[j], APN4.v[j], A2.v[j],
                           AR.v[j]);
      }
      P2 = P1; P1 = P0; R2 = R1; R1 = R0; X1 = X0;
      U3 = U2; U2 = U1; AP2 = AP1;
      RN5 = RN4; RN4 = RN3; RN3 = RN2;
      PN4 = PN3; PN3 = PN2;
      APN5 = APN4; APN4 = APN3;
    }
  }
  // Gram partials of this block, then the last block sums them all
  step2_block_sum(g, red, partials + (size_t)blockIdx.x * 10);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double acc[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int blk = threadIdx.x; blk < (int)gridDim.x; blk += LS_STEP2_THREADS) {
#pragma unroll
    for (int k = 0; k < 10; ++k)
      acc[k] += __ldcg(partials + (size_t)blk * 10 + k);
  }
  __syncthreads();  // red is reused
  step2_block_sum(acc, red, total);
  if (threadIdx.x < 10) g_out[threadIdx.x] = (float)total[threadIdx.x];
  if (threadIdx.x == 0) *counter = 0u;
}

bool is_cross(const LsStencil& st) {
  const int dy[5] = {0, -1, 1, 0, 0}, dx[5] = {0, 0, 0, -1, 1};
  if (st.n != 5) return false;
  for (int k = 0; k < 5; ++k)
    if (st.dy[k] != dy[k] || st.dx[k] != dx[k]) return false;
  return true;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool CROSS, bool VEC>
int launch_step2(float* x, const float* r, const float* p, const float* coef,
                 float* r_out, float* p_out, float* g, double* partials,
                 int capacity, unsigned* counter, int R, int C,
                 const Step2Stencil& st, cudaStream_t stream) {
  const int strips = (C + LS_STEP2_COLS - 1) / LS_STEP2_COLS;
  long long chunks = LS_STEP2_TARGET_WARPS / strips;
  const long long max_chunks = (R + LS_STEP2_MIN_ROWS - 1) / LS_STEP2_MIN_ROWS;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  const int chunk_rows = (int)((R + chunks - 1) / chunks);
  chunks = (R + chunk_rows - 1) / chunk_rows;
  const long long units = strips * chunks;
  const long long blocks = (units + LS_STEP2_WARPS - 1) / LS_STEP2_WARPS;
  if (blocks > capacity) return (int)cudaErrorInvalidValue;
  step2_kernel<CROSS, VEC><<<(unsigned)blocks, LS_STEP2_THREADS, 0, stream>>>(
      x, r, p, coef, r_out, p_out, g, partials, counter, R, C, strips,
      chunk_rows, (int)units, st);
  return (int)cudaGetLastError();
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

// K1.  partials: capacity blocks x 10 doubles; counter: one unsigned,
// zero before the first launch (the kernel leaves it zero).  Launches on
// one (partials, counter) pair must be ordered (one stream).
int ls_step2(float* x, const float* r, const float* p, const float* coef,
             float* r_out, float* p_out, float* g, double* partials,
             int capacity, unsigned* counter, int R, int C,
             const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, 1) || !counter) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Step2Stencil s2;
  s2.n = st->n;
  for (int k = 0; k < st->n; ++k) {
    s2.slot[k] = 3 * (st->dy[k] + 1) + st->dx[k] + 1;
    s2.v[k] = st->v[k];
  }
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(r) &&
                   aligned16(p) && aligned16(r_out) && aligned16(p_out);
  const bool cross = is_cross(*st);
#define LS_STEP2_LAUNCH(CR, VE)                                              \
  launch_step2<CR, VE>(x, r, p, coef, r_out, p_out, g, partials, capacity, \
                       counter, R, C, s2, stream)
  if (cross)
    return vec ? LS_STEP2_LAUNCH(true, true) : LS_STEP2_LAUNCH(true, false);
  return vec ? LS_STEP2_LAUNCH(false, true) : LS_STEP2_LAUNCH(false, false);
#undef LS_STEP2_LAUNCH
}

int ls_step2_cols() { return LS_STEP2_COLS; }
int ls_step2_min_rows() { return LS_STEP2_MIN_ROWS; }
int ls_step2_warps() { return LS_STEP2_WARPS; }

}  // extern "C"
