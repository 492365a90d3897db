// Fused BiCGStab passes over 2-D grid stencils for Hopper (sm_90a).
//
// Hand-written CUDA ports of the Pallas TPU kernels in
// legionsolvers_tpu/ops/pallas/bicgstab2d.py.  Python wrappers, plain
// PyTorch versions and the gate live in
// legionsolvers_tpu_torch/ops/cuda/bicgstab2d.py; the entry points below
// have a plain C interface and are loaded with ctypes (build.py).
//
//   ls_bicg_pv      K5a  replaces bicg_pv:     p' = r + beta (p - omega v),
//                        v' = A p', <r~, v'>
//   ls_bicg_st      K5b  replaces bicg_st:     s = r - alpha v, t = A s,
//                        <t, s>, <t, t>
//   ls_bicg_update  K5c  replaces bicg_update: x += alpha p + omega s,
//                        r' = s - omega t, <r', r'>, <r~, r'>
//
// What bounds them: bytes.  One stencil application per element (~2 flops
// per term) against 24 B (pv: reads r, p, v, r~; writes p', v'), 8 B (st:
// reads r, v) and 28 B (update: reads r, v, x, p, r~; writes x', r') per
// element: 60 B per unknown per iteration.
//
// Design, as in stencil2d.cu: each block owns one LS_TILE x LS_TILE output
// tile and loads the window it needs (the tile plus the stencil reach h on
// each side) into shared memory once.  The operand of the one stencil
// application is formed while loading: p' = r + beta (p - omega v) for pv,
// s = r - alpha v for st and update, both zero outside the grid (the
// one-application contract of the Pallas passes: no chained masking).
// s and t = A s never reach device memory.  Dots go to a [blocks, k]
// scratch and a second launch sums them in a fixed order, so results repeat
// from run to run.  With `compensated`, every thread accumulates the exact
// f32 x f32 products in double, the partials and their sum are double, and
// the result is rounded to f32 once (the card's native f64 in place of the
// TPU's two-float pairs).
//
// Buffers: no kernel writes a buffer that another block reads through a
// halo.  pv writes p' and v' to buffers other than p and v, update writes
// r' to a buffer other than r; x is updated in place, because x, p and r~
// are read only at each thread's own element.

#include "common.cuh"

namespace {

// Fill w[(i, j)], 0 <= i, j < W, with f(global row, global column) for
// points inside the grid and zero outside.  Threads walk rows and columns
// directly, so neighbouring threads read neighbouring addresses.
template <typename F>
__device__ __forceinline__ void load_window(float* w, int W, int h, int r0,
                                            int c0, int R, int C, F f) {
  for (int i = threadIdx.y; i < W; i += LS_THREADS_Y) {
    const int gr = r0 - h + i;
    for (int j = threadIdx.x; j < W; j += LS_THREADS_X) {
      const int gc = c0 - h + j;
      w[i * W + j] = in_grid(gr, gc, R, C) ? f((size_t)gr * C + gc) : 0.f;
    }
  }
}

// K5a: p' = r + beta (p - omega v) on the window, v' = A p', <r~, v'>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg_pv_kernel(const float* __restrict__ r, const float* __restrict__ p,
               const float* __restrict__ v, const float* __restrict__ rt,
               const float* __restrict__ beta_p,
               const float* __restrict__ omega_p, float* __restrict__ p_out,
               float* __restrict__ v_out,
               typename Acc<COMP>::T* __restrict__ partials, int R, int C,
               LsStencil st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float w[kWinMax * kWinMax];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const float beta = *beta_p, omega = *omega_p;
  const int W = LS_TILE + 2 * h;
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  load_window(w, W, h, r0, c0, R, C, [&](size_t idx) {
    return r[idx] + beta * (p[idx] - omega * v[idx]);
  });
  __syncthreads();
  T acc[1] = {0};
  const int j = threadIdx.x, gc = c0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    const int gr = r0 + i;
    if (gr >= R || gc >= C) continue;
    const size_t idx = (size_t)gr * C + gc;
    const float vn = apply_at(w, W, i + h, j + h, s);
    p_out[idx] = w[(i + h) * W + j + h];
    v_out[idx] = vn;
    acc[0] += (T)rt[idx] * (T)vn;
  }
  block_partials(acc, partials);
}

// K5b: s = r - alpha v on the window, t = A s; <t, s>, <t, t>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg_st_kernel(const float* __restrict__ r, const float* __restrict__ v,
               const float* __restrict__ alpha_p,
               typename Acc<COMP>::T* __restrict__ partials, int R, int C,
               LsStencil st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float w[kWinMax * kWinMax];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const float alpha = *alpha_p;
  const int W = LS_TILE + 2 * h;
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  load_window(w, W, h, r0, c0, R, C,
              [&](size_t idx) { return r[idx] - alpha * v[idx]; });
  __syncthreads();
  T acc[2] = {0, 0};
  const int j = threadIdx.x, gc = c0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    if (r0 + i >= R || gc >= C) continue;
    const float t = apply_at(w, W, i + h, j + h, s);
    const float sc = w[(i + h) * W + j + h];
    acc[0] += (T)t * (T)sc;
    acc[1] += (T)t * (T)t;
  }
  block_partials(acc, partials);
}

// K5c: s and t = A s as in st; x += alpha p + omega s (in place);
// r' = s - omega t (to r_out); <r', r'>, <r~, r'>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg_update_kernel(const float* __restrict__ r, const float* __restrict__ v,
                   float* __restrict__ x, const float* __restrict__ p,
                   const float* __restrict__ rt,
                   const float* __restrict__ alpha_p,
                   const float* __restrict__ omega_p,
                   float* __restrict__ r_out,
                   typename Acc<COMP>::T* __restrict__ partials, int R, int C,
                   LsStencil st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float w[kWinMax * kWinMax];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const float alpha = *alpha_p, omega = *omega_p;
  const int W = LS_TILE + 2 * h;
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  load_window(w, W, h, r0, c0, R, C,
              [&](size_t idx) { return r[idx] - alpha * v[idx]; });
  __syncthreads();
  T acc[2] = {0, 0};
  const int j = threadIdx.x, gc = c0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    const int gr = r0 + i;
    if (gr >= R || gc >= C) continue;
    const size_t idx = (size_t)gr * C + gc;
    const float t = apply_at(w, W, i + h, j + h, s);
    const float sc = w[(i + h) * W + j + h];
    x[idx] = x[idx] + alpha * p[idx] + omega * sc;
    const float rn = sc - omega * t;
    r_out[idx] = rn;
    acc[0] += (T)rn * (T)rn;
    acc[1] += (T)rt[idx] * (T)rn;
  }
  block_partials(acc, partials);
}

}  // namespace

extern "C" {

// partials: scratch of K doubles per tile (only K floats per tile are used
// without `compensated`).  dot: K floats.
int ls_bicg_pv(const float* r, const float* p, const float* v,
               const float* rt, const float* beta, const float* omega,
               float* p_out, float* v_out, float* dot, void* partials, int R,
               int C, int compensated, const LsStencil* st,
               void* stream_ptr) {
  if (!valid(st, R, C, LS_MAX_REACH)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = reach_of(*st), nblocks = grid.x * grid.y;
  if (compensated) {
    bicg_pv_kernel<true><<<grid, block, 0, stream>>>(
        r, p, v, rt, beta, omega, p_out, v_out, (double*)partials, R, C, *st, h);
    return finish((const double*)partials, nblocks, 1, dot, stream);
  }
  bicg_pv_kernel<false><<<grid, block, 0, stream>>>(
      r, p, v, rt, beta, omega, p_out, v_out, (float*)partials, R, C, *st, h);
  return finish((const float*)partials, nblocks, 1, dot, stream);
}

int ls_bicg_st(const float* r, const float* v, const float* alpha, float* dot,
               void* partials, int R, int C, int compensated,
               const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, LS_MAX_REACH)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = reach_of(*st), nblocks = grid.x * grid.y;
  if (compensated) {
    bicg_st_kernel<true><<<grid, block, 0, stream>>>(
        r, v, alpha, (double*)partials, R, C, *st, h);
    return finish((const double*)partials, nblocks, 2, dot, stream);
  }
  bicg_st_kernel<false><<<grid, block, 0, stream>>>(
      r, v, alpha, (float*)partials, R, C, *st, h);
  return finish((const float*)partials, nblocks, 2, dot, stream);
}

int ls_bicg_update(const float* r, const float* v, float* x, const float* p,
                   const float* rt, const float* alpha, const float* omega,
                   float* r_out, float* dot, void* partials, int R, int C,
                   int compensated, const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, LS_MAX_REACH)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = reach_of(*st), nblocks = grid.x * grid.y;
  if (compensated) {
    bicg_update_kernel<true><<<grid, block, 0, stream>>>(
        r, v, x, p, rt, alpha, omega, r_out, (double*)partials, R, C, *st, h);
    return finish((const double*)partials, nblocks, 2, dot, stream);
  }
  bicg_update_kernel<false><<<grid, block, 0, stream>>>(
      r, v, x, p, rt, alpha, omega, r_out, (float*)partials, R, C, *st, h);
  return finish((const float*)partials, nblocks, 2, dot, stream);
}

}  // extern "C"
