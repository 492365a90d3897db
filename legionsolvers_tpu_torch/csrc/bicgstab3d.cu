// Fused BiCGStab passes over 3-D grid stencils for Hopper (sm_90a).
//
// Hand-written CUDA ports of the Pallas TPU kernel
// legionsolvers_tpu/ops/pallas/bicgstab3d.py (_bicg3d_call, one pallas_call
// for three modes).  Python wrappers, plain PyTorch versions and the gate
// live in legionsolvers_tpu_torch/ops/cuda/bicgstab3d.py; the entry points
// below have a plain C interface and are loaded with ctypes (build.py).
//
//   ls_bicg3d_pv      K7 pv:     p' = r + beta (p - omega v), v' = A p',
//                                <r~, v'>
//   ls_bicg3d_st      K7 st:     s = r - alpha v, t = A s, <t, s>, <t, t>
//   ls_bicg3d_update  K7 update: x += alpha p + omega s, r' = s - omega t,
//                                <r', r'>, <r~, r'>
//
// What bounds them: bytes, as for K5: one stencil application per element
// against 24 B (pv: reads r, p, v, r~; writes p', v'), 8 B (st: reads r, v)
// and 28 B (update: reads r, v, x, p, r~; writes x', r') per element.
//
// Design: the 2-D passes of bicgstab2d.cu on the 3-D march of common.cuh
// (see stencil3d.cu): each block owns a 32 x 32 (y, z) tile, marches along x
// over 16 planes, and forms the pass's operand (p' for pv, s for st and
// update) as each plane of its window is loaded, so A is applied once to
// it and s, t never reach device memory.  Halo planes are the combined
// operand's own.  Dots go to a [blocks, k] scratch and a second launch sums
// them in a fixed order; under `compensated` the exact f32 products are
// accumulated in double and rounded to f32 once.  Buffers: pv writes p' and
// v' to buffers other than p and v, update writes r' to a buffer other than
// r (neighbouring blocks read p, v and r through their windows); x is
// updated in place, because x, p and r~ are read only at the thread's own
// element.

#include "common.cuh"

namespace {

// K7 pv: p' = r + beta (p - omega v) on the window, v' = A p', <r~, v'>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg3d_pv_kernel(const float* __restrict__ r, const float* __restrict__ p,
                 const float* __restrict__ v, const float* __restrict__ rt,
                 const float* __restrict__ beta_p,
                 const float* __restrict__ omega_p,
                 const float* __restrict__ top, const float* __restrict__ bot,
                 float* __restrict__ p_out, float* __restrict__ v_out,
                 typename Acc<COMP>::T* __restrict__ partials, int X, int Y,
                 int Z, LsStencil3 st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float win[3 * kPlaneMax];
  __shared__ SharedStencil3 s;
  stage_stencil3(s, st, LS_TILE + 2 * h);
  const float beta = *beta_p, omega = *omega_p;
  T acc[1] = {0};
  march3d(win, s, h, X, Y, Z, top, bot,
          [&](size_t idx) { return r[idx] + beta * (p[idx] - omega * v[idx]); },
          [&](size_t idx, float c, float ax) {
            p_out[idx] = c;
            v_out[idx] = ax;
            acc[0] += (T)rt[idx] * (T)ax;
          });
  block_partials(acc, partials);
}

// K7 st: s = r - alpha v on the window, t = A s; <t, s>, <t, t>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg3d_st_kernel(const float* __restrict__ r, const float* __restrict__ v,
                 const float* __restrict__ alpha_p,
                 const float* __restrict__ top, const float* __restrict__ bot,
                 typename Acc<COMP>::T* __restrict__ partials, int X, int Y,
                 int Z, LsStencil3 st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float win[3 * kPlaneMax];
  __shared__ SharedStencil3 s;
  stage_stencil3(s, st, LS_TILE + 2 * h);
  const float alpha = *alpha_p;
  T acc[2] = {0, 0};
  march3d(win, s, h, X, Y, Z, top, bot,
          [&](size_t idx) { return r[idx] - alpha * v[idx]; },
          [&](size_t idx, float c, float ax) {
            acc[0] += (T)ax * (T)c;
            acc[1] += (T)ax * (T)ax;
          });
  block_partials(acc, partials);
}

// K7 update: s and t = A s as in st; x += alpha p + omega s (in place);
// r' = s - omega t (to r_out); <r', r'>, <r~, r'>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg3d_update_kernel(const float* __restrict__ r, const float* __restrict__ v,
                     float* __restrict__ x, const float* __restrict__ p,
                     const float* __restrict__ rt,
                     const float* __restrict__ alpha_p,
                     const float* __restrict__ omega_p,
                     const float* __restrict__ top,
                     const float* __restrict__ bot, float* __restrict__ r_out,
                     typename Acc<COMP>::T* __restrict__ partials, int X,
                     int Y, int Z, LsStencil3 st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float win[3 * kPlaneMax];
  __shared__ SharedStencil3 s;
  stage_stencil3(s, st, LS_TILE + 2 * h);
  const float alpha = *alpha_p, omega = *omega_p;
  T acc[2] = {0, 0};
  march3d(win, s, h, X, Y, Z, top, bot,
          [&](size_t idx) { return r[idx] - alpha * v[idx]; },
          [&](size_t idx, float c, float ax) {
            x[idx] = x[idx] + alpha * p[idx] + omega * c;
            const float rn = c - omega * ax;
            r_out[idx] = rn;
            acc[0] += (T)rn * (T)rn;
            acc[1] += (T)rt[idx] * (T)rn;
          });
  block_partials(acc, partials);
}

}  // namespace

extern "C" {

// partials: scratch of K doubles per block (only K floats per block are
// used without `compensated`).  dot: K floats.  Halo planes may be null
// (zeros).
int ls_bicg3d_pv(const float* r, const float* p, const float* v,
                 const float* rt, const float* beta, const float* omega,
                 const float* top, const float* bot, float* p_out,
                 float* v_out, float* dot, void* partials, int X, int Y,
                 int Z, int compensated, const LsStencil3* st,
                 void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = march_grid(X, Y, Z), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = reach3_yz(*st), nblocks = grid.x * grid.y * grid.z;
  if (compensated) {
    bicg3d_pv_kernel<true><<<grid, block, 0, stream>>>(
        r, p, v, rt, beta, omega, top, bot, p_out, v_out, (double*)partials,
        X, Y, Z, *st, h);
    return finish((const double*)partials, nblocks, 1, dot, stream);
  }
  bicg3d_pv_kernel<false><<<grid, block, 0, stream>>>(
      r, p, v, rt, beta, omega, top, bot, p_out, v_out, (float*)partials, X,
      Y, Z, *st, h);
  return finish((const float*)partials, nblocks, 1, dot, stream);
}

int ls_bicg3d_st(const float* r, const float* v, const float* alpha,
                 const float* top, const float* bot, float* dot,
                 void* partials, int X, int Y, int Z, int compensated,
                 const LsStencil3* st, void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = march_grid(X, Y, Z), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = reach3_yz(*st), nblocks = grid.x * grid.y * grid.z;
  if (compensated) {
    bicg3d_st_kernel<true><<<grid, block, 0, stream>>>(
        r, v, alpha, top, bot, (double*)partials, X, Y, Z, *st, h);
    return finish((const double*)partials, nblocks, 2, dot, stream);
  }
  bicg3d_st_kernel<false><<<grid, block, 0, stream>>>(
      r, v, alpha, top, bot, (float*)partials, X, Y, Z, *st, h);
  return finish((const float*)partials, nblocks, 2, dot, stream);
}

int ls_bicg3d_update(const float* r, const float* v, float* x, const float* p,
                     const float* rt, const float* alpha, const float* omega,
                     const float* top, const float* bot, float* r_out,
                     float* dot, void* partials, int X, int Y, int Z,
                     int compensated, const LsStencil3* st,
                     void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = march_grid(X, Y, Z), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = reach3_yz(*st), nblocks = grid.x * grid.y * grid.z;
  if (compensated) {
    bicg3d_update_kernel<true><<<grid, block, 0, stream>>>(
        r, v, x, p, rt, alpha, omega, top, bot, r_out, (double*)partials, X,
        Y, Z, *st, h);
    return finish((const double*)partials, nblocks, 2, dot, stream);
  }
  bicg3d_update_kernel<false><<<grid, block, 0, stream>>>(
      r, v, x, p, rt, alpha, omega, top, bot, r_out, (float*)partials, X, Y,
      Z, *st, h);
  return finish((const float*)partials, nblocks, 2, dot, stream);
}

}  // extern "C"
