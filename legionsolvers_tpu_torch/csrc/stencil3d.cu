// 3-D grid stencil SpMV and fused-CG passes for Hopper (sm_90a).
//
// Hand-written CUDA ports of the Pallas TPU kernels in
// legionsolvers_tpu/ops/pallas/stencil3d.py.  Python wrappers, plain PyTorch
// versions and gates live in legionsolvers_tpu_torch/ops/cuda/stencil3d.py;
// the entry points below have a plain C interface and are loaded with ctypes
// (build.py).
//
//   ls_stencil3d  K6a  replaces _stencil3d_call (modes y, y_dot, pq, update)
//   ls_xpay_pq3d  K6b  replaces grid3d_cg_xpay_pq
//
// What bounds them: bytes.  The 27-point stencil does 54 flops per element
// against at least 4 B of traffic, 13 flops per byte, below the card's ~20
// f32 flops per byte of HBM bandwidth; the 7-point one does 14.  K6a moves
// 8 B per element (y, y_dot: read x, write y), 4 B (pq) or 20 B (update:
// read p, x, r; write x, r); K6b 12 B (read r, p_old; write p).
//
// Design.  The Pallas kernels stream whole [Y, Z] planes through a rotating
// 4-slot VMEM buffer on a sequential grid and carry the dot in SMEM.  Here
// each block owns a 32 x 32 (y, z) tile and marches along x over 16 planes
// (march3d in common.cuh), holding planes x - 1, x, x + 1 of its window in
// three rotating shared-memory slots, so each input byte crosses HBM about
// once: the window's y/z halo adds 13% re-reads for reach 1, the two extra
// planes of each 16-plane chunk 12.5%.  At 256^3 that is 64 tiles x 16
// chunks = 1024 blocks.  K6b forms p = r + beta p_old while loading the
// window and applies A to it once; A p never reaches HBM in pq, update or
// xpay_pq.  Partial dots go to a [blocks] scratch, summed by a second
// launch in a fixed order: no atomics, the same bits from run to run.
// Buffers: update writes x and r in place, because it reads them only at
// the thread's own element; xpay_pq writes p to a buffer other than p_old,
// which neighbouring blocks read through their windows.  The 27-point
// stencil is applied as a direct 27-term sum: the separable factorization
// of the TPU kernel saved vector-unit work there and is not used.  Speed is
// for later work: plain loads, no TMA or cp.async pipeline.

#include "common.cuh"

namespace {

// K6a: y = A x (mode 0), y and <x, A x> (1), <x, A x> (2),
//      update (3): xv += alpha x; rv -= alpha A x; <rv', rv'>  (x is p here)
template <int MODE>
__global__ void __launch_bounds__(LS_THREADS)
stencil3d_kernel(const float* __restrict__ x, const float* __restrict__ top,
                 const float* __restrict__ bot, float* __restrict__ y,
                 float* __restrict__ xv, float* __restrict__ rv,
                 const float* __restrict__ alpha_p,
                 float* __restrict__ partials, int X, int Y, int Z,
                 LsStencil3 st, int h) {
  __shared__ float win[3 * kPlaneMax];
  __shared__ SharedStencil3 s;
  stage_stencil3(s, st, LS_TILE + 2 * h);
  const float alpha = MODE == 3 ? *alpha_p : 0.f;
  float acc[1] = {0.f};
  march3d(win, s, h, X, Y, Z, top, bot, [&](size_t idx) { return x[idx]; },
          [&](size_t idx, float c, float ax) {
            if (MODE == 0 || MODE == 1) y[idx] = ax;
            if (MODE == 1 || MODE == 2) acc[0] += c * ax;
            if (MODE == 3) {
              xv[idx] = xv[idx] + alpha * c;
              const float rn = rv[idx] - alpha * ax;
              rv[idx] = rn;
              acc[0] += rn * rn;
            }
          });
  if (MODE != 0) block_partials(acc, partials);
}

// K6b: p = r + beta p_old (written to p_out) and <p, A p>; the halo planes
// are p's own (the caller combines r's and p_old's).
__global__ void __launch_bounds__(LS_THREADS)
xpay_pq3d_kernel(const float* __restrict__ r, const float* __restrict__ p_old,
                 const float* __restrict__ beta_p,
                 const float* __restrict__ top, const float* __restrict__ bot,
                 float* __restrict__ p_out, float* __restrict__ partials,
                 int X, int Y, int Z, LsStencil3 st, int h) {
  __shared__ float win[3 * kPlaneMax];
  __shared__ SharedStencil3 s;
  stage_stencil3(s, st, LS_TILE + 2 * h);
  const float beta = *beta_p;
  float acc[1] = {0.f};
  march3d(win, s, h, X, Y, Z, top, bot,
          [&](size_t idx) { return r[idx] + beta * p_old[idx]; },
          [&](size_t idx, float c, float ax) {
            p_out[idx] = c;
            acc[0] += c * ax;
          });
  block_partials(acc, partials);
}

}  // namespace

extern "C" {

int ls_chunk_x() { return LS_CHUNK_X; }
int ls_stencil3_size() { return (int)sizeof(LsStencil3); }

// mode: 0 y, 1 y_dot, 2 pq, 3 update.  Pointers unused by a mode may be
// null; halo planes may be null (zeros).  partials: one float per block.
int ls_stencil3d(int mode, const float* x, const float* top, const float* bot,
                 float* y, float* xv, float* rv, const float* alpha,
                 float* dot, float* partials, int X, int Y, int Z,
                 const LsStencil3* st, void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = march_grid(X, Y, Z), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = reach3_yz(*st);
  switch (mode) {
    case 0: stencil3d_kernel<0><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, X, Y, Z, *st, h);
            return (int)cudaGetLastError();
    case 1: stencil3d_kernel<1><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, X, Y, Z, *st, h); break;
    case 2: stencil3d_kernel<2><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, X, Y, Z, *st, h); break;
    case 3: stencil3d_kernel<3><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, X, Y, Z, *st, h); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return finish(partials, grid.x * grid.y * grid.z, 1, dot, stream);
}

int ls_xpay_pq3d(const float* r, const float* p_old, const float* beta,
                 const float* top, const float* bot, float* p_out, float* dot,
                 float* partials, int X, int Y, int Z, const LsStencil3* st,
                 void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = march_grid(X, Y, Z), block(LS_THREADS_X, LS_THREADS_Y);
  xpay_pq3d_kernel<<<grid, block, 0, stream>>>(r, p_old, beta, top, bot,
                                               p_out, partials, X, Y, Z, *st,
                                               reach3_yz(*st));
  return finish(partials, grid.x * grid.y * grid.z, 1, dot, stream);
}

}  // extern "C"
