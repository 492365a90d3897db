// Explicit-DIA SpMV (a variable-coefficient stencil) for Hopper (sm_90a).
//
// Hand-written CUDA port of the Pallas TPU kernel dia2d_matvec in
// legionsolvers_tpu/ops/pallas/dia2d.py (K8).  The Python wrapper, its plain
// PyTorch version and the gate live in
// legionsolvers_tpu_torch/ops/cuda/dia2d.py; the entry point has a plain C
// interface and is loaded with ctypes (build.py).
//
//   ls_dia2d  K8  y[r, c] = sum_k diags[k, r, c] * x[r + dy_k, c + dx_k],
//                 optionally <x, y> (an f32 sum)
//
// diags[k] starts diag_stride elements after diags[k - 1] (R * C for one
// [D, R, C] tensor; more for one piece's rows of a [D, S * R, C] tensor),
// so that each piece of a mesh runs on its rows of the shared coefficients.
//
// x is the [R, C] view of a flat vector; rows outside [0, R) come from the
// [8, C] halo blocks (real rows last in the top block, first in the bottom
// one; null = zeros) and columns outside [0, C) read 0, so a coefficient
// that is 0 there never meets garbage (NaN * 0 is NaN).
//
// What bounds it: bytes.  Each element reads its D coefficients and x once
// and writes y: (2 + D) * 4 B per element, 28 B at D = 5, against 2D flops.
//
// Design.  The TPU kernel streams row tiles of x through a double-buffered
// VMEM window and carries the dot in SMEM along its sequential grid.  Here
// one thread owns LS_DIA_ELEMS elements of the flat range, a block's
// threads on consecutive elements, so the coefficient loads and the y
// stores are coalesced; the D shifted reads of x go through L1/L2, which
// serve the neighbouring rows the block's neighbours read too.  The offsets
// sit in shared memory.  Terms are summed in offset order with unfused
// products and sums, as the plain version sums them: y matches it bit for
// bit.  The dot goes to per-block partials summed by reduce_partials in a
// fixed order, so results repeat from run to run.  Speed is for later work:
// no tile of x is staged in shared memory.

#include "common.cuh"

#define LS_DIA_ELEMS 4
#define LS_DIA_MAX_TERMS 512

namespace {

template <bool DOT>
__global__ void __launch_bounds__(LS_THREADS)
dia2d_kernel(const float* __restrict__ x, const float* __restrict__ top,
             const float* __restrict__ bot, const float* __restrict__ diags,
             long long ds, const int* __restrict__ offs, int D,
             float* __restrict__ y,
             float* __restrict__ partials, int R, int C) {
  __shared__ int so[2 * LS_DIA_MAX_TERMS];  // dy_0..dy_{D-1}, dx_0..dx_{D-1}
  for (int k = tid(); k < 2 * D; k += LS_THREADS) so[k] = offs[k];
  __syncthreads();
  const long long n = (long long)R * C;
  const long long base =
      (long long)blockIdx.x * LS_THREADS * LS_DIA_ELEMS + tid();
  float part = 0.f;
  for (int i = 0; i < LS_DIA_ELEMS; ++i) {
    const long long e = base + (long long)i * LS_THREADS;
    if (e >= n) break;
    const int r = (int)(e / C), c = (int)(e % C);
    float acc = 0.f;
    for (int k = 0; k < D; ++k) {
      const float t = mul_rn(diags[(size_t)k * ds + e],
                             load_halo(x, top, bot, R, C, r + so[k],
                                       c + so[D + k]));
      acc = k ? add_rn(acc, t) : t;
    }
    y[e] = acc;
    if (DOT) part += x[e] * acc;
  }
  if (DOT) {
    float v[1] = {part};
    block_partials<float, 1>(v, partials);
  }
}

}  // namespace

extern "C" {

int ls_dia_max_terms() { return LS_DIA_MAX_TERMS; }
int ls_dia_elems() { return LS_DIA_ELEMS; }

// diag_stride: elements from one diagonal to the next, >= R * C.
// offs: 2 * D ints on the device (dy then dx), |dy| <= 8, |dx| < C.
// partials: one float per block of LS_THREADS * LS_DIA_ELEMS elements; dot
// one float.  Both are unused without `with_dot`.
int ls_dia2d(int with_dot, const float* x, const float* top, const float* bot,
             const float* diags, long long diag_stride, const int* offs,
             int D, float* y, float* dot, float* partials, int R, int C,
             void* stream_ptr) {
  if (R < 1 || C < 1 || D < 1 || D > LS_DIA_MAX_TERMS ||
      (long long)R * C >= (1LL << 31) || diag_stride < (long long)R * C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long per_block = (long long)LS_THREADS * LS_DIA_ELEMS;
  const int nblocks = (int)(((long long)R * C + per_block - 1) / per_block);
  const dim3 block(LS_THREADS_X, LS_THREADS_Y);
  if (!with_dot) {
    dia2d_kernel<false><<<nblocks, block, 0, stream>>>(
        x, top, bot, diags, diag_stride, offs, D, y, partials, R, C);
    return (int)cudaGetLastError();
  }
  dia2d_kernel<true><<<nblocks, block, 0, stream>>>(
      x, top, bot, diags, diag_stride, offs, D, y, partials, R, C);
  return finish(partials, nblocks, 1, dot, stream);
}

}  // extern "C"
