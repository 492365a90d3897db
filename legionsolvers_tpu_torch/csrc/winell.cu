// Windowed-ELL SpMV for Hopper (sm_90a), float and double.
//
// Hand-written CUDA port of the Pallas TPU kernel winell_spmv in
// legionsolvers_tpu/ops/pallas/winell.py (K9).  The Python wrapper and its
// plain PyTorch version live in legionsolvers_tpu_torch/ops/cuda/winell.py;
// the entry point has a plain C interface and is loaded with ctypes.
//
//   ls_winell  K9  y[t, r] = sum_s vals[t, s, r] * x[wstart[t, s] * 128
//                                                    + cols[t, s, r]]
//
// Tile t covers Rt * 128 output rows; slot s of the tile reads x through a
// window of KR rows of 128 that starts at row wstart[t, s] (host-planned by
// parallel/winell_op.py, which keeps every read inside x).  Padding slots
// carry val 0 and an in-window column.
//
// What bounds it: bytes.  Per ELL slot it reads a 4 B column and a value
// (4 B f32, 8 B f64); per row it writes y; x is read once if the windows
// stay in cache.  2 flops per slot.
//
// Design.  The TPU has no gather beyond one vector register, so the Pallas
// kernel DMAs each (tile, slot) window into VMEM and sweeps it chunk by
// chunk (~4 KR vector ops per nonzero).  The card gathers through its cache
// hierarchy, so this kernel is the direct SELL product: one thread per
// output row, the L slots summed in slot order with unfused products and
// sums (bit for bit the plain version's), x read through L1/L2, the tile's
// window starts a broadcast load.  Consecutive threads read consecutive
// columns and values of a slot, so those loads are coalesced.

#include "common.cuh"

#define LS_WINELL_THREADS 256

namespace {

template <typename T>
__global__ void __launch_bounds__(LS_WINELL_THREADS)
winell_kernel(const T* __restrict__ x, const int* __restrict__ wstart,
              const int* __restrict__ cols, const T* __restrict__ vals,
              T* __restrict__ y, int nt, int L, int rows_per_tile) {
  const long long row = (long long)blockIdx.x * LS_WINELL_THREADS + threadIdx.x;
  if (row >= (long long)nt * rows_per_tile) return;
  const int t = (int)(row / rows_per_tile), rr = (int)(row % rows_per_tile);
  T acc = 0;
  for (int s = 0; s < L; ++s) {
    const size_t ts = (size_t)t * L + s;
    const size_t at = ts * rows_per_tile + rr;
    const size_t xi = (size_t)wstart[ts] * 128 + cols[at];
    acc = add_rn(acc, mul_rn(vals[at], x[xi]));
  }
  y[row] = acc;
}

template <typename T>
int launch_winell(const void* x, const int* wstart, const int* cols,
                  const void* vals, void* y, int nt, int L, int Rt,
                  cudaStream_t stream) {
  const int rows_per_tile = Rt * 128;
  const long long rows = (long long)nt * rows_per_tile;
  const int nblocks =
      (int)((rows + LS_WINELL_THREADS - 1) / LS_WINELL_THREADS);
  winell_kernel<T><<<nblocks, LS_WINELL_THREADS, 0, stream>>>(
      (const T*)x, wstart, cols, (const T*)vals, (T*)y, nt, L,
      rows_per_tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [NR, 128], wstart: [>= nt, L] int32, cols/vals: [nt, L, Rt, 128],
// y: [nt * Rt, 128].  is_double selects double for x, vals and y.
int ls_winell(int is_double, const void* x, const int* wstart,
              const int* cols, const void* vals, void* y, int nt, int L,
              int Rt, void* stream_ptr) {
  if (nt < 1 || L < 1 || Rt < 1 || (long long)nt * Rt * 128 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (is_double)
    return launch_winell<double>(x, wstart, cols, vals, y, nt, L, Rt, stream);
  return launch_winell<float>(x, wstart, cols, vals, y, nt, L, Rt, stream);
}

}  // extern "C"
