// Op-rate probe chains for Hopper (sm_90a).
//
// Hand-written CUDA port of the Pallas TPU kernel _chain_kernel in
// legionsolvers_tpu/utils/vpu_probe.py (K11).  The Python wrapper and its
// plain PyTorch version live in legionsolvers_tpu_torch/ops/cuda/vpu_probe.py;
// the entry point has a plain C interface and is loaded with ctypes.
//
//   ls_vpu_chain  K11  out = sum_{j<8} f^(8 reps)(x + j), f by kind:
//     fma   f(v) = v * 1.000001f + (float)(0.25 + 0.01 j)   (one fmaf)
//     roll  f(v) = 0.5 v + w,  w[r, c] = v[r, (c - 1) mod 1024]
//     row   f(v) = 0.5 v + w,  w[r, c] = v[(r + 1) mod 256, c]
//
// x and out are one [256, 1024] float tile (fma takes any length).  Eight
// independent chains per element hide the instruction latency; each loop
// trip applies eight steps to each.
//
// What bounds it: operations, by design.  Two bytes-moving passes (x read,
// out written: 2 MB) against 64 steps per element per trip.  fma measures
// the fmaf rate (the card's f32 peak: 132 SMs x 128 lanes x 2 flop x the
// clock).  roll and row measure a neighbour exchange through shared memory:
// every step stores the eight chain values, synchronises, loads the
// neighbour's and synchronises again, 8 bytes of shared-memory traffic per
// chain step, so their ceiling is the shared-memory rate (132 SMs x 128 B
// per clock) over 8 B.
//
// Design.  One thread per element, its eight chain values in registers.
// fma needs no exchange: blocks of 256 threads over the flat tile.  The
// wrap-around makes every element depend on its whole row (roll) or column
// (row) within a few steps, so one block holds a whole row (1024 threads)
// or a whole 256-high strip of 4 columns (1024 threads) and exchanges
// through 8 x 1024 floats (32 KB) of shared memory.  roll and row round
// the product and the sum separately (0.5 v is exact), so they equal the
// plain version bit for bit; fma rounds once per step where the plain
// version rounds twice (the tolerance is derived in the wrapper).

#include "common.cuh"

#define LS_VPU_TR 256
#define LS_VPU_C 1024
#define LS_VPU_ILP 8
#define LS_VPU_UNROLL 8
#define LS_VPU_FMA_THREADS 256
#define LS_VPU_ROW_COLS 4

namespace {

__device__ __forceinline__ float chain_sum(const float (&v)[LS_VPU_ILP]) {
  float acc = v[0];
#pragma unroll
  for (int j = 1; j < LS_VPU_ILP; ++j) acc = add_rn(acc, v[j]);
  return acc;
}

__global__ void __launch_bounds__(LS_VPU_FMA_THREADS)
chain_fma_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                 long long reps) {
  const int e = blockIdx.x * LS_VPU_FMA_THREADS + threadIdx.x;
  if (e >= n) return;
  const float x0 = x[e];
  const float a = (float)1.000001;
  float v[LS_VPU_ILP], b[LS_VPU_ILP];
#pragma unroll
  for (int j = 0; j < LS_VPU_ILP; ++j) {
    v[j] = add_rn(x0, (float)j);
    b[j] = (float)(0.25 + 0.01 * j);
  }
  for (long long t = 0; t < reps; ++t) {
#pragma unroll
    for (int u = 0; u < LS_VPU_UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < LS_VPU_ILP; ++j) v[j] = fmaf(v[j], a, b[j]);
    }
  }
  out[e] = chain_sum(v);
}

// ROW = false: roll along a row of 1024 (block = one row, thread = column).
// ROW = true: shift along a column of 256 (block = 4 columns x 256 rows,
// thread = (row, column), columns fastest).
template <bool ROW>
__global__ void __launch_bounds__(LS_VPU_C)
chain_exchange_kernel(const float* __restrict__ x, float* __restrict__ out,
                      long long reps) {
  __shared__ float s[LS_VPU_ILP][LS_VPU_C];
  const int t = threadIdx.x;
  int e, nb;
  if (ROW) {
    const int c = t % LS_VPU_ROW_COLS, r = t / LS_VPU_ROW_COLS;
    e = r * LS_VPU_C + blockIdx.x * LS_VPU_ROW_COLS + c;
    nb = ((r + 1) % LS_VPU_TR) * LS_VPU_ROW_COLS + c;
  } else {
    e = blockIdx.x * LS_VPU_C + t;
    nb = (t + LS_VPU_C - 1) % LS_VPU_C;
  }
  const float x0 = x[e];
  float v[LS_VPU_ILP];
#pragma unroll
  for (int j = 0; j < LS_VPU_ILP; ++j) v[j] = add_rn(x0, (float)j);
  for (long long it = 0; it < reps; ++it) {
#pragma unroll
    for (int u = 0; u < LS_VPU_UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < LS_VPU_ILP; ++j) s[j][t] = v[j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < LS_VPU_ILP; ++j)
        v[j] = add_rn(mul_rn(0.5f, v[j]), s[j][nb]);
      __syncthreads();
    }
  }
  out[e] = chain_sum(v);
}

}  // namespace

extern "C" {

// kind: 0 fma, 1 roll, 2 row.  x, out: rows x cols floats; roll and row
// need the probe's tile, 256 x 1024.
int ls_vpu_chain(int kind, const float* x, float* out, int rows, int cols,
                 long long reps, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (rows < 1 || cols < 1 || reps < 0) return (int)cudaErrorInvalidValue;
  if (kind == 0) {
    const long long n = (long long)rows * cols;
    if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int blocks = (int)((n + LS_VPU_FMA_THREADS - 1) / LS_VPU_FMA_THREADS);
    chain_fma_kernel<<<blocks, LS_VPU_FMA_THREADS, 0, stream>>>(
        x, out, (int)n, reps);
  } else if (kind == 1 || kind == 2) {
    if (rows != LS_VPU_TR || cols != LS_VPU_C) return (int)cudaErrorInvalidValue;
    if (kind == 1)
      chain_exchange_kernel<false><<<LS_VPU_TR, LS_VPU_C, 0, stream>>>(
          x, out, reps);
    else
      chain_exchange_kernel<true>
          <<<LS_VPU_C / LS_VPU_ROW_COLS, LS_VPU_C, 0, stream>>>(x, out, reps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int ls_vpu_tile_rows() { return LS_VPU_TR; }
int ls_vpu_tile_cols() { return LS_VPU_C; }

}  // extern "C"
