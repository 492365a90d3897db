// Row-structured gather (one hop of the routed general SpMV) for Hopper
// (sm_90a), float and double.
//
// Hand-written CUDA port of the Pallas TPU kernel blockperm_gather in
// legionsolvers_tpu/ops/pallas/rowperm.py (K10).  The Python wrapper and its
// plain PyTorch version live in legionsolvers_tpu_torch/ops/cuda/rowperm.py;
// the entry point has a plain C interface and is loaded with ctypes.
//
//   ls_blockperm  K10  out[d, j] = src[(d / br * srb + w0[d % br]) * 1024
//                                      + idx[d, j]]  (* vals[d, j])
//
// Destination rows of 1024 come in blocks of br rows; block b reads source
// block b (srb rows of 1024), and row d of a block reads the w_rows-row
// window that starts at w0[d % br] within it.  idx is relative to that
// window, so every read stays in the source block (checked on the host).
//
// What bounds it: bytes.  4 B of idx, the out element and, on the scaled
// hop, its value per element, plus the source once.  At most one multiply.
//
// Design.  The TPU kernel sweeps each window chunk by chunk with one-vreg
// lane gathers (32 w_rows vector ops per element), because Mosaic cannot
// gather across vector registers.  The card gathers through its cache: one
// thread per output element, consecutive threads on consecutive idx, vals
// and out (coalesced); the source window, at most 8 rows of 1024, stays in
// L1/L2; w0 is a small table in device memory, read by broadcast.  A
// gather and one rounded multiply give the plain version's result bit for
// bit.

#include "common.cuh"

#define LS_BLOCKPERM_THREADS 256

namespace {

template <typename T>
__global__ void __launch_bounds__(LS_BLOCKPERM_THREADS)
blockperm_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                 const T* __restrict__ vals, const int* __restrict__ w0,
                 T* __restrict__ out, long long total, int br, int srb) {
  const long long e =
      (long long)blockIdx.x * LS_BLOCKPERM_THREADS + threadIdx.x;
  if (e >= total) return;
  const long long d = e >> 10;
  const long long row = (d / br) * srb + w0[d % br];
  T g = src[row * 1024 + idx[e]];
  if (vals) g = mul_rn(g, vals[e]);
  out[e] = g;
}

template <typename T>
int launch_blockperm(const void* src, const int* idx, const void* vals,
                     const int* w0, void* out, int RD, int br, int srb,
                     cudaStream_t stream) {
  const long long total = (long long)RD * 1024;
  const long long nblocks =
      (total + LS_BLOCKPERM_THREADS - 1) / LS_BLOCKPERM_THREADS;
  blockperm_kernel<T><<<(unsigned)nblocks, LS_BLOCKPERM_THREADS, 0, stream>>>(
      (const T*)src, idx, (const T*)vals, w0, (T*)out, total, br, srb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src: flat, idx/vals/out: [RD, 1024], w0: br ints on the device; vals may
// be null (a pure gather).  is_double selects double for src, vals and out.
int ls_blockperm(int is_double, const void* src, const int* idx,
                 const void* vals, const int* w0, void* out, int RD, int br,
                 int srb, void* stream_ptr) {
  if (RD < 1 || br < 1 || srb < 1 || RD % br) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (is_double)
    return launch_blockperm<double>(src, idx, vals, w0, out, RD, br, srb,
                                    stream);
  return launch_blockperm<float>(src, idx, vals, w0, out, RD, br, srb, stream);
}

}  // extern "C"
