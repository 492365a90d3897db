// Device-memory copy probe for Hopper (sm_90a).
//
// Hand-written CUDA port of the Pallas TPU kernel pallas_copy_bw in
// scripts/probe_roofline.py (K12).  The Python wrapper and its plain
// PyTorch version live in legionsolvers_tpu_torch/ops/cuda/copy_probe.py;
// the entry point has a plain C interface and is loaded with ctypes.
//
//   ls_copy_probe  K12  out = x + 1.0f   (float, any length)
//
// What bounds it: bytes.  8 B per element (x read once, out written once),
// one add.  At the probe's 16384 x 4096 (256 MB each way) neither array
// fits the 50 MB L2, so the time is device memory's.
//
// Design.  The TPU kernel streams 512-row tiles through VMEM with
// double-buffered DMA.  Here the body (the first `body` elements, both
// pointers 16-byte aligned, body % 4 == 0) takes a float4 kernel: each
// thread keeps eight 16-byte loads in flight, with streaming (evict-first)
// loads and stores, __ldcs / __stcs, before it stores them (a block covers
// 32 KB, consecutive threads on consecutive 16 B, no grid-stride loop).
// On an H100 this ran level with torch.add in turns; four loads in flight
// without the hints, and a persistent ring on the bulk-copy (TMA) engine,
// ran no faster (PERF.md §6).  The rest (an unaligned pointer, the last
// n % 4 elements) takes a scalar kernel, one element per thread.  The add
// is rounded as the plain version rounds it: bit for bit.

#include "common.cuh"

#define LS_COPY_THREADS 256
#define LS_COPY_VECS 8          // float4 loads in flight per thread

namespace {

__device__ __forceinline__ float4 add_one(float4 v) {
  v.x = add_rn(v.x, 1.0f);
  v.y = add_rn(v.y, 1.0f);
  v.z = add_rn(v.z, 1.0f);
  v.w = add_rn(v.w, 1.0f);
  return v;
}

__global__ void __launch_bounds__(LS_COPY_THREADS)
copy_probe_vec_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                      long long n4) {
  const long long base =
      (long long)blockIdx.x * (LS_COPY_THREADS * LS_COPY_VECS) + threadIdx.x;
  float4 v[LS_COPY_VECS];
#pragma unroll
  for (int k = 0; k < LS_COPY_VECS; ++k) {
    const long long i = base + (long long)k * LS_COPY_THREADS;
    if (i < n4) v[k] = __ldcs(x + i);
  }
#pragma unroll
  for (int k = 0; k < LS_COPY_VECS; ++k) {
    const long long i = base + (long long)k * LS_COPY_THREADS;
    if (i < n4) __stcs(out + i, add_one(v[k]));
  }
}

__global__ void __launch_bounds__(LS_COPY_THREADS)
copy_probe_scalar_kernel(const float* __restrict__ x, float* __restrict__ out,
                         long long start, long long n) {
  const long long i =
      start + (long long)blockIdx.x * LS_COPY_THREADS + threadIdx.x;
  if (i < n) out[i] = add_rn(x[i], 1.0f);
}

}  // namespace

extern "C" {

// x, out: n floats each, distinct buffers.  The body [0, body) (both
// pointers 16-byte aligned and body % 4 == 0, or body == 0) takes the
// float4 kernel, [body, n) the scalar one.
int ls_copy_probe(const float* x, float* out, long long body, long long n,
                  void* stream_ptr) {
  const bool aligned = ((unsigned long long)x % 16 == 0) &&
                       ((unsigned long long)out % 16 == 0);
  if (n < 0 || body < 0 || body > n || body % 4 || (body && !aligned))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (body) {
    const long long n4 = body / 4, per_block = LS_COPY_THREADS * LS_COPY_VECS;
    const long long blocks = (n4 + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    copy_probe_vec_kernel<<<(unsigned)blocks, LS_COPY_THREADS, 0, stream>>>(
        (const float4*)x, (float4*)out, n4);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (body < n) {
    const long long blocks = (n - body + LS_COPY_THREADS - 1) / LS_COPY_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    copy_probe_scalar_kernel<<<(unsigned)blocks, LS_COPY_THREADS, 0, stream>>>(
        x, out, body, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
