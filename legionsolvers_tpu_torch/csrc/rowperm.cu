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
// hop, its value per element, plus the source elements the hop reaches.
// At most one multiply.
//
// Design.  Consecutive destination rows with one w0 form a run (the JAX
// kernel's `runs`); the host cuts each run into pieces of at most
// LS_BLOCKPERM_PIECE_ROWS rows and passes the pieces of one block as a
// table of (first row, rows, w0).  One CTA takes one piece of one block:
//   * the window base is computed once per CTA: no per-element division;
//   * every thread owns four consecutive columns and reads idx and vals as
//     16-byte vectors, four rows at a time (16 independent gathers in
//     flight per thread), and writes out as 16-byte vectors; idx, vals and
//     out stream past L1/L2 (evict-first), which keeps L2 for the source;
//   * where the window is shared by as many rows as it has (every run at
//     least w_rows long: the host's `stage` flag), the CTA copies the window
//     (w_rows * 1024 contiguous elements, at most 64 KB) into shared memory
//     with 16-byte cp.async while its first idx loads are in flight, and
//     gathers from shared memory; a window read by fewer rows than its own
//     is gathered straight from global memory through the read-only cache,
//     so that a sparsely read window is not copied whole.
// A gather and one rounded multiply (mul_rn) give the plain version's
// result bit for bit.

#include "common.cuh"

#define LS_BLOCKPERM_THREADS 256
#define LS_BLOCKPERM_PIECE_ROWS 8
#define LS_BLOCKPERM_GROUP 4

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four consecutive elements as 16-byte accesses, streamed (evict-first).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const int* p, int (&v)[4]) {
  const int4 a = __ldcs(reinterpret_cast<const int4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
}

template <typename T, bool STAGE>
__global__ void __launch_bounds__(LS_BLOCKPERM_THREADS)
blockperm_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                 const T* __restrict__ vals, const int* __restrict__ pieces,
                 T* __restrict__ out, int npieces, int br, int srb,
                 int w_elems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  constexpr int G = LS_BLOCKPERM_GROUP;
  const int b = blockIdx.x / npieces, i = blockIdx.x - b * npieces;
  const int dl0 = pieces[3 * i], nr = pieces[3 * i + 1];
  const int w0 = pieces[3 * i + 2];
  const T* __restrict__ wsrc = src + ((long long)b * srb + w0) * 1024;
  const long long e0 = ((long long)b * br + dl0) * 1024 + 4 * threadIdx.x;

  int ix[G][4];
  T v[G][4];
  auto load_group = [&](int r0) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r0 + r < nr) {
        load4(idx + e0 + (long long)(r0 + r) * 1024, ix[r]);
        if (vals) load4(vals + e0 + (long long)(r0 + r) * 1024, v[r]);
      }
    }
  };
  load_group(0);
  if (STAGE) {
    constexpr int per16 = 16 / (int)sizeof(T);
    for (int k = threadIdx.x * per16; k < w_elems;
         k += LS_BLOCKPERM_THREADS * per16)
      cp_async16(win + k, wsrc + k);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int r0 = 0; r0 < nr; r0 += G) {
    T g[G][4];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r0 + r < nr) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          g[r][j] = STAGE ? win[ix[r][j]] : __ldg(wsrc + ix[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r0 + r < nr) {
        if (vals) {
#pragma unroll
          for (int j = 0; j < 4; ++j) g[r][j] = mul_rn(g[r][j], v[r][j]);
        }
        store4(out + e0 + (long long)(r0 + r) * 1024, g[r]);
      }
    }
    if (r0 + G < nr) load_group(r0 + G);
  }
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15) != 0; }

template <typename T>
int launch_blockperm(const void* src, const int* idx, const void* vals,
                     const int* pieces, int npieces, int stage, void* out,
                     int RD, int br, int srb, int w_rows,
                     cudaStream_t stream) {
  const long long nblocks = (long long)(RD / br) * npieces;
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int w_elems = w_rows * 1024;
  if (stage) {
    const int smem = w_elems * (int)sizeof(T);
    if (smem > 48 * 1024) {  // raise the cap once per device
      static int raised[64];
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess && (dev < 0 || dev >= 64))
        err = cudaErrorInvalidValue;
      if (err == cudaSuccess && !raised[dev]) {
        err = cudaFuncSetAttribute(blockperm_kernel<T, true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   8 * 1024 * (int)sizeof(T));
        raised[dev] = err == cudaSuccess;
      }
      if (err != cudaSuccess) return (int)err;
    }
    blockperm_kernel<T, true>
        <<<(unsigned)nblocks, LS_BLOCKPERM_THREADS, smem, stream>>>(
            (const T*)src, idx, (const T*)vals, pieces, (T*)out, npieces,
            br, srb, w_elems);
  } else {
    blockperm_kernel<T, false>
        <<<(unsigned)nblocks, LS_BLOCKPERM_THREADS, 0, stream>>>(
            (const T*)src, idx, (const T*)vals, pieces, (T*)out, npieces,
            br, srb, w_elems);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ls_blockperm_piece_rows() { return LS_BLOCKPERM_PIECE_ROWS; }

// src: flat, idx/vals/out: [RD, 1024], all 16-byte aligned; vals may be
// null (a pure gather).  pieces: npieces (first row, rows, w0) triples on
// the device, the pieces of one destination block, each at most
// LS_BLOCKPERM_PIECE_ROWS rows and inside one run.  stage: copy each
// piece's window to shared memory first.  is_double selects double for
// src, vals and out.
int ls_blockperm(int is_double, const void* src, const int* idx,
                 const void* vals, const int* pieces, int npieces, int stage,
                 void* out, int RD, int br, int srb, int w_rows,
                 void* stream_ptr) {
  if (RD < 1 || br < 1 || srb < 1 || RD % br || npieces < 1 || w_rows < 1 ||
      w_rows > 8 || w_rows > srb)
    return (int)cudaErrorInvalidValue;
  if (misaligned(src) || misaligned(idx) || misaligned(out) ||
      (vals && misaligned(vals)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (is_double)
    return launch_blockperm<double>(src, idx, vals, pieces, npieces, stage,
                                    out, RD, br, srb, w_rows, stream);
  return launch_blockperm<float>(src, idx, vals, pieces, npieces, stage, out,
                                 RD, br, srb, w_rows, stream);
}

}  // extern "C"
