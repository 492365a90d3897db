// What the hand-written 2-D stencil kernels share (stencil2d.cu,
// bicgstab2d.cu): the stencil description, the tile geometry, the halo
// window load, the stencil application from shared memory and the
// fixed-order reduction of per-block partial dot products.
//
// build.py compiles every csrc/*.cu into one shared library, so everything
// here has internal linkage (an anonymous namespace): each translation unit
// gets its own copy, and no symbol collides at link time.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LS_TILE 32
#define LS_MAX_TERMS 32
#define LS_HALO_ROWS 8
#define LS_THREADS_X 32
#define LS_THREADS_Y 8
#define LS_THREADS (LS_THREADS_X * LS_THREADS_Y)
#define LS_MAX_REACH 8
#define LS_REDUCE_THREADS 256

// The stencil {(dy_k, dx_k): v_k}, passed by value to every kernel.
struct LsStencil {
  int n;
  int dy[LS_MAX_TERMS];
  int dx[LS_MAX_TERMS];
  float v[LS_MAX_TERMS];
};

namespace {

// Largest window edge of a one-application pass: the tile plus the reach
// on each side.
constexpr int kWinMax = LS_TILE + 2 * LS_MAX_REACH;

struct SharedStencil {
  int n;
  int dy[LS_MAX_TERMS];
  int dx[LS_MAX_TERMS];
  float v[LS_MAX_TERMS];
};

__device__ __forceinline__ int tid() {
  return threadIdx.y * LS_THREADS_X + threadIdx.x;
}

__device__ void stage_stencil(SharedStencil& s, const LsStencil& st) {
  if (tid() == 0) s.n = st.n;
  for (int k = tid(); k < st.n; k += LS_THREADS) {
    s.dy[k] = st.dy[k];
    s.dx[k] = st.dx[k];
    s.v[k] = st.v[k];
  }
}

// Sum of v_k * a[(i + dy_k) * W + (j + dx_k)], terms in stencil order.
__device__ __forceinline__ float apply_at(const float* a, int W, int i, int j,
                                          const SharedStencil& s) {
  float acc = 0.f;
  for (int k = 0; k < s.n; ++k) acc += s.v[k] * a[(i + s.dy[k]) * W + (j + s.dx[k])];
  return acc;
}

__device__ __forceinline__ bool in_grid(int gr, int gc, int R, int C) {
  return gr >= 0 && gr < R && gc >= 0 && gc < C;
}

// Grid value at (gr, gc): rows outside [0, R) from the [8, C] halo blocks
// (top: real rows last; bottom: real rows first; nullptr = zeros), columns
// outside [0, C) zero.
__device__ __forceinline__ float load_halo(const float* __restrict__ a,
                                           const float* __restrict__ top,
                                           const float* __restrict__ bot,
                                           int R, int C, int gr, int gc) {
  if (gc < 0 || gc >= C) return 0.f;
  if (gr >= 0 && gr < R) return a[(size_t)gr * C + gc];
  if (gr < 0 && gr >= -LS_HALO_ROWS && top)
    return top[(size_t)(LS_HALO_ROWS + gr) * C + gc];
  if (gr >= R && gr < R + LS_HALO_ROWS && bot) return bot[(size_t)(gr - R) * C + gc];
  return 0.f;
}

// Block-wide sum of K per-thread values into partials[block * K + k],
// in a fixed order (warp shuffles, then warps in index order).  T is float,
// or double for the compensated dots.
template <typename T, int K>
__device__ void block_partials(T (&v)[K], T* __restrict__ partials) {
  __shared__ T red[LS_THREADS / 32][K];
  const int lane = tid() & 31, warp = tid() >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T s = v[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (tid() < K) {
    T s = 0;
    for (int w = 0; w < LS_THREADS / 32; ++w) s += red[w][tid()];
    const int block = blockIdx.y * gridDim.x + blockIdx.x;
    partials[(size_t)block * K + tid()] = s;
  }
}

// Second launch: out[k] = sum over blocks of partials[b * K + k], summed
// in T and rounded to float at the end.  One block per k; fixed strided
// order, then a fixed tree.
template <typename T>
__global__ void __launch_bounds__(LS_REDUCE_THREADS)
reduce_partials(const T* __restrict__ partials, int nblocks, int K,
                float* __restrict__ out) {
  __shared__ T s[LS_REDUCE_THREADS];
  const int k = blockIdx.x;
  T acc = 0;
  for (int b = threadIdx.x; b < nblocks; b += LS_REDUCE_THREADS)
    acc += partials[(size_t)b * K + k];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = LS_REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = (float)s[0];
}

int reach_of(const LsStencil& st) {
  int h = 0;
  for (int k = 0; k < st.n; ++k) {
    const int a = st.dy[k] < 0 ? -st.dy[k] : st.dy[k];
    const int b = st.dx[k] < 0 ? -st.dx[k] : st.dx[k];
    h = a > h ? a : h;
    h = b > h ? b : h;
  }
  return h;
}

bool valid(const LsStencil* st, int R, int C, int max_reach) {
  return st && st->n >= 1 && st->n <= LS_MAX_TERMS && R >= 1 && C >= 1 &&
         reach_of(*st) <= max_reach;
}

dim3 tile_grid(int R, int C) {
  return dim3((C + LS_TILE - 1) / LS_TILE, (R + LS_TILE - 1) / LS_TILE);
}

// Check the pass's launch, then launch the reduction of its partials.
template <typename T>
int finish(const T* partials, int nblocks, int K, float* out,
           cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<T><<<K, LS_REDUCE_THREADS, 0, stream>>>(partials, nblocks,
                                                          K, out);
  return (int)cudaGetLastError();
}

}  // namespace
