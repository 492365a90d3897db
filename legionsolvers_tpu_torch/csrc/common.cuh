// What the hand-written kernels share (stencil2d.cu, bicgstab2d.cu,
// stencil3d.cu, bicgstab3d.cu, and dia2d.cu, winell.cu, rowperm.cu of the
// explicit-sparse path): the stencil descriptions, the tile geometry, the
// halo window loads, the stencil application from shared memory, the
// fixed-order reduction of per-block partial dot products, unfused
// round-to-nearest arithmetic and, for the 3-D kernels, the march of a
// block along x (march3d).
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
#define LS_CHUNK_X 16

// The stencil {(dy_k, dx_k): v_k}, passed by value to every kernel.
struct LsStencil {
  int n;
  int dy[LS_MAX_TERMS];
  int dx[LS_MAX_TERMS];
  float v[LS_MAX_TERMS];
};

// The 3-D stencil {(ox_k, oy_k, oz_k): v_k}, |ox| <= 1, |oy|, |oz| <= 8.
struct LsStencil3 {
  int n;
  int ox[LS_MAX_TERMS];
  int oy[LS_MAX_TERMS];
  int oz[LS_MAX_TERMS];
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

// Products and sums rounded one at a time, never contracted into an FMA:
// the explicit-sparse kernels (dia2d.cu, winell.cu, rowperm.cu) then give
// the plain PyTorch versions' results bit for bit.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

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
    const int block = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
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

// Accumulator type of the dots: float, or double under `compensated`.
template <bool COMP>
struct Acc;
template <>
struct Acc<false> {
  using T = float;
};
template <>
struct Acc<true> {
  using T = double;
};

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

// ---------------------------------------------------------------------------
// 3-D: x is [X, Y, Z], Z contiguous.  A block owns one LS_TILE x LS_TILE
// (y, z) output tile and marches along x over LS_CHUNK_X planes.  Shared
// memory holds three planes (x - 1, x, x + 1) of the block's window, the
// tile plus h = max(|oy|, |oz|) on each side, in three slots that rotate one
// plane per step: the GPU form of the TPU kernel's rotating plane buffer.
// Every window point is zero outside [0, Y) x [0, Z); planes -1 and X come
// from the [Y, Z] halo planes (nullptr = zeros).
// ---------------------------------------------------------------------------

// Slot stride: the largest window, (LS_TILE + 2 * LS_MAX_REACH)^2 floats.
constexpr int kPlaneMax = kWinMax * kWinMax;

// Terms with their window offsets for each rotation phase: the plane of
// step x sits in slot (x - x0 + 1) % 3, so in phase ph = (x - x0) % 3 the
// term (ox, oy, oz) reads slot (ph + 1 + ox) % 3 at oy * W + oz from the
// thread's point.
struct SharedStencil3 {
  int n;
  int off[3][LS_MAX_TERMS];
  float v[LS_MAX_TERMS];
};

__device__ void stage_stencil3(SharedStencil3& s, const LsStencil3& st, int W) {
  if (tid() == 0) s.n = st.n;
  for (int e = tid(); e < 3 * st.n; e += LS_THREADS) {
    const int ph = e / st.n, k = e % st.n;
    const int slot = (ph + 1 + st.ox[k] + 3) % 3;
    s.off[ph][k] = slot * kPlaneMax + st.oy[k] * W + st.oz[k];
    if (ph == 0) s.v[k] = st.v[k];
  }
}

// Fill one slot with plane gx of the window: f(flat index) inside the
// volume, the halo planes at gx = -1 and gx = X, zero outside [0, Y) x
// [0, Z).  Neighbouring threads read neighbouring addresses.
template <typename F>
__device__ __forceinline__ void load_plane3(float* dst, int W, int h, int gx,
                                            int y0, int z0, int X, int Y,
                                            int Z, const float* __restrict__ top,
                                            const float* __restrict__ bot,
                                            F f) {
  const bool inner = gx >= 0 && gx < X;
  const float* halo = gx < 0 ? top : bot;
  for (int i = threadIdx.y; i < W; i += LS_THREADS_Y) {
    const int gy = y0 - h + i;
    for (int j = threadIdx.x; j < W; j += LS_THREADS_X) {
      const int gz = z0 - h + j;
      float val = 0.f;
      if (gy >= 0 && gy < Y && gz >= 0 && gz < Z) {
        const size_t yz = (size_t)gy * Z + gz;
        if (inner)
          val = f((size_t)gx * Y * Z + yz);
        else if (halo)
          val = halo[yz];
      }
      dst[i * W + j] = val;
    }
  }
}

// The block's march.  f(flat index) gives the operand A is applied to (one
// vector, or the pass's combination of several, formed as it is loaded);
// emit(flat index, operand, A operand) runs once for every point of the
// tile inside the volume, terms summed in stencil order.  The stencil must
// be staged (stage_stencil3 with W = LS_TILE + 2h) before the call.
template <typename F, typename E>
__device__ void march3d(float* win, const SharedStencil3& s, int h, int X,
                        int Y, int Z, const float* __restrict__ top,
                        const float* __restrict__ bot, F f, E emit) {
  const int W = LS_TILE + 2 * h;
  const int z0 = blockIdx.x * LS_TILE, y0 = blockIdx.y * LS_TILE;
  const int x0 = blockIdx.z * LS_CHUNK_X;
  const int x1 = x0 + LS_CHUNK_X < X ? x0 + LS_CHUNK_X : X;
  load_plane3(win, W, h, x0 - 1, y0, z0, X, Y, Z, top, bot, f);
  load_plane3(win + kPlaneMax, W, h, x0, y0, z0, X, Y, Z, top, bot, f);
  const int j = threadIdx.x, gz = z0 + j;
  for (int x = x0; x < x1; ++x) {
    const int ph = (x - x0) % 3;
    load_plane3(win + ((ph + 2) % 3) * kPlaneMax, W, h, x + 1, y0, z0, X, Y,
                Z, top, bot, f);
    __syncthreads();
    const float* center = win + ((ph + 1) % 3) * kPlaneMax;
    for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
      const int gy = y0 + i;
      if (gy >= Y || gz >= Z) continue;
      const int at = (i + h) * W + j + h;
      float ax = 0.f;
      for (int k = 0; k < s.n; ++k) ax += s.v[k] * win[s.off[ph][k] + at];
      emit(((size_t)x * Y + gy) * Z + gz, center[at], ax);
    }
    __syncthreads();
  }
}

int reach3_yz(const LsStencil3& st) {
  int h = 0;
  for (int k = 0; k < st.n; ++k) {
    const int a = st.oy[k] < 0 ? -st.oy[k] : st.oy[k];
    const int b = st.oz[k] < 0 ? -st.oz[k] : st.oz[k];
    h = a > h ? a : h;
    h = b > h ? b : h;
  }
  return h;
}

bool valid3(const LsStencil3* st, int X, int Y, int Z) {
  if (!st || st->n < 1 || st->n > LS_MAX_TERMS || X < 1 || Y < 1 || Z < 1)
    return false;
  for (int k = 0; k < st->n; ++k)
    if (st->ox[k] < -1 || st->ox[k] > 1) return false;
  return reach3_yz(*st) <= LS_MAX_REACH;
}

dim3 march_grid(int X, int Y, int Z) {
  return dim3((Z + LS_TILE - 1) / LS_TILE, (Y + LS_TILE - 1) / LS_TILE,
              (X + LS_CHUNK_X - 1) / LS_CHUNK_X);
}

}  // namespace
