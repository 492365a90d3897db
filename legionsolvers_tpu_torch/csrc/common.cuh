// What the hand-written kernels share (stencil2d.cu, bicgstab2d.cu,
// stencil3d.cu, bicgstab3d.cu, and dia2d.cu, winell.cu, rowperm.cu of the
// explicit-sparse path): the stencil descriptions, the tile geometry, the
// halo window loads, the stencil application from shared memory, the
// fixed-order reduction of per-block partial dot products, unfused
// round-to-nearest arithmetic and, for the 3-D kernels, two marches along
// x: march3d (any reach up to 8, the stencil's terms from shared memory)
// and march1 (reach 1, a register march with the next plane in flight and
// the dot folded into the last block).
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

// ---------------------------------------------------------------------------
// 3-D, reach 1: the register march (march1).  A block of LS_M1_WARPS warps
// owns an LS_M1_TY x LS_M1_TZ (y, z) tile and a chunk of x planes.  Lane l
// of warp w owns columns 4l .. 4l + 3 (one 16-byte vector) of tile rows
// w * LS_M1_RY + r.  Each step consumes one plane x' of the operand: the
// thread reads the 3 x 3 (y, z) neighbourhood of its points once from one
// shared-memory slot (one 16-byte read per window row, the neighbouring
// columns from the neighbouring lanes) and adds the plane's three weighted
// partial sums into the outputs of planes x' + 1, x' and x' - 1, held in a
// three-deep register queue.  The output of plane x' - 1 is then complete
// and is emitted.  The terms are unrolled at compile time: the 3 x 3 x 3 box
// (weights in the kernel parameter, zero for absent terms; a point's terms
// summed plane by plane, x - 1, x, x + 1, in (oy, oz) order within a
// plane), or the 7-point Laplacian in its stencil order (center, -x, +x,
// -y, +y, -z, +z: the plain version's order, so with its exact products the
// same bits), which reads plane x' - 1's window from the slot before and
// carries only raw values.  Shared memory holds three window slots, the
// tile plus one row and column on each side: planes x' - 1 and x', and the
// one being filled with plane x' + 1, whose loads are in flight while
// plane x' is computed, as are the emit operands of the points being
// finished.  One __syncthreads() per plane.
//
// Geometry depends on (X, Y, Z) alone: the x chunks aim at a fixed number of
// blocks (LS_M1_TARGET_BLOCKS, one wave of LS_M1_MIN_BLOCKS blocks on each
// of an H100 SXM's 132 SMs; a constant, not the card's count), so the sum
// order of every dot, and with it its bits, is the same on every card.
// ---------------------------------------------------------------------------
#define LS_M1_WARPS 8
#define LS_M1_THREADS (32 * LS_M1_WARPS)
#define LS_M1_RY 2                          // tile rows per thread
#define LS_M1_TY (LS_M1_WARPS * LS_M1_RY)   // tile rows (y)
#define LS_M1_TZ 128                        // tile columns (z): 4 per lane
#define LS_M1_MIN_BLOCKS 2   // resident blocks per SM: <= 128 registers
#define LS_M1_MIN_CHUNK 8    // x chunks: at most ceil(X / 8)
#define LS_M1_TARGET_BLOCKS (132 * LS_M1_MIN_BLOCKS)

// A window row: 4 floats of padding, the left halo column at 3, the tile's
// columns at 4 .. 4 + LS_M1_TZ - 1 (16-byte aligned), the right halo column
// at 4 + LS_M1_TZ, padding.
constexpr int kM1Stride = LS_M1_TZ + 8;
constexpr int kM1Rows = LS_M1_TY + 2;
constexpr int kM1Slot = kM1Rows * kM1Stride;
constexpr int kM1Vec = kM1Rows * (LS_M1_TZ / 4);  // 16-byte vectors of a window
constexpr int kM1Halo = 2 * kM1Rows;              // its halo columns
constexpr int kM1Elems = kM1Rows * (LS_M1_TZ + 2);  // its elements
constexpr int kM1VecPer = (kM1Vec + LS_M1_THREADS - 1) / LS_M1_THREADS;
constexpr int kM1ElemPer = (kM1Elems + LS_M1_THREADS - 1) / LS_M1_THREADS;

struct M1Geom {
  int X, Y, Z;
  int tiles_z, tiles;  // (y, z) tiles: tiles_z along z, tiles in all
  int chunk;           // x planes per block
};

// The reach-1 stencil as the 3 x 3 x 3 box: w[9 (ox + 1) + 3 (oy + 1) +
// oz + 1], zero where the stencil has no term (repeated terms summed).
struct Box27 {
  float w[27];
};

// Blocks of the march on an [X, Y, Z] volume (*g filled in).
long long m1_geometry(int X, int Y, int Z, M1Geom* g) {
  const long long tz = (Z + LS_M1_TZ - 1) / LS_M1_TZ;
  const long long tiles = tz * ((Y + LS_M1_TY - 1) / LS_M1_TY);
  long long chunks = LS_M1_TARGET_BLOCKS / tiles;
  const long long max_chunks = (X + LS_M1_MIN_CHUNK - 1) / LS_M1_MIN_CHUNK;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  const int len = (int)((X + chunks - 1) / chunks);
  chunks = (X + len - 1) / len;
  *g = M1Geom{X, Y, Z, (int)tz, (int)tiles, len};
  return tiles * chunks;
}

// The box of a reach-1 stencil; true when the stencil is the 7-point
// Laplacian's shape in its order (center, -x, +x, -y, +y, -z, +z), which
// march1 compiles in.
bool m1_box(const LsStencil3& st, Box27* b) {
  static const int star[7][3] = {{0, 0, 0}, {-1, 0, 0}, {1, 0, 0},
                                 {0, -1, 0}, {0, 1, 0}, {0, 0, -1},
                                 {0, 0, 1}};
  bool is_star = st.n == 7;
  for (int k = 0; k < 27; ++k) b->w[k] = 0.f;
  for (int k = 0; k < st.n; ++k) {
    const int ox = st.ox[k], oy = st.oy[k], oz = st.oz[k];
    b->w[9 * (ox + 1) + 3 * (oy + 1) + oz + 1] += st.v[k];
    if (k < 7 && (ox != star[k][0] || oy != star[k][1] || oz != star[k][2]))
      is_star = false;
  }
  return is_star;
}

bool m1_aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0));
}

// The thread's place: the block's output planes [x0, x1), the tile's
// corner, its own rows gy[r] (which may lie past Y) and first column gz.
struct M1Place {
  int x0, x1, y0, z0, gz;
  int gy[LS_M1_RY];
};

__device__ __forceinline__ M1Place m1_place(const M1Geom& g) {
  M1Place p;
  const int tile = blockIdx.x % g.tiles, chunk = blockIdx.x / g.tiles;
  p.z0 = (tile % g.tiles_z) * LS_M1_TZ;
  p.y0 = (tile / g.tiles_z) * LS_M1_TY;
  p.x0 = chunk * g.chunk;
  p.x1 = min(p.x0 + g.chunk, g.X);
  p.gz = p.z0 + 4 * (threadIdx.x & 31);
#pragma unroll
  for (int r = 0; r < LS_M1_RY; ++r)
    p.gy[r] = p.y0 + (threadIdx.x >> 5) * LS_M1_RY + r;
  return p;
}

// Window element k of a plane (its row, its column from the left halo
// column, and the global (gy, gz) they stand for), enumerated either as
// 16-byte vectors of the tile's columns plus the two halo columns (VEC) or
// one element at a time.
__device__ __forceinline__ bool m1_vec_at(int k, const M1Place& p, int Y,
                                          int Z, int& dst, int& gy, int& gz) {
  const int row = k / (LS_M1_TZ / 4), f = k % (LS_M1_TZ / 4);
  gy = p.y0 - 1 + row;
  gz = p.z0 + 4 * f;
  dst = row * kM1Stride + 4 + 4 * f;
  return gy >= 0 && gy < Y && gz < Z;
}

__device__ __forceinline__ bool m1_halo_at(int k, const M1Place& p, int Y,
                                           int Z, int& dst, int& gy, int& gz) {
  const int row = k >> 1, side = k & 1;
  gy = p.y0 - 1 + row;
  gz = side ? p.z0 + LS_M1_TZ : p.z0 - 1;
  dst = row * kM1Stride + (side ? 4 + LS_M1_TZ : 3);
  return gy >= 0 && gy < Y && gz >= 0 && gz < Z;
}

__device__ __forceinline__ bool m1_elem_at(int k, const M1Place& p, int Y,
                                           int Z, int& dst, int& gy, int& gz) {
  const int row = k / (LS_M1_TZ + 2), col = k % (LS_M1_TZ + 2);
  gy = p.y0 - 1 + row;
  gz = p.z0 - 1 + col;
  dst = row * kM1Stride + 3 + col;
  return gy >= 0 && gy < Y && gz >= 0 && gz < Z;
}

// The source of plane gx: the volume inside [0, X), the halo planes at -1
// and X (nullptr = zeros).
__device__ __forceinline__ const float* m1_plane_src(const float* a,
                                                     const float* top,
                                                     const float* bot, int gx,
                                                     const M1Geom& g) {
  if (gx < 0) return top;
  if (gx >= g.X) return bot;
  return a + (size_t)gx * g.Y * g.Z;
}

// Plane loader of one vector: cp.async into the slot, zero-filled outside
// the volume (a zero-byte copy from the valid address `a`).
template <bool VEC>
struct M1CopyPlane {
  const float* a;
  const float* top;
  const float* bot;
  const M1Geom& g;
  const M1Place& p;

  __device__ __forceinline__ void issue(int gx, float* dst) {
    const float* src = m1_plane_src(a, top, bot, gx, g);
    int d, gy, gz;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < kM1VecPer; ++i) {
        const int k = threadIdx.x + i * LS_M1_THREADS;
        if (k >= kM1Vec) break;
        const bool in = m1_vec_at(k, p, g.Y, g.Z, d, gy, gz) && src;
        cp_async16_zfill(dst + d, in ? src + (size_t)gy * g.Z + gz : a, in);
      }
      if (threadIdx.x < kM1Halo) {
        const bool in = m1_halo_at(threadIdx.x, p, g.Y, g.Z, d, gy, gz) && src;
        cp_async4_zfill(dst + d, in ? src + (size_t)gy * g.Z + gz : a, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kM1ElemPer; ++i) {
        const int k = threadIdx.x + i * LS_M1_THREADS;
        if (k >= kM1Elems) break;
        const bool in = m1_elem_at(k, p, g.Y, g.Z, d, gy, gz) && src;
        cp_async4_zfill(dst + d, in ? src + (size_t)gy * g.Z + gz : a, in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  __device__ __forceinline__ void finish(float*) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
};

// Plane loader of a pass's operand, which Form's call forms from Form::NV
// vectors (src, in the order the call takes them): pv's p' = r + beta (p -
// omega v) from three, K6b's p = r + beta p_old and st's s = r - alpha v
// from two.  The vectors are loaded into registers, and the operand is
// formed and stored into the slot after the plane in hand is computed
// (zero outside the volume).  The halo planes are the operand's own.
template <typename Form, bool VEC>
struct M1FormPlane {
  static constexpr int NV = Form::NV;
  static constexpr int N = VEC ? 4 * kM1VecPer + 1 : kM1ElemPer;
  const float* src[NV];
  const float* top;
  const float* bot;
  Form form_;
  const M1Geom& g;
  const M1Place& pl;
  float a[NV][N];
  bool halo;

  __device__ __forceinline__ void issue(int gx, float* dst) {
    halo = gx < 0 || gx >= g.X;
    const size_t base = halo ? 0 : (size_t)gx * g.Y * g.Z;
    const float* h = gx < 0 ? top : bot;
    int d, gy, gz;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < NV; ++k) a[k][i] = 0.f;
    auto get = [&](int i, size_t o) {
      if (halo) {
        a[0][i] = h ? __ldg(h + o) : 0.f;
      } else {
#pragma unroll
        for (int k = 0; k < NV; ++k) a[k][i] = __ldg(src[k] + base + o);
      }
    };
    if (VEC) {
#pragma unroll
      for (int i = 0; i < kM1VecPer; ++i) {
        const int k = threadIdx.x + i * LS_M1_THREADS;
        if (k < kM1Vec && m1_vec_at(k, pl, g.Y, g.Z, d, gy, gz)) {
          const size_t o = (size_t)gy * g.Z + gz;
          if (halo) {
            if (h) {
              const float4 t = __ldg(reinterpret_cast<const float4*>(h + o));
              a[0][4 * i] = t.x; a[0][4 * i + 1] = t.y;
              a[0][4 * i + 2] = t.z; a[0][4 * i + 3] = t.w;
            }
          } else {
#pragma unroll
            for (int s = 0; s < NV; ++s) {
              const float4 t =
                  __ldg(reinterpret_cast<const float4*>(src[s] + base + o));
              a[s][4 * i] = t.x; a[s][4 * i + 1] = t.y;
              a[s][4 * i + 2] = t.z; a[s][4 * i + 3] = t.w;
            }
          }
        }
      }
      if (threadIdx.x < kM1Halo &&
          m1_halo_at(threadIdx.x, pl, g.Y, g.Z, d, gy, gz))
        get(N - 1, (size_t)gy * g.Z + gz);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int k = threadIdx.x + i * LS_M1_THREADS;
        if (k < kM1Elems && m1_elem_at(k, pl, g.Y, g.Z, d, gy, gz))
          get(i, (size_t)gy * g.Z + gz);
      }
    }
    (void)dst;
  }

  __device__ __forceinline__ float form(int s) const {
    float x[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) x[k] = a[k][s];
    return halo ? a[0][s] : form_(x);
  }

  __device__ __forceinline__ void finish(float* dst) {
    int d, gy, gz;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < kM1VecPer; ++i) {
        const int k = threadIdx.x + i * LS_M1_THREADS;
        if (k >= kM1Vec) break;
        const bool in = m1_vec_at(k, pl, g.Y, g.Z, d, gy, gz);
        *reinterpret_cast<float4*>(dst + d) =
            in ? make_float4(form(4 * i), form(4 * i + 1), form(4 * i + 2),
                             form(4 * i + 3))
               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (threadIdx.x < kM1Halo) {
        const bool in = m1_halo_at(threadIdx.x, pl, g.Y, g.Z, d, gy, gz);
        dst[d] = in ? form(N - 1) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int k = threadIdx.x + i * LS_M1_THREADS;
        if (k >= kM1Elems) break;
        const bool in = m1_elem_at(k, pl, g.Y, g.Z, d, gy, gz);
        dst[d] = in ? form(i) : 0.f;
      }
    }
  }
};

// One window row at the thread's four columns with their neighbours:
// e[0] from lane l - 1 (lane 0: the left halo column), e[1..4] its own
// 16-byte vector, e[5] from lane l + 1 (lane 31: the right halo column).
__device__ __forceinline__ void m1_row(const float* __restrict__ row,
                                       float (&e)[6]) {
  const int lane = threadIdx.x & 31;
  const float4 c = *reinterpret_cast<const float4*>(row + 4 + 4 * lane);
  float lft = __shfl_up_sync(0xffffffffu, c.w, 1);
  float rgt = __shfl_down_sync(0xffffffffu, c.x, 1);
  if (lane == 0) lft = row[3];
  if (lane == 31) rgt = row[4 + LS_M1_TZ];
  e[0] = lft; e[1] = c.x; e[2] = c.y; e[3] = c.z; e[4] = c.w; e[5] = rgt;
}

// The box's terms of one plane, read from its slot: an += ox = -1 terms
// (the plane feeds the point one plane on), ac += ox = 0 terms, ap += ox =
// +1 terms (the point one plane back, complete after this); cen = the
// plane's own values at the thread's points.
__device__ __forceinline__ void m1_box_plane(const float* __restrict__ slot,
                                             const Box27& w,
                                             float (&ap)[LS_M1_RY][4],
                                             float (&ac)[LS_M1_RY][4],
                                             float (&an)[LS_M1_RY][4],
                                             float (&cen)[LS_M1_RY][4]) {
  const float* base = slot + (threadIdx.x >> 5) * LS_M1_RY * kM1Stride;
#pragma unroll
  for (int q = 0; q < LS_M1_RY + 2; ++q) {
    float e[6];
    m1_row(base + q * kM1Stride, e);
#pragma unroll
    for (int r = 0; r < LS_M1_RY; ++r) {
      const int oy = q - r - 1;
      if (oy < -1 || oy > 1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (oy == 0) cen[r][j] = e[j + 1];
#pragma unroll
        for (int oz = -1; oz <= 1; ++oz) {
          const float val = e[j + 1 + oz];
          const int k = 3 * (oy + 1) + oz + 1;
          an[r][j] += w.w[k] * val;
          ac[r][j] += w.w[9 + k] * val;
          ap[r][j] += w.w[18 + k] * val;
        }
      }
    }
  }
}

// The 7-point Laplacian at the thread's points of plane x (window in
// `prv`), terms in its stencil order: center, -x (c2, plane x - 1's values,
// carried), +x (plane x + 1's, from `cur`), -y, +y, -z, +z; cen = plane
// x's own values.  ax is formed only when `out`.
__device__ __forceinline__ void m1_star_point(const float* __restrict__ prv,
                                              const float* __restrict__ cur,
                                              const Box27& w,
                                              const float (&c2)[LS_M1_RY][4],
                                              float (&ax)[LS_M1_RY][4],
                                              float (&cen)[LS_M1_RY][4],
                                              bool out) {
  const int lane = threadIdx.x & 31;
  const int base = (threadIdx.x >> 5) * LS_M1_RY * kM1Stride;
  float e[LS_M1_RY + 2][6];
#pragma unroll
  for (int q = 0; q < LS_M1_RY + 2; ++q) m1_row(prv + base + q * kM1Stride, e[q]);
#pragma unroll
  for (int r = 0; r < LS_M1_RY; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) cen[r][j] = e[r + 1][j + 1];
  if (!out) return;
#pragma unroll
  for (int r = 0; r < LS_M1_RY; ++r) {
    const float4 n = *reinterpret_cast<const float4*>(
        cur + base + (r + 1) * kM1Stride + 4 + 4 * lane);
    const float nx[4] = {n.x, n.y, n.z, n.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // the first product rounded on its own, each later term one fma, as
      // a loop over the terms from zero does: left to the compiler, the
      // first sum could fuse either product
      float a = __fmul_rn(w.w[13], e[r + 1][j + 1]);
      a = fmaf(w.w[4], c2[r][j], a);
      a = fmaf(w.w[22], nx[j], a);
      a = fmaf(w.w[10], e[r][j + 1], a);
      a = fmaf(w.w[16], e[r + 2][j + 1], a);
      a = fmaf(w.w[12], e[r + 1][j], a);
      a = fmaf(w.w[14], e[r + 1][j + 2], a);
      ax[r][j] = a;
    }
  }
}

// The block's march over planes x0 - 1 .. x1, three slots in rotation:
// plane gx sits in slot (gx - x0 + 1) % 3.  plane.issue(gx, slot) starts
// the loads of plane gx's window, plane.finish(slot) completes them;
// pre(gx) issues the loads the emit of plane gx needs; emit(gx, c, ax)
// runs once per plane of [x0, x1) with the operand c and A c at the
// thread's points (points outside the volume included: emit skips them).
template <bool STAR, typename Plane, typename Pre, typename Emit>
__device__ __forceinline__ void march1(float* win, const M1Place& pl,
                                       const Box27& w, Plane& plane, Pre pre,
                                       Emit emit) {
  float ap[LS_M1_RY][4], ac[LS_M1_RY][4], an[LS_M1_RY][4];
  float cen[LS_M1_RY][4], cprev[LS_M1_RY][4];
#pragma unroll
  for (int r = 0; r < LS_M1_RY; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) ap[r][j] = ac[r][j] = cen[r][j] = cprev[r][j] = 0.f;
  plane.issue(pl.x0 - 1, win);
  plane.finish(win);
  __syncthreads();
  for (int gx = pl.x0 - 1; gx <= pl.x1; ++gx) {
    const int s = (gx - pl.x0 + 1) % 3;
    float* cur = win + s * kM1Slot;
    float* nxt = win + (s == 2 ? 0 : s + 1) * kM1Slot;
    const float* prv = win + (s == 0 ? 2 : s - 1) * kM1Slot;
    const bool more = gx < pl.x1, out = gx > pl.x0;
    if (more) plane.issue(gx + 1, nxt);
    if (out) pre(gx - 1);
    if (STAR) {
      // cprev: plane gx - 2's values; cen: plane gx - 1's; ap: A at gx - 1
      if (gx >= pl.x0) {
        m1_star_point(prv, cur, w, cprev, ap, cen, out);
        if (out) emit(gx - 1, cen, ap);
#pragma unroll
        for (int r = 0; r < LS_M1_RY; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) cprev[r][j] = cen[r][j];
      }
    } else {
#pragma unroll
      for (int r = 0; r < LS_M1_RY; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) an[r][j] = 0.f;
      m1_box_plane(cur, w, ap, ac, an, cen);
      if (out) emit(gx - 1, cprev, ap);
#pragma unroll
      for (int r = 0; r < LS_M1_RY; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ap[r][j] = ac[r][j];
          ac[r][j] = an[r][j];
          cprev[r][j] = cen[r][j];
        }
    }
    if (more) {
      plane.finish(nxt);
      __syncthreads();
    }
  }
}

// Columns of the thread's four inside [0, Z): 0..4 (VEC: 0 or 4).
__device__ __forceinline__ int m1_ncol(const M1Place& p, int Z) {
  const int n = Z - p.gz;
  return n < 0 ? 0 : (n > 4 ? 4 : n);
}

template <bool VEC>
__device__ __forceinline__ void m1_load4(float (&d)[4],
                                         const float* __restrict__ a,
                                         size_t o, int ncol) {
  if (VEC) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ncol) t = *reinterpret_cast<const float4*>(a + o);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = j < ncol ? a[o + j] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void m1_store4(float* __restrict__ a, size_t o,
                                          const float (&d)[4], int ncol) {
  if (VEC) {
    if (ncol) *reinterpret_cast<float4*>(a + o) = make_float4(d[0], d[1], d[2], d[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < ncol) a[o + j] = d[j];
  }
}

// The K dots of the pass: each the block's sum (warp shuffles, then warps
// in index order) to partials[block * K + k]; the last block to finish (a
// device counter) sums each over all blocks in block order, writes out[k]
// rounded to float once and resets the counter to zero.  T is float, or
// double (compensated dots, K7 st).
template <typename T, int K>
__device__ __forceinline__ void m1_fold(T (&v)[K], T* __restrict__ partials,
                                        unsigned* __restrict__ counter,
                                        float* __restrict__ out) {
  __shared__ T red[K][LS_M1_WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T s = v[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T s = 0;
      for (int w = 0; w < LS_M1_WARPS; ++w) s += red[k][w];
      partials[(size_t)blockIdx.x * K + k] = s;
    }
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T acc = 0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += LS_M1_THREADS)
      acc += __ldcg(partials + (size_t)b * K + k);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) red[k][warp] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T s = 0;
      for (int w = 0; w < LS_M1_WARPS; ++w) s += red[k][w];
      out[k] = (float)s;
    }
    *counter = 0u;
  }
}

// One dot.
template <typename T>
__device__ __forceinline__ void m1_fold(T v, T* __restrict__ partials,
                                        unsigned* __restrict__ counter,
                                        float* __restrict__ out) {
  T a[1] = {v};
  m1_fold<T, 1>(a, partials, counter, out);
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB needs
// the attribute), once per device and kernel: `done` is the caller's mask
// of devices already set.
template <typename K>
int dyn_smem_ready(K kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= bit;
  return (int)err;
}

// cudaFuncGetAttributes and the occupancy calculator for one kernel
// launched with `smem` bytes of dynamic shared memory: out = {registers,
// local (spill) bytes, resident blocks per SM}.
template <typename K>
int m1_attrs(K kernel, int* out, size_t smem = 0) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, LS_M1_THREADS, smem);
}

}  // namespace
