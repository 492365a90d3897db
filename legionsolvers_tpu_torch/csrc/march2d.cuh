// The 2-D column-strip register march, shared by the reach-1 passes of
// stencil2d.cu (K1 step2, K2 gram2, K3 in its four modes, K4 xpay_pq) and
// bicgstab2d.cu (K5b st); flat1d.cu takes its row type, Gram terms, ring
// and fold for K1 and K2 on the 1-D view's flat route.
//
// A warp owns a strip of 128 columns (four per lane, read as 16-byte
// vectors where the width and the pointers allow) and marches down a chunk
// of rows [a, b).  Its 120 middle columns (lanes 1..30) are its output; the
// lanes at the strip's edges hold 4 halo columns per side, enough for the
// four chained applications of K1.  A stencil application at a row takes
// its vertical neighbours from rows held in registers and its horizontal
// ones from the neighbouring lanes (one shuffle per side per row).  The
// one-pass kernels (K3, K4) also take the grid's reach-1 halo rows from
// the caller's [LS_HALO_ROWS, C] blocks (halo_row), as the tile kernels
// do.
//
// WRAP (K3 and K4 on the 1-D kernel view: a 1-D stencil over the
// row-major flat index of the [R, C] grid, ops/cuda/stencil2d.flat_stencil;
// K1, K2 and K5b there march along the flat index, flat1d.cu): a lane's
// column c of row q is the flat element f = q C + c, whatever c, so a
// column left of the grid is the end of row q - 1 and one right of it the
// start of row q + 1 (flat_load4).  The stencil passed is the 1-D one,
// (0, s) with |s| <= 1, and a strip's 4 halo columns hold the flat
// neighbours of its edge columns, which is all that a reach-1 1-D stencil
// reads.  The one-pass kernels (K3, K4) read the halo blocks outside
// [0, R C), which extend the flat vector by 8 C elements on either side.
//
// Geometry depends on (R, C) alone: the strips are fixed (LS_STEP2_COLS
// output columns), and the row chunks aim at a fixed number of warps (one
// wave of a pass's resident blocks on each of an H100 SXM's 132 SMs; a
// constant, not the card's count), no shorter than LS_STEP2_MIN_ROWS.  So
// the sum order of every dot, and with it its bits, is the same on every
// card.  A block's dots are summed in a fixed order and folded into the
// last block to finish (a device counter): one launch, no second
// reduction.  Each pass's resident blocks per SM (its launch bounds) and
// rows in flight were chosen on the card (PERF.md section 6): K1 3 (its
// 168 registers), K2 4, K5b, K3 and K4 8 (<= 64 registers).

#pragma once

#include "common.cuh"

#define LS_STEP2_WARPS 4
#define LS_STEP2_THREADS (32 * LS_STEP2_WARPS)
#define LS_STEP2_COLS 120    // output columns of one warp's strip
#define LS_STEP2_MIN_ROWS 16  // shortest row chunk
#define LS_STEP2_MIN_BLOCKS 3  // K1's resident blocks per SM
#define LS_GRAM2_MIN_BLOCKS 4  // K2's
#define LS_ST_MIN_BLOCKS 8     // K5b's
#define LS_STENCIL_MIN_BLOCKS 8  // K3's
#define LS_XPAY_MIN_BLOCKS 8     // K4's
// Warps a pass's launch aims at: one wave of its resident blocks on each
// of an H100 SXM's 132 SMs.
#define LS_STRIP_TARGET(MIN_BLOCKS) (132 * (MIN_BLOCKS) * LS_STEP2_WARPS)
#define LS_STEP2_TARGET_WARPS LS_STRIP_TARGET(LS_STEP2_MIN_BLOCKS)
#define LS_GRAM2_TARGET_WARPS LS_STRIP_TARGET(LS_GRAM2_MIN_BLOCKS)
#define LS_ST_TARGET_WARPS LS_STRIP_TARGET(LS_ST_MIN_BLOCKS)
#define LS_STENCIL_TARGET_WARPS LS_STRIP_TARGET(LS_STENCIL_MIN_BLOCKS)
#define LS_XPAY_TARGET_WARPS LS_STRIP_TARGET(LS_XPAY_MIN_BLOCKS)

namespace {

// The stencil of a strip pass: term k reads slot[k] = 3 (dy + 1) + (dx + 1)
// of the 3x3 box with coefficient v[k].
struct Step2Stencil {
  int n;
  int slot[LS_MAX_TERMS];
  float v[LS_MAX_TERMS];
};

// Four consecutive columns of one row, held by one lane.
struct Row4 {
  float v[4];
};

constexpr unsigned kFull = 0xffffffffu;

// A row's four columns with the neighbouring lanes' edge columns beside
// them: e[0] from lane l - 1, e[5] from lane l + 1.
__device__ __forceinline__ void row_ext(const Row4& a, float (&e)[6]) {
  e[0] = __shfl_up_sync(kFull, a.v[3], 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j + 1] = a.v[j];
  e[5] = __shfl_down_sync(kFull, a.v[0], 1);
}

// A applied at the middle row (up, mid, dn = rows i - 1, i, i + 1) for the
// lane's four columns; the columns beside them come from lanes l - 1 and
// l + 1 (a lane at a strip edge reads its own: those columns are halo).
// The 5-point cross (the Laplacian, in its stencil order) has its offsets
// fixed at compile time; any other reach-1 stencil runs its terms, in
// stencil order, through a warp-uniform switch over the 3x3 box.
template <bool CROSS>
__device__ __forceinline__ Row4 apply4(const Row4& up, const Row4& mid,
                                       const Row4& dn,
                                       const Step2Stencil& st) {
  Row4 o;
  if (CROSS) {  // (0,0), (-1,0), (1,0), (0,-1), (0,1)
    const float l = __shfl_up_sync(kFull, mid.v[3], 1);
    const float r = __shfl_down_sync(kFull, mid.v[0], 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float left = j ? mid.v[j - 1] : l;
      const float right = j < 3 ? mid.v[j + 1] : r;
      float acc = 0.f;
      acc += st.v[0] * mid.v[j];
      acc += st.v[1] * up.v[j];
      acc += st.v[2] * dn.v[j];
      acc += st.v[3] * left;
      acc += st.v[4] * right;
      o.v[j] = acc;
    }
    return o;
  }
  float e[3][6];
  row_ext(up, e[0]);
  row_ext(mid, e[1]);
  row_ext(dn, e[2]);
#pragma unroll
  for (int j = 0; j < 4; ++j) o.v[j] = 0.f;
  for (int k = 0; k < st.n; ++k) {
    const float c = st.v[k];
    switch (st.slot[k]) {
#define LS_TERM(S, I, D)                                        \
  case S:                                                       \
    for (int j = 0; j < 4; ++j) o.v[j] += c * e[I][j + D];      \
    break;
      LS_TERM(0, 0, 0) LS_TERM(1, 0, 1) LS_TERM(2, 0, 2)
      LS_TERM(3, 1, 0) LS_TERM(4, 1, 1) LS_TERM(5, 1, 2)
      LS_TERM(6, 2, 0) LS_TERM(7, 2, 1) LS_TERM(8, 2, 2)
#undef LS_TERM
    }
  }
  return o;
}

__device__ __forceinline__ void mask4(Row4& a, bool row_in,
                                      const bool (&cin)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a.v[j] = row_in && cin[j] ? a.v[j] : 0.f;
}

// Zero the lane's columns of row q outside the grid: where q leaves
// [0, R) or the column [0, C) (cin).
__device__ __forceinline__ void strip_mask(Row4& a, int q, int R,
                                           const bool (&cin)[4]) {
  mask4(a, q >= 0 && q < R, cin);
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ dst, long long o,
                                       const Row4& a, const bool (&own)[4]) {
  if (VEC) {
    if (own[0])
      *reinterpret_cast<float4*>(dst + o) =
          make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (own[j]) dst[o + j] = a.v[j];
  }
}

// The 10 Gram terms (GRAM_NAMES order) of one element, each product exact
// in double and accumulated in double.
__device__ __forceinline__ void gram_terms_f64(double (&g)[10], float rb,
                                               float pb, float Apb, float A2pb,
                                               float Arb) {
  const double r = rb, p = pb, ap = Apb, a2p = A2pb, ar = Arb;
  g[0] = fma(r, r, g[0]);    g[1] = fma(p, ap, g[1]);
  g[2] = fma(r, ap, g[2]);   g[3] = fma(ap, ap, g[3]);
  g[4] = fma(r, ar, g[4]);   g[5] = fma(ap, ar, g[5]);
  g[6] = fma(ap, a2p, g[6]); g[7] = fma(ar, ar, g[7]);
  g[8] = fma(ar, a2p, g[8]); g[9] = fma(a2p, a2p, g[9]);
}

// Sum of v[k] over the block's threads into dst[k], in a fixed order: warp
// shuffles, then warps in index order.
template <int K>
__device__ __forceinline__ void step2_block_sum(
    double (&v)[K], double (&red)[LS_STEP2_WARPS][K],
    double* __restrict__ dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double s = v[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    double s = 0.0;
    for (int w = 0; w < LS_STEP2_WARPS; ++w) s += red[w][threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

// The K sums of the pass: each block's to partials[block * K + k]
// (step2_block_sum); the last block to finish (a device counter) sums
// them over all blocks (each thread a strided run of blocks, then
// step2_block_sum), writes out[k] rounded to float once and resets the
// counter to zero.  Every thread of the block calls it.
template <int K>
__device__ __forceinline__ void strip_fold(double (&v)[K],
                                           double* __restrict__ partials,
                                           unsigned* __restrict__ counter,
                                           float* __restrict__ out) {
  __shared__ double red[LS_STEP2_WARPS][K];
  __shared__ double total[K];
  __shared__ bool last;
  step2_block_sum(v, red, partials + (size_t)blockIdx.x * K);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  for (int blk = threadIdx.x; blk < (int)gridDim.x; blk += LS_STEP2_THREADS) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      acc[k] += __ldcg(partials + (size_t)blk * K + k);
  }
  __syncthreads();  // red is reused
  step2_block_sum(acc, red, total);
  if (threadIdx.x < K) out[threadIdx.x] = (float)total[threadIdx.x];
  if (threadIdx.x == 0) *counter = 0u;
}

// The strips and row chunks of a launch on an [R, C] grid whose chunks aim
// at target_warps warps.
struct StripGeom {
  int strips;      // 128-column strips (LS_STEP2_COLS output columns each)
  int chunk_rows;  // rows of a chunk (the last may be shorter)
  int units;       // strips x chunks: one warp each
  int blocks;      // blocks of LS_STEP2_WARPS warps
};

StripGeom strip_geometry(int R, int C, long long target_warps) {
  const int strips = (C + LS_STEP2_COLS - 1) / LS_STEP2_COLS;
  long long chunks = target_warps / strips;
  const long long max_chunks = (R + LS_STEP2_MIN_ROWS - 1) / LS_STEP2_MIN_ROWS;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  const int chunk_rows = (int)((R + chunks - 1) / chunks);
  chunks = (R + chunk_rows - 1) / chunk_rows;
  const long long units = strips * chunks;
  return StripGeom{strips, chunk_rows, (int)units,
                   (int)((units + LS_STEP2_WARPS - 1) / LS_STEP2_WARPS)};
}

// A warp's place: its first column c0 (lane 0's; lane l holds c0 + 4l ..
// c0 + 4l + 3), its rows [a, b), and which of the lane's columns lie
// inside the grid (cin) and are its output (own: lanes 1..30).
struct StripPlace {
  int c0, a, b;
  bool cin[4], own[4];
};

__device__ __forceinline__ StripPlace strip_place(int unit,
                                                  const StripGeom& g, int R,
                                                  int C) {
  const int lane = threadIdx.x & 31;
  const int strip = unit % g.strips, chunk = unit / g.strips;
  StripPlace p;
  p.c0 = strip * LS_STEP2_COLS - 4 + 4 * lane;
  p.a = chunk * g.chunk_rows;
  p.b = min(p.a + g.chunk_rows, R);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p.cin[j] = p.c0 + j >= 0 && p.c0 + j < C;
    p.own[j] = p.cin[j] && lane >= 1 && lane <= 30;
  }
  return p;
}

// The lane's four columns of one row (row: the row's first element, or
// null for a row of zeros) where mask[j], zero elsewhere.  VEC: one
// 16-byte load; C % 4 == 0 there, so a lane's four columns are all inside
// the grid or all outside, and mask[0] stands for the four.  NC: through
// the read-only cache (inputs the kernel never writes).
template <bool VEC, bool NC>
__device__ __forceinline__ Row4 strip_load4(const float* __restrict__ row,
                                            int c0, const bool (&mask)[4]) {
  Row4 o = {{0.f, 0.f, 0.f, 0.f}};
  if (!row) return o;
  if (VEC) {
    if (mask[0]) {
      const float4* a = reinterpret_cast<const float4*>(row + c0);
      const float4 t = NC ? __ldg(a) : *a;
      o = Row4{{t.x, t.y, t.z, t.w}};
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (mask[j]) o.v[j] = NC ? __ldg(row + c0 + j) : row[c0 + j];
  }
  return o;
}

// WRAP: the flat elements q C + c0 .. q C + c0 + 3 of v ([R, C]), extended
// by the [LS_HALO_ROWS, C] blocks top (the 8 C elements before v) and bot
// (the 8 C after it), zero where a block is null and further out.  VEC:
// one 16-byte load; C % 4 == 0 there, so the four lie in one of those
// ranges.  NC: through the read-only cache.
template <bool VEC, bool NC>
__device__ __forceinline__ Row4 flat_load4(const float* __restrict__ v,
                                           const float* __restrict__ top,
                                           const float* __restrict__ bot,
                                           int q, int R, int C, int c0) {
  const long long n = (long long)R * C, h = (long long)LS_HALO_ROWS * C;
  const long long f0 = (long long)q * C + c0;
  auto at = [&](long long f) -> const float* {
    if (f >= 0 && f < n) return v + f;
    if (f < 0 && f >= -h && top) return top + (h + f);
    if (f >= n && f < n + h && bot) return bot + (f - n);
    return nullptr;
  };
  Row4 o = {{0.f, 0.f, 0.f, 0.f}};
  if (VEC) {
    if (const float* a = at(f0)) {
      const float4* a4 = reinterpret_cast<const float4*>(a);
      const float4 t = NC ? __ldg(a4) : *a4;
      o = Row4{{t.x, t.y, t.z, t.w}};
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (const float* a = at(f0 + j)) o.v[j] = NC ? __ldg(a) : *a;
  }
  return o;
}

// Row q of NV vectors at the lane's four columns, zero outside the grid
// and past row `last` (no load issued there).
template <bool VEC, int NV>
__device__ __forceinline__ void strip_load(Row4 (&dst)[NV],
                                           const float* const (&src)[NV],
                                           int q, int last, int R, int C,
                                           const StripPlace& p) {
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[n].v[j] = 0.f;
  if (q < 0 || q >= R || q > last) return;
  const long long o = (long long)q * C + p.c0;
  if (VEC) {
    if (!p.cin[0]) return;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src[n] + o));
      dst[n] = Row4{{t.x, t.y, t.z, t.w}};
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (p.cin[j])
#pragma unroll
        for (int n = 0; n < NV; ++n) dst[n].v[j] = __ldg(src[n] + o + j);
  }
}

// The first element of row q of a one-pass kernel's operand v ([R, C]),
// or null for a row of zeros: rows -1 and R, the reach-1 halo, are the
// last row of the [LS_HALO_ROWS, C] block top and the first row of bot
// (zeros where the block is null), as load_halo reads them; rows further
// out are zero.
__device__ __forceinline__ const float* halo_row(const float* v,
                                                 const float* top,
                                                 const float* bot, int q,
                                                 int R, int C) {
  if (q >= 0 && q < R) return v + (long long)q * C;
  if (q == -1 && top) return top + (long long)(LS_HALO_ROWS - 1) * C;
  if (q == R) return bot;
  return nullptr;
}

// Row q of a one-pass kernel's operand v at the lane's four columns: rows
// -1 and R from the halo blocks (halo_row), zero outside the grid; with
// WRAP the flat elements of v and its halo blocks (flat_load4).
template <bool WRAP, bool VEC>
__device__ __forceinline__ Row4 operand_row4(const float* __restrict__ v,
                                             const float* __restrict__ top,
                                             const float* __restrict__ bot,
                                             int q, int R, int C,
                                             const StripPlace& p) {
  if (WRAP) return flat_load4<VEC, true>(v, top, bot, q, R, C, p.c0);
  return strip_load4<VEC, true>(halo_row(v, top, bot, q, R, C), p.c0, p.cin);
}

// The march over rows q0 .. q1 with DEPTH rows in flight: a register ring
// holds rows q + 1 .. q + DEPTH, loading, while row q is consumed.
// load(rows, q) fills the NV Row4 of row q; step(q, rows) runs once per
// row, in order.  The ring's slots are named at compile time (the loop
// over a turn of the ring is unrolled), so the ring stays in registers.
template <int DEPTH, int NV, typename Load, typename Step>
__device__ __forceinline__ void strip_ring(int q0, int q1, Load load,
                                           Step step) {
  Row4 ring[DEPTH][NV];
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) load(ring[k], q0 + k);
  for (int q = q0; q <= q1; q += DEPTH) {
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      if (q + u <= q1) {
        Row4 cur[NV];
#pragma unroll
        for (int n = 0; n < NV; ++n) cur[n] = ring[u][n];
        load(ring[u], q + u + DEPTH);
        step(q + u, cur);
      }
    }
  }
}

// strip_ring over rows of NV vectors, zero outside the grid (strip_load),
// written out: K2 and K5b ran 5% slower on the card with their rows
// loaded through strip_ring and strip_load4 (PERF.md section 6).
template <int DEPTH, int NV, bool VEC, typename Step>
__device__ __forceinline__ void strip_rows(const float* const (&src)[NV],
                                           int q0, int q1, int R, int C,
                                           const StripPlace& p, Step step) {
  Row4 ring[DEPTH][NV];
#pragma unroll
  for (int k = 0; k < DEPTH; ++k)
    strip_load<VEC, NV>(ring[k], src, q0 + k, q1, R, C, p);
  for (int q = q0; q <= q1; q += DEPTH) {
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      if (q + u <= q1) {
        Row4 cur[NV];
#pragma unroll
        for (int n = 0; n < NV; ++n) cur[n] = ring[u][n];
        strip_load<VEC, NV>(ring[u], src, q + u + DEPTH, q1, R, C, p);
        step(q + u, cur);
      }
    }
  }
}

// A strip launch's variant, L(CROSS, VEC, WRAP): the cross (its offsets
// fixed at compile time), another reach-1 stencil, or with WRAP the 1-D
// stencil of the flat view; 16-byte or scalar loads.
#define LS_STRIP_VARIANT(L, cross, vec, wrap)                          \
  ((wrap)    ? ((vec) ? L(false, true, true) : L(false, false, true)) \
   : (cross) ? ((vec) ? L(true, true, false) : L(true, false, false)) \
             : ((vec) ? L(false, true, false) : L(false, false, false)))

// The same for the passes without WRAP, L(CROSS, VEC).
#define LS_CROSS_VARIANT(L, cross, vec)                    \
  ((cross) ? ((vec) ? L(true, true) : L(true, false))      \
           : ((vec) ? L(false, true) : L(false, false)))

bool is_cross(const LsStencil& st) {
  const int dy[5] = {0, -1, 1, 0, 0}, dx[5] = {0, 0, 0, -1, 1};
  if (st.n != 5) return false;
  for (int k = 0; k < 5; ++k)
    if (st.dy[k] != dy[k] || st.dx[k] != dx[k]) return false;
  return true;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// A reach-1 stencil as the strip passes take it.
Step2Stencil step2_stencil(const LsStencil& st) {
  Step2Stencil s2;
  s2.n = st.n;
  for (int k = 0; k < st.n; ++k) {
    s2.slot[k] = 3 * (st.dy[k] + 1) + st.dx[k] + 1;
    s2.v[k] = st.v[k];
  }
  return s2;
}

// cudaFuncGetAttributes and the occupancy calculator for one strip kernel:
// out = {registers, local (spill) bytes, resident blocks per SM}.
template <typename K>
int strip_attrs(K kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, LS_STEP2_THREADS, 0);
}

}  // namespace
