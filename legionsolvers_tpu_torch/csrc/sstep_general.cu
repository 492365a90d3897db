// The s-step passes K1 (step2) and K2 (gram2) on the general route, for
// Hopper (sm_90a): 2-D stencils with |dy| <= 1 and any |dx| < C that are
// neither reach 1 (the strip march of march2d.cuh) nor the flat
// decomposition of a reach-1 1-D stencil (the march along the flat index
// of flat1d.cu).
//
//   ls_step2_band     K1  replaces _sstep_call mode step2
//                         (legionsolvers_tpu/ops/pallas/stencil2d.py:746)
//                         on the band march (route "general")
//   ls_step2_general  K1  the same, cooperative (route "general_coop":
//                         the stencils past the band march's gate)
//   ls_gram2_band     K2  replaces _sstep_call mode gram2 (same function)
//                         on its band march (route "general")
//   ls_gram2_general  K2  the same, cooperative (route "general_coop":
//                         the stencils past K2's band gate)
//
// Python wrappers, plain versions and the routes live in
// legionsolvers_tpu_torch/ops/cuda/stencil2d.py.
//
// Why the strip march cannot take these stencils: K1 chains four
// applications (A p; A u with u = c0 p + c1 r - c2 A p; A p''; A^2 p'' and
// A r'' for the Gram), so an output column depends on inputs 4 Qx columns
// away, Qx the widest |dx| (100 for a stencil with (1, 100)), and a
// warp's strip holds 4 halo columns.
//
// K1: the band march (step2_band_kernel), a march down a band of rows
// that keeps every intermediate on chip.  As |dy| <= 1, one application
// of A at a row reads three rows of its operand, so each block holds p,
// r, A p, u, r'', p'' and A p'' in shared-memory rings of rows (4, 4, 2,
// 3, 5, 4 and 3 rows), each stage some rows behind the stage it reads:
// at step s the block copies row s of p and r in with cp.async (zero
// outside the grid), and computes
//   phase A  S1 row s - 2: A p, u = c0 p + c1 r - c2 A p; x += u  (in place)
//            S3 row s - 5: A p''
//   phase B  S2 row s - 3: r'' = r - A u, p'' = r'' + c3 r - c4 A p + c5 p
//            S4 row s - 6: A^2 p'', A r'' and the Gram of (r'', p'')
// with a __syncthreads() after each phase.  A stage reads only rows that
// an earlier phase wrote, and the rings are deep enough that no slot is
// written in the phase that reads its old row; so two barriers a row and
// no grid barrier.  Device memory sees p, r and x read once and x, r'',
// p'' written once (24 B per element), plus the band's 4-row halo at each
// end, read again (mostly from L2), whose intermediates the band computes
// again (rows outside the grid are zero, as the JAX kernel's masks give).
//
// Columns: a block owns a strip of at most LS_BAND_COLS output columns
// [c0, c1) and holds the window [c0 - 4 Q, c1 + 4 Q) of it (Q the widest
// |dx|, clipped to [-Q, C + Q)); stage S_k computes only the columns the
// next stage reads, [c0 - (4 - k) Q, c1 + (4 - k) Q) inside the grid, so
// the strips' halo columns cost 12 Q extra column-applications per row
// against 5 (c1 - c0) (S2_gen at 4096 columns: 1.23x).  The other design,
// a row split over the blocks of a thread-block cluster with the terms
// past a block's slice read through distributed shared memory, needs a
// cluster barrier per row and remote loads with several times a local
// load's latency for every term near a slice edge; the halo columns cost
// less than that for every |dx| the s-step takes on pieces (120), so the
// band march holds whole strips (chosen by this count; the cluster design
// was not built).  Columns outside the grid are zero in the
// rings (zeroed once, never written).  Every term is a shared-memory load
// at a fixed offset from one of three ring rows (the loops over the terms
// unrolled, dy, dx and v read from the kernel parameter), summed in
// stencil order with one fma each, as the cooperative kernel sums them.
//
// Geometry depends on (R, C) alone: strips of at most LS_BAND_COLS
// columns, bands of rows aiming at LS_BAND_TARGET units (strips x bands;
// two per SM of an H100 SXM, a constant), no shorter than
// LS_BAND_MIN_ROWS.  Each unit's Gram is summed in double (exact f32
// products), its threads in a fixed order, into the unit's partials; the
// last block to finish (a device counter) sums the units in unit order and
// rounds once, so the bits depend on the shape alone, and a repeat gives
// the same bits.  The gate (band_stride): the 25 ring rows of the widest
// window, min(w + 8 Q, C + 2 Q) floats (w the strip width), and the
// slack fit in LS_BAND_SMEM_MAX bytes of shared memory; at 4096 columns
// that is Q <= 146.  A stencil past it (|dx| = C - 1 at C = 4096, S2_gen
// with |dx| = 200) keeps the cooperative kernel below.
//
// What bounds K1 now: instruction issue (by its SASS; no counter profiler
// runs on the card).  Each term of each application is a shared-memory
// load and an fma per column, plus the term's row pointer (65
// term-applications per element with S2_gen's 13 terms, 1.23x for the
// halo columns), with one 512-thread block per SM (S2_gen's rings take
// 187 KB).  Device memory is not what holds it: the kernel with every
// global load taken out ran as fast (PERF.md section 6).  The shared-memory loads' floor,
// one 128-byte load per SM per clock, is about 0.18 ms at 4096^2; the
// 24 B per element of device memory 0.133 ms.  What the design does about
// issue: the terms go in batches of 4 (padded with zero weights, so no
// term is tested), a thread's columns of a stage share each term's row
// pointer, and no load is predicated (slack at the end of the rings).
//
// K2: the band march too (gram2_band_kernel), with two chained
// applications, not four: rings of p (4 rows), r (5) and A p (3); at step
// s the block copies row s of p and r in, and computes
//   phase A  row s - 2: A p over [c0 - Q, c1 + Q) inside the grid
//   phase B  row s - 3: A^2 p and A r over the strip's own columns, and
//            the Gram terms of (r, p, A p, A^2 p, A r) added per thread
// with one barrier after each phase.  The window is [c0 - 2 Q, c1 + 2 Q)
// (K1's is 4 Q each side) and the rings 12 rows (K1's 25), so S2_gen's
// take 76 KB at 4096 columns and two blocks fit an SM.  Where that padded
// window does not fit, it is clipped to [0, C) and the terms that leave
// the grid are masked (MASK): at 4096 columns any |dx| < C fits one way or
// the other; past K2's gate (a ring row wider than LS_G2_MAX_STRIDE floats
// even clipped: more than 4388 columns with a |dx| that pads the window
// past it) K2 keeps the cooperative kernel.  Device memory sees r and p
// read once (8 B per element) plus each band's 4 halo rows; A p, A^2 p and
// A r are the cooperative kernel's to the bit (the same terms in the same
// order); the Gram is folded as K1's, its order a function of the shape.
// What holds it back is not bytes (0.044 ms at 4096^2) nor the shared
// loads' floor (S2_gen: 41 term-applications per element, about 0.08 ms)
// against 0.30 ms measured: as for K1, instruction issue and the two
// barriers a row (no counter profiler runs on the card).  Chosen on the card
// (PERF.md section 6): K1's 512 threads and strips (two columns a thread
// in phase B), two blocks per SM (64 registers, no spill; one block with
// 127 registers ran 10% slower, three spilled 64 B and ran 15% slower),
// four columns a thread per application in phase A (two: 23% slower).
//
// K1 past the gate, and K2 past its own: one cooperative launch whose
// stages run over the whole grid, separated by a grid-wide barrier
// (grid_sync; cudaLaunchCooperativeKernel guarantees that every block is
// resident, or refuses the launch):
//   K1  S1  A p, u = c0 p + c1 r - c2 A p -> workspace; x += u  (in place)
//       S2  r'' = r - A u, p'' = r'' + c3 r - c4 A p + c5 p -> r_out, p_out
//       S3  A p'' -> workspace (over A p)
//       S4  A^2 p'', A r'' and the Gram of (r'', p'')
//   K2  S1  A p -> workspace
//       S2  A^2 p, A r and the Gram of (r, p)
// Every stage computes only cells inside the grid and reads zero outside it
// (rows and columns), which is the JAX kernel's mask()/maskW() after every
// application; terms are summed in stencil order, one fma each.  x is read
// and written only at a cell by the thread that owns it (in S1); r and p
// are read-only; r'' and p'' go to separate buffers; so no block reads
// what another writes in the same stage.  Intermediates written in the
// launch are read with plain loads (never the read-only cache) after the
// barrier that follows their stage.
//
// Work: the grid is cut into units of whole rows (LS_GEN_UNIT_ELEMS
// elements, at least one row), which the blocks take in turn (unit =
// blockIdx.x, blockIdx.x + gridDim.x, ...), a row's columns j = threadIdx.x
// + k LS_GEN_THREADS.  Every stencil term is a load through L1, its dy, dx
// and v read from the kernel parameter at a fixed offset (the loops over
// the terms are unrolled).  Gram: each thread sums the exact products of
// its cells of a unit in double; the block sums its threads in a fixed
// order into the unit's partials; the last block to finish (a device
// counter) sums the units' partials in unit order and rounds to f32 once.
// So the bits of the Gram depend on (R, C) alone, not on the number of
// blocks the card holds.
//
// What bounds the cooperative kernels: the loads through L1, one per
// stencil term and application (65 per element for K1 with 13 terms, 39
// for K2), at about 0.1 warp loads per cycle per SM (latency), and the
// workspace: K1 moves about 68 B per element against its 24 (S1 reads p,
// r, x and writes x, u, A p; S2 reads u, A p, p, r and writes r'', p'';
// S3 reads p'' and writes A p''; S4 reads A p'', r'', p''), K2 20 against
// 8.

#include "march2d.cuh"

#define LS_GEN_THREADS 256
#define LS_GEN_UNIT_ELEMS 8192  // elements of a unit of whole rows
#define LS_GEN_MIN_BLOCKS 4     // resident blocks per SM the launch asks for
#define LS_GEN_BATCH 8          // stencil terms loaded before they are summed
#define LS_BAND_THREADS 512
#define LS_BAND_WARPS (LS_BAND_THREADS / 32)
#define LS_BAND_COLS 1024       // output columns of a strip, at most
#define LS_BAND_MIN_ROWS 16     // shortest band
#define LS_BAND_TARGET 264      // units (strips x bands) a launch aims at
#define LS_BAND_RING_ROWS 25    // p 4, r 4, A p 2, u 3, r'' 5, p'' 4, A p'' 3
#define LS_BAND_SMEM_MAX (225 * 1024)  // dynamic shared memory, at most
#define LS_BAND_BATCH 4         // stencil terms loaded before they are summed
// floats of a ring row, at most: the rings plus one row and a block's
// width of slack (band_apply reads past a stage's columns) fit
// LS_BAND_SMEM_MAX
#define LS_BAND_MAX_STRIDE \
  ((LS_BAND_SMEM_MAX / 4 - LS_BAND_THREADS) / (LS_BAND_RING_ROWS + 1))
// K2's band march: its rings' rows (p 4, r 5, A p 3), the resident blocks
// per SM it is built for, the columns of a thread that one application
// takes at a time, and its widest ring row (the rings, one row more and a
// block's width of slack fit LS_BAND_SMEM_MAX)
#define LS_G2_RING_ROWS 12
#define LS_G2_MIN_BLOCKS 2
#define LS_G2_CHUNK 4
#define LS_G2_MAX_STRIDE \
  ((LS_BAND_SMEM_MAX / 4 - LS_BAND_THREADS) / (LS_G2_RING_ROWS + 1))
static_assert(LS_BAND_COLS <= 2 * LS_BAND_THREADS,
              "K2's phase B takes at most two columns a thread");

namespace {

// The rows of a unit and the number of units on an [R, C] grid.
struct GenGeom {
  int unit_rows;
  int units;
};

GenGeom gen_geometry(int R, int C) {
  int rows = LS_GEN_UNIT_ELEMS / C;
  if (rows < 1) rows = 1;
  if (rows > R) rows = R;
  return GenGeom{rows, (R + rows - 1) / rows};
}

// The general route's gate (as the Python step2_supported): 1..LS_MAX_TERMS
// terms, |dy| <= 1, |dx| < C.
bool valid_general(const LsStencil* st, int R, int C) {
  if (!st || st->n < 1 || st->n > LS_MAX_TERMS || R < 1 || C < 1)
    return false;
  for (int k = 0; k < st->n; ++k)
    if (st->dy[k] > 1 || st->dy[k] < -1 || st->dx[k] >= C ||
        st->dx[k] <= -C)
      return false;
  return true;
}

// (A a)[i, j]: sum over the terms of v_k a[i + dy_k, j + dx_k], zero
// outside the grid, in stencil order, one fma per term.  The loops over the
// terms are unrolled, so each term's dy, dx and v are read from the kernel
// parameter at a fixed offset (the constant bank, no load through L1), and
// a batch of LS_GEN_BATCH terms' loads is issued before it is summed.  NC:
// through the read-only cache (only for the kernel's read-only inputs).
template <bool NC>
__device__ __forceinline__ float gen_apply(const float* a, int i, int j,
                                           int R, int C,
                                           const LsStencil& st) {
  float acc = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < LS_MAX_TERMS; k0 += LS_GEN_BATCH) {
    if (k0 >= st.n) break;
    float t[LS_GEN_BATCH];
#pragma unroll
    for (int u = 0; u < LS_GEN_BATCH; ++u) {
      const int k = k0 + u;
      t[u] = 0.f;
      if (k < st.n) {
        const int y = i + st.dy[k], x = j + st.dx[k];
        if (y >= 0 && y < R && x >= 0 && x < C) {
          const float* q = a + (long long)y * C + x;
          t[u] = NC ? __ldg(q) : *q;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LS_GEN_BATCH; ++u)
      if (k0 + u < st.n) acc = __fmaf_rn(st.v[k0 + u], t[u], acc);
  }
  return acc;
}

// f(i, j, flat index) for every cell of a unit: its rows in turn, a row's
// columns j = threadIdx.x + k LS_GEN_THREADS.
template <typename F>
__device__ __forceinline__ void gen_cells(int unit, int unit_rows, int R,
                                          int C, F f) {
  const int a = unit * unit_rows, b = min(a + unit_rows, R);
  for (int i = a; i < b; ++i)
    for (int j = threadIdx.x; j < C; j += LS_GEN_THREADS)
      f(i, j, (long long)i * C + j);
}

template <typename F>
__device__ __forceinline__ void gen_stage(int unit_rows, int units, int R,
                                          int C, F f) {
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x)
    gen_cells(unit, unit_rows, R, C, f);
}

// A barrier over every block of a cooperative launch: sync[0] counts the
// blocks arrived, sync[1] is the generation; the last block to arrive
// resets the count and advances the generation.  Writes before it are
// visible to every block after it.
__device__ __forceinline__ void grid_sync(unsigned* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Sum of v[k] over the block's threads into dst[k], in a fixed order: warp
// shuffles, then warps in index order.  Every thread calls it.
template <int K>
__device__ __forceinline__ void gen_block_sum(
    const double (&v)[K], double (&red)[LS_GEN_THREADS / 32][K],
    double* dst) {
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
    for (int w = 0; w < LS_GEN_THREADS / 32; ++w) s += red[w][threadIdx.x];
    dst[threadIdx.x] = s;
  }
  __syncthreads();  // red is reused
}

// The Gram stage: gram(i, j, idx, g) adds a cell's ten terms to g; each
// unit's sums go to partials[unit * 10 + k]; the last block to finish sums
// the units in order, writes g_out rounded to f32 once and resets
// sync[2].
template <typename G>
__device__ __forceinline__ void gen_gram(int unit_rows, int units, int R,
                                         int C, double* partials,
                                         unsigned* sync, float* g_out,
                                         G gram) {
  __shared__ double red[LS_GEN_THREADS / 32][10];
  __shared__ double total[10];
  __shared__ bool last;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    double g[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    gen_cells(unit, unit_rows, R, C,
              [&](int i, int j, long long idx) { gram(i, j, idx, g); });
    gen_block_sum<10>(g, red, partials + (size_t)unit * 10);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sync + 2, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double acc[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int u = threadIdx.x; u < units; u += LS_GEN_THREADS) {
#pragma unroll
    for (int k = 0; k < 10; ++k)
      acc[k] += __ldcg(partials + (size_t)u * 10 + k);
  }
  gen_block_sum<10>(acc, red, total);
  if (threadIdx.x < 10) g_out[threadIdx.x] = (float)total[threadIdx.x];
  if (threadIdx.x == 0) sync[2] = 0u;
}

// K1.  ws: two [R, C] planes, u (S1, S2) and A p (S1, S2), then A p''
// (S3, S4).
__global__ void __launch_bounds__(LS_GEN_THREADS, LS_GEN_MIN_BLOCKS)
step2_general_kernel(float* x, const float* __restrict__ r,
                     const float* __restrict__ p,
                     const float* __restrict__ coef, float* r_out,
                     float* p_out, float* ws, float* g_out,
                     double* partials, unsigned* sync, int R, int C,
                     int unit_rows, int units,
                     const __grid_constant__ LsStencil st) {
  const float k0 = coef[0], k1 = coef[1], k2 = coef[2];
  const float k3 = coef[3], k4 = coef[4], k5 = coef[5];
  float* u = ws;
  float* apn = ws + (long long)R * C;  // A p in S1 and S2
  // S1: A p, u, x += u
  gen_stage(unit_rows, units, R, C, [&](int i, int j, long long idx) {
    const float ap = gen_apply<true>(p, i, j, R, C, st);
    const float uv = k0 * __ldg(p + idx) + k1 * __ldg(r + idx) - k2 * ap;
    apn[idx] = ap;
    u[idx] = uv;
    x[idx] = x[idx] + uv;
  });
  grid_sync(sync);
  // S2: r'' = r - A u, p'' = r'' + c3 r - c4 A p + c5 p
  gen_stage(unit_rows, units, R, C, [&](int i, int j, long long idx) {
    const float au = gen_apply<false>(u, i, j, R, C, st);
    const float ap = apn[idx];
    const float rv = __ldg(r + idx);
    const float rn = rv - au;
    r_out[idx] = rn;
    p_out[idx] = rn + k3 * rv - k4 * ap + k5 * __ldg(p + idx);
  });
  grid_sync(sync);
  // S3: A p''
  gen_stage(unit_rows, units, R, C, [&](int i, int j, long long idx) {
    apn[idx] = gen_apply<false>(p_out, i, j, R, C, st);
  });
  grid_sync(sync);
  // S4: A^2 p'', A r'', the Gram of (r'', p'')
  gen_gram(unit_rows, units, R, C, partials, sync, g_out,
           [&](int i, int j, long long idx, double (&g)[10]) {
             const float a2 = gen_apply<false>(apn, i, j, R, C, st);
             const float ar = gen_apply<false>(r_out, i, j, R, C, st);
             gram_terms_f64(g, r_out[idx], p_out[idx], apn[idx], a2, ar);
           });
}

// K2.  ws: one [R, C] plane, A p.
__global__ void __launch_bounds__(LS_GEN_THREADS, LS_GEN_MIN_BLOCKS)
gram2_general_kernel(const float* __restrict__ r,
                     const float* __restrict__ p, float* ws, float* g_out,
                     double* partials, unsigned* sync, int R, int C,
                     int unit_rows, int units,
                     const __grid_constant__ LsStencil st) {
  float* ap = ws;
  // S1: A p
  gen_stage(unit_rows, units, R, C, [&](int i, int j, long long idx) {
    ap[idx] = gen_apply<true>(p, i, j, R, C, st);
  });
  grid_sync(sync);
  // S2: A^2 p, A r, the Gram of (r, p)
  gen_gram(unit_rows, units, R, C, partials, sync, g_out,
           [&](int i, int j, long long idx, double (&g)[10]) {
             const float a2 = gen_apply<false>(ap, i, j, R, C, st);
             const float ar = gen_apply<true>(r, i, j, R, C, st);
             gram_terms_f64(g, __ldg(r + idx), __ldg(p + idx), ap[idx], a2,
                            ar);
           });
}

// Blocks of a launch of `kernel`: every unit a block, at most the blocks
// the card holds at once (a cooperative launch must fit).  Per device and
// kernel, the SM count and residency are asked once.
template <int WHICH, typename K>
int gen_blocks(K kernel, int units, int* blocks) {
  static int cached[64];  // resident blocks on the card; 0: not asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        LS_GEN_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached[dev] = sms * per_sm;
  }
  *blocks = units < cached[dev] ? units : cached[dev];
  return 0;
}

// cudaFuncGetAttributes and the occupancy calculator: out = {registers,
// local (spill) bytes, resident blocks per SM}.
template <typename K>
int gen_attrs(K kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, LS_GEN_THREADS, 0);
}


// ---------------------------------------------------------------------------
// K1 on the band march
// ---------------------------------------------------------------------------

// The strips and bands of a band-march launch on an [R, C] grid.
struct BandGeom {
  int strips, strip_cols, band_rows, bands;
};

BandGeom band_geometry(int R, int C) {
  const int strips = (C + LS_BAND_COLS - 1) / LS_BAND_COLS;
  const int w = (C + strips - 1) / strips;
  int per = LS_BAND_TARGET / strips;
  if (per < 1) per = 1;
  int rows = (R + per - 1) / per;
  if (rows < LS_BAND_MIN_ROWS) rows = LS_BAND_MIN_ROWS;
  if (rows > R) rows = R;
  return BandGeom{strips, w, rows, (R + rows - 1) / rows};
}

int widest_dx(const LsStencil& st) {
  int q = 0;
  for (int k = 0; k < st.n; ++k) {
    const int a = st.dx[k] < 0 ? -st.dx[k] : st.dx[k];
    q = a > q ? a : q;
  }
  return q;
}

// Floats of a ring row: the widest window, min(w + 8 Q, C + 2 Q), rounded
// up to 4; 0 when it is past LS_BAND_MAX_STRIDE (the gate).
int band_stride(int C, int Q) {
  const BandGeom g = band_geometry(1, C);
  long long wid = (long long)g.strip_cols + 8LL * Q;
  const long long whole = (long long)C + 2LL * Q;
  if (whole < wid) wid = whole;
  wid = (wid + 3) / 4 * 4;
  return wid <= LS_BAND_MAX_STRIDE ? (int)wid : 0;
}

struct BandArgs {
  int R, C, Q, strips, strip_cols, band_rows, stride;
};

// Dynamic shared memory of a launch: the rings, then the slack that
// band_apply's loads past a stage's columns may reach (a block's width
// plus Q <= stride floats).
size_t band_smem(int stride) {
  return ((size_t)LS_BAND_RING_ROWS * stride + LS_BAND_THREADS + stride) *
         sizeof(float);
}

// A thread's columns of a stage: j0 + m LS_BAND_THREADS for m < the count
// of those below hi (at most LS_BAND_PER: a ring row holds at most
// LS_BAND_MAX_STRIDE floats).
#define LS_BAND_PER \
  ((LS_BAND_MAX_STRIDE + LS_BAND_THREADS - 1) / LS_BAND_THREADS)

__device__ __forceinline__ int band_count(int j0, int hi) {
  return j0 < hi ? (hi - j0 + LS_BAND_THREADS - 1) / LS_BAND_THREADS : 0;
}

// (A a) at the thread's first M columns j0 + m LS_BAND_THREADS of a row,
// from the ring rows holding rows i - 1, i and i + 1 of a.  The stencil
// comes padded to a multiple of LS_BAND_BATCH terms with zero weights at
// (0, 0) (band_args), so the terms go in whole batches (the loops
// unrolled: dy, dx and v are read from the kernel parameter at fixed
// offsets, and no term is tested): one row pointer per term, every load
// of the batch (one per term and column) issued before the batch's fmas,
// so a column's terms are summed in stencil order, one fma each from zero
// (a padded term adds v t = 0).  Columns outside the grid read the rings'
// zeros.  A column past the thread's last (M is the block's most) is
// loaded and summed too, from the rows after it or the slack at the end
// of the rings, and never used: no load is predicated.
template <int M>
__device__ __forceinline__ void band_apply_m(const float* up,
                                             const float* mid,
                                             const float* dn, int j0,
                                             const LsStencil& st,
                                             float (&acc)[LS_BAND_PER]) {
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < LS_MAX_TERMS; k0 += LS_BAND_BATCH) {
    if (k0 >= st.n) break;
    float t[LS_BAND_BATCH][M];
#pragma unroll
    for (int u = 0; u < LS_BAND_BATCH; ++u) {
      const int k = k0 + u;
      const float* row =
          (st.dy[k] < 0 ? up : (st.dy[k] > 0 ? dn : mid)) + j0 + st.dx[k];
#pragma unroll
      for (int m = 0; m < M; ++m) t[u][m] = row[m * LS_BAND_THREADS];
    }
#pragma unroll
    for (int u = 0; u < LS_BAND_BATCH; ++u) {
      const float v = st.v[k0 + u];
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = __fmaf_rn(v, t[u][m], acc[m]);
    }
  }
}

// band_apply_m with M the block's most columns per thread in the stage
// (mx, the same in every thread: the loops stay unrolled).
__device__ __forceinline__ void band_apply(const float* up, const float* mid,
                                           const float* dn, int j0, int mx,
                                           const LsStencil& st,
                                           float (&acc)[LS_BAND_PER]) {
  switch (mx) {
    case 1: band_apply_m<1>(up, mid, dn, j0, st, acc); break;
    case 2: band_apply_m<2>(up, mid, dn, j0, st, acc); break;
    case 3: band_apply_m<3>(up, mid, dn, j0, st, acc); break;
    case 4: band_apply_m<4>(up, mid, dn, j0, st, acc); break;
    default: band_apply_m<LS_BAND_PER>(up, mid, dn, j0, st, acc);
  }
}

// Ring row of grid row i in a ring of n rows at `base` (rows >= -60).
__device__ __forceinline__ float* band_row(float* base, int n, int i, int S) {
  return base + ((i + 60) % n) * S;
}

// The unit's Gram g (each thread's) summed over the block in a fixed order
// (warp shuffles, then warps in index order) into partials[blockIdx.x *
// 10 + k]; the last block to finish (a device counter) sums every unit's
// in unit order, writes g_out rounded to f32 once and resets the counter.
// Every thread of the block calls it.
__device__ __forceinline__ void band_fold(const double (&g)[10],
                                          double* __restrict__ partials,
                                          unsigned* __restrict__ counter,
                                          float* __restrict__ g_out) {
  __shared__ double red[LS_BAND_WARPS][10];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    double v = g[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 10) {
    double v = 0.0;
    for (int w = 0; w < LS_BAND_WARPS; ++w) v += red[w][threadIdx.x];
    partials[(size_t)blockIdx.x * 10 + threadIdx.x] = v;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double acc[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int u = threadIdx.x; u < (int)gridDim.x; u += LS_BAND_THREADS) {
#pragma unroll
    for (int k = 0; k < 10; ++k)
      acc[k] += __ldcg(partials + (size_t)u * 10 + k);
  }
  __syncthreads();  // red is reused
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    double v = acc[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 10) {
    double v = 0.0;
    for (int w = 0; w < LS_BAND_WARPS; ++w) v += red[w][threadIdx.x];
    g_out[threadIdx.x] = (float)v;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// K1, one unit (a strip of a band) per block; the dynamic shared memory
// holds the LS_BAND_RING_ROWS ring rows of `stride` floats and the slack
// (band_smem).  partials: ten doubles per unit; counter: zero before the
// launch, zero after it.
__global__ void __launch_bounds__(LS_BAND_THREADS, 1)
step2_band_kernel(float* __restrict__ x, const float* __restrict__ r,
                  const float* __restrict__ p,
                  const float* __restrict__ coef, float* __restrict__ r_out,
                  float* __restrict__ p_out, float* __restrict__ g_out,
                  double* __restrict__ partials,
                  unsigned* __restrict__ counter, BandArgs a,
                  const __grid_constant__ LsStencil st) {
  extern __shared__ __align__(16) float ring[];
  const int S = a.stride, R = a.R, C = a.C, Q = a.Q;
  const int strip = blockIdx.x % a.strips, band = blockIdx.x / a.strips;
  const int c0 = strip * a.strip_cols, c1 = min(c0 + a.strip_cols, C);
  const int r0 = band * a.band_rows, r1 = min(r0 + a.band_rows, R);
  // the window's first column, and each stage's columns in window terms:
  // [lo[k], hi[k]) for the loads (k = 0) and S_k, inside the grid; the
  // thread's first column j0[k] and its count nv[k]
  const int wl = max(c0 - 4 * Q, -Q);
  int lo[5], hi[5], j0[5], nv[5], mx[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    lo[k] = max(0, c0 - (4 - k) * Q) - wl;
    hi[k] = min(C, c1 + (4 - k) * Q) - wl;
    j0[k] = lo[k] + threadIdx.x;
    nv[k] = band_count(j0[k], hi[k]);
    mx[k] = band_count(lo[k], hi[k]);
  }
  float* P = ring;
  float* RR = P + 4 * S;
  float* AP = RR + 4 * S;
  float* U = AP + 2 * S;
  float* RN = U + 3 * S;
  float* PN = RN + 5 * S;
  float* APN = PN + 4 * S;
  for (int k = threadIdx.x; k < LS_BAND_RING_ROWS * S; k += LS_BAND_THREADS)
    ring[k] = 0.f;
  const float k0 = coef[0], k1 = coef[1], k2 = coef[2];
  const float k3 = coef[3], k4 = coef[4], k5 = coef[5];
  double g[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  __syncthreads();
  for (int s = r0 - 4; s <= r1 + 5; ++s) {
    if (s <= r1 + 3) {  // row s of p and r, zero outside the grid
      float* dp = band_row(P, 4, s, S);
      float* dr = band_row(RR, 4, s, S);
      const bool in = s >= 0 && s < R;
      const long long base = (long long)(in ? s : 0) * C + wl;
      for (int j = j0[0]; j < hi[0]; j += LS_BAND_THREADS) {
        cp_async4_zfill(dp + j, in ? p + base + j : p, in);
        cp_async4_zfill(dr + j, in ? r + base + j : r, in);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
    float acc[LS_BAND_PER], acc2[LS_BAND_PER];
    // phase A.  S1 at row s - 2: A p, u, x += u
    int i = s - 2;
    if (i >= r0 - 3 && i <= r1 + 2) {
      float* du = band_row(U, 3, i, S);
      float* dap = band_row(AP, 2, i, S);
      if (i >= 0 && i < R) {
        const bool mine = i >= r0 && i < r1;
        float* xr = x + (long long)i * C + wl;
        float xv[LS_BAND_PER];  // x at the thread's columns of the strip
#pragma unroll
        for (int m = 0; m < LS_BAND_PER; ++m) {
          const int j = j0[1] + m * LS_BAND_THREADS;
          xv[m] = mine && m < nv[1] && j >= lo[4] && j < hi[4] ? xr[j] : 0.f;
        }
        const float* p0 = band_row(P, 4, i, S);
        const float* rv = band_row(RR, 4, i, S);
        band_apply(band_row(P, 4, i - 1, S), p0, band_row(P, 4, i + 1, S),
                   j0[1], mx[1], st, acc);
#pragma unroll
        for (int m = 0; m < LS_BAND_PER; ++m) {
          const int j = j0[1] + m * LS_BAND_THREADS;
          if (m >= nv[1]) break;
          const float ap = acc[m];
          const float uv = k0 * p0[j] + k1 * rv[j] - k2 * ap;
          dap[j] = ap;
          du[j] = uv;
          if (mine && j >= lo[4] && j < hi[4]) xr[j] = xv[m] + uv;
        }
      } else {
        for (int j = j0[1]; j < hi[1]; j += LS_BAND_THREADS) du[j] = 0.f;
      }
    }
    // S3 at row s - 5: A p''
    i = s - 5;
    if (i >= r0 - 1 && i <= r1) {
      float* d = band_row(APN, 3, i, S);
      if (i >= 0 && i < R) {
        band_apply(band_row(PN, 4, i - 1, S), band_row(PN, 4, i, S),
                   band_row(PN, 4, i + 1, S), j0[3], mx[3], st, acc);
#pragma unroll
        for (int m = 0; m < LS_BAND_PER; ++m)
          if (m < nv[3]) d[j0[3] + m * LS_BAND_THREADS] = acc[m];
      } else {
        for (int j = j0[3]; j < hi[3]; j += LS_BAND_THREADS) d[j] = 0.f;
      }
    }
    __syncthreads();
    // phase B.  S2 at row s - 3: r'' = r - A u, p''
    i = s - 3;
    if (i >= r0 - 2 && i <= r1 + 1) {
      float* drn = band_row(RN, 5, i, S);
      float* dpn = band_row(PN, 4, i, S);
      if (i >= 0 && i < R) {
        const float* rv = band_row(RR, 4, i, S);
        const float* pv = band_row(P, 4, i, S);
        const float* apv = band_row(AP, 2, i, S);
        const bool mine = i >= r0 && i < r1;
        const long long o = (long long)i * C + wl;
        band_apply(band_row(U, 3, i - 1, S), band_row(U, 3, i, S),
                   band_row(U, 3, i + 1, S), j0[2], mx[2], st, acc);
#pragma unroll
        for (int m = 0; m < LS_BAND_PER; ++m) {
          const int j = j0[2] + m * LS_BAND_THREADS;
          if (m >= nv[2]) break;
          const float rvj = rv[j];
          const float rn = rvj - acc[m];
          const float pn = rn + k3 * rvj - k4 * apv[j] + k5 * pv[j];
          drn[j] = rn;
          dpn[j] = pn;
          if (mine && j >= lo[4] && j < hi[4]) {
            r_out[o + j] = rn;
            p_out[o + j] = pn;
          }
        }
      } else {
        for (int j = j0[2]; j < hi[2]; j += LS_BAND_THREADS) {
          drn[j] = 0.f;
          dpn[j] = 0.f;
        }
      }
    }
    // S4 at row s - 6: A^2 p'', A r'', the Gram of (r'', p'')
    i = s - 6;
    if (i >= r0 && i < r1) {
      const float* a0 = band_row(APN, 3, i, S);
      const float* rn = band_row(RN, 5, i, S);
      const float* pn = band_row(PN, 4, i, S);
      band_apply(band_row(APN, 3, i - 1, S), a0, band_row(APN, 3, i + 1, S),
                 j0[4], mx[4], st, acc);
      band_apply(band_row(RN, 5, i - 1, S), rn, band_row(RN, 5, i + 1, S),
                 j0[4], mx[4], st, acc2);
#pragma unroll
      for (int m = 0; m < LS_BAND_PER; ++m) {
        const int j = j0[4] + m * LS_BAND_THREADS;
        if (m >= nv[4]) break;
        gram_terms_f64(g, rn[j], pn[j], a0[j], acc[m], acc2[m]);
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  band_fold(g, partials, counter, g_out);
}

// The stencil padded to a multiple of LS_BAND_BATCH terms with zero
// weights at (0, 0).
LsStencil band_pad(const LsStencil& st) {
  LsStencil pad = st;
  for (; pad.n % LS_BAND_BATCH; ++pad.n) {
    pad.dy[pad.n] = 0;
    pad.dx[pad.n] = 0;
    pad.v[pad.n] = 0.f;
  }
  return pad;
}

// The launch's arguments on an [R, C] grid and the padded stencil (*pad),
// or false past the gate.
bool band_args(const LsStencil& st, int R, int C, BandArgs* a,
               LsStencil* pad) {
  const BandGeom g = band_geometry(R, C);
  const int Q = widest_dx(st);
  const int stride = band_stride(C, Q);
  *a = BandArgs{R, C, Q, g.strips, g.strip_cols, g.band_rows, stride};
  *pad = band_pad(st);
  return stride > 0;
}

// ---------------------------------------------------------------------------
// K2 on the band march
// ---------------------------------------------------------------------------

// Floats of a ring row of K2's band march on C columns with widest |dx| Q,
// rounded up to 4: the padded window, min(w + 4 Q, C + 2 Q) (*mask 0),
// where it fits LS_G2_MAX_STRIDE, else the window clipped to the grid,
// min(w + 4 Q, C) (*mask 1), where that fits; 0 past the gate.
int gram2_band_stride(int C, int Q, int* mask) {
  const BandGeom g = band_geometry(1, C);
  for (int m = 0; m < 2; ++m) {
    long long wid = (long long)g.strip_cols + 4LL * Q;
    const long long edge = m ? (long long)C : (long long)C + 2LL * Q;
    if (edge < wid) wid = edge;
    wid = (wid + 3) / 4 * 4;
    *mask = m;
    if (wid <= LS_G2_MAX_STRIDE) return (int)wid;
  }
  return 0;
}

// Dynamic shared memory of a K2 launch: the rings, then the slack that
// g2_apply's loads past a stage's columns may reach (band_smem's).
size_t gram2_band_smem(int stride) {
  return ((size_t)LS_G2_RING_ROWS * stride + LS_BAND_THREADS + stride) *
         sizeof(float);
}

// (A a) at the thread's M columns j0 + m LS_BAND_THREADS of a row (window
// terms; gj0 the grid column of j0), from the ring rows holding rows
// i - 1, i and i + 1 of a: band_apply_m's batches and order.  MASK (the
// window clipped to the grid): a term whose column leaves [0, C) reads
// zero, its load not issued.
template <int M, bool MASK>
__device__ __forceinline__ void g2_apply_m(const float* up, const float* mid,
                                           const float* dn, int j0, int gj0,
                                           int C, const LsStencil& st,
                                           float (&acc)[LS_G2_CHUNK]) {
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < LS_MAX_TERMS; k0 += LS_BAND_BATCH) {
    if (k0 >= st.n) break;
    float t[LS_BAND_BATCH][M];
#pragma unroll
    for (int u = 0; u < LS_BAND_BATCH; ++u) {
      const int k = k0 + u;
      const int dx = st.dx[k];
      const float* row =
          (st.dy[k] < 0 ? up : (st.dy[k] > 0 ? dn : mid)) + j0 + dx;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        t[u][m] = 0.f;
        if (!MASK ||
            (unsigned)(gj0 + m * LS_BAND_THREADS + dx) < (unsigned)C)
          t[u][m] = row[m * LS_BAND_THREADS];
      }
    }
#pragma unroll
    for (int u = 0; u < LS_BAND_BATCH; ++u) {
      const float v = st.v[k0 + u];
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = __fmaf_rn(v, t[u][m], acc[m]);
    }
  }
}

// g2_apply_m with M = mx (1 .. LS_G2_CHUNK, the same in every thread).
template <bool MASK>
__device__ __forceinline__ void g2_apply(const float* up, const float* mid,
                                         const float* dn, int j0, int gj0,
                                         int C, int mx, const LsStencil& st,
                                         float (&acc)[LS_G2_CHUNK]) {
  switch (mx) {
    case 1: g2_apply_m<1, MASK>(up, mid, dn, j0, gj0, C, st, acc); break;
    case 2: g2_apply_m<2, MASK>(up, mid, dn, j0, gj0, C, st, acc); break;
    case 3: g2_apply_m<3, MASK>(up, mid, dn, j0, gj0, C, st, acc); break;
    default: g2_apply_m<4, MASK>(up, mid, dn, j0, gj0, C, st, acc);
  }
}
static_assert(LS_G2_CHUNK == 4, "g2_apply's cases");

// K2, one unit (a strip of a band) per block, as step2_band_kernel's; the
// dynamic shared memory holds the LS_G2_RING_ROWS ring rows of `stride`
// floats and the slack (gram2_band_smem).  partials: ten doubles per unit;
// counter: zero before the launch, zero after it.
template <bool MASK>
__global__ void __launch_bounds__(LS_BAND_THREADS, LS_G2_MIN_BLOCKS)
gram2_band_kernel(const float* __restrict__ r, const float* __restrict__ p,
                  float* __restrict__ g_out, double* __restrict__ partials,
                  unsigned* __restrict__ counter, BandArgs a,
                  const __grid_constant__ LsStencil st) {
  extern __shared__ __align__(16) float ring[];
  const int S = a.stride, R = a.R, C = a.C, Q = a.Q;
  const int strip = blockIdx.x % a.strips, band = blockIdx.x / a.strips;
  const int c0 = strip * a.strip_cols, c1 = min(c0 + a.strip_cols, C);
  const int r0 = band * a.band_rows, r1 = min(r0 + a.band_rows, R);
  // the window's first column (padded: at most Q left of the grid;
  // clipped: inside it), and in window terms the loads' columns [l0, h0),
  // phase A's [lA, hA) and phase B's [lB, hB), all inside the grid; a
  // thread's first column of a phase, its count, and the block's most
  const int wl = max(c0 - 2 * Q, MASK ? 0 : -Q);
  const int l0 = max(0, c0 - 2 * Q) - wl, h0 = min(C, c1 + 2 * Q) - wl;
  const int lA = max(0, c0 - Q) - wl, hA = min(C, c1 + Q) - wl;
  const int lB = c0 - wl, hB = c1 - wl;
  const int jA = lA + threadIdx.x, nA = band_count(jA, hA);
  const int mA = band_count(lA, hA);
  const int jB = lB + threadIdx.x, nB = band_count(jB, hB);
  const int mB = band_count(lB, hB);
  float* P = ring;
  float* RR = P + 4 * S;
  float* AP = RR + 5 * S;
  for (int k = threadIdx.x; k < LS_G2_RING_ROWS * S; k += LS_BAND_THREADS)
    ring[k] = 0.f;
  double g[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  __syncthreads();
  for (int s = r0 - 2; s <= r1 + 2; ++s) {
    if (s <= r1 + 1) {  // row s of p and r, zero outside the grid
      float* dp = band_row(P, 4, s, S);
      float* dr = band_row(RR, 5, s, S);
      const bool in = s >= 0 && s < R;
      const long long base = (long long)(in ? s : 0) * C + wl;
      for (int j = l0 + threadIdx.x; j < h0; j += LS_BAND_THREADS) {
        cp_async4_zfill(dp + j, in ? p + base + j : p, in);
        cp_async4_zfill(dr + j, in ? r + base + j : r, in);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
    // phase A: A p at row s - 2, LS_G2_CHUNK columns of a thread at a time
    int i = s - 2;
    if (i >= r0 - 1 && i <= r1) {
      float* d = band_row(AP, 3, i, S);
      if (i >= 0 && i < R) {
        const float* up = band_row(P, 4, i - 1, S);
        const float* mid = band_row(P, 4, i, S);
        const float* dn = band_row(P, 4, i + 1, S);
        for (int m0 = 0; m0 < mA; m0 += LS_G2_CHUNK) {
          const int j = jA + m0 * LS_BAND_THREADS;
          float acc[LS_G2_CHUNK];
          g2_apply<MASK>(up, mid, dn, j, wl + j, C,
                         min(LS_G2_CHUNK, mA - m0), st, acc);
#pragma unroll
          for (int m = 0; m < LS_G2_CHUNK; ++m)
            if (m0 + m < nA) d[j + m * LS_BAND_THREADS] = acc[m];
        }
      } else {
        for (int j = jA; j < hA; j += LS_BAND_THREADS) d[j] = 0.f;
      }
    }
    __syncthreads();
    // phase B: A^2 p, A r and the Gram of (r, p) at row s - 3
    i = s - 3;
    if (i >= r0 && i < r1) {
      const float* a0 = band_row(AP, 3, i, S);
      const float* rv = band_row(RR, 5, i, S);
      const float* pv = band_row(P, 4, i, S);
      float a2[LS_G2_CHUNK], ar[LS_G2_CHUNK];
      g2_apply<MASK>(band_row(AP, 3, i - 1, S), a0, band_row(AP, 3, i + 1, S),
                     jB, wl + jB, C, mB, st, a2);
      g2_apply<MASK>(band_row(RR, 5, i - 1, S), rv, band_row(RR, 5, i + 1, S),
                     jB, wl + jB, C, mB, st, ar);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int j = jB + m * LS_BAND_THREADS;
        if (m < nB) gram_terms_f64(g, rv[j], pv[j], a0[j], a2[m], ar[m]);
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  band_fold(g, partials, counter, g_out);
}

// K2's launch arguments on an [R, C] grid, its layout (*mask) and the
// padded stencil (*pad), or false past K2's gate.
bool gram2_band_args(const LsStencil& st, int R, int C, BandArgs* a,
                     int* mask, LsStencil* pad) {
  const BandGeom g = band_geometry(R, C);
  const int Q = widest_dx(st);
  const int stride = gram2_band_stride(C, Q, mask);
  *a = BandArgs{R, C, Q, g.strips, g.strip_cols, g.band_rows, stride};
  *pad = band_pad(st);
  return stride > 0;
}

unsigned gram2_smem_done[2] = {0, 0};  // per layout: devices set

// K2's band march in the layout MASK: its attribute set once per device,
// then the launch, or (attrs) out = {registers, spill bytes, resident
// blocks per SM} at `smem` bytes of dynamic shared memory.
template <bool MASK>
int gram2_band_launch(const float* r, const float* p, float* g,
                      double* partials, unsigned* counter, int units,
                      size_t smem, const BandArgs& a, const LsStencil& pad,
                      cudaStream_t stream) {
  const int err = dyn_smem_ready(gram2_band_kernel<MASK>, LS_BAND_SMEM_MAX,
                                 gram2_smem_done[MASK]);
  if (err) return err;
  gram2_band_kernel<MASK><<<units, LS_BAND_THREADS, smem, stream>>>(
      r, p, g, partials, counter, a, pad);
  return (int)cudaGetLastError();
}

template <bool MASK>
int gram2_band_attrs(size_t smem, int* out) {
  int err = dyn_smem_ready(gram2_band_kernel<MASK>, LS_BAND_SMEM_MAX,
                           gram2_smem_done[MASK]);
  if (err) return err;
  cudaFuncAttributes fa;
  err = (int)cudaFuncGetAttributes(&fa, gram2_band_kernel<MASK>);
  if (err) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], gram2_band_kernel<MASK>, LS_BAND_THREADS, smem);
}

unsigned band_smem_done = 0;  // devices whose attribute is set

}  // namespace

extern "C" {

// K1 on the general route.  ws: 2 R C floats; partials: capacity >= units
// (ls_sstep_general_units) x 10 doubles; sync: three unsigned, zero before
// the first launch (the kernels leave them ready for the next).  K1 and K2
// may share ws, partials and sync on one stream (launches in order).
int ls_step2_general(float* x, const float* r, const float* p,
                     const float* coef, float* r_out, float* p_out,
                     float* g, float* ws, double* partials, int capacity,
                     unsigned* sync, int R, int C, const LsStencil* st,
                     void* stream_ptr) {
  if (!valid_general(st, R, C) || !sync || !ws)
    return (int)cudaErrorInvalidValue;
  const GenGeom geo = gen_geometry(R, C);
  if (geo.units > capacity) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = gen_blocks<0>(step2_general_kernel, geo.units, &blocks);
  if (err) return err;
  LsStencil s = *st;
  int unit_rows = geo.unit_rows, units = geo.units;
  void* args[] = {&x, &r, &p, &coef, &r_out, &p_out, &ws, &g, &partials,
                  &sync, &R, &C, &unit_rows, &units, &s};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)step2_general_kernel, dim3(blocks), dim3(LS_GEN_THREADS),
      args, 0, (cudaStream_t)stream_ptr);
}

// K1 on the band march (the gate: ls_step2_band_stride > 0).  partials:
// capacity >= units (ls_step2_band_geometry) x 10 doubles; counter: one
// unsigned, zero before the first launch (each launch leaves it zero).
int ls_step2_band(float* x, const float* r, const float* p,
                  const float* coef, float* r_out, float* p_out, float* g,
                  double* partials, int capacity, unsigned* counter, int R,
                  int C, const LsStencil* st, void* stream_ptr) {
  BandArgs a;
  LsStencil pad;
  if (!valid_general(st, R, C) || !counter ||
      !band_args(*st, R, C, &a, &pad))
    return (int)cudaErrorInvalidValue;
  const int units = a.strips * ((R + a.band_rows - 1) / a.band_rows);
  if (units > capacity) return (int)cudaErrorInvalidValue;
  int err = dyn_smem_ready(step2_band_kernel, LS_BAND_SMEM_MAX,
                           band_smem_done);
  if (err) return err;
  const size_t smem = band_smem(a.stride);
  step2_band_kernel<<<units, LS_BAND_THREADS, smem,
                      (cudaStream_t)stream_ptr>>>(
      x, r, p, coef, r_out, p_out, g, partials, counter, a, pad);
  return (int)cudaGetLastError();
}

// out = {strips, strip columns, band rows, bands} of a band-march launch on
// an [R, C] grid; ops/cuda/stencil2d.py mirrors it.
int ls_step2_band_geometry(int R, int C, int* out) {
  if (R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const BandGeom g = band_geometry(R, C);
  out[0] = g.strips;
  out[1] = g.strip_cols;
  out[2] = g.band_rows;
  out[3] = g.bands;
  return 0;
}

// Floats of a ring row for C columns and widest |dx| Q; 0 past the gate.
int ls_step2_band_stride(int C, int Q) { return band_stride(C, Q); }

// out = {registers, spill bytes, resident blocks per SM, dynamic shared
// memory bytes} of the band march with the stencil st on C columns.
int ls_step2_band_attrs(int C, const LsStencil* st, int* out) {
  if (!valid_general(st, 1, C)) return (int)cudaErrorInvalidValue;
  const int stride = band_stride(C, widest_dx(*st));
  if (!stride) return (int)cudaErrorInvalidValue;
  int err = dyn_smem_ready(step2_band_kernel, LS_BAND_SMEM_MAX,
                           band_smem_done);
  if (err) return err;
  cudaFuncAttributes fa;
  err = (int)cudaFuncGetAttributes(&fa, step2_band_kernel);
  if (err) return err;
  const size_t smem = band_smem(stride);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[3] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], step2_band_kernel, LS_BAND_THREADS, smem);
}

// K2 on its band march (the gate: ls_gram2_band_layout's stride > 0).
// partials: capacity >= units (ls_step2_band_geometry: K1's strips and
// bands) x 10 doubles; counter: one unsigned, zero before the first
// launch (each launch leaves it zero).  K1's and K2's band launches may
// share them on one stream (launches in order).
int ls_gram2_band(const float* r, const float* p, float* g, double* partials,
                  int capacity, unsigned* counter, int R, int C,
                  const LsStencil* st, void* stream_ptr) {
  BandArgs a;
  LsStencil pad;
  int mask = 0;
  if (!valid_general(st, R, C) || !counter ||
      !gram2_band_args(*st, R, C, &a, &mask, &pad))
    return (int)cudaErrorInvalidValue;
  const int units = a.strips * ((R + a.band_rows - 1) / a.band_rows);
  if (units > capacity) return (int)cudaErrorInvalidValue;
  const size_t smem = gram2_band_smem(a.stride);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return mask ? gram2_band_launch<true>(r, p, g, partials, counter, units,
                                        smem, a, pad, stream)
              : gram2_band_launch<false>(r, p, g, partials, counter, units,
                                         smem, a, pad, stream);
}

// K2's band layout for C columns and widest |dx| Q: out = {ring row
// floats (0 past the gate), clipped (1) or padded (0), dynamic shared
// memory bytes (0 past the gate)}; ops/cuda/stencil2d.py mirrors it.
int ls_gram2_band_layout(int C, int Q, int* out) {
  if (C < 1 || Q < 0) return (int)cudaErrorInvalidValue;
  out[0] = gram2_band_stride(C, Q, &out[1]);
  out[2] = out[0] ? (int)gram2_band_smem(out[0]) : 0;
  return 0;
}

// out = {registers, spill bytes, resident blocks per SM, dynamic shared
// memory bytes} of K2's band march with the stencil st on C columns (the
// variant its layout takes).
int ls_gram2_band_attrs(int C, const LsStencil* st, int* out) {
  if (!valid_general(st, 1, C)) return (int)cudaErrorInvalidValue;
  int mask = 0;
  const int stride = gram2_band_stride(C, widest_dx(*st), &mask);
  if (!stride) return (int)cudaErrorInvalidValue;
  const size_t smem = gram2_band_smem(stride);
  out[3] = (int)smem;
  return mask ? gram2_band_attrs<true>(smem, out)
              : gram2_band_attrs<false>(smem, out);
}

// K2 past its band gate (the cooperative kernel).  ws: R C floats; the
// rest as ls_step2_general.
int ls_gram2_general(const float* r, const float* p, float* g, float* ws,
                     double* partials, int capacity, unsigned* sync, int R,
                     int C, const LsStencil* st, void* stream_ptr) {
  if (!valid_general(st, R, C) || !sync || !ws)
    return (int)cudaErrorInvalidValue;
  const GenGeom geo = gen_geometry(R, C);
  if (geo.units > capacity) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  int err = gen_blocks<1>(gram2_general_kernel, geo.units, &blocks);
  if (err) return err;
  LsStencil s = *st;
  int unit_rows = geo.unit_rows, units = geo.units;
  void* args[] = {&r, &p, &ws, &g, &partials, &sync, &R, &C, &unit_rows,
                  &units, &s};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)gram2_general_kernel, dim3(blocks), dim3(LS_GEN_THREADS),
      args, 0, (cudaStream_t)stream_ptr);
}

// Units of a general-route launch on an [R, C] grid, and a unit's
// elements; ops/cuda/stencil2d.py mirrors both.
int ls_sstep_general_units(int R, int C) { return gen_geometry(R, C).units; }
int ls_sstep_general_unit_elems() { return LS_GEN_UNIT_ELEMS; }

// Registers, spill bytes and resident blocks per SM: which 0 K1, 1 K2.
int ls_sstep_general_attrs(int which, int* out) {
  if (which == 0) return gen_attrs(step2_general_kernel, out);
  if (which == 1) return gen_attrs(gram2_general_kernel, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
