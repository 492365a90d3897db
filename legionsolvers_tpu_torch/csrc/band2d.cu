// K3 (modes y, y_dot, pq, update), K4 (xpay_pq), K5a (bicg_pv), K5b
// (bicg_st) and K5c (bicg_update) on the band route, for Hopper (sm_90a):
// every 2-D stencil of the one-pass gate (|dy| <= 8, |dx| < C) that is
// neither reach 1 (the strip march of march2d.cuh) nor the flat
// decomposition of a reach-1 1-D stencil (the strip march with WRAP; K5a
// and K5c, which have no strip kernel, take that one here too), where the
// band march's ring fits (pass_layout below; the stencils past it keep the
// 32 x 32 tile kernels of stencil2d.cu and bicgstab2d.cu).
//
//   ls_stencil2d_band  K3   replaces _stencil_call
//                           (legionsolvers_tpu/ops/pallas/stencil2d.py:121)
//   ls_xpay_pq_band    K4   replaces grid2d_cg_xpay_pq (same file, :406)
//   ls_bicg_pv_band    K5a  replaces bicg_pv
//                           (legionsolvers_tpu/ops/pallas/bicgstab2d.py:253):
//                           p' = r + beta (p - omega v), v' = A p', <r~, v'>
//   ls_bicg_st_band    K5b  replaces bicg_st (same file, :355):
//                           s = r - alpha v, t = A s, <t, s>, <t, t>
//   ls_bicg_update_band
//                      K5c  replaces bicg_update (same file, :432):
//                           s and t as K5b's, x' = (x + alpha p) + omega s
//                           in place, r' = s - omega t, <r', r'>, <r~, r'>
//
// Python wrappers, plain versions and the route live in
// legionsolvers_tpu_torch/ops/cuda/stencil2d.py and bicgstab2d.py.  The
// kernels sit in a file of their own so that nvcc compiles them beside
// stencil2d.cu.
//
// The band march for one application of A (K1's band march in
// sstep_general.cu, cut to one ring).  A block owns a strip of at most
// LS_PASS_COLS output columns [c0, c1) and a band of output rows [r0, r1),
// and marches down the rows of its operand (x for K3; p = r + beta p_old
// for K4; p' = r + beta (p - omega v) for K5a; s = r - alpha v for K5b
// and K5c; formed once per element as its row arrives), keeping the rows a
// stencil application reads in a shared-memory ring:
//   * the ring holds the stencil's row span (every dy, and 0) plus the row
//     being stored: span + 1 rows, each the window [c0 - Qm, c1 + Qp) of
//     the strip (Qm, Qp the widest shift left and right), rounded out to
//     16-byte boundaries;
//   * the window is padded with zeros beside the grid where that fits
//     (no term is masked), or clipped to [0, C) (a term whose column leaves
//     the grid is masked to zero): at |dx| = C - 1 a padded row would be
//     three rows wide;
//   * rows outside [0, R) come from the [8, C] halo blocks, exactly as
//     load_halo reads them (zeros for a null block and further out); the
//     K5 passes take no halo blocks: their operand is zero outside the
//     grid;
//   * each row is loaded LS_PASS_DEPTH rows ahead into registers (16-byte
//     loads where the width and the pointers allow), then stored into the
//     ring; update also loads its xv and rv, K5a its r~, at its own
//     columns of its own rows that far ahead; K5c loads its r~ so where
//     the window is padded, and starts moving its x and p there (and r~
//     where the window is clipped: its masked terms take the registers
//     r~ would hold, which then spilled) into L2 (prefetch_l2), to load
//     them when it writes x' and r'.
// At step s the block stores operand row s and computes output row
// i = s - hi - 1 (hi the largest dy) from ring rows i + lo .. i + hi, all
// stored in earlier steps: one __syncthreads() per row.  Every term, near
// or wide, is a shared-memory load at a fixed offset from its ring row;
// the terms are summed in stencil order with one fma each (the loops
// unrolled in batches of LS_PASS_BATCH, the stencil padded with zero
// weights at (0, 0), dy, dx and v read from the kernel parameter).  A
// thread's output columns are c0 + t + m LS_PASS_THREADS, so consecutive
// lanes read consecutive words (no bank conflict) and write consecutive
// words (a warp's store is 128 contiguous bytes); K4's p and K5a's p' are
// written as they are formed, in 16-byte stores.  K5b stores nothing, and
// K5c only x' and r': their s at the output column is read from the ring.
//
// In place: update reads xv and rv, and K5c x, only at the elements it
// writes, by the thread that writes them; strips and bands do not overlap;
// the operand's vectors and the written p / p' / v' / r' are separate
// buffers (the wrappers check it).  K5c forms x' in the plain version's
// order, (x + alpha p) + omega s, each product and sum rounded alone
// (__fmul_rn, __fadd_rn: nothing contracts to an fma).
//
// Dots: K3 and K4 sum the exact products of the f32 values in double per
// thread (K1's band march sums its Gram so).  K5a, K5b and K5c keep the
// `compensated` flag of the strip K5b (bicgstab2d.cu): with it the exact
// products, without it each product rounded to f32 (__fmul_rn), summed in
// double either way.  Then across the block's threads in a fixed order
// into the unit's partials (one double per dot: LS_PASS_DOTS at most), and
// by the last block to finish (a device counter) over the units in unit
// order, rounded to f32 once: one launch, no reduce_partials.  The
// geometry depends on (R, C) alone (strips of at most LS_PASS_COLS
// columns, bands aiming at LS_PASS_TARGET units: one per SM of an H100
// SXM, a constant), so the bits do too, and a repeat gives the same bits.
//
// What bounds them: bytes (K3 y, y_dot 8 B per element, pq 4, update 20,
// K4 12, K5a 24, K5b 8, K5c 28), plus each band's halo rows read again
// (span - 1 of every band's rows); every term costs a shared-memory load
// and an fma per column (and a compare where the window is clipped).

#include "march2d.cuh"

#define LS_PASS_THREADS 512
#define LS_PASS_WARPS (LS_PASS_THREADS / 32)
#define LS_PASS_COLS 4096     // output columns of a strip, at most
#define LS_PASS_PER (LS_PASS_COLS / LS_PASS_THREADS)  // a thread's columns
#define LS_PASS_MIN_ROWS 16   // shortest band
#define LS_PASS_TARGET 132    // units (strips x bands) a launch aims at
#define LS_PASS_DEPTH 2       // operand rows loaded ahead, in registers
#define LS_PASS_MAX_STRIDE 6144  // floats of a ring row, at most (registers)
#define LS_PASS_CHUNKS (LS_PASS_MAX_STRIDE / 4 / LS_PASS_THREADS)  // 16 B
#define LS_PASS_LOADS (4 * LS_PASS_CHUNKS)  // floats a thread loads a row
#define LS_PASS_SLACK (4 * LS_PASS_THREADS)  // floats after the ring
#define LS_PASS_SMEM_MAX (225 * 1024)  // dynamic shared memory, at most
#define LS_PASS_BATCH 4       // stencil terms loaded before they are summed
#define LS_PASS_DOTS 2        // partial dots of a unit, at most (K5b's two)
#define LS_PV_DEPTH 1         // K5a's rows loaded ahead (r, p and v)
#define LS_UPDATE_DEPTH 1     // K5c's rows loaded ahead (r and v)

namespace {

// The strips and bands of a launch on an [R, C] grid.
struct PassGeom {
  int strips, strip_cols, band_rows, bands;
};

PassGeom pass_geometry(int R, int C) {
  int strips = (C + LS_PASS_COLS - 1) / LS_PASS_COLS;
  int w = (C + strips - 1) / strips;
  w = (w + 3) / 4 * 4;  // strips start on 16-byte boundaries
  strips = (C + w - 1) / w;
  int per = LS_PASS_TARGET / strips;
  if (per < 1) per = 1;
  int rows = (R + per - 1) / per;
  if (rows < LS_PASS_MIN_ROWS) rows = LS_PASS_MIN_ROWS;
  if (rows > R) rows = R;
  return PassGeom{strips, w, rows, (R + rows - 1) / rows};
}

// The stencil's reach: rows lo .. hi (with 0), columns -qm .. qp.
struct PassReach {
  int lo, hi, qm, qp;
};

PassReach pass_reach(const LsStencil& st) {
  PassReach q{0, 0, 0, 0};
  for (int k = 0; k < st.n; ++k) {
    q.lo = st.dy[k] < q.lo ? st.dy[k] : q.lo;
    q.hi = st.dy[k] > q.hi ? st.dy[k] : q.hi;
    q.qm = -st.dx[k] > q.qm ? -st.dx[k] : q.qm;
    q.qp = st.dx[k] > q.qp ? st.dx[k] : q.qp;
  }
  return q;
}

// The ring of a launch on C columns: floats of a row (0 past the gate),
// whether its window is clipped to [0, C) (mask), its rows, and its bytes
// of dynamic shared memory.  Padded with zeros beside the grid where that
// fits, clipped where only that fits; past LS_PASS_MAX_STRIDE or
// LS_PASS_SMEM_MAX either way, the gate refuses the stencil.
struct PassLayout {
  int stride, mask, rows;
  long long smem;
};

PassLayout pass_layout(int C, const LsStencil& st) {
  const PassReach q = pass_reach(st);
  const int w = pass_geometry(1, C).strip_cols;
  const int rows = q.hi - q.lo + 2;
  for (int mask = 0; mask < 2; ++mask) {
    long long wid = (long long)w + q.qm + q.qp + 6;
    if (mask && wid > C) wid = C;
    wid = (wid + 3) / 4 * 4;
    const long long smem = ((long long)rows * wid + LS_PASS_SLACK) * 4;
    if (wid <= LS_PASS_MAX_STRIDE && smem <= LS_PASS_SMEM_MAX)
      return PassLayout{(int)wid, mask, rows, smem};
  }
  return PassLayout{0, 1, rows, 0};
}

struct PassArgs {
  int R, C, strips, strip_cols, band_rows, stride, rows, lo, hi, qm, qp;
  int vec;   // 16-byte loads and stores of the operand's rows
  int comp;  // K5: the exact products (1) or each rounded to f32 (0)
};

// c rounded down to a multiple of 4 (c may be negative).
__device__ __forceinline__ int floor4(int c) {
  return c >= 0 ? c & ~3 : -((3 - c) & ~3);
}

// The first element of row q of a one-pass operand v ([R, C]), or null for
// a row of zeros: rows -8 .. -1 from the top halo block (its rows in
// order), R .. R + 7 from the bottom one, as load_halo reads them.
__device__ __forceinline__ const float* pass_row(const float* v,
                                                 const float* top,
                                                 const float* bot, int q,
                                                 int R, int C) {
  if (q >= 0 && q < R) return v + (long long)q * C;
  if (q < 0 && q >= -LS_HALO_ROWS)
    return top ? top + (long long)(LS_HALO_ROWS + q) * C : nullptr;
  if (q >= R && q < R + LS_HALO_ROWS)
    return bot ? bot + (long long)(q - R) * C : nullptr;
  return nullptr;
}

// (A a) at the thread's first M columns of output row i, from the ring
// (`rows` rows of S floats; ss: the slot that the current step stores,
// which holds row i + L; a row d rows before it sits d slots back).  jr:
// the ring column of the thread's first column, jc its grid column.  With
// MASK a term whose column leaves [0, C) reads zero.  The stencil comes
// padded to a multiple of LS_PASS_BATCH terms with zero weights at (0, 0).
template <int M, bool MASK>
__device__ __forceinline__ void pass_apply(const float* ring, int S,
                                           int rows, int ss, int L, int jr,
                                           int jc, int C,
                                           const LsStencil& st,
                                           float (&acc)[LS_PASS_PER]) {
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < LS_MAX_TERMS; k0 += LS_PASS_BATCH) {
    if (k0 >= st.n) break;
    float t[LS_PASS_BATCH][M];
#pragma unroll
    for (int u = 0; u < LS_PASS_BATCH; ++u) {
      const int k = k0 + u;
      const int back = L - st.dy[k];
      const int slot = ss - back + (ss < back ? rows : 0);
      const float* row = ring + slot * S + jr + st.dx[k];
      const int jx = jc + st.dx[k];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (MASK)
          t[u][m] = (unsigned)(jx + m * LS_PASS_THREADS) < (unsigned)C
                        ? row[m * LS_PASS_THREADS]
                        : 0.f;
        else
          t[u][m] = row[m * LS_PASS_THREADS];
      }
    }
#pragma unroll
    for (int u = 0; u < LS_PASS_BATCH; ++u) {
      const float v = st.v[k0 + u];
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = __fmaf_rn(v, t[u][m], acc[m]);
    }
  }
}

// pass_apply with M the block's most columns per thread rounded up to 1, 2,
// 4 or 8 (the same in every thread: the loops stay unrolled; the columns
// past a thread's last are computed from the rows after them or the
// slack, and never used).
template <bool MASK>
__device__ __forceinline__ void pass_apply_mx(const float* ring, int S,
                                              int rows, int ss, int L,
                                              int jr, int jc, int C, int mx,
                                              const LsStencil& st,
                                              float (&acc)[LS_PASS_PER]) {
  if (mx <= 1)
    pass_apply<1, MASK>(ring, S, rows, ss, L, jr, jc, C, st, acc);
  else if (mx <= 2)
    pass_apply<2, MASK>(ring, S, rows, ss, L, jr, jc, C, st, acc);
  else if (mx <= 4)
    pass_apply<4, MASK>(ring, S, rows, ss, L, jr, jc, C, st, acc);
  else
    pass_apply<LS_PASS_PER, MASK>(ring, S, rows, ss, L, jr, jc, C, st, acc);
}

// The product that a K5 dot sums in double: exact (comp), or rounded to f32
// alone (the strip K5b's orders, bicgstab2d.cu).
__device__ __forceinline__ double pass_prod(float x, float y, int comp) {
  return comp ? (double)x * (double)y : (double)__fmul_rn(x, y);
}

// MODE 0..3: K3 y, y_dot, pq, update (a0 = x, the operand; xv and rv the
// vectors update writes in place; sc = alpha).  MODE 4: K4 (a0 = r, a1 =
// p_old, sc = beta; po = p_out).  MODE 5: K5a (a0 = r, a1 = p, a2 = v, sc =
// beta, sc2 = omega; po = p', y = v', rt = r~).  MODE 6: K5b (a0 = r, a1 =
// v, sc = alpha; nothing written but the dots).  MODE 7: K5c (a0 = r, a1 =
// v, a2 = p, xv = x written in place, rt = r~, y = r', sc = alpha, sc2 =
// omega).  t0/b0 and t1/b1: the halo blocks of a0 and a1 (K3, K4).
// partials: LS_PASS_DOTS doubles per unit; counter: zero before the
// launch, zero after it.  K5's parameters come after K3's and K4's: in
// that order ptxas gives K3's and K4's kernels the registers they had
// before K5 joined them (with K5's in between, K3 update's clipped variant
// spilled 4 bytes); K5c reuses them and adds none.
template <int MODE, bool MASK>
__global__ void __launch_bounds__(LS_PASS_THREADS, 1)
band_pass_kernel(const float* __restrict__ a0, const float* __restrict__ a1,
                 const float* __restrict__ t0, const float* __restrict__ b0,
                 const float* __restrict__ t1, const float* __restrict__ b1,
                 float* __restrict__ y, float* __restrict__ xv,
                 float* __restrict__ rv, const float* __restrict__ sc_p,
                 float* __restrict__ dot, double* __restrict__ partials,
                 unsigned* __restrict__ counter, PassArgs a,
                 const float* __restrict__ a2, float* __restrict__ po,
                 const float* __restrict__ rt, const float* __restrict__ sc2_p,
                 const __grid_constant__ LsStencil st) {
  // vectors forming the operand; its rows in flight
  constexpr int NA = MODE == 5 ? 3 : MODE >= 4 ? 2 : 1;
  constexpr int DEPTH = MODE == 5   ? LS_PV_DEPTH
                        : MODE == 7 ? LS_UPDATE_DEPTH
                                    : LS_PASS_DEPTH;
  constexpr int NO = MODE == 3 ? 2 : 1;  // xv, rv (update), r~ (K5a, K5c)
  constexpr bool RT_OWN = MODE == 5 || (MODE == 7 && !MASK);  // r~ in o
  constexpr int ND = MODE >= 6 ? 2 : 1;  // dots
  constexpr int T = LS_PASS_THREADS;
  extern __shared__ __align__(16) float ring[];
  __shared__ double red[ND][LS_PASS_WARPS];
  __shared__ bool last;
  const int S = a.stride, R = a.R, C = a.C, t = threadIdx.x;
  const int strip = blockIdx.x % a.strips, band = blockIdx.x / a.strips;
  const int c0 = strip * a.strip_cols, c1 = min(c0 + a.strip_cols, C);
  const int r0 = band * a.band_rows, r1 = min(r0 + a.band_rows, R);
  // the window's first column, and the columns a row load covers
  const int wl = MASK ? floor4(max(0, c0 - a.qm)) : floor4(c0 - a.qm);
  const int ls = max(0, wl);
  const int le = min(C, (c1 + a.qp + 3) / 4 * 4);
  const int nv = c1 - c0 > t ? (c1 - c0 - t + T - 1) / T : 0;
  const int mx = (c1 - c0 + T - 1) / T;
  const int L = a.hi + 1;                   // output row = stored row - L
  const int qa = r0 + a.lo, qb = r1 - 1 + a.hi;  // operand rows
  const float* const src[3] = {a0, a1, a2};
  const float* const top[3] = {t0, t1, nullptr};
  const float* const bot[3] = {b0, b1, nullptr};
  for (int k = t; k < a.rows * S + LS_PASS_SLACK; k += T) ring[k] = 0.f;
  const float sc = MODE >= 3 ? *sc_p : 0.f;
  const float sc2 = MODE == 5 || MODE == 7 ? *sc2_p : 0.f;
  double acc[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) acc[k] = 0.0;
  float buf[DEPTH][NA][LS_PASS_LOADS];
  float own[DEPTH][NO][LS_PASS_PER];

  // the operand from its vectors' values
  auto form = [&](float (&b)[NA][LS_PASS_LOADS], int e) {
    if constexpr (MODE == 4) return b[0][e] + sc * b[1][e];
    if constexpr (MODE == 5) return b[0][e] + sc * (b[1][e] - sc2 * b[2][e]);
    if constexpr (MODE >= 6) return b[0][e] - sc * b[1][e];
    return b[0][e];
  };

  // operand row q into b; update: xv and rv of output row q - L into o;
  // K5a and K5c (RT_OWN): r~ there; K5c: x and p there (and r~ but for
  // RT_OWN) on their way into L2
  auto fetch = [&](float (&b)[NA][LS_PASS_LOADS], float (&o)[NO][LS_PASS_PER],
                   int q) {
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      const float* row =
          q <= qb ? pass_row(src[n], top[n], bot[n], q, R, C) : nullptr;
      if (a.vec) {
#pragma unroll
        for (int k = 0; k < LS_PASS_CHUNKS; ++k) {
          const int col = ls + 4 * (t + k * T);
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row && col < le)
            v = __ldg(reinterpret_cast<const float4*>(row + col));
          b[n][4 * k] = v.x;
          b[n][4 * k + 1] = v.y;
          b[n][4 * k + 2] = v.z;
          b[n][4 * k + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < LS_PASS_LOADS; ++e) {
          const int col = ls + t + e * T;
          b[n][e] = row && col < le ? __ldg(row + col) : 0.f;
        }
      }
    }
    if constexpr (MODE == 3 || MODE == 5 || MODE == 7) {
      const int i = q - L;
      const bool mine = i >= r0 && i < r1;
      const long long o0 = (long long)i * C + c0 + t;
#pragma unroll
      for (int m = 0; m < LS_PASS_PER; ++m) {
        const bool in = mine && m < nv;
        if constexpr (MODE == 3) {
          o[0][m] = in ? xv[o0 + m * T] : 0.f;
          o[1][m] = in ? rv[o0 + m * T] : 0.f;
        } else {
          if constexpr (RT_OWN) o[0][m] = in ? __ldg(rt + o0 + m * T) : 0.f;
          if (MODE == 7 && in) {
            prefetch_l2(xv + o0 + m * T);
            prefetch_l2(a2 + o0 + m * T);
            if (!RT_OWN) prefetch_l2(rt + o0 + m * T);
          }
        }
      }
    }
  };

  // store operand row s from buf[u] into ring slot ss (K4 and K5a: writing
  // it at the block's own rows and columns), keep update's xv and rv, or
  // K5a's and K5c's r~, of output row s - L in cur, and load row s + DEPTH
  // into buf[u]
  auto rotate = [&](float (&b)[NA][LS_PASS_LOADS],
                    float (&o)[NO][LS_PASS_PER], int s, int ss,
                    float (&cur)[NO][LS_PASS_PER]) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int m = 0; m < LS_PASS_PER; ++m) cur[n][m] = o[n][m];
    if (s <= qb) {
      float* dst = ring + ss * S - wl;
      const bool mine = (MODE == 4 || MODE == 5) && s >= r0 && s < r1;
      float* prow = mine ? po + (long long)s * C : nullptr;
      // K5: the operand is zero outside the grid, whatever the
      // coefficients (the columns a row load covers lie in the grid)
      const bool zero = MODE >= 5 && (s < 0 || s >= R);
      if (a.vec) {
#pragma unroll
        for (int k = 0; k < LS_PASS_CHUNKS; ++k) {
          const int col = ls + 4 * (t + k * T);
          if (col < le) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (!zero)
              v = make_float4(form(b, 4 * k), form(b, 4 * k + 1),
                              form(b, 4 * k + 2), form(b, 4 * k + 3));
            *reinterpret_cast<float4*>(dst + col) = v;
            if (mine && col >= c0 && col < c1)
              *reinterpret_cast<float4*>(prow + col) = v;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < LS_PASS_LOADS; ++e) {
          const int col = ls + t + e * T;
          if (col < le) {
            const float v = zero ? 0.f : form(b, e);
            dst[col] = v;
            if (mine && col >= c0 && col < c1) prow[col] = v;
          }
        }
      }
    }
    fetch(b, o, s + DEPTH);
  };

  __syncthreads();  // the ring's zeros
#pragma unroll
  for (int u = 0; u < DEPTH; ++u) fetch(buf[u], own[u], qa + u);
  // step s: rotate the register ring (its slot named at compile time, one
  // copy per slot), compute output row s - L from ring rows stored in
  // earlier steps (one copy of the term loop), then the block's barrier
  int ss = 0;
  for (int s = qa; s <= qb + 1; ++s) {
    float cur[NO][LS_PASS_PER];
    const int uu = (s - qa) % DEPTH;
#pragma unroll
    for (int u = 0; u < DEPTH; ++u)
      if (u == uu) rotate(buf[u], own[u], s, ss, cur);
    const int i = s - L;
    if (i >= r0 && i < r1) {  // block-uniform
      float ax[LS_PASS_PER];
      const int jr = c0 + t - wl;
      pass_apply_mx<MASK>(ring, S, a.rows, ss, L, jr, c0 + t, C, mx, st, ax);
      const int si = ss - L + (ss < L ? a.rows : 0);
      const float* xr = ring + si * S + jr;
      const long long o0 = (long long)i * C + c0 + t;
      // K5c: x, p (and r~ but for RT_OWN) at the thread's columns, all
      // loads issued first
      float xo[LS_PASS_PER], pp[LS_PASS_PER], ro[LS_PASS_PER];
      if constexpr (MODE == 7) {
#pragma unroll
        for (int m = 0; m < LS_PASS_PER; ++m) {
          const bool in = m < nv;
          xo[m] = in ? xv[o0 + m * T] : 0.f;
          pp[m] = in ? __ldg(a2 + o0 + m * T) : 0.f;
          ro[m] = RT_OWN ? cur[0][m] : in ? __ldg(rt + o0 + m * T) : 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < LS_PASS_PER; ++m) {
        if (m >= nv) break;
        const long long idx = o0 + m * T;
        const float xc = xr[m * T];
        if constexpr (MODE == 0 || MODE == 1 || MODE == 5) y[idx] = ax[m];
        if constexpr (MODE == 1 || MODE == 2 || MODE == 4)
          acc[0] = fma((double)xc, (double)ax[m], acc[0]);
        if constexpr (MODE == 3) {
          const float rn = cur[1][m] - sc * ax[m];
          xv[idx] = cur[0][m] + sc * xc;
          rv[idx] = rn;
          acc[0] = fma((double)rn, (double)rn, acc[0]);
        }
        if constexpr (MODE == 5) acc[0] += pass_prod(cur[0][m], ax[m], a.comp);
        if constexpr (MODE == 6) {
          acc[0] += pass_prod(ax[m], xc, a.comp);
          acc[1] += pass_prod(ax[m], ax[m], a.comp);
        }
        if constexpr (MODE == 7) {
          xv[idx] = __fadd_rn(__fadd_rn(xo[m], __fmul_rn(sc, pp[m])),
                              __fmul_rn(sc2, xc));
          const float rn = xc - sc2 * ax[m];
          y[idx] = rn;
          acc[0] += pass_prod(rn, rn, a.comp);
          acc[1] += pass_prod(ro[m], rn, a.comp);
        }
      }
    }
    __syncthreads();
    ss = ss + 1 == a.rows ? 0 : ss + 1;
  }
  if (MODE == 0) return;

  // the unit's dots, then the fold of every unit's in unit order
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    double v = acc[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 0; k < ND; ++k) {
      double s = 0.0;
      for (int w = 0; w < LS_PASS_WARPS; ++w) s += red[k][w];
      partials[ND * blockIdx.x + k] = s;
    }
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    double f = 0.0;
    for (int u = t; u < (int)gridDim.x; u += T)
      f += __ldcg(partials + ND * u + k);
    for (int o = 16; o > 0; o >>= 1) f += __shfl_down_sync(kFull, f, o);
    if (lane == 0) red[k][warp] = f;
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 0; k < ND; ++k) {
      double s = 0.0;
      for (int w = 0; w < LS_PASS_WARPS; ++w) s += red[k][w];
      dot[k] = (float)s;
    }
    *counter = 0u;
  }
}

// The launch's arguments on an [R, C] grid and the stencil padded to a
// multiple of LS_PASS_BATCH terms with zero weights at (0, 0) (*pad); the
// layout's stride is 0 past the gate.
PassLayout pass_args(const LsStencil& st, int R, int C, PassArgs* a,
                     LsStencil* pad) {
  const PassGeom g = pass_geometry(R, C);
  const PassReach q = pass_reach(st);
  const PassLayout lay = pass_layout(C, st);
  *a = PassArgs{R, C, g.strips, g.strip_cols, g.band_rows, lay.stride,
                lay.rows, q.lo, q.hi, q.qm, q.qp, 0, 0};
  *pad = st;
  for (; pad->n % LS_PASS_BATCH; ++pad->n) {
    pad->dy[pad->n] = 0;
    pad->dx[pad->n] = 0;
    pad->v[pad->n] = 0.f;
  }
  return lay;
}

// The vectors a band pass reads and writes (null where it has none).
struct PassIO {
  const float *a0, *a1, *a2, *t0, *b0, *t1, *b1;
  float *y, *po, *xv, *rv;
  const float *rt, *sc, *sc2;
  float* dot;
  double* partials;
  unsigned* counter;
};

template <int MODE, bool MASK>
int launch_pass(const PassIO& io, const PassArgs& a, const LsStencil& st,
                int units, size_t smem, cudaStream_t stream) {
  static unsigned done = 0;  // devices whose attribute is set
  auto* kernel = band_pass_kernel<MODE, MASK>;
  const int err = dyn_smem_ready(kernel, LS_PASS_SMEM_MAX, done);
  if (err) return err;
  kernel<<<units, LS_PASS_THREADS, smem, stream>>>(
      io.a0, io.a1, io.t0, io.b0, io.t1, io.b1, io.y, io.xv, io.rv, io.sc,
      io.dot, io.partials, io.counter, a, io.a2, io.po, io.rt, io.sc2, st);
  return (int)cudaGetLastError();
}

// A pass on the band route (MODE 0..3 K3, 4 K4, 5 K5a, 6 K5b, 7 K5c): the
// gate, the variant (the window padded or clipped; 16-byte loads, a kernel
// argument, where C % 4 == 0 and the operand's pointers allow), the
// launch.
template <int MODE>
int band_pass(const PassIO& io, int capacity, int R, int C, int comp,
              const LsStencil* st, cudaStream_t stream) {
  if (!valid2d(st, R, C) || (MODE != 0 && !io.counter))
    return (int)cudaErrorInvalidValue;
  PassArgs a;
  LsStencil pad;
  const PassLayout lay = pass_args(*st, R, C, &a, &pad);
  if (!lay.stride) return (int)cudaErrorInvalidValue;
  const int units = a.strips * ((R + a.band_rows - 1) / a.band_rows);
  if (MODE != 0 && units > capacity) return (int)cudaErrorInvalidValue;
  a.vec = C % 4 == 0 && aligned16(io.a0) && aligned16(io.a1) &&
          aligned16(io.a2) && aligned16(io.t0) && aligned16(io.b0) &&
          aligned16(io.t1) && aligned16(io.b1) && aligned16(io.po);
  a.comp = comp;
  const size_t smem = (size_t)lay.smem;
  return lay.mask ? launch_pass<MODE, true>(io, a, pad, units, smem, stream)
                  : launch_pass<MODE, false>(io, a, pad, units, smem, stream);
}

// cudaFuncGetAttributes and the occupancy calculator: out = {registers,
// spill bytes, resident blocks per SM} of the kernel launched with `smem`
// bytes.
template <int MODE, bool MASK>
int pass_attrs(size_t smem, int* out) {
  static unsigned done = 0;
  auto* kernel = band_pass_kernel<MODE, MASK>;
  int err = dyn_smem_ready(kernel, LS_PASS_SMEM_MAX, done);
  if (err) return err;
  cudaFuncAttributes fa;
  err = (int)cudaFuncGetAttributes(&fa, kernel);
  if (err) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, LS_PASS_THREADS, smem);
}

}  // namespace

extern "C" {

// K3 on the band route.  mode: 0 y, 1 y_dot, 2 pq, 3 update; pointers as
// ls_stencil2d's (halo pointers may be null: zeros).  partials: capacity
// >= units (ls_pass_band_geometry) x LS_PASS_DOTS doubles; counter: one
// unsigned, zero before the first launch (each launch leaves it zero);
// launches on one pair must be ordered (one stream).  Refuses a stencil
// past the gate (ls_pass_band_layout).
int ls_stencil2d_band(int mode, const float* x, const float* top,
                      const float* bot, float* y, float* xv, float* rv,
                      const float* alpha, float* dot, double* partials,
                      int capacity, unsigned* counter, int R, int C,
                      const LsStencil* st, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // a0 a1 a2, t0 b0 t1 b1, y po xv rv, rt sc sc2, dot partials counter
  const PassIO io{x,       nullptr, nullptr, top,      bot,     nullptr,
                  nullptr, y,       nullptr, xv,       rv,      nullptr,
                  alpha,   nullptr, dot,     partials, counter};
  switch (mode) {
    case 0: return band_pass<0>(io, capacity, R, C, 0, st, stream);
    case 1: return band_pass<1>(io, capacity, R, C, 0, st, stream);
    case 2: return band_pass<2>(io, capacity, R, C, 0, st, stream);
    case 3: return band_pass<3>(io, capacity, R, C, 0, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4 on the band route.  Scratch as ls_stencil2d_band's.
int ls_xpay_pq_band(const float* r, const float* p_old, const float* beta,
                    const float* rt, const float* rb, const float* pt,
                    const float* pb, float* p_out, float* dot,
                    double* partials, int capacity, unsigned* counter, int R,
                    int C, const LsStencil* st, void* stream_ptr) {
  const PassIO io{r,       p_old,   nullptr, rt,       rb,      pt,
                  pb,      nullptr, p_out,   nullptr,  nullptr, nullptr,
                  beta,    nullptr, dot,     partials, counter};
  return band_pass<4>(io, capacity, R, C, 0, st, (cudaStream_t)stream_ptr);
}

// K5a on the band route: p' = r + beta (p - omega v) into p_out, v' = A p'
// into v_out, <r~, v'> into dot[0] (compensated: the exact products).  No
// halo blocks: p' is zero outside the grid.  Scratch as
// ls_stencil2d_band's.
int ls_bicg_pv_band(const float* r, const float* p, const float* v,
                    const float* rt, const float* beta, const float* omega,
                    float* p_out, float* v_out, float* dot, double* partials,
                    int capacity, unsigned* counter, int R, int C,
                    int compensated, const LsStencil* st, void* stream_ptr) {
  const PassIO io{r,       p,       v,       nullptr,  nullptr, nullptr,
                  nullptr, v_out,   p_out,   nullptr,  nullptr, rt,
                  beta,    omega,   dot,     partials, counter};
  return band_pass<5>(io, capacity, R, C, compensated, st,
                      (cudaStream_t)stream_ptr);
}

// K5b on the band route: s = r - alpha v, t = A s; <t, s> and <t, t> into
// dot[0..1].  No halo blocks.  Scratch as ls_stencil2d_band's.
int ls_bicg_st_band(const float* r, const float* v, const float* alpha,
                    float* dot, double* partials, int capacity,
                    unsigned* counter, int R, int C, int compensated,
                    const LsStencil* st, void* stream_ptr) {
  const PassIO io{r,       v,       nullptr, nullptr,  nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr,  nullptr, nullptr,
                  alpha,   nullptr, dot,     partials, counter};
  return band_pass<6>(io, capacity, R, C, compensated, st,
                      (cudaStream_t)stream_ptr);
}

// K5c on the band route: s = r - alpha v, t = A s; x' = (x + alpha p) +
// omega s written into x, r' = s - omega t into r_out (not r's storage);
// <r', r'> and <r~, r'> into dot[0..1].  No halo blocks.  Scratch as
// ls_stencil2d_band's.
int ls_bicg_update_band(const float* r, const float* v, float* x,
                        const float* p, const float* rt, const float* alpha,
                        const float* omega, float* r_out, float* dot,
                        double* partials, int capacity, unsigned* counter,
                        int R, int C, int compensated, const LsStencil* st,
                        void* stream_ptr) {
  const PassIO io{r,       v,       p,       nullptr,  nullptr, nullptr,
                  nullptr, r_out,   nullptr, x,        nullptr, rt,
                  alpha,   omega,   dot,     partials, counter};
  return band_pass<7>(io, capacity, R, C, compensated, st,
                      (cudaStream_t)stream_ptr);
}

// out = {strips, strip columns, band rows, bands} of a launch on an [R, C]
// grid; ops/cuda/stencil2d.py mirrors it.
int ls_pass_band_geometry(int R, int C, int* out) {
  if (R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const PassGeom g = pass_geometry(R, C);
  out[0] = g.strips;
  out[1] = g.strip_cols;
  out[2] = g.band_rows;
  out[3] = g.bands;
  return 0;
}

// out = {ring row floats (0 past the gate), clipped (1) or padded (0), ring
// rows, dynamic shared memory bytes} with the stencil st on C columns;
// ops/cuda/stencil2d.py mirrors it.
int ls_pass_band_layout(int C, const LsStencil* st, int* out) {
  if (!st || C < 1 || st->n < 1 || st->n > LS_MAX_TERMS)
    return (int)cudaErrorInvalidValue;
  const PassLayout lay = pass_layout(C, *st);
  out[0] = lay.stride;
  out[1] = lay.mask;
  out[2] = lay.rows;
  out[3] = (int)lay.smem;
  return 0;
}

// The constants the Python mirror holds: {threads, strip columns, shortest
// band, target units, most ring-row floats, slack floats, most dynamic
// shared memory bytes, partial dots per unit}.
int ls_pass_band_consts(int* out) {
  const int c[8] = {LS_PASS_THREADS, LS_PASS_COLS, LS_PASS_MIN_ROWS,
                    LS_PASS_TARGET, LS_PASS_MAX_STRIDE, LS_PASS_SLACK,
                    LS_PASS_SMEM_MAX, LS_PASS_DOTS};
  for (int k = 0; k < 8; ++k) out[k] = c[k];
  return 0;
}

// out = {registers, spill bytes, resident blocks per SM, dynamic shared
// memory bytes} of pass `which` (0..3 K3's modes, 4 K4, 5 K5a, 6 K5b, 7
// K5c) on the band route with the stencil st on C columns (the layout's
// window).
int ls_pass_band_attrs(int which, int C, const LsStencil* st, int* out) {
  if (!valid2d(st, 1, C)) return (int)cudaErrorInvalidValue;
  const PassLayout lay = pass_layout(C, *st);
  if (!lay.stride) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)lay.smem;
  out[3] = (int)lay.smem;
#define LS_PASS_ATTR(M)                                            \
  case M:                                                          \
    return lay.mask ? pass_attrs<M, true>(smem, out)               \
                    : pass_attrs<M, false>(smem, out);
  switch (which) {
    LS_PASS_ATTR(0) LS_PASS_ATTR(1) LS_PASS_ATTR(2) LS_PASS_ATTR(3)
    LS_PASS_ATTR(4) LS_PASS_ATTR(5) LS_PASS_ATTR(6) LS_PASS_ATTR(7)
    default: return (int)cudaErrorInvalidValue;
  }
#undef LS_PASS_ATTR
}

}  // extern "C"
