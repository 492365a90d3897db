// 2-D grid stencil SpMV and fused-CG passes for Hopper (sm_90a).
//
// Hand-written CUDA ports of the Pallas TPU kernels in
// legionsolvers_tpu/ops/pallas/stencil2d.py.  Python wrappers, plain PyTorch
// versions and gates live in legionsolvers_tpu_torch/ops/cuda/stencil2d.py;
// the entry points below have a plain C interface and are loaded with ctypes
// (legionsolvers_tpu_torch/ops/cuda/build.py).
//
//   ls_stencil2d  K3  replaces _stencil_call (modes y, y_dot, pq, update)
//                     (stencil_strip_kernel; past the band route's gate,
//                     stencil_kernel; the band route: band2d.cu)
//   ls_xpay_pq    K4  replaces grid2d_cg_xpay_pq
//                     (xpay_pq_strip_kernel; past the band route's gate,
//                     xpay_pq_kernel; the band route: band2d.cu)
//   ls_gram2      K2  replaces _sstep_call mode gram2 (on the 1-D view's
//                     flat route: ls_flat_gram2, flat1d.cu)
//   ls_step2      K1  replaces _sstep_call mode step2 (flat route:
//                     ls_flat_step2, flat1d.cu)
//   ls_step2_nop  K1  replaces _sstep_call mode nop (a diagnostic: step2's
//                     loads and stores, a trivial body)
//
// What bounds them: bytes.  A 2-D stencil does ~2 flops per term per
// element, far below the card's ~20 flops per byte of HBM bandwidth.  K1
// moves 24 B per element per pass (reads x, r, p; writes x'', r'', p'') for
// two CG iterations; K2 8 B; K3 8 B (y, y_dot), 4 B (pq) or 20 B (update);
// K4 12 B.
//
// Design.  The Pallas kernels stream whole rows through a sequential grid
// and carry sums in SMEM from one grid step to the next.  CUDA blocks run
// in no order.  With a reach-1 stencil (the 5-point cross, any 3x3
// stencil) every pass runs the column-strip register march of
// march2d.cuh instead: a warp marches down a 128-column strip of a row
// chunk with the rows it needs in registers, and each dot is summed in
// double and folded into the last block to finish (one launch).  K3 and
// K4 there take their reach-1 halo rows from the caller's halo blocks
// (halo_row), so they serve every call the tile kernels serve.  The 1-D
// kernel view (a 1-D grid viewed as [n / C, C], its shifts rewritten into
// (dy, dx) terms with row-wrap terms of |dx| = C - 1) runs K3, K4 and K5b
// on the strip march with WRAP on the 1-D stencil (march2d.cuh): each
// element is addressed by its flat index, so the wrap terms cost no extra
// read; K1 and K2 there march along the flat index (flat1d.cu).  Any
// other stencil (|dy| <= 8, |dx| < C) runs K3 and K4 on the band route
// (band2d.cu: a march down bands of rows with the operand's rows in a
// shared-memory ring), or, past its gate (a ring that would not fit
// shared memory), on the tile design of the first port, its terms with
// |dx| > 8 read from device memory beside the tile (apply_at_wide: only
// the lanes whose column lands in the grid load):
//   * each block owns one TILE x TILE output tile and loads its inputs
//     plus a halo into shared memory once (halo re-reads cost
//     (TILE + 2h)^2 / TILE^2 - 1);
//   * each block writes its partial dot to a [blocks] scratch and a
//     second launch (reduce_partials) sums them in a fixed order;
// No kernel writes a buffer that another block (or another lane) reads
// through a halo: the new r and p of K1 and the p of K4 go to separate
// buffers, and K3 update writes x and r only at the elements it reads
// them (see stencil_strip_kernel).

#include "march2d.cuh"

namespace {

// ---------------------------------------------------------------------------
// K3: y = A x (mode 0), y and <x, A x> (1), <x, A x> (2),
//     update (3): xv += alpha x; rv -= alpha A x; <rv', rv'>  (x is p here)
// ---------------------------------------------------------------------------
template <int MODE>
__global__ void __launch_bounds__(LS_THREADS)
stencil_kernel(const float* __restrict__ x, const float* __restrict__ top,
               const float* __restrict__ bot, float* __restrict__ y,
               float* __restrict__ xv, float* __restrict__ rv,
               const float* __restrict__ alpha_p, float* __restrict__ partials,
               int R, int C, LsStencil st, int h) {
  __shared__ float w[kWinMax * kWinMax];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const int W = LS_TILE + 2 * h;
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  for (int e = tid(); e < W * W; e += LS_THREADS) {
    const int i = e / W, j = e % W;
    w[e] = load_halo(x, top, bot, R, C, r0 - h + i, c0 - h + j);
  }
  __syncthreads();
  const float alpha = MODE == 3 ? *alpha_p : 0.f;
  float acc[1] = {0.f};
  const int j = threadIdx.x, gc = c0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    const int gr = r0 + i;
    if (gr >= R || gc >= C) continue;
    const size_t idx = (size_t)gr * C + gc;
    const float xc = w[(i + h) * W + j + h];
    const float ax = apply_at_wide(w, W, i + h, j + h, s, [&](int dy, int dx) {
      return load_halo(x, top, bot, R, C, gr + dy, gc + dx);
    });
    if (MODE == 0 || MODE == 1) y[idx] = ax;
    if (MODE == 1 || MODE == 2) acc[0] += xc * ax;
    if (MODE == 3) {
      xv[idx] = xv[idx] + alpha * xc;
      const float rn = rv[idx] - alpha * ax;
      rv[idx] = rn;
      acc[0] += rn * rn;
    }
  }
  if (MODE != 0) block_partials(acc, partials);
}

// K3 on the strip march (reach 1).  A warp owns a 128-column strip (120
// output columns, one halo lane per side) and a row chunk [a, b); it
// reads x at rows a - 1 .. b, the two outside rows from the halo blocks
// (halo_row), and applies A at the row before the one that arrived, from
// x rows q - 2 .. q held in registers.  stencil_depth(MODE) rows are in
// flight per warp (a register ring); update also reads xv and rv there,
// at the lane's own output columns of the chunk's rows only, and keeps
// one row in flight: two rows of its three vectors spilled at 64
// registers and ran at the tile kernel's speed (PERF.md section 6).
//
// In place: update writes xv and rv at exactly the elements the lane
// read them (its own columns, rows [a, b)); the halo lanes and the rows
// outside the chunk write nothing, and x (= p) is a separate buffer, so
// no lane reads an element another lane writes.
//
// What bounds it: bytes, 8 B per element (y, y_dot: reads x, writes y),
// 4 B (pq) or 20 B (update: reads p, x, r; writes x, r), at ~10 flops;
// what holds it back is the bytes in flight, which residency gives, as
// for K5b (8 blocks per SM, <= 64 registers).  Halo columns (8 of 128)
// and two rows per chunk are read again, mostly from L2.  Dots: the f32
// products (__fmul_rn), summed in double per thread, across threads and
// blocks (strip_fold), rounded to f32 once: K5b's and K6b's order.
#define LS_STENCIL_DEPTH 2  // rows of x in flight per warp: y, y_dot, pq
#define LS_UPDATE_DEPTH 1   // rows of p, x and r in flight per warp: update
constexpr int stencil_depth(int mode) {
  return mode == 3 ? LS_UPDATE_DEPTH : LS_STENCIL_DEPTH;
}
template <int MODE, int DEPTH, int MINB, bool CROSS, bool VEC, bool WRAP>
__global__ void __launch_bounds__(LS_STEP2_THREADS, MINB)
stencil_strip_kernel(const float* __restrict__ x,
                     const float* __restrict__ top,
                     const float* __restrict__ bot, float* __restrict__ y,
                     float* __restrict__ xv, float* __restrict__ rv,
                     const float* __restrict__ alpha_p,
                     float* __restrict__ dot, double* __restrict__ partials,
                     unsigned* __restrict__ counter, int R, int C,
                     StripGeom geo, Step2Stencil st) {
  constexpr int NV = MODE == 3 ? 3 : 1;  // x; and xv, rv for update
  const int unit = blockIdx.x * LS_STEP2_WARPS + (threadIdx.x >> 5);
  double acc[1] = {0.0};
  if (unit < geo.units) {  // warp-uniform
    const StripPlace pl = strip_place(unit, geo, R, C);
    const float alpha = MODE == 3 ? *alpha_p : 0.f;
    const Row4 z = {{0.f, 0.f, 0.f, 0.f}};
    Row4 X2 = z, X1 = z;    // x rows q-2, q-1
    Row4 XV1 = z, RV1 = z;  // xv, rv row q-1 (update)
    strip_ring<DEPTH, NV>(
        pl.a - 1, pl.b,
        [&](Row4 (&dst)[NV], int q) {
          if (q > pl.b) return;  // past the chunk: never consumed
          dst[0] = operand_row4<WRAP, VEC>(x, top, bot, q, R, C, pl);
          if constexpr (MODE == 3) {
            const bool mine = q >= pl.a && q < pl.b;
            const long long o = (long long)q * C;
            dst[1] = strip_load4<VEC, false>(mine ? xv + o : nullptr, pl.c0,
                                             pl.own);
            dst[2] = strip_load4<VEC, false>(mine ? rv + o : nullptr, pl.c0,
                                             pl.own);
          }
        },
        [&](int q, const Row4 (&row)[NV]) {
          const int i = q - 1;
          if (i >= pl.a) {  // i < b: the march ends at q = b
            const Row4 ax = apply4<CROSS>(X2, X1, row[0], st);
            const long long o = (long long)i * C + pl.c0;
            if (MODE == 0 || MODE == 1) store4<VEC>(y, o, ax, pl.own);
            if (MODE == 1 || MODE == 2) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (pl.own[j]) acc[0] += (double)__fmul_rn(X1.v[j], ax.v[j]);
            }
            if (MODE == 3) {
              Row4 xn, rn;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                xn.v[j] = XV1.v[j] + alpha * X1.v[j];
                rn.v[j] = RV1.v[j] - alpha * ax.v[j];
                if (pl.own[j]) acc[0] += (double)__fmul_rn(rn.v[j], rn.v[j]);
              }
              store4<VEC>(xv, o, xn, pl.own);
              store4<VEC>(rv, o, rn, pl.own);
            }
          }
          X2 = X1;
          X1 = row[0];
          if constexpr (MODE == 3) {
            XV1 = row[1];
            RV1 = row[2];
          }
        });
  }
  if (MODE != 0) strip_fold<1>(acc, partials, counter, dot);
}

// ---------------------------------------------------------------------------
// K4: p = r + beta p_old (written to p_out) and <p, A p>; p's halo is
// r_halo + beta p_old_halo.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(LS_THREADS)
xpay_pq_kernel(const float* __restrict__ r, const float* __restrict__ p_old,
               const float* __restrict__ beta_p, const float* __restrict__ rt,
               const float* __restrict__ rb, const float* __restrict__ pt,
               const float* __restrict__ pb, float* __restrict__ p_out,
               float* __restrict__ partials, int R, int C, LsStencil st, int h) {
  __shared__ float w[kWinMax * kWinMax];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const float beta = *beta_p;
  const int W = LS_TILE + 2 * h;
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  for (int e = tid(); e < W * W; e += LS_THREADS) {
    const int gr = r0 - h + e / W, gc = c0 - h + e % W;
    w[e] = load_halo(r, rt, rb, R, C, gr, gc) +
           beta * load_halo(p_old, pt, pb, R, C, gr, gc);
  }
  __syncthreads();
  float acc[1] = {0.f};
  const int j = threadIdx.x, gc = c0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    const int gr = r0 + i;
    if (gr >= R || gc >= C) continue;
    const float pc = w[(i + h) * W + j + h];
    p_out[(size_t)gr * C + gc] = pc;
    acc[0] += pc * apply_at_wide(w, W, i + h, j + h, s, [&](int dy, int dx) {
      return load_halo(r, rt, rb, R, C, gr + dy, gc + dx) +
             beta * load_halo(p_old, pt, pb, R, C, gr + dy, gc + dx);
    });
  }
  block_partials(acc, partials);
}

// K4 on the strip march (reach 1): p = r + beta p_old formed in registers
// as each row of r and p_old arrives (rows -1 and R from their halo
// blocks, as K3 reads x; zero where both are null), A p at the row before
// it from p rows q - 2 .. q; p stored at the lane's output columns,
// <p, A p> summed as K3's dots and folded into the last block.
// LS_XPAY_DEPTH rows of r and p_old in flight per warp.  What bounds it:
// bytes, 12 B per element (reads r, p_old; writes p); what holds it back
// is the bytes in flight, as for K3.
#define LS_XPAY_DEPTH 2  // rows of r and p_old in flight per warp
template <int DEPTH, int MINB, bool CROSS, bool VEC, bool WRAP>
__global__ void __launch_bounds__(LS_STEP2_THREADS, MINB)
xpay_pq_strip_kernel(const float* __restrict__ r,
                     const float* __restrict__ p_old,
                     const float* __restrict__ beta_p,
                     const float* __restrict__ rt,
                     const float* __restrict__ rb,
                     const float* __restrict__ pt,
                     const float* __restrict__ pb, float* __restrict__ p_out,
                     float* __restrict__ dot, double* __restrict__ partials,
                     unsigned* __restrict__ counter, int R, int C,
                     StripGeom geo, Step2Stencil st) {
  const int unit = blockIdx.x * LS_STEP2_WARPS + (threadIdx.x >> 5);
  double acc[1] = {0.0};
  if (unit < geo.units) {  // warp-uniform
    const StripPlace pl = strip_place(unit, geo, R, C);
    const float beta = *beta_p;
    const Row4 z = {{0.f, 0.f, 0.f, 0.f}};
    Row4 P2 = z, P1 = z;  // p rows q-2, q-1
    strip_ring<DEPTH, 2>(
        pl.a - 1, pl.b,
        [&](Row4 (&dst)[2], int q) {
          if (q > pl.b) return;  // past the chunk: never consumed
          dst[0] = operand_row4<WRAP, VEC>(r, rt, rb, q, R, C, pl);
          dst[1] = operand_row4<WRAP, VEC>(p_old, pt, pb, q, R, C, pl);
        },
        [&](int q, const Row4 (&row)[2]) {
          Row4 P0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            P0.v[j] = row[0].v[j] + beta * row[1].v[j];
          const int i = q - 1;
          if (i >= pl.a) {  // i < b: the march ends at q = b
            const Row4 ap = apply4<CROSS>(P2, P1, P0, st);
            store4<VEC>(p_out, (long long)i * C + pl.c0, P1, pl.own);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (pl.own[j]) acc[0] += (double)__fmul_rn(P1.v[j], ap.v[j]);
          }
          P2 = P1;
          P1 = P0;
        });
  }
  strip_fold<1>(acc, partials, counter, dot);
}

// ---------------------------------------------------------------------------
// K2: the Gram vector (GRAM_NAMES order) of (r, p): A p, A^2 p, A r.
//
// K1's strip march (march2d.cuh) reduced to K2's chain of two.  Each step
// takes one new row q of p and r from a ring of LS_GRAM2_DEPTH rows in
// flight and advances two stages, each reading rows the earlier one left
// in registers:
//   S1 at q-1: Ap (zeroed outside the grid), Ar   (p, r rows q-2..q)
//   S2 at q-2: A^2 p, the Gram terms              (Ap rows q-3..q-1)
// Ap is zeroed outside the grid, which reproduces the JAX mask() chain,
// so A^2 p is the true matrix power.  The strip's halo lane per side (4
// columns) covers the chain's depth of 2.  The terms are exact products
// of the f32 values accumulated in double and rounded to f32 once, as
// K1's Gram (the JAX kernel sums in f32: this computes the same function
// more exactly); each block's sums are folded into the last block
// (strip_fold): one launch.  It shares K1's scratch, which has room for
// the largest strip launch on the grid.  What bounds it: bytes, 8 B per
// element (reads r, p), with 8 of every 128 columns and 4 rows per row
// chunk read again (about 13% at 4096^2, mostly from L2); its double Gram
// (5 conversions and 10 fma per element) is its other cost.  One row in
// flight and 4 resident blocks per SM measured best (PERF.md section 6).
// ---------------------------------------------------------------------------
#define LS_GRAM2_DEPTH 1  // rows in flight per warp (more were slower)
template <int DEPTH, int MINB, bool CROSS, bool VEC>
__global__ void __launch_bounds__(LS_STEP2_THREADS, MINB)
gram2_strip_kernel(const float* __restrict__ r, const float* __restrict__ p,
                   float* __restrict__ g_out, double* __restrict__ partials,
                   unsigned* __restrict__ counter, int R, int C,
                   StripGeom geo, Step2Stencil st) {
  const int unit = blockIdx.x * LS_STEP2_WARPS + (threadIdx.x >> 5);
  double g[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (unit < geo.units) {  // warp-uniform
    const StripPlace pl = strip_place(unit, geo, R, C);
    // windows, named by row relative to the step's new row q
    const Row4 z = {{0.f, 0.f, 0.f, 0.f}};
    Row4 P2 = z, P1 = z, R2 = z, R1 = z;  // p, r rows q-2, q-1
    Row4 AP3 = z, AP2 = z, AR2 = z;       // Ap rows q-3, q-2; Ar row q-2
    const float* const src[2] = {p, r};
    strip_rows<DEPTH, 2, VEC>(
        src, pl.a - 2, pl.b + 1, R, C, pl,
        [&](int q, const Row4 (&row)[2]) {
          const Row4& P0 = row[0];
          const Row4& R0 = row[1];
          // S1 at row q - 1
          const int i1 = q - 1;
          Row4 AP1 = apply4<CROSS>(P2, P1, P0, st);
          strip_mask(AP1, i1, R, pl.cin);
          const Row4 AR1 = apply4<CROSS>(R2, R1, R0, st);
          // S2 at row q - 2
          const int i2 = q - 2;
          if (i2 >= pl.a && i2 < pl.b) {
            const Row4 A2 = apply4<CROSS>(AP3, AP2, AP1, st);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (pl.own[j])
                gram_terms_f64(g, R2.v[j], P2.v[j], AP2.v[j], A2.v[j],
                               AR2.v[j]);
          }
          P2 = P1; P1 = P0; R2 = R1; R1 = R0;
          AP3 = AP2; AP2 = AP1; AR2 = AR1;
        });
  }
  strip_fold<10>(g, partials, counter, g_out);
}

// ---------------------------------------------------------------------------
// K1: u = c0 p + c1 r - c2 Ap; x'' = x + u; r'' = r - A u;
//     p'' = r'' + c3 r - c4 Ap + c5 p; Gram of (r'', p'').
//
// A vertical march in registers (the 2-D form of the TPU kernel's
// whole-row window and of the 3-D marches; march2d.cuh).  A warp owns a strip of 128 columns
// (four per lane, read as 16-byte vectors) and marches down a chunk of
// rows [a, b).  The chained applications shrink the strip by one column
// per side each, so its 120 middle columns (lanes 1..30) are the warp's
// output: 4 halo columns per side, read twice, instead of the 56% halo of
// a 32 x 32 tile.  Each step takes one new row of p, r (and x) and
// advances a five-stage pipeline by one row, every stage reading rows the
// earlier stages left in registers:
//   S1 at q-1: Ap, u; x += u          (p rows q-2..q)
//   S2 at q-2: r'' = r - A u, p''     (u rows q-3..q-1)
//   S3 at q-3: A p''                  (p'' rows q-4..q-2)
//   S4 at q-4: A^2 p'', A r'', Gram   (A p'', r'' rows q-5..q-3)
// Vertical neighbours come from registers, horizontal ones from the
// neighbouring lane (one shuffle per side per row).  Every intermediate is
// zeroed outside the grid, which reproduces the JAX mask() chain, so the
// chained applications are true matrix powers.  The next row's loads are
// issued before the current row's stages, so they overlap its compute.
// The 5-point cross (the Laplacian, in its stencil order) has its offsets
// fixed at compile time; any other reach-1 stencil runs its terms, in
// stencil order, through a warp-uniform switch over the 3x3 box.  The
// coefficients are kernel parameters.  The Gram terms are exact products
// of the f32 values accumulated in double (a lane sums a few hundred of
// them; in f32 that rounding would reach the s-step coefficients, which
// amplify it over the solve) and rounded to f32 once.  Each block writes
// its Gram partials and the last block to finish (a device counter) sums
// all partials in block order and resets the counter: deterministic, with
// no second launch.
//
// NOP (the TPU kernel's diagnostic mode nop): the same geometry, loads
// (window rows a - 4 .. b + 4 of p and r, x at the lane's own columns) and
// stores, and a trivial body: x'' = x + r, r'' = r, p'' = p, g[0] = sum of
// r p (exact products summed in double, as the Gram above), g[1..9] = 0.
// Its time is K1's memory floor with step2's access pattern.
// ---------------------------------------------------------------------------
template <bool CROSS, bool VEC, bool NOP = false>
__global__ void __launch_bounds__(LS_STEP2_THREADS, LS_STEP2_MIN_BLOCKS)
step2_kernel(float* __restrict__ x, const float* __restrict__ r,
             const float* __restrict__ p, const float* __restrict__ coef,
             float* __restrict__ r_out, float* __restrict__ p_out,
             float* __restrict__ g_out, double* __restrict__ partials,
             unsigned* __restrict__ counter, int R, int C, int strips,
             int chunk_rows, int units, Step2Stencil st) {
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * LS_STEP2_WARPS + (threadIdx.x >> 5);
  double g[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (unit < units) {  // warp-uniform
    const int strip = unit % strips, chunk = unit / strips;
    const int c0 = strip * LS_STEP2_COLS - 4 + 4 * lane;
    const int a = chunk * chunk_rows;
    const int b = min(a + chunk_rows, R);
    const float k0 = coef[0], k1 = coef[1], k2 = coef[2];
    const float k3 = coef[3], k4 = coef[4], k5 = coef[5];
    bool cin[4], own[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cin[j] = c0 + j >= 0 && c0 + j < C;
      own[j] = cin[j] && lane >= 1 && lane <= 30;
    }
    // row q of p, r (zero outside the grid) and of x (own columns of rows
    // [a, b) only)
    auto load_row = [&](int q, Row4& P, Row4& Rv, Row4& X) {
#pragma unroll
      for (int j = 0; j < 4; ++j) P.v[j] = Rv.v[j] = X.v[j] = 0.f;
      const bool xrow = q >= a && q < b;
      if (q < 0 || q >= R) return;
      const long long o = (long long)q * C + c0;
      if (VEC) {
        if (!cin[0]) return;
        const float4 pv = __ldg(reinterpret_cast<const float4*>(p + o));
        const float4 rv = __ldg(reinterpret_cast<const float4*>(r + o));
        P = Row4{{pv.x, pv.y, pv.z, pv.w}};
        Rv = Row4{{rv.x, rv.y, rv.z, rv.w}};
        if (xrow && own[0]) {
          const float4 xv = *reinterpret_cast<const float4*>(x + o);
          X = Row4{{xv.x, xv.y, xv.z, xv.w}};
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!cin[j]) continue;
          P.v[j] = __ldg(p + o + j);
          Rv.v[j] = __ldg(r + o + j);
          if (xrow && own[j]) X.v[j] = x[o + j];
        }
      }
    };
    // windows, named by row relative to the step's new row q
    const Row4 z = {{0.f, 0.f, 0.f, 0.f}};
    Row4 P2 = z, P1 = z, R2 = z, R1 = z, X1 = z;  // p, r, x rows q-2, q-1
    Row4 U3 = z, U2 = z, AP2 = z;                 // u rows q-3, q-2; Ap q-2
    Row4 RN5 = z, RN4 = z, RN3 = z;               // r'' rows q-5..q-3
    Row4 PN4 = z, PN3 = z;                        // p'' rows q-4, q-3
    Row4 APN5 = z, APN4 = z;                      // A p'' rows q-5, q-4
    Row4 Pn, Rn, Xn;  // row q + 1, loading while row q is computed
    load_row(a - 4, Pn, Rn, Xn);
    for (int q = a - 4; q < b + 4; ++q) {
      const Row4 P0 = Pn, R0 = Rn, X0 = Xn;
      load_row(q + 1, Pn, Rn, Xn);
      if (NOP) {  // row q - 1: x'' = x + r, r'' = r, p'' = p
        const int i = q - 1;
        if (i >= a && i < b) {
          const long long o = (long long)i * C + c0;
          Row4 XN;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            XN.v[j] = X1.v[j] + R1.v[j];
            if (own[j]) g[0] = fma((double)R1.v[j], (double)P1.v[j], g[0]);
          }
          store4<VEC>(x, o, XN, own);
          store4<VEC>(r_out, o, R1, own);
          store4<VEC>(p_out, o, P1, own);
        }
        P1 = P0; R1 = R0; X1 = X0;
        continue;
      }
      // S1 at row q - 1
      const int i1 = q - 1;
      Row4 AP1 = apply4<CROSS>(P2, P1, P0, st);
      strip_mask(AP1, i1, R, cin);
      Row4 U1;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        U1.v[j] = k0 * P1.v[j] + k1 * R1.v[j] - k2 * AP1.v[j];
      strip_mask(U1, i1, R, cin);
      if (i1 >= a && i1 < b) {
#pragma unroll
        for (int j = 0; j < 4; ++j) X1.v[j] = X1.v[j] + U1.v[j];
        store4<VEC>(x, (long long)i1 * C + c0, X1, own);
      }
      // S2 at row q - 2
      const int i2 = q - 2;
      const Row4 AU = apply4<CROSS>(U3, U2, U1, st);
      Row4 RN2, PN2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        RN2.v[j] = R2.v[j] - AU.v[j];
        PN2.v[j] = RN2.v[j] + k3 * R2.v[j] - k4 * AP2.v[j] + k5 * P2.v[j];
      }
      strip_mask(RN2, i2, R, cin);
      strip_mask(PN2, i2, R, cin);
      if (i2 >= a && i2 < b) {
        store4<VEC>(r_out, (long long)i2 * C + c0, RN2, own);
        store4<VEC>(p_out, (long long)i2 * C + c0, PN2, own);
      }
      // S3 at row q - 3
      const int i3 = q - 3;
      Row4 APN3 = apply4<CROSS>(PN4, PN3, PN2, st);
      strip_mask(APN3, i3, R, cin);
      // S4 at row q - 4
      const int i4 = q - 4;
      if (i4 >= a && i4 < b) {
        const Row4 A2 = apply4<CROSS>(APN5, APN4, APN3, st);
        const Row4 AR = apply4<CROSS>(RN5, RN4, RN3, st);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (own[j])
            gram_terms_f64(g, RN4.v[j], PN4.v[j], APN4.v[j], A2.v[j],
                           AR.v[j]);
      }
      P2 = P1; P1 = P0; R2 = R1; R1 = R0; X1 = X0;
      U3 = U2; U2 = U1; AP2 = AP1;
      RN5 = RN4; RN4 = RN3; RN3 = RN2;
      PN4 = PN3; PN3 = PN2;
      APN5 = APN4; APN4 = APN3;
    }
  }
  // Gram partials of this block, then the last block sums them all
  strip_fold<10>(g, partials, counter, g_out);
}

template <bool CROSS, bool VEC>
int launch_step2(float* x, const float* r, const float* p, const float* coef,
                 float* r_out, float* p_out, float* g, double* partials,
                 int capacity, unsigned* counter, int R, int C,
                 const Step2Stencil& st, cudaStream_t stream) {
  const StripGeom geo = strip_geometry(R, C, LS_STEP2_TARGET_WARPS);
  if (geo.blocks > capacity) return (int)cudaErrorInvalidValue;
  step2_kernel<CROSS, VEC><<<(unsigned)geo.blocks, LS_STEP2_THREADS, 0,
                             stream>>>(
      x, r, p, coef, r_out, p_out, g, partials, counter, R, C, geo.strips,
      geo.chunk_rows, geo.units, st);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_nop(float* x, const float* r, const float* p, const float* coef,
               float* r_out, float* p_out, float* g, double* partials,
               int capacity, unsigned* counter, int R, int C,
               const Step2Stencil& st, cudaStream_t stream) {
  const StripGeom geo = strip_geometry(R, C, LS_STEP2_TARGET_WARPS);
  if (geo.blocks > capacity) return (int)cudaErrorInvalidValue;
  step2_kernel<false, VEC, true><<<(unsigned)geo.blocks, LS_STEP2_THREADS,
                                   0, stream>>>(
      x, r, p, coef, r_out, p_out, g, partials, counter, R, C, geo.strips,
      geo.chunk_rows, geo.units, st);
  return (int)cudaGetLastError();
}

template <bool CROSS, bool VEC>
int launch_gram2(const float* r, const float* p, float* g, double* partials,
                 int capacity, unsigned* counter, int R, int C,
                 const Step2Stencil& st, cudaStream_t stream) {
  const StripGeom geo = strip_geometry(R, C, LS_GRAM2_TARGET_WARPS);
  if (geo.blocks > capacity) return (int)cudaErrorInvalidValue;
  gram2_strip_kernel<LS_GRAM2_DEPTH, LS_GRAM2_MIN_BLOCKS, CROSS, VEC>
      <<<(unsigned)geo.blocks, LS_STEP2_THREADS, 0, stream>>>(
          r, p, g, partials, counter, R, C, geo, st);
  return (int)cudaGetLastError();
}

template <int MODE, bool CROSS, bool VEC, bool WRAP>
int launch_stencil_strip(const float* x, const float* top, const float* bot,
                         float* y, float* xv, float* rv, const float* alpha,
                         float* dot, double* partials, int capacity,
                         unsigned* counter, int R, int C,
                         const Step2Stencil& st, cudaStream_t stream) {
  const StripGeom geo = strip_geometry(R, C, LS_STENCIL_TARGET_WARPS);
  if (geo.blocks > capacity) return (int)cudaErrorInvalidValue;
  stencil_strip_kernel<MODE, stencil_depth(MODE), LS_STENCIL_MIN_BLOCKS,
                       CROSS, VEC, WRAP><<<(unsigned)geo.blocks,
                                           LS_STEP2_THREADS, 0, stream>>>(
      x, top, bot, y, xv, rv, alpha, dot, partials, counter, R, C, geo, st);
  return (int)cudaGetLastError();
}

// K3 on the strip march in `mode`, in the variant of LS_STRIP_VARIANT.
template <int MODE>
int stencil_strip(bool cross, bool vec, bool wrap, const float* x,
                  const float* top, const float* bot, float* y, float* xv,
                  float* rv, const float* alpha, float* dot,
                  double* partials, int capacity, unsigned* counter, int R,
                  int C, const Step2Stencil& st, cudaStream_t stream) {
#define LS_K3_LAUNCH(CR, VE, WR)                                           \
  launch_stencil_strip<MODE, CR, VE, WR>(x, top, bot, y, xv, rv, alpha,   \
                                         dot, partials, capacity, counter, \
                                         R, C, st, stream)
  return LS_STRIP_VARIANT(LS_K3_LAUNCH, cross, vec, wrap);
#undef LS_K3_LAUNCH
}

template <bool CROSS, bool VEC, bool WRAP>
int launch_xpay_pq_strip(const float* r, const float* p_old,
                         const float* beta, const float* rt, const float* rb,
                         const float* pt, const float* pb, float* p_out,
                         float* dot, double* partials, int capacity,
                         unsigned* counter, int R, int C,
                         const Step2Stencil& st, cudaStream_t stream) {
  const StripGeom geo = strip_geometry(R, C, LS_XPAY_TARGET_WARPS);
  if (geo.blocks > capacity) return (int)cudaErrorInvalidValue;
  xpay_pq_strip_kernel<LS_XPAY_DEPTH, LS_XPAY_MIN_BLOCKS, CROSS, VEC, WRAP>
      <<<(unsigned)geo.blocks, LS_STEP2_THREADS, 0, stream>>>(
          r, p_old, beta, rt, rb, pt, pb, p_out, dot, partials, counter, R,
          C, geo, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ls_tile() { return LS_TILE; }
int ls_max_terms() { return LS_MAX_TERMS; }
const char* ls_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K3.  mode: 0 y, 1 y_dot, 2 pq, 3 update.  Pointers unused by a mode may
// be null; halo pointers may be null (zeros).  A reach-1 stencil, or with
// `wrap` the reach-1 1-D stencil of the flat view (march2d.cuh), runs the
// strip kernel: partials is the strip scratch (capacity blocks x at least
// one double) and counter its last-block counter (zero before the first
// launch; the kernel leaves it zero; launches on one pair must be ordered,
// one stream).  Any other stencil (|dy| <= 8, |dx| < C) runs the tile
// kernel and reduce_partials (the wrappers send the stencils inside the
// band route's gate to ls_stencil2d_band, band2d.cu): partials holds one
// float per tile, and capacity and counter are unused.
int ls_stencil2d(int mode, const float* x, const float* top, const float* bot,
                 float* y, float* xv, float* rv, const float* alpha,
                 float* dot, void* partials, int capacity, unsigned* counter,
                 int R, int C, const LsStencil* st, int wrap,
                 void* stream_ptr) {
  if (!valid2d(st, R, C) || mode < 0 || mode > 3 ||
      (wrap && reach_of(*st) > 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (wrap || reach_of(*st) <= 1) {
    if (!counter) return (int)cudaErrorInvalidValue;
    const Step2Stencil s2 = step2_stencil(*st);
    const bool vec = C % 4 == 0 && aligned16(x) && aligned16(top) &&
                     aligned16(bot) && aligned16(y) && aligned16(xv) &&
                     aligned16(rv);
    const bool cross = is_cross(*st);
    double* part = (double*)partials;
#define LS_K3_MODE(M)                                                   \
  stencil_strip<M>(cross, vec, wrap, x, top, bot, y, xv, rv, alpha, dot, \
                   part, capacity, counter, R, C, s2, stream)
    switch (mode) {
      case 0: return LS_K3_MODE(0);
      case 1: return LS_K3_MODE(1);
      case 2: return LS_K3_MODE(2);
      default: return LS_K3_MODE(3);
    }
#undef LS_K3_MODE
  }
  const int h = tile_reach(*st);
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  float* part = (float*)partials;
  switch (mode) {
    case 0: stencil_kernel<0><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, part, R, C, *st, h);
            return (int)cudaGetLastError();
    case 1: stencil_kernel<1><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, part, R, C, *st, h); break;
    case 2: stencil_kernel<2><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, part, R, C, *st, h); break;
    default: stencil_kernel<3><<<grid, block, 0, stream>>>(
                 x, top, bot, y, xv, rv, alpha, part, R, C, *st, h);
  }
  return finish(part, grid.x * grid.y, 1, dot, stream);
}

// K4.  Scratch and routes as ls_stencil2d's.
int ls_xpay_pq(const float* r, const float* p_old, const float* beta,
               const float* rt, const float* rb, const float* pt,
               const float* pb, float* p_out, float* dot, void* partials,
               int capacity, unsigned* counter, int R, int C,
               const LsStencil* st, int wrap, void* stream_ptr) {
  if (!valid2d(st, R, C) || (wrap && reach_of(*st) > 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (wrap || reach_of(*st) <= 1) {
    if (!counter) return (int)cudaErrorInvalidValue;
    const Step2Stencil s2 = step2_stencil(*st);
    const bool vec = C % 4 == 0 && aligned16(r) && aligned16(p_old) &&
                     aligned16(rt) && aligned16(rb) && aligned16(pt) &&
                     aligned16(pb) && aligned16(p_out);
    double* part = (double*)partials;
#define LS_K4_LAUNCH(CR, VE, WR)                                          \
  launch_xpay_pq_strip<CR, VE, WR>(r, p_old, beta, rt, rb, pt, pb, p_out, \
                                   dot, part, capacity, counter, R, C, s2, \
                                   stream)
    return LS_STRIP_VARIANT(LS_K4_LAUNCH, is_cross(*st), vec, wrap);
#undef LS_K4_LAUNCH
  }
  const int h = tile_reach(*st);
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  float* part = (float*)partials;
  xpay_pq_kernel<<<grid, block, 0, stream>>>(r, p_old, beta, rt, rb, pt, pb,
                                             p_out, part, R, C, *st, h);
  return finish(part, grid.x * grid.y, 1, dot, stream);
}

// K2 and K1 share their scratch (with K3, K4 and K5b).  partials:
// capacity blocks x 10 doubles; counter: one unsigned, zero before the
// first launch (the kernels leave it zero).  Launches on one (partials,
// counter) pair must be ordered (one stream).  A reach-1 stencil (the 1-D
// view's flat decompositions take ls_flat_gram2 and ls_flat_step2).
int ls_gram2(const float* r, const float* p, float* g, double* partials,
             int capacity, unsigned* counter, int R, int C,
             const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, 1) || !counter) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Step2Stencil s2 = step2_stencil(*st);
  const bool vec = C % 4 == 0 && aligned16(r) && aligned16(p);
#define LS_GRAM2_LAUNCH(CR, VE)                                      \
  launch_gram2<CR, VE>(r, p, g, partials, capacity, counter, R, C, s2, \
                       stream)
  return LS_CROSS_VARIANT(LS_GRAM2_LAUNCH, is_cross(*st), vec);
#undef LS_GRAM2_LAUNCH
}

// K1.
int ls_step2(float* x, const float* r, const float* p, const float* coef,
             float* r_out, float* p_out, float* g, double* partials,
             int capacity, unsigned* counter, int R, int C,
             const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, 1) || !counter) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Step2Stencil s2 = step2_stencil(*st);
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(r) &&
                   aligned16(p) && aligned16(r_out) && aligned16(p_out);
#define LS_STEP2_LAUNCH(CR, VE)                                   \
  launch_step2<CR, VE>(x, r, p, coef, r_out, p_out, g, partials,  \
                       capacity, counter, R, C, s2, stream)
  return LS_CROSS_VARIANT(LS_STEP2_LAUNCH, is_cross(*st), vec);
#undef LS_STEP2_LAUNCH
}

// K1 in mode nop: step2's operands, scratch and geometry (any reach-1
// stencil; its terms are not applied).
int ls_step2_nop(float* x, const float* r, const float* p, const float* coef,
                 float* r_out, float* p_out, float* g, double* partials,
                 int capacity, unsigned* counter, int R, int C,
                 const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, 1) || !counter) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Step2Stencil s2 = step2_stencil(*st);
  if (C % 4 == 0 && aligned16(x) && aligned16(r) && aligned16(p) &&
      aligned16(r_out) && aligned16(p_out))
    return launch_nop<true>(x, r, p, coef, r_out, p_out, g, partials,
                            capacity, counter, R, C, s2, stream);
  return launch_nop<false>(x, r, p, coef, r_out, p_out, g, partials,
                           capacity, counter, R, C, s2, stream);
}

int ls_step2_cols() { return LS_STEP2_COLS; }
int ls_step2_min_rows() { return LS_STEP2_MIN_ROWS; }
int ls_step2_warps() { return LS_STEP2_WARPS; }

// Blocks of a strip launch on an [R, C] grid whose row chunks aim at
// target_warps warps, and the warps each strip pass aims at (which: 0 K1,
// 1 K2, 2 K5b, 3 K3, 4 K4); ops/cuda/stencil2d.py mirrors both.
int ls_strip_blocks(int R, int C, int target_warps) {
  return strip_geometry(R, C, target_warps).blocks;
}

int ls_strip_target_warps(int which) {
  const int t[5] = {LS_STEP2_TARGET_WARPS, LS_GRAM2_TARGET_WARPS,
                    LS_ST_TARGET_WARPS, LS_STENCIL_TARGET_WARPS,
                    LS_XPAY_TARGET_WARPS};
  return which >= 0 && which < 5 ? t[which] : -1;
}

// Registers, spill bytes and resident blocks per SM of K2's variant
// `which` = 2 cross + vec.
int ls_gram2_attrs(int which, int* out) {
  switch (which) {
#define LS_G2_ATTR(CR, VE)      \
  case 2 * CR + VE:             \
    return strip_attrs(                                                    \
        gram2_strip_kernel<LS_GRAM2_DEPTH, LS_GRAM2_MIN_BLOCKS, CR, VE>,  \
        out);
    LS_G2_ATTR(0, 0) LS_G2_ATTR(0, 1) LS_G2_ATTR(1, 0) LS_G2_ATTR(1, 1)
#undef LS_G2_ATTR
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same of K3's strip variant `which` = 4 mode + 2 cross + vec.
int ls_stencil2d_strip_attrs(int which, int* out) {
  switch (which) {
#define LS_K3_ATTR(M, CR, VE)                                          \
  case 4 * M + 2 * CR + VE:                                            \
    return strip_attrs(stencil_strip_kernel<M, stencil_depth(M),       \
                                            LS_STENCIL_MIN_BLOCKS, CR, \
                                            VE, false>, out);
#define LS_K3_ATTRS(M)                      \
  LS_K3_ATTR(M, 0, 0) LS_K3_ATTR(M, 0, 1) \
  LS_K3_ATTR(M, 1, 0) LS_K3_ATTR(M, 1, 1)
    LS_K3_ATTRS(0) LS_K3_ATTRS(1) LS_K3_ATTRS(2) LS_K3_ATTRS(3)
#undef LS_K3_ATTRS
#undef LS_K3_ATTR
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same of K4's strip variant `which` = 2 cross + vec.
int ls_xpay_pq_strip_attrs(int which, int* out) {
  switch (which) {
#define LS_K4_ATTR(CR, VE)                                               \
  case 2 * CR + VE:                                                      \
    return strip_attrs(                                                  \
        xpay_pq_strip_kernel<LS_XPAY_DEPTH, LS_XPAY_MIN_BLOCKS, CR, VE, \
                             false>, out);
    LS_K4_ATTR(0, 0) LS_K4_ATTR(0, 1) LS_K4_ATTR(1, 0) LS_K4_ATTR(1, 1)
#undef LS_K4_ATTR
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
