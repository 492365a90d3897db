// K1, K2 and K5b on the 1-D kernel view's flat route, for Hopper (sm_90a).
//
// Hand-written CUDA ports of the Pallas TPU kernels _sstep_call, modes step2
// (K1) and gram2 (K2) (legionsolvers_tpu/ops/pallas/stencil2d.py:746,
// pl.pallas_call at :1107), and bicg_st (K5b;
// legionsolvers_tpu/ops/pallas/bicgstab2d.py:355, pl.pallas_call at :395),
// where ops/cuda/stencil2d.route gives "flat": a 1-D grid of n unknowns
// viewed as [R, C] (parallel/stencil_op.py), its 3-point stencil rewritten
// into (dy, dx) terms whose row-wrap terms have |dx| = C - 1
// (decompose_flat_offsets).  Every pair of those terms reads one flat
// neighbour f -+ 1 of the element f = q C + c, so these kernels run the 1-D
// stencil over the flat vector of n = R C elements, zero outside [0, n),
// and compute what step2_plain, gram2_plain and bicg_st_plain compute on
// the decomposed offsets.  Wrappers, plain versions and the gates live in
// ops/cuda/stencil2d.py and ops/cuda/bicgstab2d.py.
//
// What bounds them: bytes.  K1 moves 24 B per element (reads x, r, p;
// writes x'', r'', p''), K2 and K5b 8 B (read r, p; r, v); a 1-D stencil
// does 3 fma per application, and the Gram's 10 exact products in double
// (K5b: two products) are the other cost.
//
// Design: a march along the flat index.  A warp owns a run of consecutive
// 128-element segments (four elements per lane, one 16-byte load per
// operand) and takes one segment per step, the next ones' loads in flight
// (strip_ring).  A stencil application at a segment takes its +-1
// neighbours from the neighbouring lanes (one shuffle per side) and, at
// the segment's ends, from the element 3 a lane kept of the segment before
// and element 0 of the segment after (lanes 31 and 0 read them): each
// chained stage runs one segment behind the stage it reads.  K1's chain
// (A p, u, A u, r'', p'', A p'', A^2 p'', A r'') reaches 4 elements, K2's
// (A p, A^2 p, A r) 2 and K5b's (t = A s) 1, fewer than a segment holds, so
// a run reads one segment before it and one after it, and the stages
// outside the run start from zeros: the error that makes reaches at most 4
// elements into those segments and never into the run.  No row halo, no
// strip halo: 2 of every run's segments are read twice (3% at 2^24 for K1
// and K2, 6% for K5b's shorter runs).
//
// The stencil is fixed at compile time: the 1-D Laplacian's shifts 0, -1,
// +1 in that order (LS_FLAT_SHIFTS), one fma per term in that order; the
// coefficients are kernel parameters.  Any other 1-D stencil is refused at
// the gate (stencil2d.step2_supported; K5b's route sends it to the band
// march).
// Masks are tested only where a segment leaves [0, n): a warp-uniform
// branch on one 32-bit compare of the segment's index.  Every
// intermediate is zero outside [0, n), which reproduces the JAX mask()
// chain, so the chained applications are true matrix powers.
//
// The sums: K1's and K2's Gram from exact products of the f32 values, K5b's
// <t, s> and <t, t> from products rounded as the strip K5b rounds them
// (__fmul_rn, or exact with `compensated`), summed in double per lane
// (gram_terms_f64), across the block in a fixed order and folded into the
// last block to finish (strip_fold): one launch.  Runs are sized for a
// fixed number of warps (a wave of the pass's resident blocks on an H100
// SXM's 132 SMs, a constant), no shorter than LS_FLAT_MIN_SEGS segments, so
// the sum order is a function of n = R C alone, the same on every card;
// ops/cuda/stencil2d.flat_geometry mirrors it.
//
// Buffers: x in place (each lane reads and writes its own elements of its
// run); r'' and p'' to separate buffers, since neighbouring warps read r
// and p beside their runs.  K5b writes nothing but its two dots.

#include "march2d.cuh"

#define LS_FLAT_SEG 128        // elements of a warp's step: four per lane
#define LS_FLAT_MIN_SEGS 16    // shortest run
// Resident blocks per SM and segments in flight per warp, chosen on the card
// (PERF.md section 6): K1 at 4 blocks (<= 128 registers, no spill
// with 16-byte loads; its scalar-load variant, which only a vector length
// not a multiple of 4 or an unaligned buffer takes, spilled there and runs
// at 3), one segment of p and r in flight and x loaded where S1 updates it;
// K2 at 5 blocks (95 registers), one segment in flight.  Three blocks, two
// segments in flight and x in the ring timed the same or slower.
#define LS_FLAT_STEP2_MIN_BLOCKS 4
#define LS_FLAT_STEP2_SCALAR_MIN_BLOCKS 3
#define LS_FLAT_GRAM2_MIN_BLOCKS 5
#define LS_FLAT_STEP2_DEPTH 1
#define LS_FLAT_GRAM2_DEPTH 1
// K5b at 8 blocks (<= 64 registers) with two segments of r and v in
// flight, as the strip K5b.
#define LS_FLAT_ST_MIN_BLOCKS 8
#define LS_FLAT_ST_DEPTH 2
#define LS_FLAT_STEP2_TARGET_WARPS LS_STRIP_TARGET(LS_FLAT_STEP2_MIN_BLOCKS)
#define LS_FLAT_GRAM2_TARGET_WARPS LS_STRIP_TARGET(LS_FLAT_GRAM2_MIN_BLOCKS)
#define LS_FLAT_ST_TARGET_WARPS LS_STRIP_TARGET(LS_FLAT_ST_MIN_BLOCKS)
// The shifts of the 1-D stencil compiled, in stencil order;
// ops/cuda/stencil2d.FLAT_SHIFTS mirrors them.
#define LS_FLAT_SHIFTS {0, -1, 1}

namespace {

// The runs of a flat launch over n elements aiming at target_warps warps.
struct FlatGeom {
  int segs;        // 128-element segments covering [0, n)
  int run;         // segments of a run (the last may be shorter)
  int runs;        // one warp each
  int blocks;      // of LS_STEP2_WARPS warps
};

FlatGeom flat_geometry(long long n, long long target_warps) {
  const long long segs = (n + LS_FLAT_SEG - 1) / LS_FLAT_SEG;
  long long run = (segs + target_warps - 1) / target_warps;
  if (run < LS_FLAT_MIN_SEGS) run = LS_FLAT_MIN_SEGS;
  const long long runs = (segs + run - 1) / run;
  return FlatGeom{(int)segs, (int)run, (int)runs,
                  (int)((runs + LS_STEP2_WARPS - 1) / LS_STEP2_WARPS)};
}

// The coefficients of the 1-D stencil, in its own order.
struct FlatStencil {
  float v[3];
};

// A v at the lane's four elements of one segment (cur): prev3 is the
// lane's element 3 of the segment before (lane 31's is read), next0 its
// element 0 of the segment after (lane 0's is read).  One fma per term,
// in the stencil's order (LS_FLAT_SHIFTS).
__device__ __forceinline__ Row4 flat_apply(const Row4& cur, float prev3,
                                           float next0,
                                           const FlatStencil& st) {
  const int lane = threadIdx.x & 31;
  const float l = __shfl_sync(kFull, lane == 31 ? prev3 : cur.v[3],
                              (lane + 31) & 31);
  const float r = __shfl_sync(kFull, lane == 0 ? next0 : cur.v[0],
                              (lane + 1) & 31);
  Row4 o;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float left = j ? cur.v[j - 1] : l;
    const float right = j < 3 ? cur.v[j + 1] : r;
    float acc = 0.f;
    acc += st.v[0] * cur.v[j];
    acc += st.v[1] * left;
    acc += st.v[2] * right;
    o.v[j] = acc;
  }
  return o;
}

// The lane's elements of segment s that lie in [0, n): those whose index
// in the segment (4 lane + j) is below the returned limit.  full: the
// segments wholly inside, n / LS_FLAT_SEG.
__device__ __forceinline__ int seg_limit(int s, int full, long long n) {
  if ((unsigned)s < (unsigned)full) return LS_FLAT_SEG;
  if (s < 0) return 0;
  const long long rest = n - (long long)s * LS_FLAT_SEG;
  return rest > 0 ? (int)rest : 0;
}

// Zero the lane's elements of segment s outside [0, n).  A warp-uniform
// branch: only the segments at the vector's ends are masked.
__device__ __forceinline__ void flat_mask(Row4& a, int s, int full,
                                          long long n) {
  if ((unsigned)s < (unsigned)full) return;
  const int lim = seg_limit(s, full, n), e = 4 * (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < 4; ++j) a.v[j] = e + j < lim ? a.v[j] : 0.f;
}

// The lane's four elements of segment s of v, zero outside [0, n) and
// where !live (no load issued).  VEC: one 16-byte load; n % 4 == 0 there,
// so a lane's four elements are all inside or all outside.  NC: through
// the read-only cache (inputs the kernel never writes).
template <bool VEC, bool NC>
__device__ __forceinline__ Row4 flat_seg_load(const float* __restrict__ v,
                                              int s, bool live, int full,
                                              long long n) {
  Row4 o = {{0.f, 0.f, 0.f, 0.f}};
  if (!live) return o;
  const int e = 4 * (threadIdx.x & 31);
  const float* a = v + (long long)s * LS_FLAT_SEG + e;
  if ((unsigned)s < (unsigned)full) {  // warp-uniform: the common path
    if (VEC) {
      const float4 t = NC ? __ldg(reinterpret_cast<const float4*>(a))
                          : *reinterpret_cast<const float4*>(a);
      o = Row4{{t.x, t.y, t.z, t.w}};
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) o.v[j] = NC ? __ldg(a + j) : a[j];
    }
    return o;
  }
  const int lim = seg_limit(s, full, n);
  if (VEC) {
    if (e < lim) {
      const float4 t = NC ? __ldg(reinterpret_cast<const float4*>(a))
                          : *reinterpret_cast<const float4*>(a);
      o = Row4{{t.x, t.y, t.z, t.w}};
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < lim) o.v[j] = NC ? __ldg(a + j) : a[j];
  }
  return o;
}

// Store the lane's elements of segment s (inside [0, n)) of a to dst.
template <bool VEC>
__device__ __forceinline__ void flat_seg_store(float* __restrict__ dst,
                                               int s, const Row4& a,
                                               int full, long long n) {
  const int e = 4 * (threadIdx.x & 31);
  float* d = dst + (long long)s * LS_FLAT_SEG + e;
  const int lim = seg_limit(s, full, n);
  if (VEC) {
    if (e < lim)
      *reinterpret_cast<float4*>(d) =
          make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < lim) d[j] = a.v[j];
  }
}

// A warp's run of segments [a, b), or false past the last run.
__device__ __forceinline__ bool flat_run(const FlatGeom& g, int& a,
                                         int& b) {
  const int unit = blockIdx.x * LS_STEP2_WARPS + (threadIdx.x >> 5);
  if (unit >= g.runs) return false;  // warp-uniform
  a = unit * g.run;
  b = min(a + g.run, g.segs);
  return true;
}

// ---------------------------------------------------------------------------
// K2: the Gram vector (GRAM_NAMES order) of (r, p): A p, A^2 p, A r.  Each
// step takes segment q of p and r and advances two stages:
//   S1 at q-1: A p (zeroed outside [0, n)), A r
//   S2 at q-2: A^2 p, the Gram terms of the run's segments
// over q = a - 1 .. b + 1 (loads of segments past b are skipped: zeros).
// ---------------------------------------------------------------------------
template <int DEPTH, int MINB, bool VEC>
__global__ void __launch_bounds__(LS_STEP2_THREADS, MINB)
flat_gram2_kernel(const float* __restrict__ r, const float* __restrict__ p,
                  float* __restrict__ g_out, double* __restrict__ partials,
                  unsigned* __restrict__ counter, long long n, FlatGeom geo,
                  FlatStencil st) {
  double g[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  int a, b;
  if (flat_run(geo, a, b)) {
    const int full = (int)(n / LS_FLAT_SEG);
    const int e = 4 * (threadIdx.x & 31);
    const Row4 z = {{0.f, 0.f, 0.f, 0.f}};
    Row4 P2 = z, P1 = z, R2 = z, R1 = z;  // p, r at segments q-2, q-1
    Row4 AP2 = z, AR2 = z;                // A p, A r at q-2
    float ap3 = 0.f;                      // A p at q-3, element 3
    strip_ring<DEPTH, 2>(
        a - 1, b + 1,
        [&](Row4 (&dst)[2], int q) {
          dst[0] = flat_seg_load<VEC, true>(p, q, q <= b, full, n);
          dst[1] = flat_seg_load<VEC, true>(r, q, q <= b, full, n);
        },
        [&](int q, const Row4 (&seg)[2]) {
          const Row4& P0 = seg[0];
          const Row4& R0 = seg[1];
          // S1 at q - 1
          Row4 AP1 = flat_apply(P1, P2.v[3], P0.v[0], st);
          flat_mask(AP1, q - 1, full, n);
          const Row4 AR1 = flat_apply(R1, R2.v[3], R0.v[0], st);
          // S2 at q - 2
          const int s2 = q - 2;
          if (s2 >= a) {  // s2 < b: the march ends at q = b + 1
            const Row4 A2 = flat_apply(AP2, ap3, AP1.v[0], st);
            const int lim = seg_limit(s2, full, n);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (e + j < lim)
                gram_terms_f64(g, R2.v[j], P2.v[j], AP2.v[j], A2.v[j],
                               AR2.v[j]);
          }
          P2 = P1; P1 = P0; R2 = R1; R1 = R0;
          ap3 = AP2.v[3]; AP2 = AP1; AR2 = AR1;
        });
  }
  strip_fold<10>(g, partials, counter, g_out);
}

// ---------------------------------------------------------------------------
// K1: u = c0 p + c1 r - c2 A p; x'' = x + u; r'' = r - A u;
//     p'' = r'' + c3 r - c4 A p + c5 p; the Gram of (r'', p'').
// Each step takes segment q of p and r and advances four stages, each
// reading segments the earlier ones left in registers (x is read where S1
// updates it, the lane's own elements of the run):
//   S1 at q-1: A p, u; x += u         (p at q-2 element 3, q-1, q element 0)
//   S2 at q-2: r'' = r - A u, p''     (u at q-3 element 3, q-2, q-1 ...)
//   S3 at q-3: A p''
//   S4 at q-4: A^2 p'', A r'', Gram
// over q = a - 1 .. b + 3 (loads of segments past b are skipped: zeros).
// The elementwise arithmetic is the strip K1's (stencil2d.cu), term for
// term.
// ---------------------------------------------------------------------------
template <int DEPTH, int MINB, bool VEC>
__global__ void __launch_bounds__(LS_STEP2_THREADS, MINB)
flat_step2_kernel(float* __restrict__ x, const float* __restrict__ r,
                  const float* __restrict__ p, const float* __restrict__ coef,
                  float* __restrict__ r_out, float* __restrict__ p_out,
                  float* __restrict__ g_out, double* __restrict__ partials,
                  unsigned* __restrict__ counter, long long n, FlatGeom geo,
                  FlatStencil st) {
  double g[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  int a, b;
  if (flat_run(geo, a, b)) {
    const int full = (int)(n / LS_FLAT_SEG);
    const int e = 4 * (threadIdx.x & 31);
    const float k0 = coef[0], k1 = coef[1], k2 = coef[2];
    const float k3 = coef[3], k4 = coef[4], k5 = coef[5];
    const Row4 z = {{0.f, 0.f, 0.f, 0.f}};
    Row4 P2 = z, P1 = z, R2 = z, R1 = z;  // p, r at segments q-2, q-1
    Row4 AP2 = z, U2 = z;                 // A p, u at q-2
    Row4 RN4 = z, RN3 = z;                // r'' at q-4, q-3
    Row4 PN4 = z, PN3 = z;                // p'' at q-4, q-3
    Row4 APN4 = z;                        // A p'' at q-4
    float u3 = 0.f, rn5 = 0.f, apn5 = 0.f;  // element 3 at q-3, q-5, q-5
    strip_ring<DEPTH, 2>(
        a - 1, b + 3,
        [&](Row4 (&dst)[2], int q) {
          dst[0] = flat_seg_load<VEC, true>(p, q, q <= b, full, n);
          dst[1] = flat_seg_load<VEC, true>(r, q, q <= b, full, n);
        },
        [&](int q, const Row4 (&seg)[2]) {
          const Row4& P0 = seg[0];
          const Row4& R0 = seg[1];
          // S1 at q - 1
          const int s1 = q - 1;
          Row4 AP1 = flat_apply(P1, P2.v[3], P0.v[0], st);
          flat_mask(AP1, s1, full, n);
          Row4 U1;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            U1.v[j] = k0 * P1.v[j] + k1 * R1.v[j] - k2 * AP1.v[j];
          flat_mask(U1, s1, full, n);
          if (s1 >= a && s1 < b) {
            Row4 X1 = flat_seg_load<VEC, false>(x, s1, true, full, n);
#pragma unroll
            for (int j = 0; j < 4; ++j) X1.v[j] = X1.v[j] + U1.v[j];
            flat_seg_store<VEC>(x, s1, X1, full, n);
          }
          // S2 at q - 2
          const int s2 = q - 2;
          const Row4 AU = flat_apply(U2, u3, U1.v[0], st);
          Row4 RN2, PN2;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            RN2.v[j] = R2.v[j] - AU.v[j];
            PN2.v[j] = RN2.v[j] + k3 * R2.v[j] - k4 * AP2.v[j] + k5 * P2.v[j];
          }
          flat_mask(RN2, s2, full, n);
          flat_mask(PN2, s2, full, n);
          if (s2 >= a && s2 < b) {
            flat_seg_store<VEC>(r_out, s2, RN2, full, n);
            flat_seg_store<VEC>(p_out, s2, PN2, full, n);
          }
          // S3 at q - 3
          Row4 APN3 = flat_apply(PN3, PN4.v[3], PN2.v[0], st);
          flat_mask(APN3, q - 3, full, n);
          // S4 at q - 4
          const int s4 = q - 4;
          if (s4 >= a) {  // s4 < b: the march ends at q = b + 3
            const Row4 A2 = flat_apply(APN4, apn5, APN3.v[0], st);
            const Row4 AR = flat_apply(RN4, rn5, RN3.v[0], st);
            const int lim = seg_limit(s4, full, n);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (e + j < lim)
                gram_terms_f64(g, RN4.v[j], PN4.v[j], APN4.v[j], A2.v[j],
                               AR.v[j]);
          }
          P2 = P1; P1 = P0; R2 = R1; R1 = R0;
          AP2 = AP1; u3 = U2.v[3]; U2 = U1;
          rn5 = RN4.v[3]; RN4 = RN3; RN3 = RN2;
          PN4 = PN3; PN3 = PN2;
          apn5 = APN4.v[3]; APN4 = APN3;
        });
  }
  strip_fold<10>(g, partials, counter, g_out);
}

// ---------------------------------------------------------------------------
// K5b: s = r - alpha v, t = A s; <t, s> and <t, t>.  Each step takes
// segment q of r and v, forms s there (zero outside [0, n)) and applies A
// at q - 1, over q = a - 1 .. b.  The products as the strip K5b's
// (bicgstab2d.cu): rounded to f32 (__fmul_rn), or exact with COMP, summed
// in double.
// ---------------------------------------------------------------------------
template <int DEPTH, int MINB, bool COMP, bool VEC>
__global__ void __launch_bounds__(LS_STEP2_THREADS, MINB)
flat_bicg_st_kernel(const float* __restrict__ r, const float* __restrict__ v,
                    const float* __restrict__ alpha_p,
                    float* __restrict__ dot, double* __restrict__ partials,
                    unsigned* __restrict__ counter, long long n, FlatGeom geo,
                    FlatStencil st) {
  double acc[2] = {0.0, 0.0};
  int a, b;
  if (flat_run(geo, a, b)) {
    const int full = (int)(n / LS_FLAT_SEG);
    const int e = 4 * (threadIdx.x & 31);
    const float alpha = *alpha_p;
    auto mul = [](float x, float y) {
      return COMP ? (double)x * (double)y : (double)__fmul_rn(x, y);
    };
    const Row4 z = {{0.f, 0.f, 0.f, 0.f}};
    Row4 S2 = z, S1 = z;  // s at segments q-2, q-1
    strip_ring<DEPTH, 2>(
        a - 1, b,
        [&](Row4 (&dst)[2], int q) {
          dst[0] = flat_seg_load<VEC, true>(r, q, q <= b, full, n);
          dst[1] = flat_seg_load<VEC, true>(v, q, q <= b, full, n);
        },
        [&](int q, const Row4 (&seg)[2]) {
          Row4 S0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            S0.v[j] = seg[0].v[j] - alpha * seg[1].v[j];
          const int s1 = q - 1;
          if (s1 >= a) {  // s1 < b: the march ends at q = b
            const Row4 t = flat_apply(S1, S2.v[3], S0.v[0], st);
            const int lim = seg_limit(s1, full, n);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (e + j < lim) {
                acc[0] += mul(t.v[j], S1.v[j]);
                acc[1] += mul(t.v[j], t.v[j]);
              }
          }
          S2 = S1;
          S1 = S0;
        });
  }
  strip_fold<2>(acc, partials, counter, dot);
}

#define LS_FLAT_STEP2(VEC)                                         \
  flat_step2_kernel<LS_FLAT_STEP2_DEPTH,                         \
                    (VEC) ? LS_FLAT_STEP2_MIN_BLOCKS             \
                          : LS_FLAT_STEP2_SCALAR_MIN_BLOCKS,     \
                    VEC>
#define LS_FLAT_GRAM2(VEC) \
  flat_gram2_kernel<LS_FLAT_GRAM2_DEPTH, LS_FLAT_GRAM2_MIN_BLOCKS, VEC>
#define LS_FLAT_ST(COMP, VEC)                                    \
  flat_bicg_st_kernel<LS_FLAT_ST_DEPTH, LS_FLAT_ST_MIN_BLOCKS, COMP, \
                      VEC>

// Whether st is the 1-D stencil compiled: three terms of dy 0 and the
// shifts LS_FLAT_SHIFTS in that order.
bool flat_stencil_ok(const LsStencil& st) {
  const int shifts[3] = LS_FLAT_SHIFTS;
  if (st.n != 3) return false;
  for (int k = 0; k < 3; ++k)
    if (st.dy[k] != 0 || st.dx[k] != shifts[k]) return false;
  return true;
}

FlatStencil flat_stencil(const LsStencil& st) {
  return FlatStencil{{st.v[0], st.v[1], st.v[2]}};
}

// strip_attrs (registers, spill bytes, blocks per SM) and the kernel's
// static shared memory: out[0..3].
template <typename K>
int flat_attrs(K kernel, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  out[3] = (int)fa.sharedSizeBytes;
  return strip_attrs(kernel, out);
}

}  // namespace

extern "C" {

// K1 on the flat route: x, r, p, r_out, p_out hold the n = R C elements of
// the flat vector; st is the 1-D stencil ((0, s), ...) with the shifts
// LS_FLAT_SHIFTS in that order.  partials: capacity blocks x 10 doubles;
// counter: one unsigned, zero before the first launch (the kernel leaves
// it zero); launches on one (partials, counter) pair must be ordered (one
// stream).
int ls_flat_step2(float* x, const float* r, const float* p, const float* coef,
                  float* r_out, float* p_out, float* g, double* partials,
                  int capacity, unsigned* counter, int R, int C,
                  const LsStencil* st, void* stream_ptr) {
  if (!st || !flat_stencil_ok(*st) || R < 1 || C < 1 || !counter)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * C;
  const FlatGeom geo = flat_geometry(n, LS_FLAT_STEP2_TARGET_WARPS);
  if (geo.blocks > capacity) return (int)cudaErrorInvalidValue;
  const FlatStencil fs = flat_stencil(*st);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n % 4 == 0 && aligned16(x) && aligned16(r) && aligned16(p) &&
      aligned16(r_out) && aligned16(p_out))
    LS_FLAT_STEP2(true)<<<geo.blocks, LS_STEP2_THREADS, 0, stream>>>(
        x, r, p, coef, r_out, p_out, g, partials, counter, n, geo, fs);
  else
    LS_FLAT_STEP2(false)<<<geo.blocks, LS_STEP2_THREADS, 0, stream>>>(
        x, r, p, coef, r_out, p_out, g, partials, counter, n, geo, fs);
  return (int)cudaGetLastError();
}

// K2 on the flat route.  Operands, scratch and stencil as ls_flat_step2's.
int ls_flat_gram2(const float* r, const float* p, float* g, double* partials,
                  int capacity, unsigned* counter, int R, int C,
                  const LsStencil* st, void* stream_ptr) {
  if (!st || !flat_stencil_ok(*st) || R < 1 || C < 1 || !counter)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * C;
  const FlatGeom geo = flat_geometry(n, LS_FLAT_GRAM2_TARGET_WARPS);
  if (geo.blocks > capacity) return (int)cudaErrorInvalidValue;
  const FlatStencil fs = flat_stencil(*st);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n % 4 == 0 && aligned16(r) && aligned16(p))
    LS_FLAT_GRAM2(true)<<<geo.blocks, LS_STEP2_THREADS, 0, stream>>>(
        r, p, g, partials, counter, n, geo, fs);
  else
    LS_FLAT_GRAM2(false)<<<geo.blocks, LS_STEP2_THREADS, 0, stream>>>(
        r, p, g, partials, counter, n, geo, fs);
  return (int)cudaGetLastError();
}

// K5b on the flat route: r and v hold the n = R C elements of the flat
// vector; st is the 1-D stencil as ls_flat_step2's; alpha one float;
// dot: 2 floats.  Scratch as ls_flat_step2's (2 doubles per block).
int ls_flat_bicg_st(const float* r, const float* v, const float* alpha,
                    float* dot, double* partials, int capacity,
                    unsigned* counter, int R, int C, int compensated,
                    const LsStencil* st, void* stream_ptr) {
  if (!st || !flat_stencil_ok(*st) || R < 1 || C < 1 || !counter)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * C;
  const FlatGeom geo = flat_geometry(n, LS_FLAT_ST_TARGET_WARPS);
  if (geo.blocks > capacity) return (int)cudaErrorInvalidValue;
  const FlatStencil fs = flat_stencil(*st);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool vec = n % 4 == 0 && aligned16(r) && aligned16(v);
#define LS_FLAT_ST_LAUNCH(CO, VE)                                        \
  LS_FLAT_ST(CO, VE)<<<geo.blocks, LS_STEP2_THREADS, 0, stream>>>( \
      r, v, alpha, dot, partials, counter, n, geo, fs)
  if (compensated) {
    if (vec) LS_FLAT_ST_LAUNCH(true, true);
    else LS_FLAT_ST_LAUNCH(true, false);
  } else {
    if (vec) LS_FLAT_ST_LAUNCH(false, true);
    else LS_FLAT_ST_LAUNCH(false, false);
  }
#undef LS_FLAT_ST_LAUNCH
  return (int)cudaGetLastError();
}

// The shifts of the compiled 1-D stencil, in its order, to out[0..2].
int ls_flat_shifts(int* out) {
  const int shifts[3] = LS_FLAT_SHIFTS;
  for (int k = 0; k < 3; ++k) out[k] = shifts[k];
  return 0;
}

// {segments, segments of a run, runs, blocks} of a flat launch on an
// [R, C] view whose runs aim at target_warps warps, and the warps each flat
// pass aims at (which: 0 K1, 1 K2, 2 K5b); ops/cuda/stencil2d.py mirrors
// both.
int ls_flat_geometry(int R, int C, int target_warps, long long* out) {
  if (R < 1 || C < 1 || target_warps < 1) return (int)cudaErrorInvalidValue;
  const FlatGeom geo = flat_geometry((long long)R * C, target_warps);
  out[0] = geo.segs;
  out[1] = geo.run;
  out[2] = geo.runs;
  out[3] = geo.blocks;
  return 0;
}

int ls_flat_target_warps(int which) {
  const int t[3] = {LS_FLAT_STEP2_TARGET_WARPS, LS_FLAT_GRAM2_TARGET_WARPS,
                    LS_FLAT_ST_TARGET_WARPS};
  return which >= 0 && which < 3 ? t[which] : -1;
}

// Registers, spill bytes, resident blocks per SM and static shared memory
// of the flat kernel `which` = 2 pass + vec (pass 0 K1, 1 K2, 2 K5b with
// f32 dots, 3 K5b compensated): out[0..3].
int ls_flat_attrs(int which, int* out) {
  switch (which) {
    case 0: return flat_attrs(LS_FLAT_STEP2(false), out);
    case 1: return flat_attrs(LS_FLAT_STEP2(true), out);
    case 2: return flat_attrs(LS_FLAT_GRAM2(false), out);
    case 3: return flat_attrs(LS_FLAT_GRAM2(true), out);
    case 4: return flat_attrs(LS_FLAT_ST(false, false), out);
    case 5: return flat_attrs(LS_FLAT_ST(false, true), out);
    case 6: return flat_attrs(LS_FLAT_ST(true, false), out);
    case 7: return flat_attrs(LS_FLAT_ST(true, true), out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
