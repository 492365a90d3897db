// Fused BiCGStab passes over 3-D grid stencils for Hopper (sm_90a).
//
// Hand-written CUDA ports of the Pallas TPU kernel
// legionsolvers_tpu/ops/pallas/bicgstab3d.py (_bicg3d_call, one pallas_call
// for three modes).  Python wrappers, plain PyTorch versions and the gate
// live in legionsolvers_tpu_torch/ops/cuda/bicgstab3d.py; the entry points
// below have a plain C interface and are loaded with ctypes (build.py).
//
//   ls_bicg3d_pv      K7 pv:     p' = r + beta (p - omega v), v' = A p',
//                                <r~, v'>
//   ls_bicg3d_st      K7 st:     s = r - alpha v, t = A s, <t, s>, <t, t>
//   ls_bicg3d_update  K7 update: x += alpha p + omega s, r' = s - omega t,
//                                <r', r'>, <r~, r'>
//
// What bounds them: bytes, as for K5: one stencil application per element
// against 24 B (pv: reads r, p, v, r~; writes p', v'), 8 B (st: reads r, v)
// and 28 B (update: reads r, v, x, p, r~; writes x', r') per element.
//
// Design: the 2-D passes of bicgstab2d.cu on the 3-D marches of common.cuh
// (see stencil3d.cu).  Each forms the pass's operand (p' for pv, s for st
// and update) as each plane of its window is loaded, so A is applied once
// to it and s, t never reach device memory.  Halo planes are the combined
// operand's own.  Under `compensated` the exact f32 products of the dots
// are accumulated in double and rounded to f32 once.
//
// - All three with a reach-1 stencil (the 7- and 27-point paths) run on
//   march1 (update with f32 dots only: see ls_bicg3d_update), the register
//   march of K6a: a 16 x 128 (y, z) tile per block
//   of 8 warps, 2 rows x 4 columns per thread, the outputs of three planes
//   in registers.  The vectors of the next plane's window (r, p and v for
//   pv; r and v for st and update) are loaded into registers at the top of
//   a step, while this plane is computed, and the operand (p' = r + beta
//   (p - omega v), or s = r - alpha v) is formed and stored into the spare
//   shared slot after it; pv's r~ of the points being finished is loaded
//   before the plane's terms are summed, and update's x, p and r~ are
//   copied with cp.async into dynamic shared memory one plane ahead.  One
//   __syncthreads() per plane; terms unrolled at compile time, as for
//   K6a: the 7-point Laplacian in its stencil order, the 3 x 3 x 3 box
//   plane by plane (x - 1, x, x + 1) and in (oy, oz) order within a plane;
//   geometry set by (X, Y, Z) alone.  The dots (pv's <r~, v'>; st's <t, s>
//   and <t, t>; update's <r', r'> and <r~, r'>) are folded into the last
//   block (a device counter, float or, compensated, double partials summed
//   in block order; st sums in double in both modes, update across threads
//   and blocks): one launch, the same bits from run to run.
//   What bounds them: bytes, with the window's y halo (2 rows per 16, of
//   each vector) read again, mostly from L2, and 2 extra planes per
//   32-plane chunk; st, which stores nothing, moves 8 B per element and
//   has one plane's loads in flight per block to cover their latency.
// - All three with reach 2..8 or a z shift past 8 (up to 128): the window
//   march of K6a and K6b (common.cuh, march_win): a window holding every
//   point a term reads (at Z = 256 the whole z line), the operand (p' from
//   r, p and v; s from r and v) formed once, as a plane is staged into a
//   ring of three x planes, every term read from shared memory, the dots
//   folded into the last block (x chunks aiming at a fixed 396 blocks):
//   one launch.  pv
//   stores p' and v' at the tile's points and loads r~ of them before the
//   terms of each tile row are summed; st stores nothing and sums both
//   tile rows in one pass over the terms; update loads r~ there and
//   prefetches x's and p's lines into L2, then loads x and p at its points
//   as it stores x' and r'.
// - update with compensated dots and a reach-1 stencil: march3d (below), a
//   32 x 32 tile over 16 planes, loads and compute not overlapped, the
//   dots summed by a second launch.
//
// Buffers: pv writes p' and v' to buffers other than p and v, update
// writes r' to a buffer other than r (neighbouring blocks read p, v and r
// through their windows); x is updated in place, because x, p and r~ are
// read only at the thread's own element.

#include "common.cuh"

namespace {

// pv's operand p' = r + beta (p - omega v), and st's s = r - alpha v.
struct PvForm {
  static constexpr int NV = 3;  // r, p, v
  float beta, omega;
  __device__ __forceinline__ float operator()(const float (&x)[3]) const {
    return x[0] + beta * (x[1] - omega * x[2]);
  }
};

struct StForm {
  static constexpr int NV = 2;  // r, v
  float alpha;
  __device__ __forceinline__ float operator()(const float (&x)[2]) const {
    return x[0] - alpha * x[1];
  }
};

// K7 pv on the window march (every stencil off march1: reach 2..8, wide z
// shifts): p' = r + beta (p - omega v) formed as each plane is staged, p'
// and v' = A p' stored at the tile's points, r~ of them loaded before the
// terms of each tile row are summed, <r~, v'> folded into the last block.
// The halo planes are those of p' (the caller combines them).  partials:
// one T per block; counter: zero before the launch, zero after it.
template <bool COMP>
__global__ void __launch_bounds__(LS_W3_THREADS, LS_W3_MIN_BLOCKS)
bicg3d_pv_win_kernel(const float* __restrict__ r, const float* __restrict__ p,
                     const float* __restrict__ v,
                     const float* __restrict__ rt,
                     const float* __restrict__ beta_p,
                     const float* __restrict__ omega_p,
                     const float* __restrict__ top,
                     const float* __restrict__ bot,
                     float* __restrict__ p_out, float* __restrict__ v_out,
                     float* __restrict__ dot,
                     typename Acc<COMP>::T* __restrict__ partials,
                     unsigned* __restrict__ counter, W3Geom g,
                     const __grid_constant__ LsStencil3 st) {
  using T = typename Acc<COMP>::T;
  extern __shared__ __align__(16) float win[];
  __shared__ W3Terms s;
  w3_stage_terms(s, st);
  const W3Place pl = w3_place(g);
  const float* src[3] = {r, p, v};
  float et[LS_W3_COLS];  // r~ of the row
  T acc = 0;
  auto at = [&](int gx, int gy, int z) {
    return ((size_t)gx * g.Y + gy) * g.Z + z;
  };
  march_win<1>(
      win, s, g, pl, src, top, bot, PvForm{*beta_p, *omega_p},
      [&](int gx, int gy) {
#pragma unroll
        for (int c = 0; c < LS_W3_COLS; ++c) {
          const int z = w3_col(pl, c);
          et[c] = gy < g.Y && z < g.Z ? __ldg(rt + at(gx, gy, z)) : 0.f;
        }
      },
      [&](int gx, int gy, int c, int z, float cv, float ax) {
        const size_t o = at(gx, gy, z);
        p_out[o] = cv;
        v_out[o] = ax;
        acc += (T)et[c] * (T)ax;
      });
  m1_fold<T>(acc, partials, counter, dot);
}

// K7 st on the window march (every stencil off march1): s = r - alpha v
// formed as each plane is staged, t = A s summed for both tile rows in one
// pass over the terms, nothing stored; <t, s> and <t, t> summed in double
// as march1's st sums them (the product in f32, or exact under COMP; its
// comment says why an f32 running sum is not enough) and folded into the
// last block.  The halo planes are those of s (the caller combines them).
// partials: two doubles per block; counter: zero before the launch, zero
// after it.
template <bool COMP>
__global__ void __launch_bounds__(LS_W3_THREADS, LS_W3_MIN_BLOCKS)
bicg3d_st_win_kernel(const float* __restrict__ r, const float* __restrict__ v,
                     const float* __restrict__ alpha_p,
                     const float* __restrict__ top,
                     const float* __restrict__ bot, float* __restrict__ dot,
                     double* __restrict__ partials,
                     unsigned* __restrict__ counter, W3Geom g,
                     const __grid_constant__ LsStencil3 st) {
  extern __shared__ __align__(16) float win[];
  __shared__ W3Terms s;
  w3_stage_terms(s, st);
  const W3Place pl = w3_place(g);
  const float* src[2] = {r, v};
  double acc[2] = {0, 0};
  auto mul = [](float a, float b) {
    return COMP ? (double)a * (double)b : (double)__fmul_rn(a, b);
  };
  march_win<2>(win, s, g, pl, src, top, bot, StForm{*alpha_p},
               [](int, int) {},
               [&](int, int, int, int, float c, float ax) {
                 acc[0] += mul(ax, c);
                 acc[1] += mul(ax, ax);
               });
  m1_fold<double, 2>(acc, partials, counter, dot);
}

// K7 update on the window march (every stencil off march1): s formed as st
// forms it, t = A s; before the terms of each tile row are summed
// (march_win's pre), r~ of the thread's points is loaded and x's and p's
// lines are prefetched into L2 (as K6a update's x: held in registers too
// they would spill at the 80 registers that 3 blocks per SM leave); the
// emit loads x and p, stores x' = x + alpha p + omega s in place and r' =
// s - omega t to r_out, rounded as march1's update rounds them.  <r', r'>
// and <r~, r'> are summed as march1's update sums them, in f32 within a
// thread (one fma per product) and in double across threads and blocks,
// or under COMP from exact products in double throughout, and folded into
// the last block.
// partials: two doubles per block; counter as for st.
template <bool COMP>
__global__ void __launch_bounds__(LS_W3_THREADS, LS_W3_MIN_BLOCKS)
bicg3d_update_win_kernel(const float* __restrict__ r,
                         const float* __restrict__ v, float* __restrict__ x,
                         const float* __restrict__ p,
                         const float* __restrict__ rt,
                         const float* __restrict__ alpha_p,
                         const float* __restrict__ omega_p,
                         const float* __restrict__ top,
                         const float* __restrict__ bot,
                         float* __restrict__ r_out, float* __restrict__ dot,
                         double* __restrict__ partials,
                         unsigned* __restrict__ counter, W3Geom g,
                         const __grid_constant__ LsStencil3 st) {
  using T = typename Acc<COMP>::T;
  extern __shared__ __align__(16) float win[];
  __shared__ W3Terms s;
  w3_stage_terms(s, st);
  const W3Place pl = w3_place(g);
  const float* src[2] = {r, v};
  const float alpha = *alpha_p, omega = *omega_p;
  float et[LS_W3_COLS];  // r~ of the row
  T acc[2] = {0, 0};
  auto at = [&](int gx, int gy, int z) {
    return ((size_t)gx * g.Y + gy) * g.Z + z;
  };
  march_win<1>(
      win, s, g, pl, src, top, bot, StForm{alpha},
      [&](int gx, int gy) {
#pragma unroll
        for (int c = 0; c < LS_W3_COLS; ++c) {
          const int z = w3_col(pl, c);
          const bool in = gy < g.Y && z < g.Z;
          et[c] = in ? __ldg(rt + at(gx, gy, z)) : 0.f;
          if (in) {
            prefetch_l2(x + at(gx, gy, z));
            prefetch_l2(p + at(gx, gy, z));
          }
        }
      },
      [&](int gx, int gy, int c, int z, float cv, float ax) {
        const size_t o = at(gx, gy, z);
        x[o] = x[o] + alpha * p[o] + omega * cv;
        const float rn = cv - omega * ax;
        r_out[o] = rn;
        acc[0] += (T)rn * (T)rn;
        acc[1] += (T)et[c] * (T)rn;
      });
  double sum[2] = {acc[0], acc[1]};
  m1_fold<double, 2>(sum, partials, counter, dot);
}

// Devices whose dynamic shared-memory attribute is set, by K7 window
// kernel (0 pv, 1 st, 2 update) and COMP.
unsigned win_done[3][2] = {};

// Registers, spill bytes and resident blocks per SM of K7's window kernel
// `which` = 2 pass + compensated (pass 0 pv, 1 st, 2 update) launched with
// `smem` bytes.
int win_attrs(int which, size_t smem, int* out) {
  switch (which) {
#define LS_WIN_ATTR(P, C, K) \
  case 2 * P + C: return w3_attrs(K<C>, win_done[P][C], smem, out);
    LS_WIN_ATTR(0, 0, bicg3d_pv_win_kernel)
    LS_WIN_ATTR(0, 1, bicg3d_pv_win_kernel)
    LS_WIN_ATTR(1, 0, bicg3d_st_win_kernel)
    LS_WIN_ATTR(1, 1, bicg3d_st_win_kernel)
    LS_WIN_ATTR(2, 0, bicg3d_update_win_kernel)
    LS_WIN_ATTR(2, 1, bicg3d_update_win_kernel)
#undef LS_WIN_ATTR
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7 pv on march1 (reach 1).  partials: one T per block; counter: zero
// before the launch, zero after it.
template <bool COMP, bool STAR, bool VEC>
__global__ void __launch_bounds__(LS_M1_THREADS, LS_M1_MIN_BLOCKS)
bicg3d_pv_m1_kernel(const float* __restrict__ r, const float* __restrict__ p,
                    const float* __restrict__ v, const float* __restrict__ rt,
                    const float* __restrict__ beta_p,
                    const float* __restrict__ omega_p,
                    const float* __restrict__ top,
                    const float* __restrict__ bot, float* __restrict__ p_out,
                    float* __restrict__ v_out, float* __restrict__ dot,
                    typename Acc<COMP>::T* __restrict__ partials,
                    unsigned* __restrict__ counter, M1Geom g, Box27 w) {
  using T = typename Acc<COMP>::T;
  __shared__ __align__(16) float win[3 * kM1Slot];
  const M1Place pl = m1_place(g);
  const int ncol = m1_ncol(pl, g.Z);
  M1FormPlane<PvForm, VEC> plane{{r, p, v}, top, bot,
                                 PvForm{*beta_p, *omega_p}, g, pl};
  float et[LS_M1_RY][4];  // r~ of the points being finished
  T acc = 0;
  auto at = [&](int gx, int k) {
    return ((size_t)gx * g.Y + pl.gy[k]) * g.Z + pl.gz;
  };
  march1<STAR>(
      win, pl, w, plane,
      [&](int gx) {
#pragma unroll
        for (int k = 0; k < LS_M1_RY; ++k)
          m1_load4<VEC>(et[k], rt, at(gx, k), pl.gy[k] < g.Y ? ncol : 0);
      },
      [&](int gx, const float (&c)[LS_M1_RY][4],
          const float (&ax)[LS_M1_RY][4]) {
#pragma unroll
        for (int k = 0; k < LS_M1_RY; ++k) {
          if (pl.gy[k] >= g.Y || !ncol) continue;
          const size_t o = at(gx, k);
          m1_store4<VEC>(p_out, o, c[k], ncol);
          m1_store4<VEC>(v_out, o, ax[k], ncol);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < ncol) acc += (T)et[k][j] * (T)ax[k][j];
        }
      });
  m1_fold<T>(acc, partials, counter, dot);
}

// K7 st on march1 (reach 1): nothing stored; <t, s> and <t, t> folded into
// the last block.  Both modes sum in double (partials: two doubles per
// block; counter as for pv): with `compensated` the exact products, else
// the products rounded to f32, as K1 sums its Gram.  A thread here sums
// 256 products of a 32-plane chunk; an f32 running sum that long strayed
// further from float64 than the reductions of textbook f32 BiCGStab do,
// and on the 7-point system, where f32 BiCGStab amplifies a dot's rounding
// ~1e3-fold per iteration, left float64 one iteration earlier than they.
template <bool COMP, bool STAR, bool VEC>
__global__ void __launch_bounds__(LS_M1_THREADS, LS_M1_MIN_BLOCKS)
bicg3d_st_m1_kernel(const float* __restrict__ r, const float* __restrict__ v,
                    const float* __restrict__ alpha_p,
                    const float* __restrict__ top,
                    const float* __restrict__ bot, float* __restrict__ dot,
                    double* __restrict__ partials,
                    unsigned* __restrict__ counter, M1Geom g, Box27 w) {
  __shared__ __align__(16) float win[3 * kM1Slot];
  const M1Place pl = m1_place(g);
  const int ncol = m1_ncol(pl, g.Z);
  M1FormPlane<StForm, VEC> plane{{r, v}, top, bot, StForm{*alpha_p}, g, pl};
  double acc[2] = {0, 0};
  // the product in f32 (rounded alone) or exact in double
  auto mul = [](float a, float b) {
    return COMP ? (double)a * (double)b : (double)__fmul_rn(a, b);
  };
  march1<STAR>(
      win, pl, w, plane, [](int) {},
      [&](int, const float (&c)[LS_M1_RY][4],
          const float (&ax)[LS_M1_RY][4]) {
#pragma unroll
        for (int k = 0; k < LS_M1_RY; ++k) {
          if (pl.gy[k] >= g.Y) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < ncol) {
              acc[0] += mul(ax[k][j], c[k][j]);
              acc[1] += mul(ax[k][j], ax[k][j]);
            }
        }
      });
  m1_fold<double, 2>(acc, partials, counter, dot);
}

// K7 update on march1 (reach 1), f32 dots: s formed as st forms it, x' =
// x + alpha p + omega s (in place) and r' = s - omega t stored at the
// thread's points and rounded as the window kernel rounds them, <r',
// r'> and <r~, r'> summed in f32 within a thread (one fma per product, as
// pv sums its dot) and in double across threads and blocks, folded into
// the last block.  Of the sum orders chip_smoke.py --breakdown compared
// over 16 right-hand sides, this one and those summing in double
// throughout kept f32 BiCGStab within 1e-3 of float64 as long as textbook
// f32 on 15 of them, f32 alone on 11, and it alone of those also did so at
// b = 1, phase 4d's system (PERF.md §6).  With `compensated` the pass runs
// march3d: see ls_bicg3d_update.  x, p and r~ of the thread's points are
// copied with cp.async into a private slot of dynamic shared memory one
// plane ahead (two slots in turn, the one of plane gx - x0 even or odd),
// so their loads overlap a whole plane's step and hold no registers
// across it; each thread reads back only what it copied, so only its
// own cp.async.wait_group orders them.
constexpr int kUpdVecs = 3;  // x, p, r~
constexpr int kUpdSlot = kUpdVecs * LS_M1_RY * 4 * LS_M1_THREADS;  // floats
constexpr int kUpdSmem = (3 * kM1Slot + 2 * kUpdSlot) * (int)sizeof(float);

template <bool STAR, bool VEC>
__global__ void __launch_bounds__(LS_M1_THREADS, LS_M1_MIN_BLOCKS)
bicg3d_update_m1_kernel(const float* __restrict__ r,
                        const float* __restrict__ v, float* __restrict__ x,
                        const float* __restrict__ p,
                        const float* __restrict__ rt,
                        const float* __restrict__ alpha_p,
                        const float* __restrict__ omega_p,
                        const float* __restrict__ top,
                        const float* __restrict__ bot,
                        float* __restrict__ r_out, float* __restrict__ dot,
                        float* __restrict__ partials,
                        unsigned* __restrict__ counter, M1Geom g, Box27 w) {
  extern __shared__ __align__(16) float smem[];
  float* win = smem;
  const M1Place pl = m1_place(g);
  const int ncol = m1_ncol(pl, g.Z);
  const float alpha = *alpha_p, omega = *omega_p;
  M1FormPlane<StForm, VEC> plane{{r, v}, top, bot, StForm{alpha}, g, pl};
  const float* const src[kUpdVecs] = {x, p, rt};
  auto at = [&](int gx, int k) {
    return ((size_t)gx * g.Y + pl.gy[k]) * g.Z + pl.gz;
  };
  // the thread's 16 bytes of vector i, row k, plane gx
  auto slot = [&](int gx, int i, int k) {
    return smem + 3 * kM1Slot + ((gx - pl.x0) & 1) * kUpdSlot +
           ((i * LS_M1_RY + k) * LS_M1_THREADS + threadIdx.x) * 4;
  };
  // copies of plane gx (none past the chunk: an empty group)
  auto stage = [&](int gx) {
    if (gx < pl.x1) {
#pragma unroll
      for (int k = 0; k < LS_M1_RY; ++k) {
        const int n = pl.gy[k] < g.Y ? ncol : 0;
#pragma unroll
        for (int i = 0; i < kUpdVecs; ++i) {
          float* d = slot(gx, i, k);
          const size_t o = at(gx, k);
          if (VEC) {
            if (n) cp_async16_zfill(d, src[i] + o, true);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              cp_async4_zfill(d + j, j < n ? src[i] + o + j : src[i], j < n);
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float acc[2] = {0.f, 0.f};
  stage(pl.x0);
  march1<STAR>(
      win, pl, w, plane, [&](int gx) { stage(gx + 1); },
      [&](int gx, const float (&c)[LS_M1_RY][4],
          const float (&ax)[LS_M1_RY][4]) {
        // plane gx's copies done; gx + 1's may still be in flight
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < LS_M1_RY; ++k) {
          if (pl.gy[k] >= g.Y || !ncol) continue;
          const size_t o = at(gx, k);
          float e[kUpdVecs][4];
#pragma unroll
          for (int i = 0; i < kUpdVecs; ++i) {
            const float4 t = *reinterpret_cast<const float4*>(slot(gx, i, k));
            e[i][0] = t.x; e[i][1] = t.y; e[i][2] = t.z; e[i][3] = t.w;
          }
          float xn[4], rn[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            xn[j] = e[0][j] + alpha * e[1][j] + omega * c[k][j];
            rn[j] = c[k][j] - omega * ax[k][j];
          }
          m1_store4<VEC>(x, o, xn, ncol);
          m1_store4<VEC>(r_out, o, rn, ncol);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < ncol) {
              acc[0] += rn[j] * rn[j];
              acc[1] += e[2][j] * rn[j];
            }
        }
      });
  double sum[2] = {acc[0], acc[1]};
  m1_fold<double, 2>(sum, (double*)partials, counter, dot);
}

// ---------------------------------------------------------------------------
// K7 update with compensated dots on a reach-1 stencil: march3d, the march
// this pass ran off march1 before the window march, kept for this one case
// (ls_bicg3d_update says why).  A block of LS_THREADS owns one LS_TILE x
// LS_TILE (y, z) output tile and marches along x over LS_CHUNK_X planes.
// Shared memory holds three planes (x - 1, x, x + 1) of the block's window,
// the tile plus h = max(|oy|, |oz|) <= 1 on each side, in three slots that
// rotate one plane per step; window points outside [0, Y) x [0, Z) are
// zero, planes -1 and X come from the halo planes (nullptr = zeros).  s =
// r - alpha v is formed as each window point is loaded; loads and compute
// are not overlapped; each term is one fma in stencil order; the exact
// products of the dots are summed in double per thread, then per block
// into a [blocks, 2] scratch that a second launch sums (reduce_partials).
// ---------------------------------------------------------------------------
#define LS_CHUNK_X 16

constexpr int kM3W = LS_TILE + 2;      // the window's edge at reach 1
constexpr int kM3Plane = kM3W * kM3W;  // slot stride

// Terms with their window offsets for each rotation phase: the plane of
// step x sits in slot (x - x0 + 1) % 3, so in phase ph = (x - x0) % 3 the
// term (ox, oy, oz) reads slot (ph + 1 + ox) % 3 at oy * W + oz from the
// thread's point.
struct M3Terms {
  int n;
  int off[3][LS_MAX_TERMS];
  float v[LS_MAX_TERMS];
};

__device__ void m3_stage_terms(M3Terms& s, const LsStencil3& st, int W) {
  if (tid() == 0) s.n = st.n;
  for (int e = tid(); e < 3 * st.n; e += LS_THREADS) {
    const int ph = e / st.n, k = e % st.n;
    const int slot = (ph + 1 + st.ox[k] + 3) % 3;
    s.off[ph][k] = slot * kM3Plane + st.oy[k] * W + st.oz[k];
    if (ph == 0) s.v[k] = st.v[k];
  }
}

// Fill one slot with plane gx of the window: f(flat index) inside the
// volume, the halo planes at gx = -1 and gx = X, zero outside [0, Y) x
// [0, Z).  Neighbouring threads read neighbouring addresses.
template <typename F>
__device__ __forceinline__ void m3_load_plane(float* dst, int W, int h,
                                              int gx, int y0, int z0, int X,
                                              int Y, int Z,
                                              const float* __restrict__ top,
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

// The block's march: emit(flat index, operand, A operand) once for every
// point of the tile inside the volume.
template <typename F, typename E>
__device__ void march3d(float* win, const M3Terms& s, int h, int X, int Y,
                        int Z, const float* __restrict__ top,
                        const float* __restrict__ bot, F f, E emit) {
  const int W = LS_TILE + 2 * h;
  const int z0 = blockIdx.x * LS_TILE, y0 = blockIdx.y * LS_TILE;
  const int x0 = blockIdx.z * LS_CHUNK_X;
  const int x1 = x0 + LS_CHUNK_X < X ? x0 + LS_CHUNK_X : X;
  m3_load_plane(win, W, h, x0 - 1, y0, z0, X, Y, Z, top, bot, f);
  m3_load_plane(win + kM3Plane, W, h, x0, y0, z0, X, Y, Z, top, bot, f);
  const int j = threadIdx.x, gz = z0 + j;
  for (int x = x0; x < x1; ++x) {
    const int ph = (x - x0) % 3;
    m3_load_plane(win + ((ph + 2) % 3) * kM3Plane, W, h, x + 1, y0, z0, X,
                  Y, Z, top, bot, f);
    __syncthreads();
    const float* center = win + ((ph + 1) % 3) * kM3Plane;
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

// max(|oy|, |oz|) over a reach-1 stencil's terms: 0 or 1.
int m3_reach(const LsStencil3& st) {
  int h = 0;
  for (int k = 0; k < st.n; ++k)
    if (st.oy[k] || st.oz[k]) h = 1;
  return h;
}

dim3 m3_grid(int X, int Y, int Z) {
  return dim3((Z + LS_TILE - 1) / LS_TILE, (Y + LS_TILE - 1) / LS_TILE,
              (X + LS_CHUNK_X - 1) / LS_CHUNK_X);
}

// K7 update with compensated dots on march3d: s and t = A s; x += alpha p
// + omega s (in place); r' = s - omega t (to r_out); <r', r'>, <r~, r'>.
__global__ void __launch_bounds__(LS_THREADS)
bicg3d_update_m3_kernel(const float* __restrict__ r,
                        const float* __restrict__ v, float* __restrict__ x,
                        const float* __restrict__ p,
                        const float* __restrict__ rt,
                        const float* __restrict__ alpha_p,
                        const float* __restrict__ omega_p,
                        const float* __restrict__ top,
                        const float* __restrict__ bot,
                        float* __restrict__ r_out,
                        double* __restrict__ partials, int X, int Y, int Z,
                        LsStencil3 st, int h) {
  __shared__ float win[3 * kM3Plane];
  __shared__ M3Terms s;
  m3_stage_terms(s, st, LS_TILE + 2 * h);
  const float alpha = *alpha_p, omega = *omega_p;
  double acc[2] = {0, 0};
  march3d(win, s, h, X, Y, Z, top, bot,
          [&](size_t idx) { return r[idx] - alpha * v[idx]; },
          [&](size_t idx, float c, float ax) {
            x[idx] = x[idx] + alpha * p[idx] + omega * c;
            const float rn = c - omega * ax;
            r_out[idx] = rn;
            acc[0] += (double)rn * (double)rn;
            acc[1] += (double)rt[idx] * (double)rn;
          });
  block_partials(acc, partials);
}

template <bool COMP>
int launch_pv_m1(bool star, bool vec, unsigned blocks, cudaStream_t stream,
                 const float* r, const float* p, const float* v,
                 const float* rt, const float* beta, const float* omega,
                 const float* top, const float* bot, float* p_out,
                 float* v_out, float* dot, void* partials, unsigned* counter,
                 const M1Geom& g, const Box27& w) {
  using T = typename Acc<COMP>::T;
#define LS_PV_LAUNCH(ST, VE)                                                 \
  bicg3d_pv_m1_kernel<COMP, ST, VE><<<blocks, LS_M1_THREADS, 0, stream>>>(  \
      r, p, v, rt, beta, omega, top, bot, p_out, v_out, dot, (T*)partials,  \
      counter, g, w)
  if (star) {
    if (vec) LS_PV_LAUNCH(true, true); else LS_PV_LAUNCH(true, false);
  } else {
    if (vec) LS_PV_LAUNCH(false, true); else LS_PV_LAUNCH(false, false);
  }
#undef LS_PV_LAUNCH
  return (int)cudaGetLastError();
}

template <bool COMP>
int launch_st_m1(bool star, bool vec, unsigned blocks, cudaStream_t stream,
                 const float* r, const float* v, const float* alpha,
                 const float* top, const float* bot, float* dot,
                 void* partials, unsigned* counter, const M1Geom& g,
                 const Box27& w) {
#define LS_ST_LAUNCH(ST, VE)                                                \
  bicg3d_st_m1_kernel<COMP, ST, VE><<<blocks, LS_M1_THREADS, 0, stream>>>( \
      r, v, alpha, top, bot, dot, (double*)partials, counter, g, w)
  if (star) {
    if (vec) LS_ST_LAUNCH(true, true); else LS_ST_LAUNCH(true, false);
  } else {
    if (vec) LS_ST_LAUNCH(false, true); else LS_ST_LAUNCH(false, false);
  }
#undef LS_ST_LAUNCH
  return (int)cudaGetLastError();
}

template <bool STAR, bool VEC>
int update_m1_ready() {
  static unsigned done = 0;
  return dyn_smem_ready(bicg3d_update_m1_kernel<STAR, VEC>, kUpdSmem, done);
}

int launch_update_m1(bool star, bool vec, unsigned blocks,
                     cudaStream_t stream, const float* r, const float* v,
                     float* x, const float* p, const float* rt,
                     const float* alpha, const float* omega,
                     const float* top, const float* bot, float* r_out,
                     float* dot, void* partials, unsigned* counter,
                     const M1Geom& g, const Box27& w) {
#define LS_UP_LAUNCH(ST, VE)                                                 \
  do {                                                                       \
    const int err = update_m1_ready<ST, VE>();                               \
    if (err) return err;                                                     \
    bicg3d_update_m1_kernel<ST, VE>                                          \
        <<<blocks, LS_M1_THREADS, kUpdSmem, stream>>>(                       \
            r, v, x, p, rt, alpha, omega, top, bot, r_out, dot,              \
            (float*)partials, counter, g, w);                                \
  } while (0)
  if (star) {
    if (vec) LS_UP_LAUNCH(true, true); else LS_UP_LAUNCH(true, false);
  } else {
    if (vec) LS_UP_LAUNCH(false, true); else LS_UP_LAUNCH(false, false);
  }
#undef LS_UP_LAUNCH
  return (int)cudaGetLastError();
}

// Launch K7's window kernel of pass P (0 pv, 1 st, 2 update) with COMP
// dots, its dynamic shared-memory attribute set first.
template <int P, bool COMP, typename K, typename... A>
int launch_win(K kernel, unsigned blocks, size_t smem, cudaStream_t stream,
               A... args) {
  const int err = dyn_smem_ready(kernel, kW3SmemMax, win_done[P][COMP]);
  if (err) return err;
  kernel<<<blocks, LS_W3_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Registers, spill bytes and resident blocks per SM of K7 pv's and st's
// march1 variant `which` = 4 compensated + 2 star + vec.
int ls_bicg3d_pv_m1_attrs(int which, int* out) {
  switch (which) {
#define LS_PV_ATTR(C, ST, VE) \
  case 4 * C + 2 * ST + VE: return m1_attrs(bicg3d_pv_m1_kernel<C, ST, VE>, out);
    LS_PV_ATTR(0, 0, 0) LS_PV_ATTR(0, 0, 1) LS_PV_ATTR(0, 1, 0)
    LS_PV_ATTR(0, 1, 1) LS_PV_ATTR(1, 0, 0) LS_PV_ATTR(1, 0, 1)
    LS_PV_ATTR(1, 1, 0) LS_PV_ATTR(1, 1, 1)
#undef LS_PV_ATTR
    default: return (int)cudaErrorInvalidValue;
  }
}

int ls_bicg3d_st_m1_attrs(int which, int* out) {
  switch (which) {
#define LS_ST_ATTR(C, ST, VE) \
  case 4 * C + 2 * ST + VE: return m1_attrs(bicg3d_st_m1_kernel<C, ST, VE>, out);
    LS_ST_ATTR(0, 0, 0) LS_ST_ATTR(0, 0, 1) LS_ST_ATTR(0, 1, 0)
    LS_ST_ATTR(0, 1, 1) LS_ST_ATTR(1, 0, 0) LS_ST_ATTR(1, 0, 1)
    LS_ST_ATTR(1, 1, 0) LS_ST_ATTR(1, 1, 1)
#undef LS_ST_ATTR
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7 update's march1 variant `which` = 2 star + vec (f32 dots only).
int ls_bicg3d_update_m1_attrs(int which, int* out) {
  switch (which) {
#define LS_UP_ATTR(ST, VE)                                           \
  case 2 * ST + VE: {                                                \
    const int err = update_m1_ready<ST, VE>();                       \
    if (err) return err;                                             \
    return m1_attrs(bicg3d_update_m1_kernel<ST, VE>, out, kUpdSmem); \
  }
    LS_UP_ATTR(0, 0) LS_UP_ATTR(0, 1) LS_UP_ATTR(1, 0) LS_UP_ATTR(1, 1)
#undef LS_UP_ATTR
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same of K7's window kernels at the largest window's shared memory:
// `which` = 2 pass + compensated, pass 0 pv, 1 st, 2 update.
int ls_bicg3d_attrs(int which, int* out) {
  return win_attrs(which, kW3SmemMax, out);
}

// out = {registers, spill bytes, resident blocks per SM, dynamic shared
// memory bytes, blocks} of K7's window kernel `which` (as for
// ls_bicg3d_attrs) on [X, Y, Z] with st.
int ls_bicg3d_win_attrs(int which, int X, int Y, int Z, const LsStencil3* st,
                        int* out) {
  const size_t smem = w3_shape(X, Y, Z, st, out);
  return smem ? win_attrs(which, smem, out) : (int)cudaErrorInvalidValue;
}

// partials: scratch of 2 * capacity doubles (the K <= 2 dots of each of up
// to capacity blocks; pv's floats without `compensated`, st's and update's
// doubles).  counter: one unsigned, zero before the first launch (every
// launch leaves it zero); launches on one (partials, counter) pair must be
// ordered (one stream).  dot: K floats.  Halo planes may be null (zeros).
int ls_bicg3d_pv(const float* r, const float* p, const float* v,
                 const float* rt, const float* beta, const float* omega,
                 const float* top, const float* bot, float* p_out,
                 float* v_out, float* dot, void* partials, int capacity,
                 unsigned* counter, int X, int Y, int Z, int compensated,
                 const LsStencil3* st, void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (on_march1(*st)) {
    M1Geom g;
    const long long blocks = m1_geometry(X, Y, Z, &g);
    if (!counter || blocks > capacity) return (int)cudaErrorInvalidValue;
    Box27 w;
    const bool star = m1_box(*st, &w);
    const bool vec = Z % 4 == 0 && m1_aligned(r) && m1_aligned(p) &&
                     m1_aligned(v) && m1_aligned(rt) && m1_aligned(top) &&
                     m1_aligned(bot) && m1_aligned(p_out) &&
                     m1_aligned(v_out);
    const unsigned nb = (unsigned)blocks;
    if (compensated)
      return launch_pv_m1<true>(star, vec, nb, stream, r, p, v, rt, beta,
                                omega, top, bot, p_out, v_out, dot, partials,
                                counter, g, w);
    return launch_pv_m1<false>(star, vec, nb, stream, r, p, v, rt, beta,
                               omega, top, bot, p_out, v_out, dot, partials,
                               counter, g, w);
  }
  W3Geom g;
  const long long blocks = w3_geometry(X, Y, Z, *st, &g);
  if (!counter || blocks > capacity) return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  const size_t smem = w3_smem(g);
  if (compensated)
    return launch_win<0, true>(bicg3d_pv_win_kernel<true>, nb, smem, stream,
                               r, p, v, rt, beta, omega, top, bot, p_out,
                               v_out, dot, (double*)partials, counter, g,
                               *st);
  return launch_win<0, false>(bicg3d_pv_win_kernel<false>, nb, smem, stream,
                              r, p, v, rt, beta, omega, top, bot, p_out,
                              v_out, dot, (float*)partials, counter, g, *st);
}

int ls_chunk_x() { return LS_CHUNK_X; }

int ls_bicg3d_st(const float* r, const float* v, const float* alpha,
                 const float* top, const float* bot, float* dot,
                 void* partials, int capacity, unsigned* counter, int X,
                 int Y, int Z, int compensated, const LsStencil3* st,
                 void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (on_march1(*st)) {
    M1Geom g;
    const long long blocks = m1_geometry(X, Y, Z, &g);
    if (!counter || blocks > capacity) return (int)cudaErrorInvalidValue;
    Box27 w;
    const bool star = m1_box(*st, &w);
    const bool vec = Z % 4 == 0 && m1_aligned(r) && m1_aligned(v) &&
                     m1_aligned(top) && m1_aligned(bot);
    const unsigned nb = (unsigned)blocks;
    if (compensated)
      return launch_st_m1<true>(star, vec, nb, stream, r, v, alpha, top, bot,
                                dot, partials, counter, g, w);
    return launch_st_m1<false>(star, vec, nb, stream, r, v, alpha, top, bot,
                               dot, partials, counter, g, w);
  }
  W3Geom g;
  const long long blocks = w3_geometry(X, Y, Z, *st, &g);
  if (!counter || blocks > capacity) return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  const size_t smem = w3_smem(g);
  if (compensated)
    return launch_win<1, true>(bicg3d_st_win_kernel<true>, nb, smem, stream,
                               r, v, alpha, top, bot, dot, (double*)partials,
                               counter, g, *st);
  return launch_win<1, false>(bicg3d_st_win_kernel<false>, nb, smem, stream,
                              r, v, alpha, top, bot, dot, (double*)partials,
                              counter, g, *st);
}

// K7 update: march1 for a reach-1 stencil with f32 dots, march3d and a
// second launch for one with compensated dots, the window march for every
// other stencil.  Late in the 7-point solve at 256^3 f32 BiCGStab is
// chaotic, and phase 4d of chip_smoke.py holds the compensated run's end
// to twice textbook f32's error, which march3d meets and march1 versions
// with exactly rounded dots missed; so did the window kernel, which forms
// s, t, x' and r' with march3d's roundings and sums the same exact
// products in double in another order (PERF.md §6).
int ls_bicg3d_update(const float* r, const float* v, float* x, const float* p,
                     const float* rt, const float* alpha, const float* omega,
                     const float* top, const float* bot, float* r_out,
                     float* dot, void* partials, int capacity,
                     unsigned* counter, int X, int Y, int Z, int compensated,
                     const LsStencil3* st, void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (on_march1(*st) && compensated) {
    const dim3 grid = m3_grid(X, Y, Z), block(LS_THREADS_X, LS_THREADS_Y);
    const int nblocks = grid.x * grid.y * grid.z;
    if (nblocks > capacity) return (int)cudaErrorInvalidValue;
    bicg3d_update_m3_kernel<<<grid, block, 0, stream>>>(
        r, v, x, p, rt, alpha, omega, top, bot, r_out, (double*)partials, X,
        Y, Z, *st, m3_reach(*st));
    return finish((const double*)partials, nblocks, 2, dot, stream);
  }
  if (on_march1(*st)) {
    M1Geom g;
    const long long blocks = m1_geometry(X, Y, Z, &g);
    if (!counter || blocks > capacity) return (int)cudaErrorInvalidValue;
    Box27 w;
    const bool star = m1_box(*st, &w);
    const bool vec = Z % 4 == 0 && m1_aligned(r) && m1_aligned(v) &&
                     m1_aligned(x) && m1_aligned(p) && m1_aligned(rt) &&
                     m1_aligned(top) && m1_aligned(bot) &&
                     m1_aligned(r_out);
    return launch_update_m1(star, vec, (unsigned)blocks, stream, r, v, x, p,
                            rt, alpha, omega, top, bot, r_out, dot,
                            partials, counter, g, w);
  }
  W3Geom g;
  const long long blocks = w3_geometry(X, Y, Z, *st, &g);
  if (!counter || blocks > capacity) return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  const size_t smem = w3_smem(g);
  if (compensated)
    return launch_win<2, true>(bicg3d_update_win_kernel<true>, nb, smem,
                               stream, r, v, x, p, rt, alpha, omega, top, bot,
                               r_out, dot, (double*)partials, counter, g,
                               *st);
  return launch_win<2, false>(bicg3d_update_win_kernel<false>, nb, smem,
                              stream, r, v, x, p, rt, alpha, omega, top, bot,
                              r_out, dot, (double*)partials, counter, g, *st);
}

}  // extern "C"
