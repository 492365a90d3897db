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
// - pv with reach 2..8 or a z shift past 8 (up to 128): the window march
//   of K6a and K6b (common.cuh, march_win): a window holding every point a
//   term reads (at Z = 256 the whole z line), p' formed from r, p and v
//   once, as a plane is staged into a ring of three x planes, every term
//   read from shared memory, p' and v' stored at the tile's points, r~ of
//   them loaded before the terms of each tile row are summed, <r~, v'>
//   folded into the last block (float or, compensated, double partials;
//   x chunks aiming at a fixed 396 blocks): one launch.
// - st and update with reach 2..8 or a z shift past 8, and update with
//   compensated dots on every stencil, run on march3d: a 32 x 32 tile over
//   16 planes, the terms from shared memory, the wide ones beside the
//   window (wide_at, common.cuh), where the pass's operand is formed from
//   device memory at the shifted point as the window's points are (s from
//   r and v: the same rounding), loads and compute not overlapped, dots to
//   a [blocks, k] scratch summed in a fixed order by a second launch.
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

unsigned pv_win_done[2] = {};  // devices whose attribute is set, by COMP

template <bool COMP>
int pv_win_attrs(size_t smem, int* out) {
  return w3_attrs(bicg3d_pv_win_kernel<COMP>, pv_win_done[COMP], smem, out);
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

// K7 st on march3d (reach 2..8, wide z shifts): s = r - alpha v on the
// window, t = A s; <t, s>, <t, t>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg3d_st_kernel(const float* __restrict__ r, const float* __restrict__ v,
                 const float* __restrict__ alpha_p,
                 const float* __restrict__ top, const float* __restrict__ bot,
                 typename Acc<COMP>::T* __restrict__ partials, int X, int Y,
                 int Z, LsStencil3 st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float win[3 * kPlaneMax];
  __shared__ SharedStencil3 s;
  stage_stencil3(s, st, LS_TILE + 2 * h);
  const float alpha = *alpha_p;
  T acc[2] = {0, 0};
  march3d(win, s, h, X, Y, Z, top, bot,
          [&](size_t idx) { return r[idx] - alpha * v[idx]; },
          [&](size_t idx, float c, float ax) {
            acc[0] += (T)ax * (T)c;
            acc[1] += (T)ax * (T)ax;
          });
  block_partials(acc, partials);
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

// K7 update on march3d (reach 2..8, wide z shifts): s and t = A s as in
// st; x += alpha p + omega s (in place); r' = s - omega t (to r_out);
// <r', r'>, <r~, r'>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg3d_update_kernel(const float* __restrict__ r, const float* __restrict__ v,
                     float* __restrict__ x, const float* __restrict__ p,
                     const float* __restrict__ rt,
                     const float* __restrict__ alpha_p,
                     const float* __restrict__ omega_p,
                     const float* __restrict__ top,
                     const float* __restrict__ bot, float* __restrict__ r_out,
                     typename Acc<COMP>::T* __restrict__ partials, int X,
                     int Y, int Z, LsStencil3 st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float win[3 * kPlaneMax];
  __shared__ SharedStencil3 s;
  stage_stencil3(s, st, LS_TILE + 2 * h);
  const float alpha = *alpha_p, omega = *omega_p;
  T acc[2] = {0, 0};
  march3d(win, s, h, X, Y, Z, top, bot,
          [&](size_t idx) { return r[idx] - alpha * v[idx]; },
          [&](size_t idx, float c, float ax) {
            x[idx] = x[idx] + alpha * p[idx] + omega * c;
            const float rn = c - omega * ax;
            r_out[idx] = rn;
            acc[0] += (T)rn * (T)rn;
            acc[1] += (T)rt[idx] * (T)rn;
          });
  block_partials(acc, partials);
}

// K7 update on march1 (reach 1), f32 dots: s formed as st forms it, x' =
// x + alpha p + omega s (in place) and r' = s - omega t stored at the
// thread's points and rounded as the march3d kernel rounds them,
// <r', r'> and <r~, r'> summed in f32 within a thread (one fma per
// product, as pv and the march3d kernel sum them) and in double across
// threads and blocks, folded into the last block.  Of the sum orders
// chip_smoke.py --breakdown compared over 16 right-hand sides, this one
// and those summing in double throughout kept f32 BiCGStab within 1e-3 of
// float64 as long as textbook f32 on 15 of them, f32 alone on 11, and it
// alone of those also did so at b = 1, phase 4d's system (PERF.md §6).
// With `compensated` the pass stays on march3d: see ls_bicg3d_update.
// x, p and r~ of the thread's points are
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

template <bool COMP>
int launch_pv_win(unsigned blocks, size_t smem, cudaStream_t stream,
                  const float* r, const float* p, const float* v,
                  const float* rt, const float* beta, const float* omega,
                  const float* top, const float* bot, float* p_out,
                  float* v_out, float* dot, void* partials,
                  unsigned* counter, const W3Geom& g, const LsStencil3& st) {
  using T = typename Acc<COMP>::T;
  const int err = dyn_smem_ready(bicg3d_pv_win_kernel<COMP>, kW3SmemMax,
                                 pv_win_done[COMP]);
  if (err) return err;
  bicg3d_pv_win_kernel<COMP><<<blocks, LS_W3_THREADS, smem, stream>>>(
      r, p, v, rt, beta, omega, top, bot, p_out, v_out, dot, (T*)partials,
      counter, g, st);
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

// The same of the kernels K7 runs off march1: `which` = 2 pass +
// compensated, pass 0 pv (the window march, at the largest window's shared
// memory), 1 st, 2 update (march3d).
int ls_bicg3d_attrs(int which, int* out) {
  switch (which) {
    case 0: return pv_win_attrs<false>(kW3SmemMax, out);
    case 1: return pv_win_attrs<true>(kW3SmemMax, out);
    case 2: return m1_attrs(bicg3d_st_kernel<false>, out);
    case 3: return m1_attrs(bicg3d_st_kernel<true>, out);
    case 4: return m1_attrs(bicg3d_update_kernel<false>, out);
    case 5: return m1_attrs(bicg3d_update_kernel<true>, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out = {registers, spill bytes, resident blocks per SM, dynamic shared
// memory bytes, blocks} of K7 pv's window march on [X, Y, Z] with st.
int ls_bicg3d_pv_win_attrs(int compensated, int X, int Y, int Z,
                           const LsStencil3* st, int* out) {
  const size_t smem = w3_shape(X, Y, Z, st, out);
  if (!smem) return (int)cudaErrorInvalidValue;
  return compensated ? pv_win_attrs<true>(smem, out)
                     : pv_win_attrs<false>(smem, out);
}

// partials: scratch of 2 * capacity doubles (the K <= 2 dots of each of up
// to capacity blocks; floats without `compensated`, but for st and update
// on march1).  counter: one unsigned, zero before the first launch (every
// launch that folds its dots leaves it zero); launches on one (partials,
// counter) pair must be ordered (one stream).  dot: K floats.  Halo planes may be null
// (zeros).
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
  if (compensated)
    return launch_pv_win<true>(nb, w3_smem(g), stream, r, p, v, rt, beta,
                               omega, top, bot, p_out, v_out, dot, partials,
                               counter, g, *st);
  return launch_pv_win<false>(nb, w3_smem(g), stream, r, p, v, rt, beta,
                              omega, top, bot, p_out, v_out, dot, partials,
                              counter, g, *st);
}

int ls_bicg3d_st(const float* r, const float* v, const float* alpha,
                 const float* top, const float* bot, float* dot,
                 void* partials, int capacity, unsigned* counter, int X,
                 int Y, int Z, int compensated, const LsStencil3* st,
                 void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int h = reach3_yz(*st);
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
  const dim3 grid = march_grid(X, Y, Z), block(LS_THREADS_X, LS_THREADS_Y);
  const int nblocks = grid.x * grid.y * grid.z;
  if (nblocks > capacity) return (int)cudaErrorInvalidValue;
  if (compensated) {
    bicg3d_st_kernel<true><<<grid, block, 0, stream>>>(
        r, v, alpha, top, bot, (double*)partials, X, Y, Z, *st, h);
    return finish((const double*)partials, nblocks, 2, dot, stream);
  }
  bicg3d_st_kernel<false><<<grid, block, 0, stream>>>(
      r, v, alpha, top, bot, (float*)partials, X, Y, Z, *st, h);
  return finish((const float*)partials, nblocks, 2, dot, stream);
}

// K7 update: march1 for a reach-1 stencil with f32 dots, march3d and a
// second launch otherwise.  With `compensated` it stays on march3d: late
// in the 7-point solve at 256^3, f32 BiCGStab is chaotic, and phase 4d of
// chip_smoke.py holds the compensated run's end to twice textbook f32's
// error, which march1 versions with exactly rounded dots missed and this
// kernel meets (PERF.md §6).
int ls_bicg3d_update(const float* r, const float* v, float* x, const float* p,
                     const float* rt, const float* alpha, const float* omega,
                     const float* top, const float* bot, float* r_out,
                     float* dot, void* partials, int capacity,
                     unsigned* counter, int X, int Y, int Z, int compensated,
                     const LsStencil3* st, void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int h = reach3_yz(*st);
  if (on_march1(*st) && !compensated) {
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
  const dim3 grid = march_grid(X, Y, Z), block(LS_THREADS_X, LS_THREADS_Y);
  const int nblocks = grid.x * grid.y * grid.z;
  if (nblocks > capacity) return (int)cudaErrorInvalidValue;
  if (compensated) {
    bicg3d_update_kernel<true><<<grid, block, 0, stream>>>(
        r, v, x, p, rt, alpha, omega, top, bot, r_out, (double*)partials, X,
        Y, Z, *st, h);
    return finish((const double*)partials, nblocks, 2, dot, stream);
  }
  bicg3d_update_kernel<false><<<grid, block, 0, stream>>>(
      r, v, x, p, rt, alpha, omega, top, bot, r_out, (float*)partials, X, Y,
      Z, *st, h);
  return finish((const float*)partials, nblocks, 2, dot, stream);
}

}  // extern "C"
