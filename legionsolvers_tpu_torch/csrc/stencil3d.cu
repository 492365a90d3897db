// 3-D grid stencil SpMV and fused-CG passes for Hopper (sm_90a).
//
// Hand-written CUDA ports of the Pallas TPU kernels in
// legionsolvers_tpu/ops/pallas/stencil3d.py.  Python wrappers, plain PyTorch
// versions and gates live in legionsolvers_tpu_torch/ops/cuda/stencil3d.py;
// the entry points below have a plain C interface and are loaded with ctypes
// (build.py).
//
//   ls_stencil3d  K6a  replaces _stencil3d_call (modes y, y_dot, pq, update)
//   ls_xpay_pq3d  K6b  replaces grid3d_cg_xpay_pq
//
// Both run march1 for reach-1 stencils and the window march for every
// other stencil of the gate: one launch each.
//
// What bounds them: bytes.  The 27-point stencil does 54 flops per element
// against at least 4 B of traffic, 13 flops per byte, below the card's ~20
// f32 flops per byte of HBM bandwidth; the 7-point one does 14.  K6a moves
// 8 B per element (y, y_dot: read x, write y), 4 B (pq) or 20 B (update:
// read p, x, r; write x, r); K6b 12 B (read r, p_old; write p).
//
// Design.  The Pallas kernels stream whole [Y, Z] planes through a rotating
// 4-slot VMEM buffer on a sequential grid and carry the dot in SMEM.  Here
// K6a and K6b have two marches along x (common.cuh):
//
// - Reach 1 (the 7- and 27-point stencils, all the repo's 3-D paths run):
//   march1, a register march.  A block of 8 warps owns a 16 x 128 (y, z)
//   tile and a chunk of x planes; each thread owns 2 rows x 4 columns (one
//   16-byte vector per row).  The window (the tile plus one row and column
//   on each side) of each plane is read once from one of three
//   shared-memory slots; the next plane is copied into the third slot with
//   cp.async (zero-filled outside the volume) while this one is computed,
//   and update's x and r of the points being finished are loaded before
//   the plane's terms are summed.  K6b loads r and p_old of the next
//   plane's window into registers instead, and forms p = r + beta p_old
//   into the spare slot after this plane is computed; its emit stores p at
//   the thread's points.  One __syncthreads() per plane.  The
//   terms are unrolled at compile time, their weights kernel parameters:
//   the 3 x 3 x 3 box (zero weights for absent terms) carries the partial
//   outputs of planes x - 1, x, x + 1 in registers and sums a point's
//   terms plane by plane (x - 1, x, x + 1), in (oy, oz) order within a
//   plane; the 7-point Laplacian sums them in its stencil order (center,
//   -x, +x, -y, +y, -z, +z), reading plane x - 1's window from the slot
//   before, which with its exact products gives the plain version's bits
//   (and f32 BiCGStab with compensated dots on the 7-point system stays
//   as close to float64 as before).  The x chunks aim at a fixed
//   264 blocks (two per SM of an H100 SXM), so the geometry, and the sum
//   order of the dot, depend on (X, Y, Z) alone: 256 blocks of 32 planes at
//   256^3.  Z % 4 != 0 or an unaligned pointer takes a variant with 4-byte
//   copies and scalar loads.  The dot is folded into the last block to
//   finish (a device counter, reset by that block): no second launch, the
//   same bits from run to run.  What bounds it: bytes, with the window's
//   y halo (2 rows per 16) read again, mostly from L2, and 2 extra planes
//   per 32-plane chunk.
// - Reach 2..8, or any z shift past 8 (up to 128, the TPU kernel's
//   PADZ): the window march (common.cuh, march_win), K6a's four modes and
//   K6b alike (and K7's passes, bicgstab3d.cu).  On march3d, which read
//   the terms past |oz| = 8 beside a smaller window, each of S_wide's 8
//   wide terms formed the operand at the shifted point from L1, L2 or
//   device memory, which held a pass near 0.5 ms at 256^3 whatever its
//   bytes (PERF.md §6).  Here the window holds every point a term
//   reads: a 16-row tile plus the widest |oy| on each side, and the tile's
//   256 z columns plus the widest |oz| on each side, inside [0, Z) (at Z =
//   256 the whole z line).  The operand (K6a: x itself; K6b: p = r + beta
//   p_old) is formed once, as a plane is staged into a ring of three x
//   planes (|ox| <= 1), every term is read from shared memory, and the
//   dot (y_dot's <x, A x>, pq's, update's <r', r'>, K6b's <p, A p>) is
//   folded into the last block (m1_fold; x chunks aiming at a fixed 396
//   blocks, so its bits depend on (X, Y, Z) alone): one launch.  K6a
//   update loads x and r at the thread's points before the terms of each
//   tile row are summed (march_win's pre), and writes them in place; K6b
//   stores p at the tile's points.  What bounds them: bytes, those of the
//   pass plus the window's y halo (2 hy rows per 16, mostly from L2) and 2
//   planes per x chunk of the staged operand; S_wide's window (22 x 256
//   floats a plane, 67.6 KB for three) leaves 3 blocks per SM.  Every
//   stencil of the gate fits (the largest window, 32 x 512 floats, takes
//   192 KB).
//
// Both read each input byte from HBM about once.  K6b forms p = r + beta
// p_old while loading the window and applies A to it once; A p never
// reaches HBM in pq, update or xpay_pq.  Buffers: update writes x and r in
// place, because it reads them only at the thread's own element; xpay_pq
// writes p to a buffer other than p_old, which neighbouring blocks read
// through their windows.  The 27-point stencil is applied as a direct
// 27-term sum: the separable factorization of the TPU kernel saved
// vector-unit work there and is not used.

#include "common.cuh"

namespace {

// K6a on march1 (reach 1): y = A x (mode 0), y and <x, A x> (1), <x, A x>
// (2), update (3; x is p here): xv += alpha x; rv -= alpha A x; <rv',
// rv'>.  partials: one float per block; counter: zero before the launch,
// zero after it.
template <int MODE, bool STAR, bool VEC>
__global__ void __launch_bounds__(LS_M1_THREADS, LS_M1_MIN_BLOCKS)
stencil3d_m1_kernel(const float* __restrict__ x, const float* __restrict__ top,
                    const float* __restrict__ bot, float* __restrict__ y,
                    float* __restrict__ xv, float* __restrict__ rv,
                    const float* __restrict__ alpha_p, float* __restrict__ dot,
                    float* __restrict__ partials,
                    unsigned* __restrict__ counter, M1Geom g, Box27 w) {
  __shared__ __align__(16) float win[3 * kM1Slot];
  const M1Place pl = m1_place(g);
  const float alpha = MODE == 3 ? *alpha_p : 0.f;
  const int ncol = m1_ncol(pl, g.Z);
  M1CopyPlane<VEC> plane{x, top, bot, g, pl};
  float ex[LS_M1_RY][4], er[LS_M1_RY][4];  // update: x and r being finished
  float acc = 0.f;
  auto at = [&](int gx, int r) {
    return ((size_t)gx * g.Y + pl.gy[r]) * g.Z + pl.gz;
  };
  march1<STAR>(
      win, pl, w, plane,
      [&](int gx) {
        if (MODE != 3) return;
#pragma unroll
        for (int r = 0; r < LS_M1_RY; ++r) {
          const int n = pl.gy[r] < g.Y ? ncol : 0;
          m1_load4<VEC>(ex[r], xv, at(gx, r), n);
          m1_load4<VEC>(er[r], rv, at(gx, r), n);
        }
      },
      [&](int gx, const float (&c)[LS_M1_RY][4],
          const float (&ax)[LS_M1_RY][4]) {
#pragma unroll
        for (int r = 0; r < LS_M1_RY; ++r) {
          if (pl.gy[r] >= g.Y || !ncol) continue;
          const size_t o = at(gx, r);
          if (MODE == 0 || MODE == 1) m1_store4<VEC>(y, o, ax[r], ncol);
          if (MODE == 1 || MODE == 2) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j < ncol) acc += c[r][j] * ax[r][j];
          }
          if (MODE == 3) {
            float xn[4], rn[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              xn[j] = ex[r][j] + alpha * c[r][j];
              rn[j] = er[r][j] - alpha * ax[r][j];
              if (j < ncol) acc += rn[j] * rn[j];
            }
            m1_store4<VEC>(xv, o, xn, ncol);
            m1_store4<VEC>(rv, o, rn, ncol);
          }
        }
      });
  if (MODE != 0) m1_fold(acc, partials, counter, dot);
}

unsigned win_smem_done[5] = {};  // devices whose attribute is set, by kernel

// K6a on the window march (every stencil off march1: reach 2..8, wide z
// shifts), the four modes of stencil3d_m1_kernel: y = A x stored (mode 0),
// y and <x, A x> (1), <x, A x> (2), update (3, x is p): xv += alpha x, rv
// -= alpha A x in place, <rv', rv'>; before the terms of each tile row are
// summed (march_win's pre), rv of the thread's points is loaded and xv's
// lines are prefetched into L2 (xv in registers as well spilled at the 80
// registers that 3 blocks per SM leave), xv loaded in the emit.  The dot
// is folded into the last block.  partials: one float per block; counter:
// zero before the launch, zero after it.
template <int MODE>
__global__ void __launch_bounds__(LS_W3_THREADS, LS_W3_MIN_BLOCKS)
stencil3d_win_kernel(const float* __restrict__ x,
                     const float* __restrict__ top,
                     const float* __restrict__ bot, float* __restrict__ y,
                     float* __restrict__ xv, float* __restrict__ rv,
                     const float* __restrict__ alpha_p,
                     float* __restrict__ dot, float* __restrict__ partials,
                     unsigned* __restrict__ counter, W3Geom g,
                     const __grid_constant__ LsStencil3 st) {
  extern __shared__ __align__(16) float win[];
  __shared__ W3Terms s;
  w3_stage_terms(s, st);
  const W3Place pl = w3_place(g);
  const float* src[1] = {x};
  const float alpha = MODE == 3 ? *alpha_p : 0.f;
  float er[LS_W3_COLS];  // update: rv of the row
  float acc = 0.f;
  auto at = [&](int gx, int gy, int z) {
    return ((size_t)gx * g.Y + gy) * g.Z + z;
  };
  // both tile rows a pass (the terms' metadata and column tests serve
  // both), but for update: its rv of two rows beside twice the sums would
  // spill
  constexpr int ROWS = MODE == 3 ? 1 : 2;
  march_win<ROWS>(
      win, s, g, pl, src, top, bot, IdentityForm{},
      [&](int gx, int gy) {
        if (MODE != 3) return;
#pragma unroll
        for (int c = 0; c < LS_W3_COLS; ++c) {
          const int z = w3_col(pl, c);
          const bool in = gy < g.Y && z < g.Z;
          er[c] = in ? rv[at(gx, gy, z)] : 0.f;
          if (in) prefetch_l2(xv + at(gx, gy, z));
        }
      },
      [&](int gx, int gy, int c, int z, float cv, float ax) {
        const size_t o = at(gx, gy, z);
        if (MODE == 0 || MODE == 1) y[o] = ax;
        if (MODE == 1 || MODE == 2) acc += cv * ax;
        if (MODE == 3) {
          xv[o] = xv[o] + alpha * cv;
          const float rn = er[c] - alpha * ax;
          rv[o] = rn;
          acc += rn * rn;
        }
      });
  if (MODE != 0) m1_fold(acc, partials, counter, dot);
}

// K6b's operand: p = r + beta p_old.
struct XpayForm {
  static constexpr int NV = 2;  // r, p_old
  float beta;
  __device__ __forceinline__ float operator()(const float (&x)[2]) const {
    return x[0] + beta * x[1];
  }
};

// K6b on the window march (every stencil off march1: reach 2..8, wide z
// shifts): p = r + beta p_old formed as each plane is staged, stored at
// the tile's points, <p, A p> folded into the last block.  The halo planes
// are p's own (the caller combines r's and p_old's).  partials: one float
// per block; counter: zero before the launch, zero after it.
__global__ void __launch_bounds__(LS_W3_THREADS, LS_W3_MIN_BLOCKS)
xpay_pq3d_win_kernel(const float* __restrict__ r,
                     const float* __restrict__ p_old,
                     const float* __restrict__ beta_p,
                     const float* __restrict__ top,
                     const float* __restrict__ bot, float* __restrict__ p_out,
                     float* __restrict__ dot, float* __restrict__ partials,
                     unsigned* __restrict__ counter, W3Geom g,
                     const __grid_constant__ LsStencil3 st) {
  extern __shared__ __align__(16) float win[];
  __shared__ W3Terms s;
  w3_stage_terms(s, st);
  const W3Place pl = w3_place(g);
  const float* src[2] = {r, p_old};
  float acc = 0.f;
  march_win<1>(win, s, g, pl, src, top, bot, XpayForm{*beta_p},
               [](int, int) {},
               [&](int x, int gy, int, int z, float c, float ax) {
                 p_out[((size_t)x * g.Y + gy) * g.Z + z] = c;
                 acc += c * ax;
               });
  m1_fold(acc, partials, counter, dot);
}

// K6b on march1 (reach 1): p formed while the window is loaded, stored at
// the thread's points, <p, A p> folded into the last block.  partials: one
// float per block; counter: zero before the launch, zero after it.
template <bool STAR, bool VEC>
__global__ void __launch_bounds__(LS_M1_THREADS, LS_M1_MIN_BLOCKS)
xpay_pq3d_m1_kernel(const float* __restrict__ r,
                    const float* __restrict__ p_old,
                    const float* __restrict__ beta_p,
                    const float* __restrict__ top,
                    const float* __restrict__ bot, float* __restrict__ p_out,
                    float* __restrict__ dot, float* __restrict__ partials,
                    unsigned* __restrict__ counter, M1Geom g, Box27 w) {
  __shared__ __align__(16) float win[3 * kM1Slot];
  const M1Place pl = m1_place(g);
  const int ncol = m1_ncol(pl, g.Z);
  M1FormPlane<XpayForm, VEC> plane{{r, p_old}, top, bot, XpayForm{*beta_p},
                                   g, pl};
  float acc = 0.f;
  march1<STAR>(
      win, pl, w, plane, [](int) {},
      [&](int gx, const float (&c)[LS_M1_RY][4],
          const float (&ax)[LS_M1_RY][4]) {
#pragma unroll
        for (int k = 0; k < LS_M1_RY; ++k) {
          if (pl.gy[k] >= g.Y || !ncol) continue;
          m1_store4<VEC>(p_out, ((size_t)gx * g.Y + pl.gy[k]) * g.Z + pl.gz,
                         c[k], ncol);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < ncol) acc += c[k][j] * ax[k][j];
        }
      });
  m1_fold(acc, partials, counter, dot);
}

template <int MODE>
int launch_m1(bool star, bool vec, unsigned blocks, cudaStream_t stream,
              const float* x, const float* top, const float* bot, float* y,
              float* xv, float* rv, const float* alpha, float* dot,
              float* partials, unsigned* counter, const M1Geom& g,
              const Box27& w) {
#define LS_M1_LAUNCH(ST, VE)                                              \
  stencil3d_m1_kernel<MODE, ST, VE><<<blocks, LS_M1_THREADS, 0, stream>>>( \
      x, top, bot, y, xv, rv, alpha, dot, partials, counter, g, w)
  if (star) {
    if (vec) LS_M1_LAUNCH(true, true); else LS_M1_LAUNCH(true, false);
  } else {
    if (vec) LS_M1_LAUNCH(false, true); else LS_M1_LAUNCH(false, false);
  }
#undef LS_M1_LAUNCH
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_win(unsigned blocks, size_t smem, cudaStream_t stream,
               const float* x, const float* top, const float* bot, float* y,
               float* xv, float* rv, const float* alpha, float* dot,
               float* partials, unsigned* counter, const W3Geom& g,
               const LsStencil3& st) {
  const int err = dyn_smem_ready(stencil3d_win_kernel<MODE>, kW3SmemMax,
                                 win_smem_done[MODE]);
  if (err) return err;
  stencil3d_win_kernel<MODE><<<blocks, LS_W3_THREADS, smem, stream>>>(
      x, top, bot, y, xv, rv, alpha, dot, partials, counter, g, st);
  return (int)cudaGetLastError();
}

// Registers, spill bytes and resident blocks per SM of the window-march
// kernel `which` (0..3 K6a's modes, 4 K6b) launched with `smem` bytes.
int win_attrs(int which, size_t smem, int* out) {
  switch (which) {
#define LS_WIN_ATTR(M)                                                      \
  case M: return w3_attrs(stencil3d_win_kernel<M>, win_smem_done[M], smem, \
                          out);
    LS_WIN_ATTR(0) LS_WIN_ATTR(1) LS_WIN_ATTR(2) LS_WIN_ATTR(3)
#undef LS_WIN_ATTR
    case 4: return w3_attrs(xpay_pq3d_win_kernel, win_smem_done[4], smem,
                            out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ls_stencil3_size() { return (int)sizeof(LsStencil3); }
int ls_max_reach() { return LS_MAX_REACH; }
int ls_wide_z() { return LS_WIDE_Z; }

// Blocks of the reach-1 march on an [X, Y, Z] volume.
int ls_march1_blocks(int X, int Y, int Z) {
  M1Geom g;
  return X < 1 || Y < 1 || Z < 1 ? 0 : (int)m1_geometry(X, Y, Z, &g);
}

// Registers, spill bytes and resident blocks per SM of K6a's march1
// variant `which` = 4 mode + 2 star + vec, and of K6b's, 2 star + vec.
int ls_stencil3d_m1_attrs(int which, int* out) {
  switch (which) {
#define LS_M1_ATTR(M, ST, VE) \
  case 4 * M + 2 * ST + VE: return m1_attrs(stencil3d_m1_kernel<M, ST, VE>, out);
#define LS_M1_ATTRS(M) \
  LS_M1_ATTR(M, 0, 0) LS_M1_ATTR(M, 0, 1) LS_M1_ATTR(M, 1, 0) LS_M1_ATTR(M, 1, 1)
    LS_M1_ATTRS(0) LS_M1_ATTRS(1) LS_M1_ATTRS(2) LS_M1_ATTRS(3)
#undef LS_M1_ATTRS
#undef LS_M1_ATTR
    default: return (int)cudaErrorInvalidValue;
  }
}

int ls_xpay_pq3d_m1_attrs(int which, int* out) {
  switch (which) {
    case 0: return m1_attrs(xpay_pq3d_m1_kernel<false, false>, out);
    case 1: return m1_attrs(xpay_pq3d_m1_kernel<false, true>, out);
    case 2: return m1_attrs(xpay_pq3d_m1_kernel<true, false>, out);
    case 3: return m1_attrs(xpay_pq3d_m1_kernel<true, true>, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers, spill bytes and resident blocks per SM of the window-march
// kernel `which` (0..3 K6a's modes y, y_dot, pq, update; 4 K6b) at the
// largest window's shared memory.
int ls_stencil3d_attrs(int which, int* out) {
  return win_attrs(which, kW3SmemMax, out);
}

// mode: 0 y, 1 y_dot, 2 pq, 3 update.  Pointers unused by a mode may be
// null; halo planes may be null (zeros).  partials: scratch of 2 *
// capacity doubles (two dots for each of up to capacity blocks); counter:
// one unsigned, zero before the first launch (every launch leaves it
// zero).  Launches on one (partials, counter) pair must be ordered (one
// stream).
int ls_stencil3d(int mode, const float* x, const float* top, const float* bot,
                 float* y, float* xv, float* rv, const float* alpha,
                 float* dot, float* partials, int capacity, unsigned* counter,
                 int X, int Y, int Z, const LsStencil3* st,
                 void* stream_ptr) {
  if (!valid3(st, X, Y, Z) || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (on_march1(*st)) {
    M1Geom g;
    const long long blocks = m1_geometry(X, Y, Z, &g);
    if (!counter || blocks > capacity) return (int)cudaErrorInvalidValue;
    Box27 w;
    const bool star = m1_box(*st, &w);
    const bool vec = Z % 4 == 0 && m1_aligned(x) && m1_aligned(top) &&
                     m1_aligned(bot) && m1_aligned(y) && m1_aligned(xv) &&
                     m1_aligned(rv);
    const unsigned nb = (unsigned)blocks;
    switch (mode) {
#define LS_M1_MODE(M)                                                       \
  case M:                                                                   \
    return launch_m1<M>(star, vec, nb, stream, x, top, bot, y, xv, rv,      \
                        alpha, dot, partials, counter, g, w);
      LS_M1_MODE(0) LS_M1_MODE(1) LS_M1_MODE(2) LS_M1_MODE(3)
#undef LS_M1_MODE
    }
  }
  W3Geom g;
  const long long blocks = w3_geometry(X, Y, Z, *st, &g);
  if (!counter || blocks > capacity) return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  const size_t smem = w3_smem(g);
  switch (mode) {
#define LS_WIN_MODE(M)                                                       \
  case M:                                                                    \
    return launch_win<M>(nb, smem, stream, x, top, bot, y, xv, rv, alpha,    \
                         dot, partials, counter, g, *st);
    LS_WIN_MODE(0) LS_WIN_MODE(1) LS_WIN_MODE(2)
#undef LS_WIN_MODE
    default:
      return launch_win<3>(nb, smem, stream, x, top, bot, y, xv, rv, alpha,
                           dot, partials, counter, g, *st);
  }
}

// K6b: p = r + beta p_old to p_out, <p, A p> to dot, one launch (march1
// for reach-1 stencils, the window march for every other); scratch as for
// ls_stencil3d.
int ls_xpay_pq3d(const float* r, const float* p_old, const float* beta,
                 const float* top, const float* bot, float* p_out, float* dot,
                 float* partials, int capacity, unsigned* counter, int X,
                 int Y, int Z, const LsStencil3* st, void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (on_march1(*st)) {
    M1Geom g;
    const long long blocks = m1_geometry(X, Y, Z, &g);
    if (!counter || blocks > capacity) return (int)cudaErrorInvalidValue;
    Box27 w;
    const bool star = m1_box(*st, &w);
    const bool vec = Z % 4 == 0 && m1_aligned(r) && m1_aligned(p_old) &&
                     m1_aligned(top) && m1_aligned(bot) && m1_aligned(p_out);
    const unsigned nb = (unsigned)blocks;
#define LS_XP_LAUNCH(ST, VE)                                                \
  xpay_pq3d_m1_kernel<ST, VE><<<nb, LS_M1_THREADS, 0, stream>>>(            \
      r, p_old, beta, top, bot, p_out, dot, partials, counter, g, w)
    if (star) {
      if (vec) LS_XP_LAUNCH(true, true); else LS_XP_LAUNCH(true, false);
    } else {
      if (vec) LS_XP_LAUNCH(false, true); else LS_XP_LAUNCH(false, false);
    }
#undef LS_XP_LAUNCH
    return (int)cudaGetLastError();
  }
  W3Geom g;
  const long long blocks = w3_geometry(X, Y, Z, *st, &g);
  if (!counter || blocks > capacity) return (int)cudaErrorInvalidValue;
  const int err = dyn_smem_ready(xpay_pq3d_win_kernel, kW3SmemMax,
                                 win_smem_done[4]);
  if (err) return err;
  xpay_pq3d_win_kernel<<<(unsigned)blocks, LS_W3_THREADS, w3_smem(g),
                         stream>>>(r, p_old, beta, top, bot, p_out, dot,
                                   partials, counter, g, *st);
  return (int)cudaGetLastError();
}

// Blocks of the window march on an [X, Y, Z] volume (whatever the
// stencil); ops/cuda/stencil3d.py mirrors it.
int ls_window3d_blocks(int X, int Y, int Z) {
  LsStencil3 st;
  st.n = 0;
  W3Geom g;
  return X < 1 || Y < 1 || Z < 1 ? 0 : (int)w3_geometry(X, Y, Z, st, &g);
}

// out = {registers, spill bytes, resident blocks per SM, dynamic shared
// memory bytes, blocks} of the window-march kernel `which` (as for
// ls_stencil3d_attrs) on [X, Y, Z] with st.
int ls_stencil3d_win_attrs(int which, int X, int Y, int Z,
                           const LsStencil3* st, int* out) {
  const size_t smem = w3_shape(X, Y, Z, st, out);
  return smem ? win_attrs(which, smem, out) : (int)cudaErrorInvalidValue;
}

}  // extern "C"
