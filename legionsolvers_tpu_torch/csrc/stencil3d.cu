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
// - Reach 2..8: march3d, each block a 32 x 32 tile over 16 planes, three
//   rotating shared slots sized for reach 8, the terms read from shared
//   memory in stencil order, loads
//   and compute not overlapped, and partial dots summed by a second launch
//   (reduce_partials).
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

// K6a on march3d (reach 2..8): y = A x (mode 0), y and <x, A x> (1),
// <x, A x> (2), update (3): xv += alpha x; rv -= alpha A x; <rv', rv'>
// (x is p here)
template <int MODE>
__global__ void __launch_bounds__(LS_THREADS)
stencil3d_kernel(const float* __restrict__ x, const float* __restrict__ top,
                 const float* __restrict__ bot, float* __restrict__ y,
                 float* __restrict__ xv, float* __restrict__ rv,
                 const float* __restrict__ alpha_p,
                 float* __restrict__ partials, int X, int Y, int Z,
                 LsStencil3 st, int h) {
  __shared__ float win[3 * kPlaneMax];
  __shared__ SharedStencil3 s;
  stage_stencil3(s, st, LS_TILE + 2 * h);
  const float alpha = MODE == 3 ? *alpha_p : 0.f;
  float acc[1] = {0.f};
  march3d(win, s, h, X, Y, Z, top, bot, [&](size_t idx) { return x[idx]; },
          [&](size_t idx, float c, float ax) {
            if (MODE == 0 || MODE == 1) y[idx] = ax;
            if (MODE == 1 || MODE == 2) acc[0] += c * ax;
            if (MODE == 3) {
              xv[idx] = xv[idx] + alpha * c;
              const float rn = rv[idx] - alpha * ax;
              rv[idx] = rn;
              acc[0] += rn * rn;
            }
          });
  if (MODE != 0) block_partials(acc, partials);
}

// K6a on march1 (reach 1), the same four modes.  partials: one float per
// block; counter: zero before the launch, zero after it.
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

// K6b on march3d (reach 2..8): p = r + beta p_old (written to p_out) and
// <p, A p>; the halo planes are p's own (the caller combines r's and
// p_old's).
__global__ void __launch_bounds__(LS_THREADS)
xpay_pq3d_kernel(const float* __restrict__ r, const float* __restrict__ p_old,
                 const float* __restrict__ beta_p,
                 const float* __restrict__ top, const float* __restrict__ bot,
                 float* __restrict__ p_out, float* __restrict__ partials,
                 int X, int Y, int Z, LsStencil3 st, int h) {
  __shared__ float win[3 * kPlaneMax];
  __shared__ SharedStencil3 s;
  stage_stencil3(s, st, LS_TILE + 2 * h);
  const float beta = *beta_p;
  float acc[1] = {0.f};
  march3d(win, s, h, X, Y, Z, top, bot,
          [&](size_t idx) { return r[idx] + beta * p_old[idx]; },
          [&](size_t idx, float c, float ax) {
            p_out[idx] = c;
            acc[0] += c * ax;
          });
  block_partials(acc, partials);
}

// K6b's operand: p = r + beta p_old.
struct XpayForm {
  static constexpr int NV = 2;  // r, p_old
  float beta;
  __device__ __forceinline__ float operator()(const float (&x)[2]) const {
    return x[0] + beta * x[1];
  }
};

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

}  // namespace

extern "C" {

int ls_chunk_x() { return LS_CHUNK_X; }
int ls_stencil3_size() { return (int)sizeof(LsStencil3); }

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

// mode: 0 y, 1 y_dot, 2 pq, 3 update.  Pointers unused by a mode may be
// null; halo planes may be null (zeros).  partials: scratch of 2 *
// capacity doubles (two dots for each of up to capacity blocks); counter:
// one unsigned, zero before the first launch (a reach-1 launch leaves it
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
  const int h = reach3_yz(*st);
  if (h <= 1) {
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
  const dim3 grid = march_grid(X, Y, Z), block(LS_THREADS_X, LS_THREADS_Y);
  if ((long long)grid.x * grid.y * grid.z > capacity)
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case 0: stencil3d_kernel<0><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, X, Y, Z, *st, h);
            return (int)cudaGetLastError();
    case 1: stencil3d_kernel<1><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, X, Y, Z, *st, h); break;
    case 2: stencil3d_kernel<2><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, X, Y, Z, *st, h); break;
    default: stencil3d_kernel<3><<<grid, block, 0, stream>>>(
                x, top, bot, y, xv, rv, alpha, partials, X, Y, Z, *st, h); break;
  }
  return finish(partials, grid.x * grid.y * grid.z, 1, dot, stream);
}

// K6b: p = r + beta p_old to p_out, <p, A p> to dot; scratch as for
// ls_stencil3d.
int ls_xpay_pq3d(const float* r, const float* p_old, const float* beta,
                 const float* top, const float* bot, float* p_out, float* dot,
                 float* partials, int capacity, unsigned* counter, int X,
                 int Y, int Z, const LsStencil3* st, void* stream_ptr) {
  if (!valid3(st, X, Y, Z)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int h = reach3_yz(*st);
  if (h <= 1) {
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
  const dim3 grid = march_grid(X, Y, Z), block(LS_THREADS_X, LS_THREADS_Y);
  const int nblocks = grid.x * grid.y * grid.z;
  if (nblocks > capacity) return (int)cudaErrorInvalidValue;
  xpay_pq3d_kernel<<<grid, block, 0, stream>>>(r, p_old, beta, top, bot,
                                               p_out, partials, X, Y, Z, *st,
                                               h);
  return finish(partials, nblocks, 1, dot, stream);
}

}  // extern "C"
