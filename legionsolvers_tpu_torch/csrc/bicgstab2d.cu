// Fused BiCGStab passes over 2-D grid stencils for Hopper (sm_90a).
//
// Hand-written CUDA ports of the Pallas TPU kernels in
// legionsolvers_tpu/ops/pallas/bicgstab2d.py.  Python wrappers, plain
// PyTorch versions and the gate live in
// legionsolvers_tpu_torch/ops/cuda/bicgstab2d.py; the entry points below
// have a plain C interface and are loaded with ctypes (build.py).
//
//   ls_bicg_pv      K5a  replaces bicg_pv:     p' = r + beta (p - omega v),
//                        v' = A p', <r~, v'>
//   ls_bicg_st      K5b  replaces bicg_st:     s = r - alpha v, t = A s,
//                        <t, s>, <t, t>
//   ls_bicg_update  K5c  replaces bicg_update: x += alpha p + omega s,
//                        r' = s - omega t, <r', r'>, <r~, r'>
//
// What bounds them: bytes.  One stencil application per element (~2 flops
// per term) against 24 B (pv: reads r, p, v, r~; writes p', v'), 8 B (st:
// reads r, v) and 28 B (update: reads r, v, x, p, r~; writes x', r') per
// element: 60 B per unknown per iteration.
//
// Design, as in stencil2d.cu: each block owns one LS_TILE x LS_TILE output
// tile and loads the window it needs (the tile plus the stencil reach h on
// each side) into shared memory once.  The operand of the one stencil
// application is formed while loading: p' = r + beta (p - omega v) for pv,
// s = r - alpha v for st and update, both zero outside the grid (the
// one-application contract of the Pallas passes: no chained masking).
// s and t = A s never reach device memory.  Dots go to a [blocks, k]
// scratch and a second launch sums them in a fixed order, so results repeat
// from run to run.  With `compensated`, every thread accumulates the exact
// f32 x f32 products in double, the partials and their sum are double, and
// the result is rounded to f32 once (the card's native f64 in place of the
// TPU's two-float pairs).
//
// Terms with |dx| > 8 (up to C - 1, as the 1-D kernel view's row-wrap
// terms) are read beside the tile from device memory, their operand formed
// there (apply_tile), by the lanes whose column lands in the grid.
//
// K5b with a reach-1 stencil (the 5-point cross, any 3x3 stencil) runs on
// the column-strip register march of K1 instead (see
// bicg_st_strip_kernel), and on the 1-D kernel view on the march along the
// flat index (flat1d.cu): one launch, its two dots folded into the last
// block.  K5a-c with the other stencils whose ring fits run the band march
// of band2d.cu (K5a and K5c also on the 1-D view).  The tile kernels here
// keep the stencils past that gate, and K5a and K5c with reach-1 stencils,
// with their second launch.
//
// Buffers: no kernel writes a buffer that another block reads through a
// halo.  pv writes p' and v' to buffers other than p and v, update writes
// r' to a buffer other than r; x is updated in place, because x, p and r~
// are read only at each thread's own element.

#include "march2d.cuh"

namespace {

// f(flat index) at (gr, gc) inside the grid, zero outside: the operand of
// a pass's one stencil application.
template <typename F>
__device__ __forceinline__ float operand_at(int gr, int gc, int R, int C,
                                            F f) {
  return in_grid(gr, gc, R, C) ? f((size_t)gr * C + gc) : 0.f;
}

// Fill w[(i, j)], 0 <= i, j < W, with the operand (operand_at).  Threads
// walk rows and columns directly, so neighbouring threads read
// neighbouring addresses.
template <typename F>
__device__ __forceinline__ void load_window(float* w, int W, int h, int r0,
                                            int c0, int R, int C, F f) {
  for (int i = threadIdx.y; i < W; i += LS_THREADS_Y) {
    const int gr = r0 - h + i;
    for (int j = threadIdx.x; j < W; j += LS_THREADS_X)
      w[i * W + j] = operand_at(gr, c0 - h + j, R, C, f);
  }
}

// A applied at (gr, gc) from the window, its terms with |dx| > 8 from the
// operand beside it (apply_at_wide).
template <typename F>
__device__ __forceinline__ float apply_tile(const float* w, int W, int h,
                                            int i, int j, int gr, int gc,
                                            int R, int C,
                                            const SharedStencil& s, F f) {
  return apply_at_wide(w, W, i + h, j + h, s, [&](int dy, int dx) {
    return operand_at(gr + dy, gc + dx, R, C, f);
  });
}

// K5a: p' = r + beta (p - omega v) on the window, v' = A p', <r~, v'>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg_pv_kernel(const float* __restrict__ r, const float* __restrict__ p,
               const float* __restrict__ v, const float* __restrict__ rt,
               const float* __restrict__ beta_p,
               const float* __restrict__ omega_p, float* __restrict__ p_out,
               float* __restrict__ v_out,
               typename Acc<COMP>::T* __restrict__ partials, int R, int C,
               LsStencil st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float w[kWinMax * kWinMax];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const float beta = *beta_p, omega = *omega_p;
  const int W = LS_TILE + 2 * h;
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  auto pn = [&](size_t idx) {
    return r[idx] + beta * (p[idx] - omega * v[idx]);
  };
  load_window(w, W, h, r0, c0, R, C, pn);
  __syncthreads();
  T acc[1] = {0};
  const int j = threadIdx.x, gc = c0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    const int gr = r0 + i;
    if (gr >= R || gc >= C) continue;
    const size_t idx = (size_t)gr * C + gc;
    const float vn = apply_tile(w, W, h, i, j, gr, gc, R, C, s, pn);
    p_out[idx] = w[(i + h) * W + j + h];
    v_out[idx] = vn;
    acc[0] += (T)rt[idx] * (T)vn;
  }
  block_partials(acc, partials);
}

// K5b: s = r - alpha v on the window, t = A s; <t, s>, <t, t>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg_st_kernel(const float* __restrict__ r, const float* __restrict__ v,
               const float* __restrict__ alpha_p,
               typename Acc<COMP>::T* __restrict__ partials, int R, int C,
               LsStencil st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float w[kWinMax * kWinMax];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const float alpha = *alpha_p;
  const int W = LS_TILE + 2 * h;
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  auto sv = [&](size_t idx) { return r[idx] - alpha * v[idx]; };
  load_window(w, W, h, r0, c0, R, C, sv);
  __syncthreads();
  T acc[2] = {0, 0};
  const int j = threadIdx.x, gc = c0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    if (r0 + i >= R || gc >= C) continue;
    const float t = apply_tile(w, W, h, i, j, r0 + i, gc, R, C, s, sv);
    const float sc = w[(i + h) * W + j + h];
    acc[0] += (T)t * (T)sc;
    acc[1] += (T)t * (T)t;
  }
  block_partials(acc, partials);
}

// K5b on the strip march (reach 1): s = r - alpha v formed in registers
// as each row arrives (zero outside the grid), t = A s at the row before
// it from s rows q-2..q, <t, s> and <t, t> accumulated per thread;
// nothing is stored.  A warp owns a 128-column strip (120 output columns,
// one halo lane per side) and a row chunk; LS_ST_DEPTH rows of r and v
// are in flight per warp (a register ring), and the chunks aim at
// LS_ST_TARGET_WARPS warps, LS_ST_MIN_BLOCKS blocks resident per SM: K5b
// moves 8 B per element and does ~16 flops on them, so what bounds it is
// bytes, and what holds it back is the bytes in flight, which residency
// gave and a deeper ring did not (PERF.md section 6).  Halo columns (8 of
// 128) and two rows per chunk are read again, mostly from L2.  Sum
// order: with `compensated`, the exact products in double; without it,
// the products rounded to f32 (__fmul_rn) and summed in double.  Both
// are summed in double across threads and blocks (strip_fold) and
// rounded to f32 once.  A thread sums a whole chunk's products, too long
// a run for an f32 sum; of the orders chip_smoke.py --breakdown --dim 2
// compared, this one alone passed phase 4b at b = 1 (PERF.md section 6).
template <int DEPTH, int MINB, bool COMP, bool CROSS, bool VEC>
__global__ void __launch_bounds__(LS_STEP2_THREADS, MINB)
bicg_st_strip_kernel(const float* __restrict__ r, const float* __restrict__ v,
                     const float* __restrict__ alpha_p,
                     float* __restrict__ dot, double* __restrict__ partials,
                     unsigned* __restrict__ counter, int R, int C,
                     StripGeom geo, Step2Stencil st) {
  const int unit = blockIdx.x * LS_STEP2_WARPS + (threadIdx.x >> 5);
  double acc[2] = {0.0, 0.0};
  if (unit < geo.units) {  // warp-uniform
    const StripPlace pl = strip_place(unit, geo, R, C);
    const float alpha = *alpha_p;
    // the product in f32 (rounded alone) or exact in double
    auto mul = [](float a, float b) {
      return COMP ? (double)a * (double)b : (double)__fmul_rn(a, b);
    };
    const Row4 z = {{0.f, 0.f, 0.f, 0.f}};
    Row4 S2 = z, S1 = z;  // s rows q-2, q-1
    const float* const src[2] = {r, v};
    strip_rows<DEPTH, 2, VEC>(
        src, pl.a - 1, pl.b, R, C, pl, [&](int q, const Row4 (&row)[2]) {
          Row4 S0;
#pragma unroll
          for (int j = 0; j < 4; ++j) S0.v[j] = row[0].v[j] - alpha * row[1].v[j];
          strip_mask(S0, q, R, pl.cin);
          const int i = q - 1;
          if (i >= pl.a && i < pl.b) {
            const Row4 t = apply4<CROSS>(S2, S1, S0, st);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (pl.own[j]) {
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

#define LS_ST_DEPTH 2  // rows of r and v in flight per warp

template <bool COMP, bool CROSS, bool VEC>
int launch_st_strip(const float* r, const float* v, const float* alpha,
                    float* dot, double* partials, int capacity,
                    unsigned* counter, int R, int C, const Step2Stencil& st,
                    cudaStream_t stream) {
  const StripGeom geo = strip_geometry(R, C, LS_ST_TARGET_WARPS);
  if (geo.blocks > capacity) return (int)cudaErrorInvalidValue;
  bicg_st_strip_kernel<LS_ST_DEPTH, LS_ST_MIN_BLOCKS, COMP, CROSS, VEC>
      <<<(unsigned)geo.blocks, LS_STEP2_THREADS, 0, stream>>>(
          r, v, alpha, dot, partials, counter, R, C, geo, st);
  return (int)cudaGetLastError();
}

// K5c: s and t = A s as in st; x += alpha p + omega s (in place);
// r' = s - omega t (to r_out); <r', r'>, <r~, r'>.
template <bool COMP>
__global__ void __launch_bounds__(LS_THREADS)
bicg_update_kernel(const float* __restrict__ r, const float* __restrict__ v,
                   float* __restrict__ x, const float* __restrict__ p,
                   const float* __restrict__ rt,
                   const float* __restrict__ alpha_p,
                   const float* __restrict__ omega_p,
                   float* __restrict__ r_out,
                   typename Acc<COMP>::T* __restrict__ partials, int R, int C,
                   LsStencil st, int h) {
  using T = typename Acc<COMP>::T;
  __shared__ float w[kWinMax * kWinMax];
  __shared__ SharedStencil s;
  stage_stencil(s, st);
  const float alpha = *alpha_p, omega = *omega_p;
  const int W = LS_TILE + 2 * h;
  const int r0 = blockIdx.y * LS_TILE, c0 = blockIdx.x * LS_TILE;
  auto sv = [&](size_t idx) { return r[idx] - alpha * v[idx]; };
  load_window(w, W, h, r0, c0, R, C, sv);
  __syncthreads();
  T acc[2] = {0, 0};
  const int j = threadIdx.x, gc = c0 + j;
  for (int i = threadIdx.y; i < LS_TILE; i += LS_THREADS_Y) {
    const int gr = r0 + i;
    if (gr >= R || gc >= C) continue;
    const size_t idx = (size_t)gr * C + gc;
    const float t = apply_tile(w, W, h, i, j, gr, gc, R, C, s, sv);
    const float sc = w[(i + h) * W + j + h];
    x[idx] = x[idx] + alpha * p[idx] + omega * sc;
    const float rn = sc - omega * t;
    r_out[idx] = rn;
    acc[0] += (T)rn * (T)rn;
    acc[1] += (T)rt[idx] * (T)rn;
  }
  block_partials(acc, partials);
}

}  // namespace

extern "C" {

// partials: scratch of K doubles per tile (only K floats per tile are used
// without `compensated`).  dot: K floats.
int ls_bicg_pv(const float* r, const float* p, const float* v,
               const float* rt, const float* beta, const float* omega,
               float* p_out, float* v_out, float* dot, void* partials, int R,
               int C, int compensated, const LsStencil* st,
               void* stream_ptr) {
  if (!valid2d(st, R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = tile_reach(*st), nblocks = grid.x * grid.y;
  if (compensated) {
    bicg_pv_kernel<true><<<grid, block, 0, stream>>>(
        r, p, v, rt, beta, omega, p_out, v_out, (double*)partials, R, C, *st, h);
    return finish((const double*)partials, nblocks, 1, dot, stream);
  }
  bicg_pv_kernel<false><<<grid, block, 0, stream>>>(
      r, p, v, rt, beta, omega, p_out, v_out, (float*)partials, R, C, *st, h);
  return finish((const float*)partials, nblocks, 1, dot, stream);
}

int ls_bicg_st(const float* r, const float* v, const float* alpha, float* dot,
               void* partials, int R, int C, int compensated,
               const LsStencil* st, void* stream_ptr) {
  if (!valid2d(st, R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = tile_reach(*st), nblocks = grid.x * grid.y;
  if (compensated) {
    bicg_st_kernel<true><<<grid, block, 0, stream>>>(
        r, v, alpha, (double*)partials, R, C, *st, h);
    return finish((const double*)partials, nblocks, 2, dot, stream);
  }
  bicg_st_kernel<false><<<grid, block, 0, stream>>>(
      r, v, alpha, (float*)partials, R, C, *st, h);
  return finish((const float*)partials, nblocks, 2, dot, stream);
}

// K5b with a reach-1 stencil on the strip march.  partials: capacity
// blocks x 2 doubles; counter: one unsigned, zero before the first launch
// (the kernel leaves it zero).  Launches on one (partials, counter) pair
// must be ordered (one stream).  dot: 2 floats.
int ls_bicg_st_strip(const float* r, const float* v, const float* alpha,
                     float* dot, double* partials, int capacity,
                     unsigned* counter, int R, int C, int compensated,
                     const LsStencil* st, void* stream_ptr) {
  if (!valid(st, R, C, 1) || !counter) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Step2Stencil s2 = step2_stencil(*st);
  const bool vec = C % 4 == 0 && aligned16(r) && aligned16(v);
  const bool cross = is_cross(*st);
#define LS_ST_COMP(CR, VE)                                            \
  launch_st_strip<true, CR, VE>(r, v, alpha, dot, partials, capacity, \
                                counter, R, C, s2, stream)
#define LS_ST_F32(CR, VE)                                              \
  launch_st_strip<false, CR, VE>(r, v, alpha, dot, partials, capacity, \
                                 counter, R, C, s2, stream)
  if (compensated) return LS_CROSS_VARIANT(LS_ST_COMP, cross, vec);
  return LS_CROSS_VARIANT(LS_ST_F32, cross, vec);
#undef LS_ST_COMP
#undef LS_ST_F32
}

// Registers, spill bytes and resident blocks per SM of K5b's strip
// variant `which` = 4 compensated + 2 cross + vec.
int ls_bicg_st_strip_attrs(int which, int* out) {
  switch (which) {
#define LS_ST_ATTR(CO, CR, VE)                                              \
  case 4 * CO + 2 * CR + VE:                                                \
    return strip_attrs(bicg_st_strip_kernel<LS_ST_DEPTH, LS_ST_MIN_BLOCKS, \
                                            CO, CR, VE>, out);
    LS_ST_ATTR(0, 0, 0) LS_ST_ATTR(0, 0, 1) LS_ST_ATTR(0, 1, 0)
    LS_ST_ATTR(0, 1, 1) LS_ST_ATTR(1, 0, 0) LS_ST_ATTR(1, 0, 1)
    LS_ST_ATTR(1, 1, 0) LS_ST_ATTR(1, 1, 1)
#undef LS_ST_ATTR
    default: return (int)cudaErrorInvalidValue;
  }
}

int ls_bicg_update(const float* r, const float* v, float* x, const float* p,
                   const float* rt, const float* alpha, const float* omega,
                   float* r_out, float* dot, void* partials, int R, int C,
                   int compensated, const LsStencil* st, void* stream_ptr) {
  if (!valid2d(st, R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(R, C), block(LS_THREADS_X, LS_THREADS_Y);
  const int h = tile_reach(*st), nblocks = grid.x * grid.y;
  if (compensated) {
    bicg_update_kernel<true><<<grid, block, 0, stream>>>(
        r, v, x, p, rt, alpha, omega, r_out, (double*)partials, R, C, *st, h);
    return finish((const double*)partials, nblocks, 2, dot, stream);
  }
  bicg_update_kernel<false><<<grid, block, 0, stream>>>(
      r, v, x, p, rt, alpha, omega, r_out, (float*)partials, R, C, *st, h);
  return finish((const float*)partials, nblocks, 2, dot, stream);
}

}  // extern "C"
