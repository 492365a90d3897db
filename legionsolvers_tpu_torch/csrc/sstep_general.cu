// The s-step passes K1 (step2) and K2 (gram2) on the general route, for
// Hopper (sm_90a): 2-D stencils with |dy| <= 1 and any |dx| < C that are
// neither reach 1 (the strip march of march2d.cuh) nor the flat
// decomposition of a reach-1 1-D stencil (the strip march with WRAP).
//
//   ls_step2_general  K1  replaces _sstep_call mode step2
//                         (legionsolvers_tpu/ops/pallas/stencil2d.py:746)
//   ls_gram2_general  K2  replaces _sstep_call mode gram2 (same function)
//
// Python wrappers, plain versions and the route live in
// legionsolvers_tpu_torch/ops/cuda/stencil2d.py (route "general").
//
// Why the strip march cannot take these stencils: K1 chains four
// applications (A p; A u with u = c0 p + c1 r - c2 A p; A p''; A^2 p'' and
// A r'' for the Gram), so an output column depends on inputs 4 Qx columns
// away, Qx the widest |dx| (100 for a stencil with (1, 100)), and a
// warp's strip holds 4 halo columns.  Reading the wide terms from device
// memory beside the strip does not work either: the intermediates (u,
// r'', p'', A p'') of a column that another block owns are in no buffer.
//
// Design: one cooperative launch whose stages run over the whole grid,
// separated by a grid-wide barrier (grid_sync; cudaLaunchCooperativeKernel
// guarantees that every block is resident, or refuses the launch):
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
// What bounds it: bytes.  The bound is K1's and K2's I/O, 24 and 8 B per
// element; this design moves about 68 (K1: S1 reads p, r, x and writes x,
// u, A p; S2 reads u, A p, p, r and writes r'', p''; S3 reads p'' and
// writes A p''; S4 reads A p'', r'', p'') and 20 (K2), the stencil's
// neighbours mostly from L1 and L2.  A simple kernel that is right: what
// holds it back is the loads through L1, one per stencil term and
// application (65 per element for K1 with 13 terms, 39 for K2); staging
// each unit's rows in shared memory ran slower (K1's registers; PERF.md
// section 6).  A march that keeps the intermediates on chip is later
// work.

#include "march2d.cuh"

#define LS_GEN_THREADS 256
#define LS_GEN_UNIT_ELEMS 8192  // elements of a unit of whole rows
#define LS_GEN_MIN_BLOCKS 4     // resident blocks per SM the launch asks for
#define LS_GEN_BATCH 8          // stencil terms loaded before they are summed

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

// K2 on the general route.  ws: R C floats; the rest as ls_step2_general.
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
