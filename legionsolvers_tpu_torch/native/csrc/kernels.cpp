// Host-side build helpers of legionsolvers_tpu_torch (no torch, no CUDA).
//
// The O(nnz) loops that build a problem on the host once before the card
// solves it: stencil COO generation, CSR row pointers, the per-piece ELL
// packing with halo-slot column remapping, the DIA extraction of explicit
// matrices, the reverse Cuthill-McKee ordering of the reordered-basis
// systems and the text lines of a Matrix Market file.  The analog of the
// reference's C++ fill tasks and dependent partitioning (reference:
// src/StencilGenerator.cpp fill bodies, src/ExampleSystems.cpp:250-470,
// COOMatrix.cpp:57-141).  Exposed through a C ABI that
// native/bindings.py loads with ctypes; every entry point there keeps its
// numpy version, which runs when this library is not loaded and returns
// the same arrays bit for bit.
//
// A port of legionsolvers_tpu/native/csrc/kernels.cpp.  The RCM BFS is
// the same code, so that both packages pick the same permutation.  The
// DIA accumulation differs: it sums each slot's duplicates in input order
// in double, as the numpy version does, where the JAX package's adds f32
// values with atomics in no fixed order.  Entry points that write through
// an index taken from their input check it and return -1 when it is out
// of range.
//
// Conventions: 64-bit row/col indices, row-major linearization (reference:
// linearize_row_major, StencilGenerator.hpp:231-243).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <utility>
#include <vector>

#include <omp.h>

extern "C" {

// ---------------------------------------------------------------------------
// Stencil COO generation.
//
// shape[ndim]: grid extents; offsets[noff][ndim]; values[noff].  Emits one
// nonzero per (grid point, in-bounds offset), grid points in row-major
// order and offsets in the given order per point: with the offsets sorted
// by their linear offset the stream is (row, col)-sorted.  Returns the
// number of nonzeros written; rows/cols/vals hold stencil_size entries.
// ---------------------------------------------------------------------------

int64_t stencil_size(
    const int64_t* shape, int64_t ndim,
    const int64_t* offsets, int64_t noff
) {
    // closed form: sum over offsets of prod_d max(n_d - |o_d|, 0)
    // (reference computes this recursively: StencilGenerator.hpp:270-323)
    int64_t total = 0;
    for (int64_t k = 0; k < noff; ++k) {
        int64_t cnt = 1;
        for (int64_t d = 0; d < ndim; ++d) {
            int64_t o = offsets[k * ndim + d];
            int64_t c = shape[d] - (o < 0 ? -o : o);
            cnt *= c > 0 ? c : 0;
        }
        total += cnt;
    }
    return total;
}

int64_t stencil_fill_coo(
    const int64_t* shape, int64_t ndim,
    const int64_t* offsets, const double* values, int64_t noff,
    int64_t* rows, int64_t* cols, double* vals
) {
    std::vector<int64_t> stride(ndim, 1);
    for (int64_t d = ndim - 2; d >= 0; --d) {
        stride[d] = stride[d + 1] * shape[d + 1];
    }
    int64_t n = 1;
    for (int64_t d = 0; d < ndim; ++d) { n *= shape[d]; }

    std::vector<int64_t> lin_off(noff);
    for (int64_t k = 0; k < noff; ++k) {
        int64_t s = 0;
        for (int64_t d = 0; d < ndim; ++d) {
            s += offsets[k * ndim + d] * stride[d];
        }
        lin_off[k] = s;
    }

    // grid points in linear order, in-bounds offsets per point
    // (reference: StencilGenerator.cpp:92-126)
    std::vector<int64_t> coord(ndim, 0);
    int64_t out = 0;
    for (int64_t p = 0; p < n; ++p) {
        for (int64_t k = 0; k < noff; ++k) {
            bool ok = true;
            for (int64_t d = 0; d < ndim; ++d) {
                int64_t q = coord[d] + offsets[k * ndim + d];
                if (q < 0 || q >= shape[d]) { ok = false; break; }
            }
            if (ok) {
                rows[out] = p;
                cols[out] = p + lin_off[k];
                vals[out] = values[k];
                ++out;
            }
        }
        // mixed-radix increment, last dimension fastest
        for (int64_t d = ndim - 1; d >= 0; --d) {
            if (++coord[d] < shape[d]) break;
            coord[d] = 0;
        }
    }
    return out;
}

// ---------------------------------------------------------------------------
// CSR row pointers [n_rows + 1] of a row index array.  Returns 0, or -1 if
// a row lies outside [0, n_rows).
// ---------------------------------------------------------------------------
int64_t build_indptr(
    const int64_t* rows, int64_t nnz, int64_t n_rows, int64_t* indptr
) {
    std::memset(indptr, 0, sizeof(int64_t) * (n_rows + 1));
    for (int64_t k = 0; k < nnz; ++k) {
        if (rows[k] < 0 || rows[k] >= n_rows) return -1;
        ++indptr[rows[k] + 1];
    }
    for (int64_t i = 0; i < n_rows; ++i) { indptr[i + 1] += indptr[i]; }
    return 0;
}

// ---------------------------------------------------------------------------
// Per-piece ELL packing with halo-slot remapping.
//
// Input: one piece's nonzeros (rows_local sorted ascending, stable within
// a row; cols global; vals), the piece's block [d0, d0 + B_d) and the
// sorted halo_global (the columns outside the block it reads).  Output:
// ell_cols[B_r * L], ell_vals[B_r * L], columns remapped into the piece's
// extended buffer (own block, then the halo slots), padded slots holding
// (dump, 0).  Returns 0, or -1 if a row is outside [0, B_r), the rows are
// not sorted or a row has more than L nonzeros.
// ---------------------------------------------------------------------------
int64_t pack_ell_shard(
    int64_t nnz,
    const int64_t* rows_local,
    const int64_t* cols_global,
    const double* vals,
    int64_t B_r, int64_t B_d, int64_t d0,
    const int64_t* halo_global, int64_t n_halo,
    int64_t L, int64_t dump,
    int32_t* ell_cols, double* ell_vals
) {
    for (int64_t i = 0; i < B_r * L; ++i) {
        ell_cols[i] = static_cast<int32_t>(dump);
        ell_vals[i] = 0.0;
    }
    int64_t slot = 0;
    int64_t prev_row = -1;
    for (int64_t k = 0; k < nnz; ++k) {
        int64_t r = rows_local[k];
        if (r < prev_row || r >= B_r) return -1;
        slot = (r == prev_row) ? slot + 1 : 0;
        if (slot >= L) return -1;
        prev_row = r;
        int64_t c = cols_global[k];
        int64_t lc;
        if (c >= d0 && c < d0 + B_d) {
            lc = c - d0;
        } else {
            const int64_t* lo = std::lower_bound(
                halo_global, halo_global + n_halo, c
            );
            lc = B_d + (lo - halo_global);
        }
        ell_cols[r * L + slot] = static_cast<int32_t>(lc);
        ell_vals[r * L + slot] = vals[k];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// The sorted distinct columns outside the block [d0, d0 + B_d): the halo
// one piece reads (the ghost image, reference: COOMatrix.cpp:98-118).
// Returns the count; halo_out holds nnz entries.
// ---------------------------------------------------------------------------
int64_t shard_halo_columns(
    int64_t nnz, const int64_t* cols_global,
    int64_t d0, int64_t B_d,
    int64_t* halo_out
) {
    int64_t m = 0;
    for (int64_t k = 0; k < nnz; ++k) {
        int64_t c = cols_global[k];
        if (c < d0 || c >= d0 + B_d) { halo_out[m++] = c; }
    }
    std::sort(halo_out, halo_out + m);
    return std::unique(halo_out, halo_out + m) - halo_out;
}

// ---------------------------------------------------------------------------
// DIA extraction of an explicit matrix, in two passes whose memory is the
// output's (reference analog: the distributed fill tasks,
// src/ExampleSystems.cpp:252-470).
//
// Pass 1: the distinct diagonals (col - row), sorted ascending.  Returns
// the count, or -1 once more than max_diags are seen; out_offsets holds
// max_diags entries.
// ---------------------------------------------------------------------------
int64_t dia_unique_offsets(
    int64_t nnz, const int64_t* rows, const int64_t* cols,
    int64_t max_diags, int64_t* out_offsets
) {
    // a small sorted set per thread: D is bounded by max_diags
    std::vector<int64_t> offs;
    offs.reserve(static_cast<size_t>(max_diags) + 1);
    int64_t over = 0;
    #pragma omp parallel
    {
        std::vector<int64_t> local;
        local.reserve(static_cast<size_t>(max_diags) + 1);
        #pragma omp for nowait
        for (int64_t k = 0; k < nnz; ++k) {
            if (over) continue;  // a racy read is fine: an early-out hint
            const int64_t d = cols[k] - rows[k];
            auto it = std::lower_bound(local.begin(), local.end(), d);
            if (it == local.end() || *it != d) {
                local.insert(it, d);
                if (static_cast<int64_t>(local.size()) > max_diags) {
                    #pragma omp atomic write
                    over = 1;
                }
            }
        }
        #pragma omp critical
        {
            std::vector<int64_t> merged;
            merged.reserve(offs.size() + local.size());
            std::merge(offs.begin(), offs.end(), local.begin(), local.end(),
                       std::back_inserter(merged));
            merged.erase(std::unique(merged.begin(), merged.end()),
                         merged.end());
            offs.swap(merged);
        }
    }
    if (over || static_cast<int64_t>(offs.size()) > max_diags) return -1;
    std::copy(offs.begin(), offs.end(), out_offsets);
    return static_cast<int64_t>(offs.size());
}

// ---------------------------------------------------------------------------
// Pass 2: acc[k * padded + r] += the entries of row r on diagonal
// offsets[k], duplicates summed (COO semantics, reference:
// COOMatrixTasks.cpp:38-39), in double and in input order, each value
// first rounded to the target dtype (f32: to float).  The caller rounds
// acc to the target dtype once.  offsets is pass 1's.  Each thread owns a
// range of rows and scans every entry, taking those of its rows, so each
// slot's sum runs in input order whatever the thread count.  Returns 0,
// or -1 if an entry's row is outside [0, padded) or its diagonal is not
// in offsets.
// ---------------------------------------------------------------------------

static int64_t dia_accumulate(
    int64_t nnz, const int64_t* rows, const int64_t* cols,
    const double* vals, int64_t n_offs, const int64_t* offsets,
    int64_t padded, double* acc, bool round_f32
) {
    int bad = 0;
    #pragma omp parallel reduction(|:bad)
    {
        const int64_t nt = omp_get_num_threads();
        const int64_t t = omp_get_thread_num();
        const int64_t r0 = padded * t / nt, r1 = padded * (t + 1) / nt;
        for (int64_t k = 0; k < nnz; ++k) {
            const int64_t r = rows[k];
            if (r < r0 || r >= r1) {
                // a row outside [0, padded) is the first or last thread's
                bad |= (t == 0 && r < 0) || (t == nt - 1 && r >= padded);
                continue;
            }
            const int64_t d = cols[k] - r;
            const int64_t* it = std::lower_bound(offsets, offsets + n_offs,
                                                 d);
            if (it == offsets + n_offs || *it != d) {
                bad = 1;
                continue;
            }
            const double v = round_f32
                ? static_cast<double>(static_cast<float>(vals[k])) : vals[k];
            acc[(it - offsets) * padded + r] += v;
        }
    }
    return bad ? -1 : 0;
}

int64_t dia_accumulate_f32(
    int64_t nnz, const int64_t* rows, const int64_t* cols,
    const double* vals, int64_t n_offs, const int64_t* offsets,
    int64_t padded, double* acc
) {
    return dia_accumulate(nnz, rows, cols, vals, n_offs, offsets, padded,
                          acc, true);
}

int64_t dia_accumulate_f64(
    int64_t nnz, const int64_t* rows, const int64_t* cols,
    const double* vals, int64_t n_offs, const int64_t* offsets,
    int64_t padded, double* acc
) {
    return dia_accumulate(nnz, rows, cols, vals, n_offs, offsets, padded,
                          acc, false);
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering of the symmetrized sparsity pattern: the
// planner reorders general sparse systems into banded form at build time
// and solves in the permuted basis (parallel/reorder.py).  George-Liu
// pseudo-peripheral start nodes, BFS with neighbours visited in
// increasing-degree order, each component's order reversed; disconnected
// graphs are handled.  The JAX package's code, unchanged.
//
// perm_out[i] = original index of the node placed at position i (the
// scipy.sparse.csgraph.reverse_cuthill_mckee convention).
// ---------------------------------------------------------------------------

void rcm_permutation(
    int64_t n, int64_t nnz,
    const int64_t* rows, const int64_t* cols,
    int64_t* perm_out
) {
    // symmetrized adjacency CSR (both directions, self-loops dropped)
    std::vector<int64_t> deg(n, 0);
    for (int64_t k = 0; k < nnz; ++k) {
        if (rows[k] != cols[k]) { ++deg[rows[k]]; ++deg[cols[k]]; }
    }
    std::vector<int64_t> adj_ptr(n + 1, 0);
    for (int64_t i = 0; i < n; ++i) { adj_ptr[i + 1] = adj_ptr[i] + deg[i]; }
    std::vector<int64_t> adj(adj_ptr[n]);
    {
        std::vector<int64_t> fill(adj_ptr.begin(), adj_ptr.end() - 1);
        for (int64_t k = 0; k < nnz; ++k) {
            if (rows[k] == cols[k]) continue;
            adj[fill[rows[k]]++] = cols[k];
            adj[fill[cols[k]]++] = rows[k];
        }
    }
    // dedup neighbour lists (duplicate COO entries / symmetric inputs)
    {
        int64_t w = 0;
        std::vector<int64_t> new_ptr(n + 1, 0);
        for (int64_t i = 0; i < n; ++i) {
            int64_t b = adj_ptr[i], e = adj_ptr[i + 1];
            std::sort(adj.begin() + b, adj.begin() + e);
            int64_t start = w;
            for (int64_t k = b; k < e; ++k) {
                if (k == b || adj[k] != adj[k - 1]) { adj[w++] = adj[k]; }
            }
            new_ptr[i + 1] = new_ptr[i] + (w - start);
        }
        adj_ptr.swap(new_ptr);
        for (int64_t i = 0; i < n; ++i) { deg[i] = adj_ptr[i + 1] - adj_ptr[i]; }
    }

    std::vector<uint8_t> visited(n, 0);
    std::vector<int64_t> level_of(n);
    int64_t out = 0;

    auto bfs = [&](int64_t start, std::vector<int64_t>& order,
                   int64_t* last_level_begin) -> int64_t {
        // plain BFS recording levels; returns the eccentricity, fills
        // `order` with the component in BFS order and last_level_begin
        // with the index where the final level starts.  Marks nodes 2 in
        // `visited` during the sweep and unmarks after (1 = placed).
        order.clear();
        order.push_back(start);
        level_of[start] = 0;
        int64_t head = 0;
        visited[start] = 2;
        int64_t ecc = 0, last_begin = 0;
        while (head < static_cast<int64_t>(order.size())) {
            int64_t u = order[head++];
            if (level_of[u] > ecc) { ecc = level_of[u]; last_begin = head - 1; }
            for (int64_t k = adj_ptr[u]; k < adj_ptr[u + 1]; ++k) {
                int64_t v = adj[k];
                if (visited[v] == 0) {
                    visited[v] = 2;
                    level_of[v] = level_of[u] + 1;
                    order.push_back(v);
                }
            }
        }
        for (int64_t x : order) { visited[x] = 0; }
        *last_level_begin = last_begin;
        return ecc;
    };

    std::vector<int64_t> comp, comp2;
    for (int64_t root_scan = 0; root_scan < n; ++root_scan) {
        if (visited[root_scan]) continue;
        // George-Liu pseudo-peripheral node: from root_scan, walk to the
        // min-degree node of the far level while the eccentricity grows
        int64_t start = root_scan;
        int64_t last_begin = 0;
        int64_t ecc = bfs(start, comp, &last_begin);
        for (int iter = 0; iter < 8; ++iter) {
            int64_t best = comp[last_begin];
            for (int64_t k = last_begin;
                 k < static_cast<int64_t>(comp.size()); ++k) {
                if (deg[comp[k]] < deg[best]) { best = comp[k]; }
            }
            int64_t lb2 = 0;
            int64_t ecc2 = bfs(best, comp2, &lb2);
            if (ecc2 > ecc) {
                ecc = ecc2; start = best; comp.swap(comp2); last_begin = lb2;
            } else {
                break;
            }
        }
        // Cuthill-McKee BFS from `start`, neighbours by increasing degree
        int64_t comp_begin = out;
        perm_out[out++] = start;
        visited[start] = 1;
        int64_t head = comp_begin;
        std::vector<std::pair<int64_t, int64_t>> nbrs;  // (deg, node)
        while (head < out) {
            int64_t u = perm_out[head++];
            nbrs.clear();
            for (int64_t k = adj_ptr[u]; k < adj_ptr[u + 1]; ++k) {
                int64_t v = adj[k];
                if (!visited[v]) { visited[v] = 1; nbrs.push_back({deg[v], v}); }
            }
            std::sort(nbrs.begin(), nbrs.end());
            for (auto& dv : nbrs) { perm_out[out++] = dv.second; }
        }
        // reverse this component's ordering (the "R" in RCM)
        std::reverse(perm_out + comp_begin, perm_out + out);
    }
}

// ---------------------------------------------------------------------------
// Matrix Market coordinate lines "<row + 1> <col + 1> <value>\n", the value
// with 17 significant digits (which reads back to the same double).  Each
// thread formats a contiguous run of entries into its own stretch of
// `out` (MM_LINE_MAX bytes an entry), and the stretches are then closed
// up.  Returns the bytes written.
// ---------------------------------------------------------------------------

#define MM_LINE_MAX 72

int64_t mm_line_max(void) { return MM_LINE_MAX; }

int64_t mm_format_coo(
    int64_t nnz, const int64_t* rows, const int64_t* cols,
    const double* vals, char* out
) {
    const int nt = omp_get_max_threads();
    std::vector<int64_t> len(nt, 0), first(nt + 1, 0);
    for (int t = 0; t <= nt; ++t) { first[t] = nnz * t / nt; }
    #pragma omp parallel for schedule(static, 1)
    for (int t = 0; t < nt; ++t) {
        char* p = out + first[t] * MM_LINE_MAX;
        char* const p0 = p;
        for (int64_t k = first[t]; k < first[t + 1]; ++k) {
            p += std::snprintf(p, MM_LINE_MAX, "%lld %lld %.17g\n",
                               static_cast<long long>(rows[k] + 1),
                               static_cast<long long>(cols[k] + 1), vals[k]);
        }
        len[t] = p - p0;
    }
    int64_t w = 0;
    for (int t = 0; t < nt; ++t) {
        std::memmove(out + w, out + first[t] * MM_LINE_MAX, len[t]);
        w += len[t];
    }
    return w;
}

}  // extern "C"
