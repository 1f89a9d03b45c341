// tpufem_torch native host runtime: mesh preprocessing kernels.
//
// The port's own copy of the JAX package's host library: the same plain C
// symbols, function for function, so that host tables built by either
// package are equal. It covers the one-time host preprocessing that would
// otherwise be NumPy: entity deduplication, scatter->gather plan
// transposition, reverse Cuthill-McKee reordering, Morton (SFC) ordering,
// the lane planner's passes, damage smoothing and the SA-AMG aggregation.
// The device compute path is PyTorch/CUDA and never calls it. Loaded via
// ctypes (no pybind11).
//
// Build: see tpufem_torch/native.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <vector>

extern "C" {

// Deduplicate candidate entities given as (n, nv) vertex tuples.
// Writes: sorted-unique entities into out_entities ((n, nv), only the
// first n_unique rows valid), and the candidate→unique map into
// out_inverse (n). Rows must already be vertex-sorted. Returns n_unique.
int64_t unique_entities(const int32_t* cand, int64_t n, int64_t nv,
                        int32_t* out_entities, int64_t* out_inverse) {
    std::vector<int64_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    auto less = [cand, nv](int64_t a, int64_t b) {
        const int32_t* ra = cand + a * nv;
        const int32_t* rb = cand + b * nv;
        for (int64_t k = 0; k < nv; ++k) {
            if (ra[k] != rb[k]) return ra[k] < rb[k];
        }
        return false;
    };
    std::sort(order.begin(), order.end(), less);
    auto equal = [cand, nv](int64_t a, int64_t b) {
        return std::memcmp(cand + a * nv, cand + b * nv,
                           nv * sizeof(int32_t)) == 0;
    };
    int64_t nu = -1;
    for (int64_t i = 0; i < n; ++i) {
        int64_t e = order[i];
        if (nu < 0 || !equal(order[i - 1], e)) {
            ++nu;
            std::memcpy(out_entities + nu * nv, cand + e * nv,
                        nv * sizeof(int32_t));
        }
        out_inverse[e] = nu;
    }
    return nu + 1;
}

// Transpose a scatter: targets[e] = target row of source entry e.
// Emits the (K, n_targets) gather table (pad = n_src) used by
// GatherSumPlan (tpufem/assemble/scatter.py). Returns K.
int64_t gather_plan(const int64_t* targets, int64_t n_src,
                    int64_t n_targets, int32_t* out_idx /* K*n_targets */,
                    int64_t max_k) {
    std::vector<int32_t> counts(n_targets, 0);
    for (int64_t e = 0; e < n_src; ++e) counts[targets[e]]++;
    int64_t K = 0;
    for (int64_t t = 0; t < n_targets; ++t) K = std::max<int64_t>(K, counts[t]);
    if (K > max_k) return -K;  // caller must re-allocate
    // fill column-wise: out_idx[k * n_targets + t]
    for (int64_t i = 0; i < K * n_targets; ++i) out_idx[i] = (int32_t)n_src;
    std::vector<int32_t> fill(n_targets, 0);
    for (int64_t e = 0; e < n_src; ++e) {
        int64_t t = targets[e];
        out_idx[(int64_t)fill[t] * n_targets + t] = (int32_t)e;
        fill[t]++;
    }
    return K;
}

// Reverse Cuthill-McKee ordering of an undirected graph in CSR form.
// out_perm[new_index] = old_index. Handles disconnected graphs.
void rcm_ordering(const int64_t* indptr, const int32_t* indices,
                  int64_t n, int32_t* out_perm) {
    std::vector<uint8_t> visited(n, 0);
    std::vector<int32_t> order;
    order.reserve(n);
    std::vector<int32_t> nbrs;
    for (int64_t start_scan = 0; start_scan < n;) {
        // next unvisited node of minimum degree in this component scan
        while (start_scan < n && visited[start_scan]) ++start_scan;
        if (start_scan >= n) break;
        // find min-degree unvisited node (global scan is fine: host-side,
        // one-time)
        int64_t best = start_scan;
        int64_t best_deg = indptr[best + 1] - indptr[best];
        for (int64_t v = start_scan; v < n; ++v) {
            if (!visited[v]) {
                int64_t d = indptr[v + 1] - indptr[v];
                if (d < best_deg) { best = v; best_deg = d; }
            }
        }
        std::queue<int32_t> q;
        q.push((int32_t)best);
        visited[best] = 1;
        while (!q.empty()) {
            int32_t v = q.front(); q.pop();
            order.push_back(v);
            nbrs.clear();
            for (int64_t j = indptr[v]; j < indptr[v + 1]; ++j) {
                int32_t w = indices[j];
                if (!visited[w]) { visited[w] = 1; nbrs.push_back(w); }
            }
            std::sort(nbrs.begin(), nbrs.end(),
                      [indptr](int32_t a, int32_t b) {
                          return (indptr[a + 1] - indptr[a]) <
                                 (indptr[b + 1] - indptr[b]);
                      });
            for (int32_t w : nbrs) q.push(w);
        }
    }
    // reverse
    for (int64_t i = 0; i < n; ++i) out_perm[i] = order[n - 1 - i];
}

// Greedy Vanek smoothed-aggregation seeding on a symmetric CSR strength
// graph (zero diagonal assumed removed). The sequential three-phase
// algorithm of the SA-AMG literature — the role of hypre BoomerAMG's
// coarsening in the reference solve (FEniCSx/mechanic2d/
// asym_elasto_damage_model.cc:720-813). Deterministic.
// out_agg[i] = aggregate id; returns n_agg.
int64_t amg_aggregate(const int64_t* indptr, const int32_t* indices,
                      const double* data, int64_t n, int64_t* out_agg) {
    for (int64_t i = 0; i < n; ++i) out_agg[i] = -1;
    int64_t n_agg = 0;
    // phase 1: a node whose whole neighborhood is free seeds an
    // aggregate of itself + its neighbors
    for (int64_t i = 0; i < n; ++i) {
        if (out_agg[i] != -1) continue;
        bool free_nbhd = true;
        for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j) {
            if (out_agg[indices[j]] != -1) { free_nbhd = false; break; }
        }
        if (!free_nbhd) continue;
        int64_t id = n_agg++;
        out_agg[i] = id;
        for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j)
            out_agg[indices[j]] = id;
    }
    // phase 2: attach remaining nodes to the strongest phase-1
    // neighbor aggregate (buffered so attachments do not chain)
    std::vector<int64_t> phase2(n, -1);
    for (int64_t i = 0; i < n; ++i) {
        if (out_agg[i] != -1) continue;
        double best_w = -1.0;
        int64_t best_a = -1;
        for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j) {
            int64_t a = out_agg[indices[j]];
            if (a != -1 && data[j] > best_w) { best_w = data[j]; best_a = a; }
        }
        phase2[i] = best_a;
    }
    for (int64_t i = 0; i < n; ++i)
        if (phase2[i] != -1) out_agg[i] = phase2[i];
    // phase 3: leftovers (isolated pockets) seed new aggregates with
    // their still-free neighbors
    for (int64_t i = 0; i < n; ++i) {
        if (out_agg[i] != -1) continue;
        int64_t id = n_agg++;
        out_agg[i] = id;
        for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j) {
            if (out_agg[indices[j]] == -1) out_agg[indices[j]] = id;
        }
    }
    return n_agg;
}

// Morton (Z-curve) ordering of points in up to 3 dimensions.
// out_order[rank] = point index.
void morton_order(const double* coords, int64_t n, int64_t dim,
                  int64_t* out_order) {
    const int bits = 20;
    double mins[3] = {0, 0, 0}, maxs[3] = {0, 0, 0};
    for (int64_t d = 0; d < dim; ++d) {
        mins[d] = maxs[d] = coords[d];
    }
    for (int64_t i = 1; i < n; ++i) {
        for (int64_t d = 0; d < dim; ++d) {
            double v = coords[i * dim + d];
            mins[d] = std::min(mins[d], v);
            maxs[d] = std::max(maxs[d], v);
        }
    }
    std::vector<std::pair<uint64_t, int64_t>> keys(n);
    for (int64_t i = 0; i < n; ++i) {
        uint64_t code = 0;
        uint64_t q[3] = {0, 0, 0};
        for (int64_t d = 0; d < dim; ++d) {
            double span = maxs[d] - mins[d];
            double x = span > 0 ? (coords[i * dim + d] - mins[d]) / span : 0;
            q[d] = (uint64_t)(x * ((1u << bits) - 1));
        }
        for (int b = 0; b < bits; ++b) {
            for (int64_t d = 0; d < dim; ++d) {
                code |= ((q[d] >> b) & 1ull) << (b * dim + d);
            }
        }
        keys[i] = {code, i};
    }
    std::stable_sort(keys.begin(), keys.end());
    for (int64_t i = 0; i < n; ++i) out_order[i] = keys[i].second;
}

// Balance the lane planner's cell->home-bin assignment
// (tpufem/lane/plan.py "home-bins" stage). Each cell may be homed in
// any of its nv nodes' bins (cand gives the candidate bin keys); start
// from node 0's bin and move cells out of bins loaded past the target,
// only into candidate bins of maximal residency (number of the cell's
// nodes homed there — fewer copy slots) with spare room; raise the
// target by 8 when no move is possible. Online load updates give the
// same damping as the NumPy round quotas. Writes the chosen candidate
// INDEX (0..nv-1) per cell; returns the final target.
int64_t lane_balance(const int64_t* cand, int64_t nc, int64_t nv,
                     int64_t n_keys, int64_t target0, int64_t* choice) {
    std::vector<int64_t> loads(n_keys, 0);
    std::vector<int8_t> allowed(nc * nv);
    // residency of each candidate: one entry per node of the cell (27 for
    // a Q2 hexahedron; a fixed 16-entry array overflowed there)
    std::vector<int8_t> res(nv);
    for (int64_t i = 0; i < nc; ++i) {
        const int64_t* c = cand + i * nv;
        int8_t mx = 0;
        for (int64_t a = 0; a < nv; ++a) {
            int8_t r = 0;
            for (int64_t b = 0; b < nv; ++b) r += (c[a] == c[b]);
            res[a] = r;
            mx = std::max(mx, r);
        }
        for (int64_t a = 0; a < nv; ++a)
            allowed[i * nv + a] = (res[a] == mx);
        choice[i] = 0;
        loads[c[0]]++;
    }
    // round/quota scheme, identical to the NumPy fallback in
    // tpufem/lane/plan.py: per round, loads are FROZEN, each
    // overloaded cell nominates its least-loaded allowed bin, and each
    // target bin accepts movers (stable cell order) only up to its
    // spare room. Freezing loads within a round damps herding — an
    // online-updating greedy measurably converges to worse kc padding
    // (24 vs 16 on a jittered polycrystal test mesh).
    int64_t target = target0;
    std::vector<int64_t> room(n_keys);
    for (int round = 0; round < 64; ++round) {
        int64_t mx = 0;
        for (int64_t k = 0; k < n_keys; ++k) mx = std::max(mx, loads[k]);
        if (mx <= target) break;
        for (int64_t k = 0; k < n_keys; ++k)
            room[k] = target - loads[k];
        bool moved = false;
        for (int64_t i = 0; i < nc; ++i) {
            const int64_t* c = cand + i * nv;
            int64_t cur = c[choice[i]];
            if (loads[cur] <= target) continue;
            int64_t best = -1, bl = INT64_MAX;
            for (int64_t a = 0; a < nv; ++a) {
                if (!allowed[i * nv + a]) continue;
                int64_t l = loads[c[a]];
                if (l < bl) { bl = l; best = a; }
            }
            if (best >= 0 && bl < target && room[c[best]] > 0) {
                --room[c[best]];
                choice[i] = best;
                moved = true;
            }
        }
        if (!moved) {
            target += 8;
            continue;
        }
        // recompute loads from the updated choices for the next round
        std::fill(loads.begin(), loads.end(), 0);
        for (int64_t i = 0; i < nc; ++i) loads[cand[i * nv + choice[i]]]++;
    }
    return target;
}

// Copies stage of the lane planner (tpufem/lane/plan.py "copies"):
// for every (cell, vertex) whose node is homed in a different bin than
// the cell, deduplicate the (cell-bin-key, node) pair, rank each unique
// copy within its bin (sorted by (bin, node) — matches the NumPy
// np.unique order), and emit the per-(cell, vertex) gather offset:
// own nodes -> their row_in_bin, foreign nodes -> wg_own + copy rank.
// Outputs (caller allocates at nc*nv capacity): out_off (nc*nv),
// out_ubin / out_unode / out_urank (first n_unique entries valid).
// out_meta[0] = max copies per bin. Returns n_unique.
int64_t lane_copies(const int64_t* cells, const int64_t* cell_key,
                    const int64_t* node_key, const int64_t* row_in_bin,
                    int64_t nc, int64_t nv, int64_t n_nodes,
                    int64_t wg_own, int64_t* out_off, int64_t* out_ubin,
                    int64_t* out_unode, int64_t* out_urank,
                    int64_t* out_meta) {
    std::vector<std::pair<int64_t, int64_t>> entries;  // (pairkey, flat)
    for (int64_t i = 0; i < nc; ++i) {
        int64_t ck = cell_key[i];
        for (int64_t v = 0; v < nv; ++v) {
            int64_t nd = cells[i * nv + v];
            if (node_key[nd] != ck) {
                entries.push_back({ck * n_nodes + nd, i * nv + v});
            } else {
                out_off[i * nv + v] = row_in_bin[nd];
            }
        }
    }
    std::sort(entries.begin(), entries.end());
    int64_t nu = 0, max_per_bin = 0, run = 0;
    int64_t prev_key = INT64_MIN, prev_bin = INT64_MIN;
    for (size_t e = 0; e < entries.size(); ++e) {
        int64_t key = entries[e].first;
        if (key != prev_key) {
            int64_t bin = key / n_nodes;
            if (bin != prev_bin) {
                run = 0;
                prev_bin = bin;
            }
            out_ubin[nu] = bin;
            out_unode[nu] = key % n_nodes;
            out_urank[nu] = run++;
            max_per_bin = std::max(max_per_bin, run);
            prev_key = key;
            ++nu;
        }
        out_off[entries[e].second] = wg_own + out_urank[nu - 1];
    }
    out_meta[0] = max_per_bin;
    return nu;
}

// Counting-sort rank: out_rank[i] = number of j < i with keys[j] ==
// keys[i] (stable within-key position). Replaces the planner's
// argsort + searchsorted rank computation, O(n log n) -> O(n).
void rank_by_key(const int64_t* keys, int64_t n, int64_t n_keys,
                 int64_t* out_rank) {
    std::vector<int64_t> seen(n_keys, 0);
    for (int64_t i = 0; i < n; ++i) out_rank[i] = seen[keys[i]]++;
}

// Fill the lane gather table and cell-order map in one pass
// (tpufem/lane/plan.py "gather-idx" stage). For cell i homed at bin
// g[i], lane j[i], slot cpos[i]: gather_idx[g, v, cpos, j] = off[i, v]
// and cell_order[(g*kc + cpos)*128 + j] = i. Both outputs must be
// pre-filled with -1.
void lane_gather_fill(const int64_t* g, const int64_t* j,
                      const int64_t* cpos, const int64_t* off,
                      int64_t nc, int64_t nv, int64_t kc,
                      int32_t* gather_idx, int64_t* cell_order) {
    const int64_t L = 128;
    for (int64_t i = 0; i < nc; ++i) {
        int64_t base = ((g[i] * nv) * kc + cpos[i]) * L + j[i];
        for (int64_t v = 0; v < nv; ++v)
            gather_idx[base + v * kc * L] = (int32_t)off[i * nv + v];
        cell_order[(g[i] * kc + cpos[i]) * L + j[i]] = i;
    }
}

// Damage smoothing host loop (tpufem/cases/damage.py host twin of the
// reference's FEniCSx/...cc:414-473 two-half-step iteration). nb is
// the sentinel-padded ELL neighbor table (n, k) with pad entries == n;
// per-row sums accumulate left-to-right over k, matching the NumPy
// axis-sum of the twin element-for-element.
void damage_smooth(const int32_t* nb, int64_t n, int64_t k,
                   const double* inv_deg, double* d,
                   int64_t iterations, double thresh) {
    std::vector<double> ext((size_t)n + 1, 0.0);
    std::vector<double> avg((size_t)n, 0.0);
    auto neighbor_avg = [&]() {
        std::copy(d, d + n, ext.begin());
        ext[n] = 0.0;
        for (int64_t i = 0; i < n; ++i) {
            double s = 0.0;
            const int32_t* row = nb + i * k;
            for (int64_t j = 0; j < k; ++j) s += ext[row[j]];
            avg[i] = s * inv_deg[i];
        }
    };
    for (int64_t it = 0; it < iterations; ++it) {
        neighbor_avg();
        for (int64_t i = 0; i < n; ++i) {
            double cand = d[i] < thresh ? avg[i] : 0.0;
            d[i] = std::max(cand, d[i]);
        }
        neighbor_avg();
        for (int64_t i = 0; i < n; ++i) d[i] = std::max(avg[i], d[i]);
    }
}

}  // extern "C"
