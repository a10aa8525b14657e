// Host-side Vecchia preprocessing: maximin (farthest-point) ordering and
// k-nearest-predecessor / scaled-ball neighbor search.
//
// These are inherently sequential/greedy host algorithms (argsort-like data
// preprocessing), so they live in native code rather than on the device: the
// device then consumes their outputs (order / neighbor indices) as plain
// gather indices.  This is the PyTorch port's own copy of
// approximategps_tpu/native/vecchia_order.cpp (same algorithms, same
// outputs).  Counterpart of the orderings discussed for the reference's
// NearestNeighborsModule (src/NearestNeighborsModule.jl:63-72 fixes the
// ordering to "as given"); maximin ordering follows Guinness (2018), the
// scaled-ball pattern Schäfer et al. (arXiv 2004.14455).
//
// Exposed as a plain C ABI for ctypes.  All three entry points dispatch to
// a UNIFORM-GRID accelerated implementation for low-dimensional inputs
// (D <= 4, the spatial regime these orderings exist for) and to the exact
// brute-force scans otherwise.  The grid paths are EXACT — identical
// selections to the brute scans, including lowest-index tie-breaking —
// just with range/ring queries instead of O(N) scans:
//
//   maximin:   lazy-deletion max-heap over dist-to-ordered-set + radius-
//              bounded updates (each selection only touches points within
//              the current maximin radius) — ~O(N log N) vs O(N^2).
//   nearest:   expanding-ring kNN over the ordered prefix with the kth-best
//              bound as the stopping rule.
//   scaled:    ring search for ell_i (nearest predecessor), then one range
//              query at rho*ell_i, keeping the k nearest in-ball.
//
// The grid is a PACKED-CSR structure (cell_ptr offsets + per-cell ids and
// coordinates stored contiguously, ids ascending within each cell) rather
// than bucket-of-vectors: the query loops are memory-bound, and the packed
// layout both streams candidates from contiguous memory and lets the
// predecessor filter (only ids < i are valid) early-exit per cell instead of
// scanning rejects.  The predecessor searches rebuild
// the grid at doubling prefix capacities (total rebuild work <= 2N inserts,
// a geometric series) so cell occupancy tracks the CURRENT prefix density;
// the initial query radius is derived from the true predecessor count i so
// the first ring targets ~1.6k candidates instead of over-covering.
//

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <limits>
#include <queue>

namespace {

inline double sqdist(const double* a, const double* b, int64_t D) {
    double s = 0.0;
    for (int64_t d = 0; d < D; ++d) {
        const double t = a[d] - b[d];
        s += t * t;
    }
    return s;
}

constexpr int64_t kGridMaxD = 4;      // grid paths only for spatial D
constexpr int64_t kBruteMinN = 2048;  // below this brute force wins anyway

// Volume of the unit L2 ball per dimension, for the expected-count initial
// radius: a ball of radius r among n points of density n/vol holds
// ~ n * c_D r^D / vol points.
constexpr double kBallVol[kGridMaxD + 1] = {
    1.0, 2.0, 3.14159265358979324, 4.18879020478639098, 4.93480220054467931};

// kth-best tracker with lowest-index tie-break, matching the brute scans'
// "strictly better replaces" + ascending-position emission.  Flat max-heap
// over (dist, pos) with REUSABLE storage (reset() keeps capacity): the
// query loops run one of these per point and a fresh priority_queue per
// query was measurable allocator churn.  Lexicographic max-heap order means
// among equal dists the LARGEST pos is on top and gets evicted first,
// matching a brute scan that only replaces on strict improvement (keeps the
// earliest positions).
struct KBest {
    int64_t k = 0;
    std::vector<std::pair<double, int64_t>> v;  // max-heap (lexicographic)
    std::vector<int64_t> scratch;               // emit workspace
    explicit KBest(int64_t kk = 0) { reset(kk); }
    void reset(int64_t kk) {
        k = kk;
        v.clear();
    }
    inline double bound() const {
        return (static_cast<int64_t>(v.size()) < k)
                   ? std::numeric_limits<double>::infinity()
                   : v.front().first;
    }
    inline void offer(double d, int64_t pos) {
        if (k <= 0) return;
        if (static_cast<int64_t>(v.size()) < k) {
            v.emplace_back(d, pos);
            std::push_heap(v.begin(), v.end());
        } else if (d < v.front().first ||
                   (d == v.front().first && pos < v.front().second)) {
            std::pop_heap(v.begin(), v.end());
            v.back() = {d, pos};
            std::push_heap(v.begin(), v.end());
        }
    }
    void emit(int64_t* out, int64_t k_out) {
        scratch.clear();
        for (const auto& e : v) scratch.push_back(e.second);
        std::sort(scratch.begin(), scratch.end());
        for (int64_t t = 0; t < k_out; ++t)
            out[t] = (t < static_cast<int64_t>(scratch.size())) ? scratch[t]
                                                                : -1;
    }
};

// Uniform grid over the bounding box of the first m rows of a point set,
// packed CSR: ptr (ncells+1) offsets into ids/pts, ids ASCENDING within
// each cell (stable counting sort), coordinates copied alongside so range
// queries stream contiguous memory instead of gathering rows of X.
struct PackedGrid {
    int64_t D = 0;
    int64_t ncells = 1;
    int64_t live_dims = 0;
    int64_t res[kGridMaxD], stride[kGridMaxD];
    double lo[kGridMaxD], hi[kGridMaxD];
    double h[kGridMaxD], inv_h[kGridMaxD];
    double h_min = 1.0;
    std::vector<int64_t> ptr;
    std::vector<int32_t> ids;
    std::vector<double> pts;
    std::vector<int64_t> cell_scratch;

    void build(const double* Xp, int64_t m, int64_t Dp, int64_t target_occ) {
        D = Dp;
        for (int64_t d = 0; d < D; ++d) {
            lo[d] = std::numeric_limits<double>::infinity();
            hi[d] = -std::numeric_limits<double>::infinity();
        }
        for (int64_t i = 0; i < m; ++i)
            for (int64_t d = 0; d < D; ++d) {
                const double v = Xp[i * D + d];
                lo[d] = std::min(lo[d], v);
                hi[d] = std::max(hi[d], v);
            }
        // aim for ~target_occ points per cell: equal cell EDGE h across
        // dims, h = (vol / (m / occ))^(1/D) with degenerate-extent guards
        double vol = 1.0;
        live_dims = 0;
        for (int64_t d = 0; d < D; ++d) {
            const double e = hi[d] - lo[d];
            if (e > 0) { vol *= e; ++live_dims; }
        }
        const double want_cells =
            std::max<double>(1.0, static_cast<double>(m) /
                                      std::max<int64_t>(1, target_occ));
        const double hh = live_dims > 0
            ? std::pow(vol / want_cells, 1.0 / static_cast<double>(live_dims))
            : 1.0;
        ncells = 1;
        for (int64_t d = 0; d < D; ++d) {
            const double e = hi[d] - lo[d];
            res[d] = 1;
            if (e > 0 && hh > 0) {
                res[d] = std::max<int64_t>(
                    1, static_cast<int64_t>(std::floor(e / hh)));
                // cap total cells at ~4m to bound memory on skewed aspect
                if (ncells * res[d] > 4 * m)
                    res[d] = std::max<int64_t>(
                        1, 4 * m / std::max<int64_t>(1, ncells));
            }
            h[d] = (e > 0) ? e / static_cast<double>(res[d]) : 1.0;
            inv_h[d] = (e > 0) ? 1.0 / h[d] : 0.0;
            ncells *= res[d];
        }
        for (int64_t d = D - 1; d >= 0; --d)
            stride[d] = (d == D - 1) ? 1 : stride[d + 1] * res[d + 1];
        h_min = std::numeric_limits<double>::infinity();
        for (int64_t d = 0; d < D; ++d)
            if (hi[d] - lo[d] > 0) h_min = std::min(h_min, h[d]);
        if (!std::isfinite(h_min)) h_min = 1.0;  // all-degenerate input

        // CSR fill: count, exclusive scan, stable ascending-id placement
        ptr.assign(static_cast<size_t>(ncells) + 1, 0);
        ids.resize(m);
        pts.resize(static_cast<size_t>(m) * D);
        cell_scratch.resize(m);
        for (int64_t i = 0; i < m; ++i) {
            cell_scratch[i] = cell_of(&Xp[i * D]);
            ++ptr[cell_scratch[i] + 1];
        }
        for (int64_t c = 0; c < ncells; ++c) ptr[c + 1] += ptr[c];
        std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
        for (int64_t i = 0; i < m; ++i) {
            const int64_t at = cur[cell_scratch[i]]++;
            ids[at] = static_cast<int32_t>(i);
            std::memcpy(&pts[at * D], &Xp[i * D], sizeof(double) * D);
        }
    }

    inline int64_t cell_coord(double v, int64_t d) const {
        int64_t c = static_cast<int64_t>((v - lo[d]) * inv_h[d]);
        return std::min(std::max<int64_t>(c, 0), res[d] - 1);
    }

    inline int64_t cell_of(const double* x) const {
        int64_t id = 0;
        for (int64_t d = 0; d < D; ++d) id += cell_coord(x[d], d) * stride[d];
        return id;
    }

    // squared distance from point x to the closed cell box `cc` (per-dim ids)
    inline double cell_min_sq(const double* x, const int64_t* cc) const {
        double s = 0.0;
        for (int64_t d = 0; d < D; ++d) {
            const double clo = lo[d] + cc[d] * h[d];
            const double chi = clo + h[d];
            double t = 0.0;
            if (x[d] < clo) t = clo - x[d];
            else if (x[d] > chi) t = x[d] - chi;
            s += t * t;
        }
        return s;
    }

    // Visit every stored id < id_limit in cells whose min distance to x is
    // <= r2, passing the id and its PACKED coordinate row.  Ids ascend
    // within a cell, so the id_limit filter breaks out of a cell at the
    // first reject instead of scanning them.  (Stack arrays: this is the
    // innermost query loop — a heap allocation trio per call measured as
    // real time over ~1e7 ring queries.)
    template <typename F>
    void range(const double* x, double r2, int32_t id_limit, F&& f) const {
        const double r = std::sqrt(r2);
        int64_t clo[kGridMaxD], chi[kGridMaxD], cc[kGridMaxD];
        for (int64_t d = 0; d < D; ++d) {
            clo[d] = cell_coord(x[d] - r, d);
            chi[d] = cell_coord(x[d] + r, d);
            cc[d] = clo[d];
        }
        while (true) {
            if (cell_min_sq(x, cc) <= r2) {
                int64_t id = 0;
                for (int64_t d = 0; d < D; ++d) id += cc[d] * stride[d];
                const int64_t end = ptr[id + 1];
                for (int64_t t = ptr[id]; t < end; ++t) {
                    const int32_t j = ids[t];
                    if (j >= id_limit) break;
                    f(j, &pts[t * D]);
                }
            }
            int64_t d = D - 1;
            while (d >= 0) {
                if (++cc[d] <= chi[d]) break;
                cc[d] = clo[d];
                --d;
            }
            if (d < 0) break;
        }
    }

    // Largest possible squared distance from x to any grid cell — once a
    // query radius covers this, one more pass sees everything.
    double max_extent_sq(const double* x) const {
        double s = 0.0;
        for (int64_t d = 0; d < D; ++d) {
            const double t = std::max(std::abs(x[d] - lo[d]),
                                      std::abs(hi[d] - x[d]));
            s += t * t;
        }
        return s;
    }

    // Initial squared radius for a query expecting ~target candidates among
    // n_pred uniformly-spread predecessors: solve n_pred * c_L r^L / vol =
    // target with vol estimated from the grid resolution (h^L * m / occ).
    // An underestimate only costs a doubling round; the ring loop corrects.
    double guess_r2(int64_t n_pred, int64_t m, int64_t target_occ,
                    double target) const {
        const int64_t L = std::max<int64_t>(1, live_dims);
        const double per = target * static_cast<double>(m) /
                           (static_cast<double>(target_occ) * kBallVol[L] *
                            std::max<int64_t>(1, n_pred));
        return h_min * h_min *
               std::pow(std::max(per, 1.0), 2.0 / static_cast<double>(L));
    }
};

// ---------------------------------------------------------------------------
// Exact brute-force reference implementations (small N / high D dispatch).
// ---------------------------------------------------------------------------

void maximin_brute(const double* X, int64_t N, int64_t D, int64_t* order) {
    std::vector<double> centroid(D, 0.0);
    for (int64_t i = 0; i < N; ++i)
        for (int64_t d = 0; d < D; ++d) centroid[d] += X[i * D + d];
    for (int64_t d = 0; d < D; ++d) centroid[d] /= static_cast<double>(N);

    int64_t first = 0;
    double best = sqdist(&X[0], centroid.data(), D);
    for (int64_t i = 1; i < N; ++i) {
        const double s = sqdist(&X[i * D], centroid.data(), D);
        if (s < best) { best = s; first = i; }
    }

    std::vector<double> mind(N);
    std::vector<char> taken(N, 0);
    order[0] = first;
    taken[first] = 1;
    for (int64_t i = 0; i < N; ++i)
        mind[i] = sqdist(&X[i * D], &X[first * D], D);

    for (int64_t step = 1; step < N; ++step) {
        int64_t pick = -1;
        double far = -1.0;
        for (int64_t i = 0; i < N; ++i) {
            if (!taken[i] && mind[i] > far) { far = mind[i]; pick = i; }
        }
        order[step] = pick;
        taken[pick] = 1;
        const double* xp = &X[pick * D];
        for (int64_t i = 0; i < N; ++i) {
            if (taken[i]) continue;
            const double s = sqdist(&X[i * D], xp, D);
            if (s < mind[i]) mind[i] = s;
        }
    }
}

void nearest_brute(const double* Xo, int64_t N, int64_t D, int64_t k,
                   int64_t* nbr) {
    KBest kb;
    for (int64_t i = 0; i < N; ++i) {
        kb.reset(std::min<int64_t>(k, i));
        const double* xi = &Xo[i * D];
        for (int64_t j = 0; j < i; ++j)
            kb.offer(sqdist(xi, &Xo[j * D], D), j);
        kb.emit(&nbr[i * k], k);
    }
}

void scaled_brute(const double* Xo, int64_t N, int64_t D, double rho,
                  int64_t k, int64_t* nbr) {
    const double rho2 = rho * rho;
    std::vector<double> d;
    KBest kb;
    for (int64_t i = 0; i < N; ++i) {
        if (i == 0) {
            for (int64_t t = 0; t < k; ++t) nbr[t] = -1;
            continue;
        }
        const double* xi = &Xo[i * D];
        d.resize(i);
        double ell2 = std::numeric_limits<double>::infinity();
        for (int64_t j = 0; j < i; ++j) {
            d[j] = sqdist(xi, &Xo[j * D], D);
            if (d[j] < ell2) ell2 = d[j];
        }
        const double r2 = rho2 * ell2;
        kb.reset(k);
        for (int64_t j = 0; j < i; ++j)
            if (d[j] <= r2) kb.offer(d[j], j);
        kb.emit(&nbr[i * k], k);
    }
}

}  // namespace

extern "C" {

// Greedy maximin ordering: first point = the one closest to the centroid
// (a canonical deterministic start), then repeatedly pick the point whose
// distance to the already-ordered set is largest (lowest index on ties).
void agp_maximin_order(const double* X, int64_t N, int64_t D, int64_t* order) {
    if (N <= 0) return;
    if (D > kGridMaxD || N < kBruteMinN) {
        maximin_brute(X, N, D, order);
        return;
    }

    std::vector<double> centroid(D, 0.0);
    for (int64_t i = 0; i < N; ++i)
        for (int64_t d = 0; d < D; ++d) centroid[d] += X[i * D + d];
    for (int64_t d = 0; d < D; ++d) centroid[d] /= static_cast<double>(N);
    int64_t first = 0;
    double best = sqdist(&X[0], centroid.data(), D);
    for (int64_t i = 1; i < N; ++i) {
        const double s = sqdist(&X[i * D], centroid.data(), D);
        if (s < best) { best = s; first = i; }
    }

    PackedGrid grid;
    grid.build(X, N, D, /*target_occ=*/2);
    const int32_t all = (N < INT32_MAX) ? static_cast<int32_t>(N) : INT32_MAX;

    std::vector<double> mind(N);
    std::vector<char> taken(N, 0);
    order[0] = first;
    taken[first] = 1;
    for (int64_t i = 0; i < N; ++i)
        mind[i] = sqdist(&X[i * D], &X[first * D], D);

    // lazy-deletion max-heap on (mind, -i): equal distances pop the LOWEST
    // index first, matching the brute scan's strict-> argmax
    std::priority_queue<std::pair<double, int64_t>> heap;
    for (int64_t i = 0; i < N; ++i)
        if (!taken[i]) heap.emplace(mind[i], -i);

    for (int64_t step = 1; step < N; ++step) {
        int64_t pick = -1;
        while (!heap.empty()) {
            const auto top = heap.top();
            const int64_t i = -top.second;
            if (taken[i] || top.first != mind[i]) { heap.pop(); continue; }
            pick = i;
            heap.pop();
            break;
        }
        order[step] = pick;
        taken[pick] = 1;
        const double* xp = &X[pick * D];
        // every point needing an update satisfies dist(j, pick) <
        // sqrt(mind[j]) <= sqrt(mind[pick]) — one radius query suffices
        const double r2 = mind[pick];
        grid.range(xp, r2, all, [&](int32_t j, const double* xj) {
            if (taken[j]) return;
            const double s = sqdist(xj, xp, D);
            if (s < mind[j]) {
                mind[j] = s;
                heap.emplace(s, -static_cast<int64_t>(j));
            }
        });
    }
}

// For each position i in the ordering, the k nearest points among the
// predecessors order[0..i-1] (exact).  nbr is (N, k) int64, padded with -1
// where i < k.  Positions in nbr refer to POSITIONS IN THE ORDERING.
void agp_nearest_predecessors(const double* X, int64_t N, int64_t D,
                              const int64_t* order, int64_t k, int64_t* nbr) {
    std::vector<double> Xo(static_cast<size_t>(N) * D);
    for (int64_t i = 0; i < N; ++i)
        std::memcpy(&Xo[i * D], &X[order[i] * D], sizeof(double) * D);
    if (D > kGridMaxD || N < kBruteMinN) {
        nearest_brute(Xo.data(), N, D, k, nbr);
        return;
    }

    // brute warmup: with few predecessors the ring search scans mostly
    // empty cells (maximin prefixes span the whole domain)
    const int64_t warm = std::min<int64_t>(N, std::max<int64_t>(4 * k, 256));
    // Density-matched re-gridding: a grid sized for all N points makes the
    // early ring queries sweep ~N/i mostly-empty cells each (the prefix is
    // sparse in a resolution built for the full set).  Build over the
    // current prefix [0, P) and rebuild at doubling capacities; total
    // rebuild work is <= 2N inserts (geometric series).  Queries filter to
    // ids < i, which the packed ascending-id cells early-exit on.
    const int64_t occ = 2;
    PackedGrid grid;
    int64_t P = std::min<int64_t>(N, std::max<int64_t>(2 * warm, 4096));
    grid.build(Xo.data(), P, D, occ);
    KBest kb;
    for (int64_t i = 0; i < N; ++i) {
        if (i == P && P < N) {
            P = std::min<int64_t>(N, 2 * P);
            grid.build(Xo.data(), P, D, occ);
        }
        const double* xi = &Xo[i * D];
        const int64_t ki = std::min<int64_t>(k, i);
        kb.reset(ki);
        if (i <= warm) {
            for (int64_t j = 0; j < i; ++j)
                kb.offer(sqdist(xi, &Xo[j * D], D), j);
        } else {
            // doubling-radius range queries: stop once the k-th best lies
            // inside the queried radius (anything outside is farther).
            // Each round restarts the candidate set — the larger box
            // revisits the smaller one, and restarting keeps the tracker
            // duplicate-free.  The first radius targets ~1.6k candidates
            // among the i true predecessors (k expected + slack so a
            // second round is the exception, not the rule).
            const double capr2 = grid.max_extent_sq(xi);
            double r2 = grid.guess_r2(i, P, occ, 1.6 * static_cast<double>(k));
            while (true) {
                kb.reset(ki);
                grid.range(xi, r2, static_cast<int32_t>(i),
                           [&](int32_t j, const double* xj) {
                               kb.offer(sqdist(xi, xj, D), j);
                           });
                if (kb.bound() <= r2 || r2 >= capr2) break;
                r2 *= 4.0;  // double the radius
            }
        }
        kb.emit(&nbr[i * k], k);
    }
}

// Schäfer et al. (arXiv 2004.14455) KL-minimized sparsity pattern, adapted
// to the fixed-k gather layout: for each ordering position i, the
// conditioning set is the predecessors within distance rho * ell_i, where
// ell_i = min_{j<i} dist(x_i, x_j) is the distance of point i to the
// already-ordered set (for the maximin ordering these are the maximin
// distances — the multiscale pattern of the paper's Theorem 3.2).  Sets
// larger than k keep the k nearest; smaller sets are padded with -1.
void agp_scaled_predecessors(const double* X, int64_t N, int64_t D,
                             const int64_t* order, double rho, int64_t k,
                             int64_t* nbr) {
    std::vector<double> Xo(static_cast<size_t>(N) * D);
    for (int64_t i = 0; i < N; ++i)
        std::memcpy(&Xo[i * D], &X[order[i] * D], sizeof(double) * D);
    if (D > kGridMaxD || N < kBruteMinN) {
        scaled_brute(Xo.data(), N, D, rho, k, nbr);
        return;
    }

    const double rho2 = rho * rho;
    const int64_t warm = std::min<int64_t>(N, std::max<int64_t>(4 * k, 256));
    // density-matched re-gridding, same schedule as agp_nearest_predecessors
    const int64_t occ = 2;
    PackedGrid grid;
    int64_t P = std::min<int64_t>(N, std::max<int64_t>(2 * warm, 4096));
    grid.build(Xo.data(), P, D, occ);
    std::vector<double> d;
    KBest kb;
    for (int64_t i = 0; i < N; ++i) {
        if (i == P && P < N) {
            P = std::min<int64_t>(N, 2 * P);
            grid.build(Xo.data(), P, D, occ);
        }
        const double* xi = &Xo[i * D];
        if (i == 0) {
            for (int64_t t = 0; t < k; ++t) nbr[t] = -1;
            continue;
        }
        kb.reset(k);
        if (i <= warm) {
            d.resize(i);
            double ell2 = std::numeric_limits<double>::infinity();
            for (int64_t j = 0; j < i; ++j) {
                d[j] = sqdist(xi, &Xo[j * D], D);
                if (d[j] < ell2) ell2 = d[j];
            }
            const double r2 = rho2 * ell2;
            for (int64_t j = 0; j < i; ++j)
                if (d[j] <= r2) kb.offer(d[j], j);
        } else {
            // ell_i: 1-NN among predecessors by doubling range queries,
            // starting from a radius expecting ~2 candidates
            const double capr2 = grid.max_extent_sq(xi);
            double q2 = grid.guess_r2(i, P, occ, 2.0);
            double ell2 = std::numeric_limits<double>::infinity();
            while (true) {
                grid.range(xi, q2, static_cast<int32_t>(i),
                           [&](int32_t j, const double* xj) {
                               const double s = sqdist(xi, xj, D);
                               if (s < ell2) ell2 = s;
                           });
                if (ell2 <= q2 || q2 >= capr2) break;
                q2 *= 4.0;
            }
            const double r2 = rho2 * ell2;
            // in-ball candidates, keep the k nearest (lowest index on ties)
            grid.range(xi, r2, static_cast<int32_t>(i),
                       [&](int32_t j, const double* xj) {
                           const double s = sqdist(xi, xj, D);
                           if (s <= r2) kb.offer(s, j);
                       });
        }
        kb.emit(&nbr[i * k], k);
    }
}

}  // extern "C"
