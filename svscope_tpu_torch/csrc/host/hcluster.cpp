// Sequential-order pairwise euclidean distances for the Ward-linkage init.
//
// scipy.spatial.distance.pdist's C kernel accumulates one feature at a
// time per pair: s += (u[k]-v[k])^2 in k order, then sqrt.  The EM init's
// bitwise-scipy parity contract (svscope_tpu/models/mixture.py::
// ward_linkage, replacing scipy linkage at reference
// src/ReadsCluster.py:242-243) depends on reproducing that exact rounding
// sequence — NumPy's pairwise-summation reductions differ by ~1 ulp,
// enough to flip downstream tie comparisons and reorder equal-height Ward
// merges.  The Python fallback therefore loops features sequentially,
// costing ~0.5 s at n=500 (125M fused sub/mul/add passes through (n,n)
// temporaries per feature).
//
// This kernel keeps the exact per-element operation order — for each pair
// the k loop is sequential with a single accumulator — but vectorizes over
// PAIRS: lanes are independent (i,j) accumulators, so SIMD never
// reassociates any pair's sum.  Input is transposed (nf, n) so the inner
// j loop is unit-stride.  Compiled with -ffp-contract=off: a fused
// multiply-add would skip the intermediate d*d rounding that scipy's and
// NumPy's separate ops perform.
//
// ~30 ms single-thread at n=nf=500 (vs ~0.5 s in Python), threaded over
// rows for larger inputs.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

extern "C" {

// xt: (nf, n) row-major (feature-major); out: (n, n) squared... no —
// full euclidean distances, diagonal left at 0.
void pdist_seq(const double* xt, int64_t n, int64_t nf, double* out,
               int32_t n_threads) {
    auto run_rows = [&](int64_t i0, int64_t i1) {
        for (int64_t i = i0; i < i1; ++i) {
            double* row = out + i * n;
            std::memset(row, 0, sizeof(double) * n);
            for (int64_t k = 0; k < nf; ++k) {
                const double xi = xt[k * n + i];
                const double* xr = xt + k * n;
                for (int64_t j = 0; j < n; ++j) {
                    const double d = xi - xr[j];
                    row[j] += d * d;
                }
            }
            for (int64_t j = 0; j < n; ++j) row[j] = std::sqrt(row[j]);
        }
    };
    if (n_threads <= 1 || n < 64) {
        run_rows(0, n);
        return;
    }
    std::vector<std::thread> pool;
    const int64_t t = n_threads;
    for (int64_t w = 0; w < t; ++w) {
        const int64_t i0 = n * w / t, i1 = n * (w + 1) / t;
        if (i0 < i1) pool.emplace_back(run_rows, i0, i1);
    }
    for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Full Ward NN-chain linkage + incremental K-cut labels (round 5).
//
// Replicates svscope_tpu/models/mixture.py::ward_linkage +
// ward_init_labels BITWISE (same float64 operation order, -ffp-contract
// =off so no FMA skips an intermediate rounding).  The Python NN-chain
// costs ~1.1 ms per 24-read window — 0.147 s of the 0.64 s localGraph
// chunk wall was this loop (round-5 stage probe), the single largest
// host-prep item in EM dispatch.  This kernel runs the whole
// sim -> pdist -> NN-chain -> stable-sort -> union-find -> K-cuts
// pipeline per window in C++, threaded across windows.
// ---------------------------------------------------------------------------

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// pdist with scipy's sequential per-pair accumulation over features of the
// (n, n) similarity matrix (observations = sim rows, nf = n), into D with
// +inf diagonal.  Identical element order to pdist_seq above; only the
// upper triangle is computed (each pair once) and mirrored — the matrix
// is symmetric by construction, so this halves the O(n^3) work without
// touching any pair's accumulation order.
void pdist_sim(const double* sim, int64_t n, double* D,
               std::vector<double>& xt) {
    xt.resize(n * n);
    for (int64_t i = 0; i < n; ++i)
        for (int64_t k = 0; k < n; ++k) xt[k * n + i] = sim[i * n + k];
    for (int64_t i = 0; i < n; ++i) {
        double* row = D + i * n;
        std::memset(row + i, 0, sizeof(double) * (n - i));
        for (int64_t k = 0; k < n; ++k) {
            const double xi = xt[k * n + i];
            const double* xr = xt.data() + k * n;
            for (int64_t j = i + 1; j < n; ++j) {
                const double d = xi - xr[j];
                row[j] += d * d;
            }
        }
        for (int64_t j = i + 1; j < n; ++j) row[j] = std::sqrt(row[j]);
        row[i] = kInf;
    }
    for (int64_t i = 1; i < n; ++i)
        for (int64_t j = 0; j < i; ++j) D[i * n + j] = D[j * n + i];
}

struct MergeRow { int64_t x, y; double dist; };

// One window: sim (n, n) row-major -> labels (kmax, n) int32, rows k-1
// hold the K=k cut (row 0 = all zeros), first-occurrence numbering.
//
// Dead nodes are POISONED: when a node dies its row and column in D are
// set to +inf, so the NN-chain scan is a branchless full-row min + a
// first-equal-index pass (first minimum wins, exactly np.min+np.argmin
// over the alive-masked row — inf never wins while >=2 nodes live), and
// the Lance-Williams update runs branchless over the whole row (dead
// lanes read inf and write inf back; all ops are elementwise IEEE in the
// NumPy operand order, so results are bitwise identical to the masked
// scalar loop — tested).  Assumes no NaN distances (valid inputs cannot
// produce them; the Python oracle's min/argmin would also misorder under
// NaN).
void ward_cut_one(const double* sim, int32_t n32, int32_t kmax,
                  int32_t* labels) {
    const int64_t n = n32;
    std::memset(labels, 0, sizeof(int32_t) * (int64_t)kmax * n);
    if (n < 2 || kmax < 2) return;
    std::vector<double> D(n * n), xt;
    pdist_sim(sim, n, D.data(), xt);
    std::vector<int64_t> size(n, 1);
    std::vector<double> dsize(n, 1.0);
    std::vector<char> alive(n, 1);
    std::vector<MergeRow> Z(n - 1);
    std::vector<int64_t> chain;
    chain.reserve(n);
    for (int64_t k = 0; k < n - 1; ++k) {
        if (chain.empty()) {
            for (int64_t i = 0; i < n; ++i)
                if (alive[i]) { chain.push_back(i); break; }
        }
        int64_t x, y;
        for (;;) {
            x = chain.back();
            const double* row = D.data() + x * n;
            double m = kInf;
            for (int64_t j = 0; j < n; ++j) m = std::min(m, row[j]);
            int64_t am = 0;
            for (int64_t j = 0; j < n; ++j)
                if (row[j] == m) { am = j; break; }
            if (chain.size() > 1) {
                const int64_t prev = chain[chain.size() - 2];
                y = (m < row[prev]) ? am : prev;
                if (y == prev) break;
            } else {
                y = am;
            }
            chain.push_back(y);
        }
        chain.pop_back();
        chain.pop_back();
        if (x > y) std::swap(x, y);
        const int64_t nx = size[x], ny = size[y];
        const double d_xy = D[x * n + y];
        Z[k] = {x, y, d_xy};
        alive[x] = 0;
        size[y] = nx + ny;
        // Lance-Williams Ward update, scipy/NumPy operand order:
        // sqrt((ni+nx)*t*d_xi*d_xi + (ni+ny)*t*d_yi*d_yi - ni*t*d_xy*d_xy)
        // Branchless over every i: dead i has d_yi = inf -> nv = inf
        // (stays poisoned); i = y has d_yi = D[y][y] = inf -> diagonal
        // stays inf; i = x gets overwritten by the poison pass below.
        {
            const double dnx = (double)nx, dny = (double)ny;
            const double nxny = (double)(nx + ny);
            double* rowx = D.data() + x * n;
            double* rowy = D.data() + y * n;
            const double* ds = dsize.data();
            for (int64_t i = 0; i < n; ++i) {
                const double ni = ds[i];
                const double t = 1.0 / (nxny + ni);
                const double d_xi = rowx[i];
                const double d_yi = rowy[i];
                rowy[i] = std::sqrt((ni + dnx) * t * d_xi * d_xi
                                    + (ni + dny) * t * d_yi * d_yi
                                    - ni * t * d_xy * d_xy);
            }
            for (int64_t i = 0; i < n; ++i) rowx[i] = kInf;   // poison row
            for (int64_t i = 0; i < n; ++i) {
                D[i * n + y] = rowy[i];                 // mirror column y
                D[i * n + x] = kInf;                    // poison column x
            }
            rowy[y] = kInf;                             // keep diagonal
            rowy[x] = kInf;
            dsize[y] = nxny;
        }
    }
    // stable sort by merge distance (np.argsort kind='stable')
    std::vector<int64_t> order(n - 1);
    for (int64_t i = 0; i < n - 1; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                         return Z[a].dist < Z[b].dist;
                     });
    // union-find relabel in sorted order (scipy label()): slot index ->
    // cluster id (leaf 0..n-1, merge i -> n+i)
    std::vector<int64_t> parent(2 * n - 1);
    for (int64_t i = 0; i < 2 * n - 1; ++i) parent[i] = i;
    auto find = [&](int64_t i) {
        int64_t root = i;
        while (parent[root] != root) root = parent[root];
        while (parent[i] != root) {
            const int64_t nxt = parent[i];
            parent[i] = root;
            i = nxt;
        }
        return root;
    };
    std::vector<std::pair<int64_t, int64_t>> merges(n - 1);
    for (int64_t i = 0; i < n - 1; ++i) {
        int64_t xr = find(Z[order[i]].x), yr = find(Z[order[i]].y);
        if (xr > yr) std::swap(xr, yr);
        merges[i] = {xr, yr};
        parent[xr] = parent[yr] = n + i;
    }
    // incremental cuts: apply merges small-K-ward from K=min(kmax,n) to 2,
    // labels numbered by first leaf occurrence
    std::vector<int64_t> root(n);
    for (int64_t i = 0; i < n; ++i) root[i] = i;
    std::vector<std::vector<int32_t>> members(2 * n - 1);
    for (int64_t i = 0; i < n; ++i) members[i] = {(int32_t)i};
    std::vector<int32_t> remap(2 * n - 1);
    int64_t m = 0;
    const int64_t ktop = std::min<int64_t>(kmax, n);
    for (int64_t k = ktop; k >= 2; --k) {
        while (m < n - k) {
            const auto [a, b] = merges[m];
            auto& ma = members[a];
            auto& mb = members[b];
            auto& mc = members[n + m];
            mc.reserve(ma.size() + mb.size());
            mc.insert(mc.end(), ma.begin(), ma.end());
            mc.insert(mc.end(), mb.begin(), mb.end());
            for (const int32_t leaf : mc) root[leaf] = n + m;
            ma.clear(); ma.shrink_to_fit();
            mb.clear(); mb.shrink_to_fit();
            ++m;
        }
        int32_t next_id = 0;
        std::fill(remap.begin(), remap.end(), (int32_t)-1);
        int32_t* lrow = labels + (k - 1) * n;
        for (int64_t i = 0; i < n; ++i) {
            int32_t& slot = remap[root[i]];
            if (slot < 0) slot = next_id++;
            lrow[i] = slot;
        }
    }
}

}  // namespace

// sims: concatenated (n_w, n_w) float64 blocks at sim_off[w] doubles;
// labels: concatenated (kmax, n_w) int32 blocks at lab_off[w] ints.
void ward_cut_batch(const double* sims, const int64_t* sim_off,
                    const int32_t* ns, int64_t n_windows, int32_t kmax,
                    int32_t* labels, const int64_t* lab_off,
                    int32_t n_threads) {
    auto run = [&](int64_t w0, int64_t w1) {
        for (int64_t w = w0; w < w1; ++w)
            ward_cut_one(sims + sim_off[w], ns[w], kmax,
                         labels + lab_off[w]);
    };
    if (n_threads <= 1 || n_windows < 2) {
        run(0, n_windows);
        return;
    }
    std::vector<std::thread> pool;
    const int64_t t = std::min<int64_t>(n_threads, n_windows);
    for (int64_t w = 0; w < t; ++w) {
        const int64_t w0 = n_windows * w / t, w1 = n_windows * (w + 1) / t;
        if (w0 < w1) pool.emplace_back(run, w0, w1);
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"
