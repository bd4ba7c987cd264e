// Native partial-order-alignment engine.
//
// The runtime half of the POA subsystem: graph storage, NW graph-vs-sequence
// alignment, alignment fusion, topological packing for the TPU kernel, MSA
// and consensus extraction.  Semantics are the spoa algorithm exactly as
// specified by svscope_tpu/ops/poa.py (the NumPy reference); parity is
// enforced by tests/test_native_poa.py, and the TPU device aligner
// (ops/poa_device.py) consumes the packed arrays produced here.
//
// C ABI (ctypes): all buffers caller-allocated int32/uint8.
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <pthread.h>

#ifdef __AVX512F__
#include <immintrin.h>
#endif

namespace {

// Small-vector adjacency: two entries inline, spill beyond.  POA graphs
// average ~1.1 out-edges and ~0 aligned entries per node, so per-node
// std::vector headers put every topo rebuild / pred-list build behind a
// scattered heap pointer chase (measured 26% of align wall, PERF.md §12);
// inline storage keeps the hot sweeps on sequential cache lines.
struct Adj {
  int32_t n = 0;
  int32_t inl[2];
  std::vector<int32_t> spill;
  int size() const { return n; }
  bool empty() const { return n == 0; }
  int32_t operator[](int k) const { return k < 2 ? inl[k] : spill[k - 2]; }
  int32_t& operator[](int k) { return k < 2 ? inl[k] : spill[k - 2]; }
  void push_back(int32_t v) {
    if (n < 2)
      inl[n] = v;
    else
      spill.push_back(v);
    n++;
  }
  struct It {
    const Adj* a;
    int k;
    int32_t operator*() const { return (*a)[k]; }
    It& operator++() {
      k++;
      return *this;
    }
    bool operator!=(const It& o) const { return k != o.k; }
  };
  It begin() const { return {this, 0}; }
  It end() const { return {this, n}; }
};

struct Graph {
  std::vector<char> chars;
  std::vector<Adj> in_edges;   // tails, insertion order
  std::vector<Adj> out_edges;  // heads, insertion order
  std::vector<Adj> out_w;      // weights parallel to out_edges
  std::vector<Adj> aligned;    // same-column nodes
  std::vector<int> seq_begin;
  std::vector<std::vector<int>> paths;      // per-sequence node path
  std::vector<int> rank;
  bool order_dirty = true;
  int max_indeg = 0;  // largest in_edges size (edges are never removed)

  // Incrementally maintained aligned-group structure.  Group ids equal
  // the from-scratch discovery order (ranks of min-member node ids):
  // node ids only grow, a new node either JOINS an existing column
  // (group min unchanged — every gid stable) or opens a new group whose
  // min id exceeds all others (gid appended at the end), and existing
  // groups never merge.  Maintaining {membership, distinct cross-group
  // edges, group indegrees} at mutation time leaves topo_order() with
  // only the Kahn scan — the rebuild's discovery + edge sweeps were
  // 2/3 of a per-read cost measured at 26% of align (PERF.md §12).
  std::vector<int32_t> group;   // node -> group id
  std::vector<Adj> gmembers;    // group -> member ids, ascending
  std::vector<Adj> gout;        // group -> distinct successor groups
  std::vector<int32_t> gindeg;  // distinct-predecessor-group counts

  int add_node(char c) {
    chars.push_back(c);
    in_edges.emplace_back();
    out_edges.emplace_back();
    out_w.emplace_back();
    aligned.emplace_back();
    int id = (int)chars.size() - 1;
    group.push_back((int32_t)gmembers.size());
    gmembers.emplace_back();
    gmembers.back().push_back(id);
    gout.emplace_back();
    gindeg.push_back(0);
    order_dirty = true;
    return id;
  }

  // move a just-created node (always the newest — its singleton group is
  // the last) into the aligned column of col_node.  Anything else would
  // leave dangling group ids and a wrong group in-degree (a truncated
  // order), so a call that breaks the invariant aborts the process.
  void join_group(int node, int col_node) {
    const int32_t last = (int32_t)gmembers.size() - 1;
    if (node != n_nodes() - 1 || group[node] != last ||
        gmembers.back().size() != 1 || !gout.back().empty() ||
        gindeg.back() != 0) {
      std::fprintf(stderr,
                   "poa_engine: join_group(%d, %d) on a node that is not the "
                   "newest edgeless singleton (nodes %d, its group %d of %d, "
                   "members %d, out-groups %d, in-degree %d)\n",
                   node, col_node, n_nodes(), (int)group[node], (int)last + 1,
                   (int)gmembers.back().size(), (int)gout.back().size(),
                   (int)gindeg.back());
      std::abort();
    }
    gmembers.pop_back();
    gout.pop_back();
    gindeg.pop_back();
    int32_t gid = group[col_node];
    group[node] = gid;
    gmembers[gid].push_back(node);  // node id > all members: stays sorted
  }

  void add_edge(int tail, int head) {
    auto& heads = out_edges[tail];
    for (int k = 0; k < heads.size(); k++) {
      if (heads[k] == head) {
        out_w[tail][k]++;
        return;
      }
    }
    heads.push_back(head);
    out_w[tail].push_back(1);
    in_edges[head].push_back(tail);
    max_indeg = std::max(max_indeg, in_edges[head].size());
    int32_t gt = group[tail], gh = group[head];
    if (gt != gh) {
      bool seen = false;
      for (int32_t s : gout[gt])
        if (s == gh) {
          seen = true;
          break;
        }
      if (!seen) {
        gout[gt].push_back(gh);
        gindeg[gh]++;
      }
    }
    order_dirty = true;
  }

  int edge_weight(int tail, int head) const {
    const auto& heads = out_edges[tail];
    for (int k = 0; k < heads.size(); k++)
      if (heads[k] == head) return out_w[tail][k];
    return 0;
  }

  int n_nodes() const { return (int)chars.size(); }

  // topological order with aligned groups adjacent; group ids assigned by
  // first-member discovery in node-id order; Kahn with min-heap on group id
  // (mirrors PoaGraph.topo_order exactly).  Allocation-free rebuild:
  // flat member lists + stamp-based cross-group edge dedupe.
  const std::vector<int>& topo_order() {
    if (!order_dirty) return rank;
    const int ng = (int)gmembers.size();
    // min-id Kahn via a bitset scan over the incrementally maintained
    // group graph (identical pop order to a min-heap over group ids —
    // and gids equal the from-scratch discovery order, see above): lo
    // tracks the lowest word that can hold a ready bit; pushing a
    // smaller id rewinds it
    thread_local std::vector<int32_t> indeg;
    thread_local std::vector<uint64_t> readyw;
    indeg.assign(gindeg.begin(), gindeg.end());
    const int nwords = (ng + 63) >> 6;
    readyw.assign(nwords, 0);
    int lo = nwords;
    auto push_ready = [&](int g) {
      readyw[g >> 6] |= 1ull << (g & 63);
      if ((g >> 6) < lo) lo = g >> 6;
    };
    for (int g = 0; g < ng; g++)
      if (indeg[g] == 0) push_ready(g);
    rank.clear();
    rank.reserve(n_nodes());
    while (true) {
      while (lo < nwords && readyw[lo] == 0) lo++;
      if (lo >= nwords) break;
      const int g = (lo << 6) + __builtin_ctzll(readyw[lo]);
      readyw[lo] &= readyw[lo] - 1;
      for (int32_t v : gmembers[g]) rank.push_back(v);
      for (int32_t s : gout[g])
        if (--indeg[s] == 0) push_ready(s);
    }
    order_dirty = false;
    return rank;
  }
};

constexpr int kMatch = 5;
constexpr int kMismatch = -4;
constexpr int kGap = -8;
constexpr int32_t kNeg = -(1 << 29);

// Fused DP row update: base[j] = max over preds of
//   max(Hp[j-1] + sub[j], Hp[j] + gap)
// then the in-row gap chain as a prefix max in offset space
//   Hi[j] = max_{k<=j}(base[k] - kGap*k) + kGap*j.
// Two AVX-512 instantiations: int32 (16 lanes, general) and int16
// (32 lanes; selected when 8*(N+L) and 13*L fit the int16 range — the
// overwhelmingly common case for candidate windows).
template <typename ST>
struct RowKernel;

#ifdef __AVX512F__
template <>
struct RowKernel<int32_t> {
  static void run(int32_t* Hi, const int32_t* const* prows, int npred,
                  const int32_t* S, int n, int32_t base0) {
    const __m512i kneg = _mm512_set1_epi32(kNeg);
    const __m512i gv = _mm512_set1_epi32(kGap);
    const __m512i idx0 = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                           11, 12, 13, 14, 15);
    const __m512i g16 = _mm512_set1_epi32(-kGap * 16);
    const __m512i lastlane = _mm512_set1_epi32(15);
    __m512i off = _mm512_mullo_epi32(idx0, _mm512_set1_epi32(-kGap));
    __m512i carry = kneg;
    const int32_t* Hp0 = prows[0];
    // The final partial vector runs full-width: rows are CONTIGUOUS
    // (stride = L+1), so its overrunning loads/stores land in the FIRST
    // cells of row i+1 (and, for the last row, in align_seq_t's +32
    // buffer-end slack).  This is safe only under the invariants that
    // rows are processed strictly in increasing order (row i+1's own run
    // rewrites the garbage before anything reads it) and that nothing
    // reads a successor row between runs — do not reuse this kernel on
    // unpadded buffers or with out-of-order/threaded rows.  Within the
    // vector itself, garbage occupies lanes for cells >= n only, and the
    // prefix max propagates strictly low->high lanes, so it never
    // reaches a valid cell.  A scalar tail (serial prev+gap chain) cost
    // as much as all the vector iterations on ~400 bp rows.
    int j = 0;
    for (; j < n; j += 16) {
      __m512i d = _mm512_add_epi32(_mm512_loadu_si512(Hp0 + j - 1),
                                   _mm512_loadu_si512(S + j));
      __m512i u = _mm512_add_epi32(_mm512_loadu_si512(Hp0 + j), gv);
      __m512i b = _mm512_max_epi32(d, u);
      for (int k = 1; k < npred; k++) {
        const int32_t* Hq = prows[k];
        __m512i d2 = _mm512_add_epi32(_mm512_loadu_si512(Hq + j - 1),
                                      _mm512_loadu_si512(S + j));
        __m512i u2 = _mm512_add_epi32(_mm512_loadu_si512(Hq + j), gv);
        b = _mm512_max_epi32(b, _mm512_max_epi32(d2, u2));
      }
      if (j == 0)
        b = _mm512_mask_mov_epi32(b, 1, _mm512_set1_epi32(base0));
      __m512i c = _mm512_add_epi32(b, off);
      c = _mm512_max_epi32(c, _mm512_alignr_epi32(c, kneg, 15));
      c = _mm512_max_epi32(c, _mm512_alignr_epi32(c, kneg, 14));
      c = _mm512_max_epi32(c, _mm512_alignr_epi32(c, kneg, 12));
      c = _mm512_max_epi32(c, _mm512_alignr_epi32(c, kneg, 8));
      c = _mm512_max_epi32(c, carry);
      carry = _mm512_permutexvar_epi32(lastlane, c);
      _mm512_storeu_si512(Hi + j, _mm512_sub_epi32(c, off));
      off = _mm512_add_epi32(off, g16);
    }
  }
};

constexpr int16_t kNeg16 = -28000;

template <>
struct RowKernel<int16_t> {
  static void run(int16_t* Hi, const int16_t* const* prows, int npred,
                  const int16_t* S, int n, int16_t base0) {
    const __m512i kneg = _mm512_set1_epi16(kNeg16);
    const __m512i gv = _mm512_set1_epi16((int16_t)kGap);
    const __m512i g32 = _mm512_set1_epi16((int16_t)(-kGap * 32));
    const __m512i lastlane = _mm512_set1_epi16(31);
    alignas(64) int16_t idx_buf[32];
    for (int k = 0; k < 32; k++) idx_buf[k] = (int16_t)(k * -kGap);
    __m512i off = _mm512_load_si512(idx_buf);
    // one-lane shift index for the first prefix-max step (idx[i] = i - 1);
    // the remaining steps are dword-aligned and use 1-cycle valignd
    for (int k = 0; k < 32; k++) idx_buf[k] = (int16_t)((k - 1) & 31);
    const __m512i shift1_idx = _mm512_load_si512(idx_buf);
    const __mmask32 shift1_mask = (__mmask32)(~0u << 1);
    __m512i carry = kneg;
    const int16_t* Hp0 = prows[0];
    // full-width tail overrunning into row i+1 / the buffer-end slack —
    // same invariants as the int32 kernel's note above
    int j = 0;
    for (; j < n; j += 32) {
      __m512i d = _mm512_adds_epi16(_mm512_loadu_si512(Hp0 + j - 1),
                                    _mm512_loadu_si512(S + j));
      __m512i u = _mm512_adds_epi16(_mm512_loadu_si512(Hp0 + j), gv);
      __m512i b = _mm512_max_epi16(d, u);
      for (int k = 1; k < npred; k++) {
        const int16_t* Hq = prows[k];
        __m512i d2 = _mm512_adds_epi16(_mm512_loadu_si512(Hq + j - 1),
                                       _mm512_loadu_si512(S + j));
        __m512i u2 = _mm512_adds_epi16(_mm512_loadu_si512(Hq + j), gv);
        b = _mm512_max_epi16(b, _mm512_max_epi16(d2, u2));
      }
      if (j == 0)
        b = _mm512_mask_mov_epi16(b, 1, _mm512_set1_epi16(base0));
      __m512i c = _mm512_adds_epi16(b, off);
      c = _mm512_max_epi16(c, _mm512_mask_permutexvar_epi16(
                                  kneg, shift1_mask, shift1_idx, c));
      c = _mm512_max_epi16(c, _mm512_alignr_epi32(c, kneg, 15));  // 2 lanes
      c = _mm512_max_epi16(c, _mm512_alignr_epi32(c, kneg, 14));  // 4
      c = _mm512_max_epi16(c, _mm512_alignr_epi32(c, kneg, 12));  // 8
      c = _mm512_max_epi16(c, _mm512_alignr_epi32(c, kneg, 8));   // 16
      c = _mm512_max_epi16(c, carry);
      carry = _mm512_permutexvar_epi16(lastlane, c);
      _mm512_storeu_si512(Hi + j, _mm512_subs_epi16(c, off));
      off = _mm512_adds_epi16(off, g32);
    }
  }
};
#else
template <typename ST>
struct RowKernel {
  static void run(ST* Hi, const ST* const* prows, int npred, const ST* S,
                  int n, ST base0) {
    const ST* Hp0 = prows[0];
    int32_t prev = kNeg;
    for (int j = 0; j < n; j++) {
      int32_t b = j == 0 ? (int32_t)base0
                         : std::max(Hp0[j - 1] + S[j], Hp0[j] + kGap);
      for (int k = 1; k < npred && j > 0; k++) {
        const ST* Hq = prows[k];
        b = std::max(b, (int32_t)std::max(Hq[j - 1] + S[j], Hq[j] + kGap));
      }
      Hi[j] = (ST)std::max(b, prev + kGap);
      prev = Hi[j];
    }
  }
};
#endif

// SVSCOPE_POA_PROF sub-phase counters for align_seq_t (ns, thread-summed)
std::atomic<int64_t> g_ns_setup(0), g_ns_dp(0), g_ns_tb(0);
std::atomic<int64_t> g_cells(0), g_rows(0), g_preds(0);
inline bool poa_prof_on() {
  static const bool on = std::getenv("SVSCOPE_POA_PROF") != nullptr;
  return on;
}

// NW graph-vs-seq alignment, identical to PoaGraph.align.
// Returns pairs (node_id or -1, seq_pos or -1) in order.
template <typename ST>
void align_seq_t(Graph& g, const char* seq, int L,
                 std::vector<std::pair<int, int>>& aln) {
  const bool prof = poa_prof_on();
  std::chrono::steady_clock::time_point tp0;
  if (prof) tp0 = std::chrono::steady_clock::now();
  auto lap = [&](std::atomic<int64_t>& acc) {
    if (!prof) return;
    auto now = std::chrono::steady_clock::now();
    acc.fetch_add(std::chrono::duration_cast<std::chrono::nanoseconds>(
                      now - tp0).count(),
                  std::memory_order_relaxed);
    tp0 = now;
  };
  const std::vector<int>& order = g.topo_order();
  int N = (int)order.size();
  thread_local std::vector<int> pos_of;
  pos_of.resize(g.n_nodes());
  for (int i = 0; i < N; i++) pos_of[order[i]] = i;
  thread_local std::vector<ST> H;
  // +32 both ends: AVX overread/underread slack (block 0 loads Hp[-1])
  H.resize((size_t)(N + 1) * (L + 1) + 64);
  ST* Hb = H.data() + 32;
  for (int j = 0; j <= L; j++) Hb[j] = (ST)(kGap * j);
  // flat predecessor rank lists (+1 for the virtual row), one pass
  thread_local std::vector<int32_t> pred_flat;
  thread_local std::vector<int> pred_off;
  pred_off.resize(N + 1);
  pred_flat.clear();
  for (int i = 0; i < N; i++) {
    pred_off[i] = (int)pred_flat.size();
    for (int p : g.in_edges[order[i]]) pred_flat.push_back(pos_of[p] + 1);
    if (pred_flat.size() == (size_t)pred_off[i]) pred_flat.push_back(0);
  }
  pred_off[N] = (int)pred_flat.size();
  // per-character substitution rows, computed once per distinct node char:
  // subrow(c)[j] = (seq[j-1] == c) ? kMatch : kMismatch  for j in 1..L
  thread_local std::vector<ST> subrows;
  subrows.resize(8 * (size_t)(L + 1 + 32));
  char sub_char[8];
  int n_sub = 0;
  auto subrow = [&](char c) -> const ST* {
    for (int k = 0; k < n_sub; k++)
      if (sub_char[k] == c) return &subrows[k * (size_t)(L + 1 + 32)];
    int k = n_sub < 8 ? n_sub++ : 7;
    sub_char[k] = c;
    ST* S = &subrows[k * (size_t)(L + 1 + 32)];
    S[0] = 0;
    for (int j = 1; j <= L; j++)
      S[j] = (ST)((seq[j - 1] == c) ? kMatch : kMismatch);
    return S;
  };
  const size_t stride = (size_t)(L + 1);
  const int n = L + 1;
  thread_local std::vector<const void*> prow_buf;
  for (int i = 1; i <= N; i++) {
    const int32_t* preds = &pred_flat[pred_off[i - 1]];
    const int npred = pred_off[i] - pred_off[i - 1];
    ST* Hi = Hb + (size_t)i * stride;
    const ST* S = subrow(g.chars[order[i - 1]]);
    prow_buf.resize(std::max<size_t>(prow_buf.size(), npred));
    const ST** prows = (const ST**)prow_buf.data();
    int32_t base0 = kNeg;
    for (int k = 0; k < npred; k++) {
      prows[k] = Hb + (size_t)preds[k] * stride;
      base0 = std::max(base0, (int32_t)prows[k][0] + kGap);
    }
    if (i == 1) lap(g_ns_setup);
    RowKernel<ST>::run(Hi, prows, npred, S, n, (ST)base0);
  }
  lap(g_ns_dp);
  if (prof) {
    g_cells.fetch_add((int64_t)N * (L + 1), std::memory_order_relaxed);
    g_rows.fetch_add(N, std::memory_order_relaxed);
    g_preds.fetch_add(pred_flat.size(), std::memory_order_relaxed);
  }
  // best sink at column L
  int best_i = -1;
  int32_t best = kNeg;
  for (int i = 1; i <= N; i++) {
    int node = order[i - 1];
    if (g.out_edges[node].empty()) {
      int32_t v = Hb[(size_t)i * stride + L];
      if (best_i < 0 || v > best) {
        best = v;
        best_i = i;
      }
    }
  }
  int i = best_i, j = L;
  std::vector<std::pair<int, int>> rev;
  while (j > 0) {
    if (i == 0) {
      rev.emplace_back(-1, j - 1);
      j--;
      continue;
    }
    int node = order[i - 1];
    const int32_t* preds = &pred_flat[pred_off[i - 1]];
    const int npred = pred_off[i] - pred_off[i - 1];
    int32_t hij = Hb[(size_t)i * stride + j];
    int sub = (seq[j - 1] == g.chars[node]) ? kMatch : kMismatch;
    bool moved = false;
    for (int k = 0; k < npred; k++) {
      int p = preds[k];
      if (hij == Hb[(size_t)p * stride + j - 1] + sub) {
        rev.emplace_back(node, j - 1);
        i = p;
        j--;
        moved = true;
        break;
      }
    }
    if (moved) continue;
    for (int k = 0; k < npred; k++) {
      int p = preds[k];
      if (hij == Hb[(size_t)p * stride + j] + kGap) {
        rev.emplace_back(node, -1);
        i = p;
        moved = true;
        break;
      }
    }
    if (moved) continue;
    // left
    rev.emplace_back(-1, j - 1);
    j--;
  }
  aln.assign(rev.rbegin(), rev.rend());
  lap(g_ns_tb);
}

std::atomic<int64_t> g_ns_topo(0);

void align_seq(Graph& g, const char* seq, int L,
               std::vector<std::pair<int, int>>& aln) {
  aln.clear();
  std::chrono::steady_clock::time_point tp0;
  const bool prof = poa_prof_on();
  if (prof) tp0 = std::chrono::steady_clock::now();
  const std::vector<int>& order = g.topo_order();
  if (prof)
    g_ns_topo.fetch_add(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - tp0).count(),
        std::memory_order_relaxed);
  int N = (int)order.size();
  if (N == 0) {
    for (int j = 0; j < L; j++) aln.emplace_back(-1, j);
    return;
  }
  // int16 covers candidate-window scales exactly (scores are bounded by
  // [-8*(N+L), 5*L] and the offset-space prefix max by 13*L); anything
  // larger takes the int32 path
  if (N + L <= 3400 && L <= 2200)
    align_seq_t<int16_t>(g, seq, L, aln);
  else
    align_seq_t<int32_t>(g, seq, L, aln);
}

// add_alignment + record path (mirrors ops/poa._fused_path)
void fuse(Graph& g, const std::vector<std::pair<int, int>>& aln,
          const char* seq) {
  int prev = -1, begin = -1;
  std::vector<int> path;
  for (auto& pr : aln) {
    int node_id = pr.first, spos = pr.second;
    if (spos < 0) continue;
    char ch = seq[spos];
    int cur;
    if (node_id >= 0) {
      if (g.chars[node_id] == ch) {
        cur = node_id;
      } else {
        cur = -1;
        for (int a : g.aligned[node_id]) {
          if (g.chars[a] == ch) {
            cur = a;
            break;
          }
        }
        if (cur < 0) {
          cur = g.add_node(ch);
          std::vector<int> col;
          col.push_back(node_id);
          for (int a : g.aligned[node_id]) col.push_back(a);
          for (int a : col) g.aligned[a].push_back(cur);
          for (int a : col) g.aligned[cur].push_back(a);
          g.join_group(cur, node_id);
        }
      }
    } else {
      cur = g.add_node(ch);
    }
    if (prev >= 0)
      g.add_edge(prev, cur);
    else
      begin = cur;
    prev = cur;
    path.push_back(cur);
  }
  g.seq_begin.push_back(begin);
  g.paths.push_back(path);
}

void add_first(Graph& g, const char* seq, int L) {
  int prev = -1, begin = -1;
  std::vector<int> path;
  for (int k = 0; k < L; k++) {
    int cur = g.add_node(seq[k]);
    if (prev >= 0)
      g.add_edge(prev, cur);
    else
      begin = cur;
    prev = cur;
    path.push_back(cur);
  }
  g.seq_begin.push_back(begin);
  g.paths.push_back(path);
}

// consensus: heaviest bundle (mirrors PoaGraph.consensus)
std::string consensus(Graph& g) {
  int n = g.n_nodes();
  if (n == 0) return "";
  const std::vector<int>& order = g.topo_order();
  std::vector<int64_t> score(n, 0);
  std::vector<int> best_in(n, -1);
  for (int v : order) {
    bool have = false;
    int bw = 0;
    for (int t : g.in_edges[v]) {
      int w = g.edge_weight(t, v);
      if (!have || w > bw || (w == bw && score[t] > score[best_in[v]])) {
        have = true;
        bw = w;
        best_in[v] = t;
      }
    }
    if (best_in[v] >= 0) score[v] = bw + score[best_in[v]];
  }
  int vmax = order[0];
  for (int v : order)
    if (score[v] > score[vmax]) vmax = v;
  std::vector<int> path;
  path.push_back(vmax);
  while (best_in[path.back()] >= 0) path.push_back(best_in[path.back()]);
  std::reverse(path.begin(), path.end());
  int v = vmax;
  while (!g.out_edges[v].empty()) {
    const auto& heads = g.out_edges[v];
    int bh = heads[0];
    int wb = g.out_w[v][0];
    for (size_t k = 1; k < heads.size(); k++) {
      int wh = g.out_w[v][k];
      if (wh > wb || (wh == wb && score[heads[k]] > score[bh])) {
        bh = heads[k];
        wb = wh;
      }
    }
    v = bh;
    path.push_back(v);
  }
  std::string out;
  for (int u : path) out.push_back(g.chars[u]);
  return out;
}

// A persistent pool for the device rounds' batch entries, which run well
// under a ms of work per call: on the H100 host the port is measured on,
// starting threads on each call cost more than the work (PERF.md §6).
// One job at a time (callers from several threads queue on
// submit_m_), the caller working beside the helpers; helpers start on
// first need, then sleep on cv_ and take on the caller's CPU affinity
// with each job.  Never deleted (threads blocked at exit are the
// process's to end); a forked child starts a fresh pool.
class Pool {
 public:
  void run(int64_t n, int nt, const std::function<void(int64_t)>& fn) {
    cpu_set_t cpus;
    pthread_getaffinity_np(pthread_self(), sizeof cpus, &cpus);
    std::lock_guard<std::mutex> job(submit_m_);
    {
      std::lock_guard<std::mutex> lk(m_);
      while ((int)workers_.size() < nt - 1) {
        const int id = (int)workers_.size();
        const uint64_t seen = gen_;
        workers_.emplace_back([this, id, seen]() { loop(id, seen); });
      }
      fn_ = &fn;
      cpus_ = cpus;
      n_ = n;
      next_.store(0);
      helpers_ = nt - 1;
      busy_ = nt - 1;
      gen_++;
    }
    cv_.notify_all();
    drain();
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [&]() { return busy_ == 0; });
  }

 private:
  void drain() {
    for (int64_t i = next_.fetch_add(1); i < n_; i = next_.fetch_add(1))
      (*fn_)(i);
  }

  void loop(int id, uint64_t seen) {
    cpu_set_t mine;
    pthread_getaffinity_np(pthread_self(), sizeof mine, &mine);
    for (;;) {
      cpu_set_t want;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&]() { return gen_ != seen; });
        seen = gen_;
        if (id >= helpers_) continue;
        want = cpus_;
      }
      if (!CPU_EQUAL(&mine, &want)) {
        mine = want;
        pthread_setaffinity_np(pthread_self(), sizeof mine, &mine);
      }
      drain();
      std::lock_guard<std::mutex> lk(m_);
      if (--busy_ == 0) done_cv_.notify_one();
    }
  }

  std::mutex submit_m_, m_;
  std::condition_variable cv_, done_cv_;
  std::vector<std::thread> workers_;
  const std::function<void(int64_t)>* fn_ = nullptr;
  cpu_set_t cpus_;
  int64_t n_ = 0;
  std::atomic<int64_t> next_{0};
  int helpers_ = 0, busy_ = 0;
  uint64_t gen_ = 0;
};

std::atomic<Pool*> g_pool{nullptr};

Pool& pool() {
  Pool* p = g_pool.load();
  if (p) return *p;
  static const bool registered = [] {
    pthread_atfork(nullptr, nullptr, [] { g_pool.store(nullptr); });
    return true;
  }();
  (void)registered;
  Pool* fresh = new Pool();
  if (g_pool.compare_exchange_strong(p, fresh)) return *fresh;
  delete fresh;
  return *p;
}

// Run fn(i) for every i in [0, n) on up to n_threads threads of the pool
// drawing i from one atomic counter, so each item is touched by one
// thread only.
void parallel_for(int64_t n, int32_t n_threads,
                  const std::function<void(int64_t)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; i++) fn(i);
    return;
  }
  pool().run(n, (int)std::min<int64_t>(n_threads, n), fn);
}

// Pack g for the device kernel into one window's rows: chars_out (n_max)
// ascii, preds_out (n_max*p_max) rank ids, sink_out (n_max) 0/1,
// node_of_rank (n_max); rows and slots past the graph's own hold 0 / -1.
// Returns n_nodes, or -1 (rows unwritten) past n_max nodes or p_max
// in-degree.
int pack_rows(Graph& g, int n_max, int p_max, uint8_t* chars_out,
              int32_t* preds_out, uint8_t* sink_out, int32_t* node_of_rank) {
  const std::vector<int>& order = g.topo_order();
  const int n = (int)order.size();
  if (n > n_max) return -1;
  for (int v : order)
    if ((int)g.in_edges[v].size() > p_max) return -1;
  thread_local std::vector<int> pos_of;
  pos_of.resize(g.n_nodes());
  for (int i = 0; i < n; i++) pos_of[order[i]] = i;
  for (int i = 0; i < n; i++) {
    const int node = order[i];
    const Adj& in = g.in_edges[node];
    chars_out[i] = (uint8_t)g.chars[node];
    node_of_rank[i] = node;
    int32_t* row = preds_out + (size_t)i * p_max;
    int k = 0;
    for (; k < in.size(); k++) row[k] = pos_of[in[k]];
    for (; k < p_max; k++) row[k] = -1;
    sink_out[i] = g.out_edges[node].empty() ? 1 : 0;
  }
  memset(chars_out + n, 0, n_max - n);
  memset(sink_out + n, 0, n_max - n);
  std::fill(preds_out + (size_t)n * p_max, preds_out + (size_t)n_max * p_max,
            -1);
  std::fill(node_of_rank + n, node_of_rank + n_max, -1);
  return n;
}

}  // namespace

extern "C" {

void* poa_create() { return new Graph(); }
void poa_free(void* h) { delete (Graph*)h; }
int poa_n_nodes(void* h) { return ((Graph*)h)->n_nodes(); }
int poa_n_seqs(void* h) { return (int)((Graph*)h)->paths.size(); }

int poa_max_indegree(void* h) { return ((Graph*)h)->max_indeg; }

void poa_add_sequence(void* h, const char* seq, int len) {
  Graph& g = *(Graph*)h;
  if (len == 0) {
    g.seq_begin.push_back(-1);
    g.paths.emplace_back();
    return;
  }
  if (g.n_nodes() == 0) {
    add_first(g, seq, len);
    return;
  }
  std::vector<std::pair<int, int>> aln;
  align_seq(g, seq, len, aln);
  fuse(g, aln, seq);
}

// align without fusing; out buffers sized n_nodes+len; returns aln length
int poa_align_only(void* h, const char* seq, int len, int32_t* out_nodes,
                   int32_t* out_spos) {
  Graph& g = *(Graph*)h;
  std::vector<std::pair<int, int>> aln;
  align_seq(g, seq, len, aln);
  for (size_t k = 0; k < aln.size(); k++) {
    out_nodes[k] = aln[k].first;
    out_spos[k] = aln[k].second;
  }
  return (int)aln.size();
}

// fuse an externally computed alignment (e.g. from the TPU kernel)
void poa_fuse(void* h, const int32_t* nodes, const int32_t* spos, int n,
              const char* seq) {
  Graph& g = *(Graph*)h;
  std::vector<std::pair<int, int>> aln(n);
  for (int k = 0; k < n; k++) aln[k] = {nodes[k], spos[k]};
  fuse(g, aln, seq);
}

// pack for the device kernel; returns n_nodes or -1 if it exceeds n_max /
// p_max.  chars_out (n_max) ascii; preds_out (n_max*p_max) rank ids (-1
// pad); sink_out (n_max) 0/1; node_of_rank (n_max).
int poa_pack(void* h, int n_max, int p_max, uint8_t* chars_out,
             int32_t* preds_out, uint8_t* sink_out, int32_t* node_of_rank) {
  return pack_rows(*(Graph*)h, n_max, p_max, chars_out, preds_out, sink_out,
                   node_of_rank);
}

// MSA: writes ncol then row strings ('-' padded) into out (n_seqs * ncol
// bytes); out must hold n_seqs * max_cols. Returns ncol or -1 on overflow.
int poa_msa(void* h, int max_cols, uint8_t* out) {
  Graph& g = *(Graph*)h;
  const std::vector<int>& order = g.topo_order();
  std::vector<int> col(g.n_nodes(), -1);
  int ncol = 0;
  for (int v : order) {
    if (col[v] >= 0) continue;
    col[v] = ncol;
    for (int a : g.aligned[v]) col[a] = ncol;
    ncol++;
  }
  if (ncol > max_cols) return -1;
  int ns = (int)g.paths.size();
  memset(out, '-', (size_t)ns * ncol);
  for (int s = 0; s < ns; s++) {
    for (int v : g.paths[s]) out[(size_t)s * ncol + col[v]] = g.chars[v];
  }
  return ncol;
}

// consensus into out (cap bytes); returns length or -1 on overflow
int poa_consensus(void* h, int cap, uint8_t* out) {
  std::string c = consensus(*(Graph*)h);
  if ((int)c.size() > cap) return -1;
  memcpy(out, c.data(), c.size());
  return (int)c.size();
}

// Batch MSA across windows with an internal thread pool: one C call builds
// every window's graph and emits '\n'-joined MSA rows with the consensus
// first.  Input: all sequences concatenated; seq_off (n_seqs+1); win_off
// (n_windows+1) indexing into the sequence list.  Output per window into
// out + out_off slots (caller provides per-window capacity cap_per_win).
// Returns 0, or the index+1 of the first window whose output overflowed.
int poa_msa_batch(const char* seqs, const int64_t* seq_off, int64_t n_seqs,
                  const int64_t* win_off, int64_t n_windows,
                  uint8_t* out, int64_t cap_per_win, int64_t* out_len,
                  int32_t n_threads) {
  std::vector<int> status((size_t)n_windows, 0);
  // SVSCOPE_POA_PROF=1: phase split (ns, summed over worker threads) so
  // Python-side probes can attribute batch wall to DP vs graph bookkeeping
  const bool prof = std::getenv("SVSCOPE_POA_PROF") != nullptr;
  std::atomic<int64_t> ns_align(0), ns_fuse(0), ns_cons(0), ns_extract(0);
  using clk = std::chrono::steady_clock;
  auto tick = [&]() { return clk::now(); };
  auto lap = [&](std::atomic<int64_t>& acc, clk::time_point t0) {
    acc.fetch_add(std::chrono::duration_cast<std::chrono::nanoseconds>(
                      clk::now() - t0).count(),
                  std::memory_order_relaxed);
  };
  auto work = [&](int64_t w) {
    Graph g;
    for (int64_t s = win_off[w]; s < win_off[w + 1]; s++) {
      const char* seq = seqs + seq_off[s];
      int len = (int)(seq_off[s + 1] - seq_off[s]);
      if (len == 0) {
        g.seq_begin.push_back(-1);
        g.paths.emplace_back();
      } else if (g.n_nodes() == 0) {
        add_first(g, seq, len);
      } else {
        std::vector<std::pair<int, int>> aln;
        if (prof) {
          auto t0 = tick();
          align_seq(g, seq, len, aln);
          lap(ns_align, t0);
          t0 = tick();
          fuse(g, aln, seq);
          lap(ns_fuse, t0);
        } else {
          align_seq(g, seq, len, aln);
          fuse(g, aln, seq);
        }
      }
    }
    auto tc = tick();
    std::string cons = consensus(g);
    if (prof) lap(ns_cons, tc);
    auto te = tick();
    const std::vector<int>& order = g.topo_order();
    std::vector<int> col(g.n_nodes(), -1);
    int ncol = 0;
    for (int v : order) {
      if (col[v] >= 0) continue;
      col[v] = ncol;
      for (int a : g.aligned[v]) col[a] = ncol;
      ncol++;
    }
    int64_t ns = (int64_t)g.paths.size();
    int64_t need = (int64_t)cons.size() + 1 + ns * (ncol + 1);
    if (need > cap_per_win) {
      status[w] = 1;
      out_len[w] = 0;
      return;
    }
    uint8_t* dst = out + w * cap_per_win;
    memcpy(dst, cons.data(), cons.size());
    int64_t pos = cons.size();
    dst[pos++] = '\n';
    for (int64_t s = 0; s < ns; s++) {
      memset(dst + pos, '-', ncol);
      for (int v : g.paths[s]) dst[pos + col[v]] = g.chars[v];
      pos += ncol;
      dst[pos++] = '\n';
    }
    out_len[w] = pos;
    if (prof) lap(ns_extract, te);
  };
  if (n_threads <= 1 || n_windows <= 1) {
    for (int64_t w = 0; w < n_windows; w++) work(w);
  } else {
    std::vector<std::thread> pool;
    std::atomic<int64_t> next(0);
    for (int t = 0; t < n_threads; t++)
      pool.emplace_back([&]() {
        for (int64_t w = next.fetch_add(1); w < n_windows;
             w = next.fetch_add(1))
          work(w);
      });
    for (auto& th : pool) th.join();
  }
  if (prof) {
    std::fprintf(stderr,
                 "[poa_prof] windows=%lld align=%.1fms fuse=%.1fms "
                 "consensus=%.1fms extract=%.1fms (thread-summed)\n",
                 (long long)n_windows, ns_align.load() / 1e6,
                 ns_fuse.load() / 1e6, ns_cons.load() / 1e6,
                 ns_extract.load() / 1e6);
    std::fprintf(stderr,
                 "[poa_prof]   align split: topo=%.1fms setup=%.1fms "
                 "dp=%.1fms traceback=%.1fms (cumulative since load)\n",
                 g_ns_topo.load() / 1e6, g_ns_setup.load() / 1e6,
                 g_ns_dp.load() / 1e6, g_ns_tb.load() / 1e6);
    std::fprintf(stderr,
                 "[poa_prof]   dp volume: cells=%.1fM rows=%lld "
                 "preds/row=%.2f -> %.2f Gcells/s in-dp (cumulative)\n",
                 g_cells.load() / 1e6, (long long)g_rows.load(),
                 g_rows.load() ? (double)g_preds.load() / g_rows.load() : 0.0,
                 g_ns_dp.load() ? (double)g_cells.load() / g_ns_dp.load()
                                : 0.0);
  }
  for (int64_t w = 0; w < n_windows; w++)
    if (status[w]) return (int)(w + 1);
  return 0;
}

// The per-round device path's batch entries: one call a round (stat) or a
// bucket chunk (pack, fuse) over an array of graph handles, each graph
// touched by one thread only.

// Node count and largest in-degree of each graph, the two numbers that
// decide its route (device bucket, oversize wavefront or host DP) before
// anything is packed.  Both are kept as the graph grows, so one serial
// pass reads them.
void poa_stat_batch(void* const* handles, int64_t n, int32_t* n_nodes_out,
                    int32_t* max_indeg_out) {
  for (int64_t i = 0; i < n; i++) {
    const Graph& g = *(const Graph*)handles[i];
    n_nodes_out[i] = g.n_nodes();
    max_indeg_out[i] = g.max_indeg;
  }
}

// Pack one (n_max, l_max) chunk of a round: window i's graph into row i of
// chars (b_pad, n_max), preds (b_pad, n_max, p_max), sinks, n_nodes and
// node_of_rank (b_pad, n_max), and its read (reads + seq_off[seq_idx[i]])
// into reads (b_pad, l_max, zero-padded) and lens; rows n..b_pad-1 repeat
// row 0.  Returns 0, or i+1 for the first window that does not fit (rows
// then unspecified).
int poa_pack_batch(void* const* handles, int64_t n, int64_t b_pad,
                   int32_t n_max, int32_t p_max, int32_t l_max,
                   const char* reads_in, const int64_t* seq_off,
                   const int64_t* seq_idx, uint8_t* chars, int32_t* preds,
                   uint8_t* sinks, int32_t* n_nodes, int32_t* node_of_rank,
                   uint8_t* reads, int32_t* lens, int32_t n_threads) {
  std::vector<uint8_t> bad((size_t)n, 0);
  parallel_for(n, n_threads, [&](int64_t i) {
    const int64_t s = seq_idx[i];
    const int64_t len = seq_off[s + 1] - seq_off[s];
    const int nn = len > l_max ? -1 : pack_rows(
        *(Graph*)handles[i], n_max, p_max, chars + i * n_max,
        preds + i * n_max * p_max, sinks + i * n_max,
        node_of_rank + i * n_max);
    if (nn < 0) {
      bad[i] = 1;
      return;
    }
    n_nodes[i] = nn;
    uint8_t* row = reads + i * l_max;
    memcpy(row, reads_in + seq_off[s], len);
    memset(row + len, 0, l_max - len);
    lens[i] = (int32_t)len;
  });
  for (int64_t i = 0; i < n; i++)
    if (bad[i]) return (int)(i + 1);
  // batch padding: replicate row 0
  auto rep = [&](auto* a, int64_t width) {
    for (int64_t i = n; i < b_pad; i++)
      std::copy(a, a + width, a + i * width);
  };
  rep(chars, n_max);
  rep(preds, (int64_t)n_max * p_max);
  rep(sinks, n_max);
  rep(n_nodes, 1);
  rep(node_of_rank, n_max);
  rep(reads, l_max);
  rep(lens, 1);
  return 0;
}

// Fuse one chunk's alignments: window i's kernel rows aln_nodes/aln_spos
// (width entries each, right-aligned after k_end[i]; -2 pads, -1 gaps)
// are unpacked as ops/poa_device.unpack_alignment_arrays does (entries
// past k_end[i], -2 dropped, ranks through node_of_rank row i, n_max
// wide) and fused into its graph with its read.  Unpack is one serial
// pass over every window's rows, then fuse runs on the pool; seconds[0]
// and [1] get the two passes' wall times.  Returns 0, or i+1 for the
// first window whose rows name no rank of its bucket (nothing fused
// then).
int poa_fuse_batch(void* const* handles, int64_t n, const int32_t* aln_nodes,
                   const int32_t* aln_spos, int64_t width,
                   const int32_t* k_end, const int32_t* node_of_rank,
                   int32_t n_max, const char* reads, const int64_t* seq_off,
                   const int64_t* seq_idx, int32_t n_threads,
                   double* seconds) {
  using clk = std::chrono::steady_clock;
  auto t0 = clk::now();
  std::vector<std::vector<std::pair<int, int>>> alns((size_t)n);
  for (int64_t i = 0; i < n; i++) {
    const int32_t* an = aln_nodes + i * width;
    const int32_t* as = aln_spos + i * width;
    const int32_t* nor = node_of_rank + i * n_max;
    auto& aln = alns[i];
    aln.reserve(width);
    for (int64_t k = std::max<int64_t>(k_end[i] + 1, 0); k < width; k++) {
      const int32_t r = an[k];
      if (r == -2) continue;
      if (r < -1 || r >= n_max) return (int)(i + 1);
      aln.emplace_back(r >= 0 ? nor[r] : -1, as[k]);
    }
  }
  auto t1 = clk::now();
  parallel_for(n, n_threads, [&](int64_t i) {
    fuse(*(Graph*)handles[i], alns[i], reads + seq_off[seq_idx[i]]);
  });
  seconds[0] = std::chrono::duration<double>(t1 - t0).count();
  seconds[1] = std::chrono::duration<double>(clk::now() - t1).count();
  return 0;
}

// The fused engine's emit (ops/poa_fused.emit_window) over a fetched chunk
// of n window states, each window on one thread of the pool.  Window w's
// arrays: ch, gm, order, back_buf, fwd_buf (ncap each), path (r_max rows
// of l_max, -1 for no node; row r of window w at path + w * path_ws +
// r * path_rs, so the fetch's (R, B, l_max) layout is read in place), nn,
// back_start, fwd_cnt, n_seqs (one each).
// Its MSA columns are the distinct gm values along order[:nn], ranked by
// first occurrence; read r < n_seqs gets a row of '-' with its path's
// bases at their nodes' columns; the consensus is the bases of
// back_buf[back_start:] then fwd_buf[:fwd_cnt] (nn == 0: no columns and
// an empty consensus).  Written at out + off[w]: the consensus, then the
// n_seqs rows back to back, with its length in cons_len[w] and the
// column count in ncol[w]; a window with skip[w] set is neither read nor
// written.  Returns 0, or w+1 for the first window whose state names an
// index outside its arrays or whose text passes off[w+1] - off[w] bytes
// (its outputs then unspecified).
int pk_emit_batch(const int32_t* ch, const int32_t* gm, const int32_t* nn,
                  const int32_t* path, const int32_t* order,
                  const int32_t* back_buf, const int32_t* back_start,
                  const int32_t* fwd_buf, const int32_t* fwd_cnt,
                  const int32_t* n_seqs, const uint8_t* skip, int64_t n,
                  int32_t ncap, int32_t r_max, int32_t l_max,
                  int64_t path_ws, int64_t path_rs,
                  uint8_t* out, const int64_t* off, int64_t* cons_len,
                  int64_t* ncol, int32_t n_threads) {
  static const uint8_t kDecode[5] = {'A', 'C', 'G', 'T', 'N'};
  std::vector<uint8_t> bad((size_t)n, 0);
  parallel_for(n, n_threads, [&](int64_t w) {
    if (skip[w]) return;
    const int64_t nw = nn[w], ns = n_seqs[w];
    if (nw < 0 || nw > ncap || ns < 0 || ns > r_max) {
      bad[w] = 1;
      return;
    }
    cons_len[w] = ncol[w] = 0;
    if (nw == 0) return;
    const int32_t* chw = ch + w * ncap;
    const int32_t* gmw = gm + w * ncap;
    auto valid = [&](int64_t v) {
      return v >= 0 && v < ncap && gmw[v] >= 0 && gmw[v] < ncap &&
             chw[v] >= 0 && chw[v] < 5;
    };
    thread_local std::vector<int32_t> col;
    col.assign(ncap, -1);
    int64_t nc = 0;
    const int32_t* ord = order + w * ncap;
    for (int64_t k = 0; k < nw; k++) {
      if (!valid(ord[k])) {
        bad[w] = 1;
        return;
      }
      int32_t& c = col[gmw[ord[k]]];
      if (c < 0) c = (int32_t)nc++;
    }
    const int64_t b0 = back_start[w], nf = fwd_cnt[w];
    if (b0 < 0 || b0 > ncap || nf < 0 || nf > ncap ||
        (ncap - b0) + nf + ns * nc > off[w + 1] - off[w]) {
      bad[w] = 1;
      return;
    }
    uint8_t* dst = out + off[w];
    int64_t pos = 0;
    auto put = [&](const int32_t* nodes, int64_t m) {
      for (int64_t k = 0; k < m; k++) {
        if (!valid(nodes[k])) return false;
        dst[pos++] = kDecode[chw[nodes[k]]];
      }
      return true;
    };
    if (!put(back_buf + w * ncap + b0, ncap - b0) ||
        !put(fwd_buf + w * ncap, nf)) {
      bad[w] = 1;
      return;
    }
    cons_len[w] = pos;
    ncol[w] = nc;
    const int32_t* pw = path + w * path_ws;
    for (int64_t r = 0; r < ns; r++, pw += path_rs, pos += nc) {
      uint8_t* row = dst + pos;
      memset(row, '-', nc);
      for (int64_t k = 0; k < l_max; k++) {
        const int32_t v = pw[k];
        if (v < 0) continue;
        if (!valid(v)) {
          bad[w] = 1;
          return;
        }
        // a column that order[:nn] never reaches is column 0, as
        // emit_window's zero-filled col_of_gm has it
        row[std::max(col[gmw[v]], 0)] = kDecode[chw[v]];
      }
    }
  });
  for (int64_t i = 0; i < n; i++)
    if (bad[i]) return (int)(i + 1);
  return 0;
}

}  // extern "C"
