#include "rt_poa.hpp"

#include <algorithm>
#include <atomic>
#include <cassert>
#include <cmath>
#include <cstdio>
#include <limits>
#include <cstdint>
#include <cstdlib>
#include <numeric>

#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

namespace rt {

namespace {
constexpr int32_t kNegInf = std::numeric_limits<int32_t>::min() / 4;

// Env-gated (RT_POA_STATS=1) predecessor rank-distance telemetry. The
// device kernel keeps DP rows in a rank-keyed ring buffer, so a node whose
// predecessor lies more than RING_ROWS ranks back cannot run on the
// accelerator; this histogram, dumped at process exit, is how the ring
// size is chosen (and re-validated) against real workloads.
struct PredDistStats {
  std::atomic<uint64_t> edge_hist[16];   // per-edge log2 distance buckets
  std::atomic<uint64_t> align_hist[16];  // per-align(=layer) max distance
  std::atomic<uint64_t> edges{0}, aligns{0};
  std::atomic<int64_t> max_dist{0};
  std::atomic<int64_t> max_sub{0};  // largest subgraph (DP row count)
  const bool enabled = []() {
    const char* v = std::getenv("RT_POA_STATS");
    return v != nullptr && v[0] == '1';  // RT_POA_STATS=0 means off
  }();

  static int bucket(int64_t d) {
    int b = 0;
    while ((int64_t{1} << b) < d && b < 15) ++b;  // bucket b: d <= 2^b
    return b;
  }

  void record(int64_t d, std::atomic<uint64_t>* hist) {
    hist[bucket(d)].fetch_add(1, std::memory_order_relaxed);
  }

  ~PredDistStats() {
    if (!enabled || aligns.load() == 0) return;
    std::fprintf(stderr, "[rt_poa::stats] pred rank distance: edges=%llu "
                 "aligns=%llu max=%lld max_sub=%lld\n",
                 (unsigned long long)edges.load(),
                 (unsigned long long)aligns.load(),
                 (long long)max_dist.load(),
                 (long long)max_sub.load());
    for (int b = 0; b < 16; ++b) {
      const uint64_t e = edge_hist[b].load(), a = align_hist[b].load();
      if (e == 0 && a == 0) continue;
      std::fprintf(stderr, "[rt_poa::stats]   d<=%-6lld edges=%-10llu "
                   "align_max=%llu\n", (long long)(int64_t{1} << b),
                   (unsigned long long)e, (unsigned long long)a);
    }
  }
};
PredDistStats g_pred_stats;
}  // namespace

int32_t PoaGraph::new_column(double key) {
  col_keys_.push_back(key);
  col_members_.emplace_back();
  return static_cast<int32_t>(col_keys_.size()) - 1;
}

int32_t PoaGraph::new_node(char base, int32_t col) {
  PoaNode n;
  n.base = base;
  n.col = col;
  n.coverage = 0;
  nodes_.push_back(std::move(n));
  const int32_t id = static_cast<int32_t>(nodes_.size()) - 1;
  col_members_[col].push_back(id);
  return id;
}

void PoaGraph::add_or_bump_edge(int32_t src, int32_t dst, int64_t w) {
  for (int32_t e : nodes_[src].out_edges) {
    if (edges_[e].dst == dst) {
      edges_[e].weight += w;
      return;
    }
  }
  PoaEdge e{src, dst, w};
  edges_.push_back(e);
  const int32_t id = static_cast<int32_t>(edges_.size()) - 1;
  nodes_[src].out_edges.push_back(id);
  nodes_[dst].in_edges.push_back(id);
}

void PoaGraph::add_alignment(const PoaAlignment& alignment, const char* seq,
                             uint32_t len,
                             const std::vector<uint32_t>& weights) {
  if (len == 0) {
    return;
  }
  ++num_sequences_;

  if (alignment.empty()) {
    // Fresh source->sink chain (the window backbone). Integer column keys —
    // backbone column i gets key exactly i, which is what the key-range
    // subgraph filter relies on.
    double base_key = -1.0;
    for (double k : col_keys_) {
      base_key = std::max(base_key, k);
    }
    base_key = std::floor(base_key) + 1.0;
    int32_t prev = -1;
    for (uint32_t p = 0; p < len; ++p) {
      const int32_t node = new_node(seq[p], new_column(base_key + p));
      ++nodes_[node].coverage;
      if (prev != -1) {
        add_or_bump_edge(prev, node,
                         static_cast<int64_t>(weights[p - 1]) +
                             static_cast<int64_t>(weights[p]));
      }
      prev = node;
    }
    return;
  }

  // Seq position -> matched graph node (-1 = insertion, gets a new column).
  std::vector<int32_t> pos_node(len, -1);
  for (const auto& pr : alignment) {
    if (pr.second != -1 && pr.first != -1) {
      pos_node[pr.second] = pr.first;
    }
  }

  int32_t prev = -1;
  int32_t prev_pos = -1;
  uint32_t pos = 0;
  while (pos < len) {
    const char b = seq[pos];
    int32_t node;
    if (pos_node[pos] != -1) {
      const int32_t n = pos_node[pos];
      const int32_t col = nodes_[n].col;
      if (nodes_[n].base == b) {
        node = n;
      } else {
        node = -1;
        for (int32_t m : col_members_[col]) {
          if (nodes_[m].base == b) {
            node = m;
            break;
          }
        }
        if (node == -1) {
          node = new_node(b, col);  // column sibling == classic aligned ring
        }
      }
      ++pos;
    } else {
      // Insertion run [pos, run_end): fresh columns with keys strictly
      // between the previous path column and the next matched column.
      // `run_len` is the REMAINING run length (runs shrink as positions are
      // consumed one per loop iteration), so each new key subdivides the
      // residual interval and the run stays strictly increasing.
      uint32_t run_end = pos;
      while (run_end < len && pos_node[run_end] == -1) {
        ++run_end;
      }
      const uint32_t run_len = run_end - pos;
      double hi;
      if (run_end < len) {
        hi = col_keys_[nodes_[pos_node[run_end]].col];
      } else if (prev != -1) {
        hi = col_keys_[nodes_[prev].col] + 1.0;
      } else {
        double max_key = -1.0;
        for (double k : col_keys_) {
          max_key = std::max(max_key, k);
        }
        hi = max_key + static_cast<double>(run_len) + 1.0;
      }
      const double lo =
          prev != -1 ? col_keys_[nodes_[prev].col] : hi - run_len - 1.0;

      const double key = lo + (hi - lo) / (run_len + 1.0);
      node = new_node(b, new_column(key));
      ++pos;
    }

    ++nodes_[node].coverage;
    if (prev != -1) {
      add_or_bump_edge(prev, node,
                       static_cast<int64_t>(weights[prev_pos]) +
                           static_cast<int64_t>(weights[pos - 1]));
    }
    prev = node;
    prev_pos = static_cast<int32_t>(pos) - 1;
  }
}

std::vector<int32_t> PoaGraph::topo_order() const {
  std::vector<int32_t> order(nodes_.size());
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    const double ka = col_keys_[nodes_[a].col], kb = col_keys_[nodes_[b].col];
    if (ka != kb) {
      return ka < kb;
    }
    return a < b;
  });
  return order;
}

std::string PoaGraph::generate_consensus(
    std::vector<uint32_t>* coverages) const {
  std::string consensus;
  if (nodes_.empty()) {
    if (coverages) {
      coverages->clear();
    }
    return consensus;
  }

  const auto order = topo_order();
  std::vector<int64_t> score(nodes_.size(), 0);
  std::vector<int32_t> pred(nodes_.size(), -1);

  // Heaviest bundle: each node takes its best in-edge by
  // (edge weight, predecessor score).
  int32_t best_node = order[0];
  for (int32_t u : order) {
    int64_t best_w = -1, best_pred_score = -1;
    int32_t best_pred = -1;
    for (int32_t e : nodes_[u].in_edges) {
      const int64_t w = edges_[e].weight;
      const int64_t s = score[edges_[e].src];
      if (w > best_w || (w == best_w && s > best_pred_score)) {
        best_w = w;
        best_pred_score = s;
        best_pred = edges_[e].src;
      }
    }
    if (best_pred != -1) {
      score[u] = best_w + score[best_pred];
      pred[u] = best_pred;
    }
    if (score[u] > score[best_node]) {
      best_node = u;
    }
  }

  // Backward to a source along chosen predecessors, then forward from the
  // summit to a sink along the heaviest out-edges (branch completion
  // analogue: the consensus always spans source -> sink, so zero-weight
  // backbone-only stretches at window edges are retained for the trim stage
  // to judge; reference behavior: src/window.cpp:122-146).
  std::vector<int32_t> path;
  for (int32_t u = best_node; u != -1; u = pred[u]) {
    path.push_back(u);
  }
  std::reverse(path.begin(), path.end());

  int32_t u = best_node;
  while (!nodes_[u].out_edges.empty()) {
    int64_t best_w = -1, best_dst_score = -1;
    int32_t best_dst = -1;
    for (int32_t e : nodes_[u].out_edges) {
      const int64_t w = edges_[e].weight;
      const int64_t s = score[edges_[e].dst];
      if (w > best_w || (w == best_w && s > best_dst_score)) {
        best_w = w;
        best_dst_score = s;
        best_dst = edges_[e].dst;
      }
    }
    u = best_dst;
    path.push_back(u);
  }

  consensus.reserve(path.size());
  if (coverages) {
    coverages->clear();
    coverages->reserve(path.size());
  }
  for (int32_t v : path) {
    consensus += nodes_[v].base;
    if (coverages) {
      // Node coverage (paths through the chosen node itself) drives the
      // trim rule; measured better end-trimming than column-sum coverage
      // on every golden scenario.
      coverages->push_back(nodes_[v].coverage);
    }
  }
  return consensus;
}


namespace {

// Horizontal (gap-chain) pass of one DP row: row[j] = max over k<=j of
// row[k] + (j-k)*gap. In t-space (t[j] = row[j] - j*gap, ramp precomputed
// in jg) this is a prefix max. Generic version keeps the scalar chain.
template <typename ScoreT>
inline void horizontal_pass(ScoreT* __restrict row,
                            const ScoreT* __restrict /*jg*/, uint32_t L,
                            int8_t gap_) {
  for (uint32_t j = 1; j <= L; ++j) {
    const ScoreT left = static_cast<ScoreT>(row[j - 1] + gap_);
    if (left > row[j]) {
      row[j] = left;
    }
  }
}

#if defined(__AVX512BW__)
// int16 fast path: 32-lane blocks, prefix max inside the register via five
// shift-max steps (permutexvar word shifts), scalar carry across blocks.
inline void horizontal_pass(int16_t* __restrict row,
                            const int16_t* __restrict jg, uint32_t L,
                            int8_t gap_) {
  const uint32_t n = L + 1;
  const __m512i vneg = _mm512_set1_epi16(INT16_MIN);
  // shift-by-k index vectors: lane i reads lane i-k (masked to -inf below)
  __m512i idx[5];
  alignas(64) int16_t ibuf[32];
  for (int s = 0, k = 1; s < 5; ++s, k *= 2) {
    for (int i = 0; i < 32; ++i) {
      ibuf[i] = static_cast<int16_t>(i >= k ? i - k : 0);
    }
    idx[s] = _mm512_load_si512(ibuf);
  }
  const __mmask32 keep[5] = {
      static_cast<__mmask32>(~0x1u), static_cast<__mmask32>(~0x3u),
      static_cast<__mmask32>(~0xFu), static_cast<__mmask32>(~0xFFu),
      static_cast<__mmask32>(~0xFFFFu)};

  int16_t carry = INT16_MIN;
  uint32_t j = 0;
  for (; j + 32 <= n; j += 32) {
    __m512i t = _mm512_sub_epi16(_mm512_loadu_si512(row + j),
                                 _mm512_loadu_si512(jg + j));
    for (int s = 0; s < 5; ++s) {
      const __m512i sh = _mm512_mask_permutexvar_epi16(vneg, keep[s],
                                                       idx[s], t);
      t = _mm512_max_epi16(t, sh);
    }
    t = _mm512_max_epi16(t, _mm512_set1_epi16(carry));
    alignas(64) int16_t out[32];
    _mm512_store_si512(out, t);
    carry = out[31];
    _mm512_storeu_si512(
        row + j, _mm512_add_epi16(t, _mm512_loadu_si512(jg + j)));
  }
  // tail: scalar chain seeded with the carried prefix
  int16_t run = carry;
  for (; j < n; ++j) {
    const int16_t t = static_cast<int16_t>(row[j] - jg[j]);
    run = t > run ? t : run;
    row[j] = static_cast<int16_t>(run + jg[j]);
  }
  (void)gap_;
}
#endif

// DP + traceback core, templated on the score type (int16 when the score
// range allows, halving memory traffic). Returns the REVERSED alignment.
// preds come as CSR (poff/pdat) and scratch buffers are caller-owned so the
// hot path makes no allocations in steady state; per-letter match-profile
// rows turn the inner loop into pure ScoreT add/max streams (SPOA's SIMD
// engines use the same profile trick).
template <typename ScoreT>
PoaAlignment dp_and_traceback(const PoaGraph& graph, const char* seq,
                              uint32_t L, const std::vector<int32_t>& sub,
                              const int32_t* poff, const int32_t* pdat,
                              std::vector<ScoreT>& h,
                              std::vector<ScoreT>& prof,
                              std::vector<int32_t>& prof_of,
                              std::vector<uint8_t>& in_sub,
                              std::vector<uint8_t>& has_out, int8_t match_,
                              int8_t mismatch_, int8_t gap_) {
  const uint32_t S = static_cast<uint32_t>(sub.size());
  const size_t stride = L + 1;
  // No full-matrix fill: every subgraph row is written before any read (key
  // order == topological order); only the virtual start row needs values.
  // One extra row at the tail holds the j*gap ramp for the horizontal pass.
  h.resize(static_cast<size_t>(S + 2) * stride);
  ScoreT* __restrict jg = h.data() + static_cast<size_t>(S + 1) * stride;
  for (uint32_t j = 0; j <= L; ++j) {
    jg[j] = static_cast<ScoreT>(static_cast<int32_t>(j) * gap_);
  }

  for (uint32_t j = 0; j <= L; ++j) {
    h[j] = static_cast<ScoreT>(static_cast<int32_t>(j) * gap_);
  }

  // Match-profile rows, one per distinct letter in the subgraph.
  int32_t slot_of[256];
  std::fill(std::begin(slot_of), std::end(slot_of), -1);
  prof.clear();
  prof_of.resize(S);
  for (uint32_t r = 0; r < S; ++r) {
    const unsigned char ub =
        static_cast<unsigned char>(graph.nodes()[sub[r]].base);
    int32_t s = slot_of[ub];
    if (s < 0) {
      s = static_cast<int32_t>(prof.size() / stride);
      slot_of[ub] = s;
      prof.resize(prof.size() + stride);
      ScoreT* p = prof.data() + static_cast<size_t>(s) * stride;
      p[0] = 0;
      for (uint32_t j = 1; j <= L; ++j) {
        p[j] = static_cast<ScoreT>(
            seq[j - 1] == static_cast<char>(ub) ? match_ : mismatch_);
      }
    }
    prof_of[r] = s;
  }

  for (uint32_t r = 1; r <= S; ++r) {
    ScoreT* __restrict row = h.data() + static_cast<size_t>(r) * stride;
    const ScoreT* __restrict pf =
        prof.data() + static_cast<size_t>(prof_of[r - 1]) * stride;
    const int32_t pb = poff[r - 1];
    const int32_t pe = poff[r];

    // Diag/up pass over each predecessor row (vectorizable: row never
    // aliases a predecessor row — predecessors have strictly lower ranks),
    // then one sequential horizontal (gap-chain) pass.
    {
      const ScoreT* __restrict prow =
          pb == pe ? h.data()
                   : h.data() + static_cast<size_t>(pdat[pb]) * stride;
      row[0] = static_cast<ScoreT>(prow[0] + gap_);
      for (uint32_t j = 1; j <= L; ++j) {
        const ScoreT diag = static_cast<ScoreT>(prow[j - 1] + pf[j]);
        const ScoreT up = static_cast<ScoreT>(prow[j] + gap_);
        row[j] = diag > up ? diag : up;
      }
    }
    for (int32_t pi = pb + 1; pi < pe; ++pi) {
      const ScoreT* __restrict prow =
          h.data() + static_cast<size_t>(pdat[pi]) * stride;
      if (static_cast<ScoreT>(prow[0] + gap_) > row[0]) {
        row[0] = static_cast<ScoreT>(prow[0] + gap_);
      }
      for (uint32_t j = 1; j <= L; ++j) {
        const ScoreT diag = static_cast<ScoreT>(prow[j - 1] + pf[j]);
        const ScoreT up = static_cast<ScoreT>(prow[j] + gap_);
        const ScoreT cand = diag > up ? diag : up;
        if (cand > row[j]) {
          row[j] = cand;
        }
      }
    }
    // Horizontal pass. The gap chain row[j] = max(row[j], row[j-1]+g) is a
    // loop-carried dependency (~70% of DP time when scalar); in t-space
    // t[j] = row[j] - j*g it is a plain prefix max, computed per 32-lane
    // block with in-register shift-max steps plus a scalar carry.
    horizontal_pass(row, jg, L, gap_);
  }

  // End-node set: subgraph nodes without an out-edge inside the subgraph.
  // (An edge's dst is in the subgraph iff some preds entry references its
  // rank; recompute via a membership flag.)
  in_sub.assign(graph.num_nodes(), 0);
  for (int32_t u : sub) {
    in_sub[u] = 1;
  }
  has_out.assign(S, 0);
  for (uint32_t r = 0; r < S; ++r) {
    for (int32_t e : graph.nodes()[sub[r]].out_edges) {
      if (in_sub[graph.edges()[e].dst]) {
        has_out[r] = 1;
        break;
      }
    }
  }
  int32_t best_rank = -1;
  int64_t best_score = INT64_MIN;
  for (uint32_t r = 1; r <= S; ++r) {
    if (!has_out[r - 1]) {
      const int64_t sc = h[static_cast<size_t>(r) * stride + L];
      if (sc > best_score) {
        best_score = sc;
        best_rank = static_cast<int32_t>(r);
      }
    }
  }

  // Traceback by transition re-checking (H holds exact maxima, so any
  // satisfying transition lies on an optimal path). Priority: diag, up, left.
  int32_t r = best_rank;
  uint32_t j = L;
  PoaAlignment rev;
  while (r != 0 || j != 0) {
    if (r == 0) {
      rev.emplace_back(-1, static_cast<int32_t>(j) - 1);
      --j;
      continue;
    }
    const int32_t u = sub[r - 1];
    const char ub = graph.nodes()[u].base;
    const ScoreT* row = h.data() + static_cast<size_t>(r) * stride;
    const int32_t pb = poff[r - 1];
    const int32_t pe = poff[r];
    const int32_t cur = row[j];
    bool moved = false;

    const int32_t sc = j > 0 ? (seq[j - 1] == ub ? match_ : mismatch_) : 0;
    if (pb == pe) {
      const ScoreT* prow = h.data();
      if (j > 0 && prow[j - 1] + sc == cur) {
        rev.emplace_back(u, static_cast<int32_t>(j) - 1);
        r = 0;
        --j;
        moved = true;
      } else if (prow[j] + gap_ == cur) {
        rev.emplace_back(u, -1);
        r = 0;
        moved = true;
      }
    } else {
      for (int32_t pi = pb; pi < pe; ++pi) {
        const int32_t p = pdat[pi];
        const ScoreT* prow = h.data() + static_cast<size_t>(p) * stride;
        if (j > 0 && prow[j - 1] + sc == cur) {
          rev.emplace_back(u, static_cast<int32_t>(j) - 1);
          r = p;
          --j;
          moved = true;
          break;
        }
      }
      if (!moved) {
        for (int32_t pi = pb; pi < pe; ++pi) {
          const int32_t p = pdat[pi];
          const ScoreT* prow = h.data() + static_cast<size_t>(p) * stride;
          if (prow[j] + gap_ == cur) {
            rev.emplace_back(u, -1);
            r = p;
            moved = true;
            break;
          }
        }
      }
    }
    if (!moved) {
      // Left move (insertion).
      rev.emplace_back(-1, static_cast<int32_t>(j) - 1);
      --j;
    }
  }
  return rev;
}

}  // namespace

PoaAlignment PoaAligner::align(const char* seq, uint32_t len,
                               const PoaGraph& graph, double key_lo,
                               double key_hi) {
  PoaAlignment result;
  if (len == 0 || graph.num_nodes() == 0) {
    return result;
  }

  // Subgraph: nodes whose column key lies in [key_lo, key_hi], topo order.
  // Keys are cached in a flat array so the sort comparator is two loads,
  // not four indirections.
  keys_.resize(graph.num_nodes());
  sub_.clear();
  for (uint32_t i = 0; i < graph.num_nodes(); ++i) {
    const double k = graph.col_key(graph.nodes()[i].col);
    keys_[i] = k;
    if (k >= key_lo && k <= key_hi) {
      sub_.push_back(static_cast<int32_t>(i));
    }
  }
  if (sub_.empty()) {
    return result;
  }
  std::sort(sub_.begin(), sub_.end(), [&](int32_t a, int32_t b) {
    if (keys_[a] != keys_[b]) {
      return keys_[a] < keys_[b];
    }
    return a < b;
  });

  const uint32_t S = static_cast<uint32_t>(sub_.size());
  rank_of_.assign(graph.num_nodes(), 0);
  for (uint32_t r = 0; r < S; ++r) {
    rank_of_[sub_[r]] = static_cast<int32_t>(r) + 1;
  }

  // Predecessor ranks per subgraph node (edges from outside the key range
  // are cut, turning their targets into subgraph sources). CSR layout in
  // reused scratch — the nested-vector version spent more time in
  // allocator churn than in the DP at shallow depths.
  preds_off_.assign(S + 1, 0);
  for (uint32_t r = 0; r < S; ++r) {
    int32_t cnt = 0;
    for (int32_t e : graph.nodes()[sub_[r]].in_edges) {
      cnt += rank_of_[graph.edges()[e].src] > 0;
    }
    preds_off_[r + 1] = preds_off_[r] + cnt;
  }
  preds_dat_.resize(preds_off_[S]);
  for (uint32_t r = 0; r < S; ++r) {
    int32_t w = preds_off_[r];
    for (int32_t e : graph.nodes()[sub_[r]].in_edges) {
      const int32_t pr = rank_of_[graph.edges()[e].src];
      if (pr > 0) {
        preds_dat_[w++] = pr;
      }
    }
  }

  if (g_pred_stats.enabled) {
    int64_t amax = 0;
    for (uint32_t r = 0; r < S; ++r) {
      for (int32_t pi = preds_off_[r]; pi < preds_off_[r + 1]; ++pi) {
        const int64_t d = static_cast<int64_t>(r) + 1 - preds_dat_[pi];
        g_pred_stats.record(d, g_pred_stats.edge_hist);
        amax = std::max(amax, d);
      }
    }
    g_pred_stats.edges.fetch_add(preds_off_[S], std::memory_order_relaxed);
    g_pred_stats.aligns.fetch_add(1, std::memory_order_relaxed);
    g_pred_stats.record(amax, g_pred_stats.align_hist);
    int64_t cur = g_pred_stats.max_dist.load(std::memory_order_relaxed);
    while (amax > cur &&
           !g_pred_stats.max_dist.compare_exchange_weak(cur, amax)) {
    }
    int64_t cs = g_pred_stats.max_sub.load(std::memory_order_relaxed);
    while (S > cs &&
           !g_pred_stats.max_sub.compare_exchange_weak(cs, int64_t{S})) {
    }
  }

  const uint32_t L = len;
  // Score range bound: |score| <= (S + L + 2) * max |parameter|. When it
  // fits int16, the halved DP memory traffic nearly doubles throughput on
  // this bandwidth-bound loop.
  const int64_t max_param = std::max<int64_t>(
      {std::abs((int)match_), std::abs((int)mismatch_), std::abs((int)gap_)});
  const int64_t bound = static_cast<int64_t>(S + L + 2) * max_param;
  // t-space values in the horizontal prefix max reach bound + L*|gap|;
  // both must fit int16 for the fast path.
  const int64_t t_bound =
      bound + static_cast<int64_t>(L) * std::abs((int)gap_);
  PoaAlignment rev;
  if (t_bound < 32000) {
    rev = dp_and_traceback<int16_t>(graph, seq, L, sub_, preds_off_.data(),
                                    preds_dat_.data(), h16_, prof16_,
                                    prof_of_, in_sub_, has_out_, match_,
                                    mismatch_, gap_);
  } else {
    rev = dp_and_traceback<int32_t>(graph, seq, L, sub_, preds_off_.data(),
                                    preds_dat_.data(), h_, prof32_, prof_of_,
                                    in_sub_, has_out_, match_, mismatch_,
                                    gap_);
  }
  result.assign(rev.rbegin(), rev.rend());
  return result;
}

}  // namespace rt
