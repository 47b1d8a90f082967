// Partial-order alignment (POA) engine: sequence-to-graph global alignment,
// incremental graph construction, and heaviest-bundle consensus.
//
// Capability parity with the reference's use of vendored SPOA
// (spoa::AlignmentEngine::Create(kNW, m, x, g), Graph::AddAlignment with
// optional per-base quality weights, Graph::Subgraph + UpdateAlignment,
// Graph::GenerateConsensus(&coverages); call sites
// racon src/polisher.cpp:179-183 and
// racon src/window.cpp:65-149).
//
// The design is new and deliberately TPU-shaped: instead of SPOA's pointer
// graph with aligned-node rings, nodes live in *columns*. A column is an
// alignment slot holding at most one node per distinct base; the aligned-ring
// relation of classic POA is exactly column co-membership. Every column
// carries a strictly ordered fractional key; all edges point from lower to
// higher keys, so topological order is just a sort by key. This same
// column/key representation is what the JAX/Pallas batch POA kernel uses on
// device (racon_tpu/ops/poa.py), which keeps host fallback and device path
// semantically aligned.
//
// Subgraph extraction for span-bounded alignment (reference:
// src/window.cpp:98-107) becomes a key-range filter: backbone column i has
// key exactly i, so aligning a layer against backbone span [b, e] means
// aligning against all nodes whose column key lies in [b, e].
#pragma once

#include <cstdint>
#include <string>
#include <utility>
#include <vector>

namespace rt {

using PoaAlignment = std::vector<std::pair<int32_t, int32_t>>;  // (node, pos)

struct PoaNode {
  char base;
  int32_t col;          // column index
  uint32_t coverage;    // number of sequence paths through this node
  std::vector<int32_t> in_edges;   // edge ids
  std::vector<int32_t> out_edges;  // edge ids
};

struct PoaEdge {
  int32_t src, dst;
  int64_t weight;
};

class PoaGraph {
 public:
  PoaGraph() = default;

  // Incorporate `seq` along `alignment` (empty alignment = append the whole
  // sequence as a fresh source->sink chain, used for the backbone).
  // `weights` are per-base weights (PHRED quality - 33, or all 1 when the
  // sequence has no quality); an edge traversed between positions p-1 and p
  // gains w[p-1] + w[p].
  void add_alignment(const PoaAlignment& alignment, const char* seq,
                     uint32_t len, const std::vector<uint32_t>& weights);

  // Heaviest-bundle consensus. Every consensus base gets the chosen node's
  // own path coverage, consumed by the window trim rule (reference call
  // site: src/window.cpp:122-146). Deliberate deviation: spoa's summary
  // counts the whole aligned column; node-only coverage measured better
  // end-trimming on every golden scenario (docs/benchmarks.md), so the
  // trim threshold sees the support for the *chosen* base, not the column.
  std::string generate_consensus(std::vector<uint32_t>* coverages) const;

  uint32_t num_nodes() const { return static_cast<uint32_t>(nodes_.size()); }
  uint32_t num_sequences() const { return num_sequences_; }

  const std::vector<PoaNode>& nodes() const { return nodes_; }
  const std::vector<PoaEdge>& edges() const { return edges_; }
  double col_key(int32_t col) const { return col_keys_[col]; }
  const std::vector<std::vector<int32_t>>& col_members() const {
    return col_members_;
  }

  // Topologically sorted node ids (sorted by column key; nodes sharing a
  // column are mutually exclusive alternatives, so their relative order is
  // free).
  std::vector<int32_t> topo_order() const;

 private:
  friend class PoaAligner;
  int32_t new_column(double key);
  int32_t new_node(char base, int32_t col);
  void add_or_bump_edge(int32_t src, int32_t dst, int64_t w);

  std::vector<PoaNode> nodes_;
  std::vector<PoaEdge> edges_;
  std::vector<double> col_keys_;
  std::vector<std::vector<int32_t>> col_members_;
  uint32_t num_sequences_ = 0;
};

// Global (kNW) sequence-to-graph aligner with linear gap penalty.
// One instance per worker thread; DP buffers are reused across calls
// (reference analogue: per-thread spoa::AlignmentEngine,
// src/polisher.cpp:179-183).
class PoaAligner {
 public:
  PoaAligner(int8_t match, int8_t mismatch, int8_t gap)
      : match_(match), mismatch_(mismatch), gap_(gap) {}

  // Align seq against the subgraph of nodes whose column key lies in
  // [key_lo, key_hi]. Pass -inf/+inf bounds for a full-graph alignment.
  // Returned pairs reference full-graph node ids.
  PoaAlignment align(const char* seq, uint32_t len, const PoaGraph& graph,
                     double key_lo, double key_hi);

 private:
  int8_t match_, mismatch_, gap_;
  std::vector<int32_t> h_;       // (S+1) x (L+1) scores (wide-range fallback)
  std::vector<int16_t> h16_;     // narrow-range fast path
  std::vector<int32_t> sub_;     // subgraph node ids in topo order
  std::vector<int32_t> rank_of_; // node id -> rank (1-based), 0 = absent
  // Steady-state scratch (no per-call allocation on the hot path):
  std::vector<int32_t> preds_off_;  // CSR offsets into preds_dat_, size S+1
  std::vector<int32_t> preds_dat_;  // predecessor ranks, flat
  std::vector<int16_t> prof16_;     // per-letter match-profile rows
  std::vector<int32_t> prof32_;
  std::vector<int32_t> prof_of_;    // rank -> profile row index
  std::vector<double> keys_;        // node id -> column key (sort cache)
  std::vector<uint8_t> in_sub_, has_out_;
};

}  // namespace rt
