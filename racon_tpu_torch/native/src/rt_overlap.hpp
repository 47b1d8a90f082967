// Overlap data model: one read<->target overlap from MHAP/PAF/SAM input,
// with id resolution against the loaded sequence set and computation of
// per-window "breaking points" (the (target_pos, query_pos) match anchors at
// window boundaries that later drive zero-copy window layer assignment).
//
// Capability parity with the reference overlap model
// (racon src/overlap.{hpp,cpp}): the three format constructors
// (MHAP src/overlap.cpp:15-27, PAF :29-42, SAM with full CIGAR scan :44-108),
// name/id -> internal id transmutation (:129-177) with the same hard
// length-consistency errors, the span-ratio error metric (:24-26), and the
// CIGAR walk emitting per-window first/last match pairs (:226-292).
//
// The alignment step for CIGAR-less overlaps is pluggable (host CPU aligner
// or the TPU batch aligner) instead of a hardwired edlib call — that is the
// seam the accelerator backend overrides (reference seam:
// src/overlap.cpp:179-203 + src/cuda/cudaaligner.cpp).
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#include "rt_sequence.hpp"

namespace rt {

struct Overlap {
  std::string q_name;
  uint64_t q_id = 0;
  uint32_t q_begin = 0, q_end = 0, q_length = 0;
  std::string t_name;
  uint64_t t_id = 0;
  uint32_t t_begin = 0, t_end = 0, t_length = 0;
  bool strand = false;  // true if query maps to the reverse strand
  uint32_t length = 0;  // max of the two spans
  double error = 0.0;   // 1 - min(span)/max(span)
  std::string cigar;    // SAM-provided or filled by the aligner
  bool is_valid = true;
  bool is_transmuted = false;
  // Flattened (t_pos, q_pos) pairs; even index = first match in a window,
  // odd index = one-past the last match.
  std::vector<std::pair<uint32_t, uint32_t>> breaking_points;

  Overlap() : is_transmuted(true) {}

  // MHAP record: ids are 1-based ordinals. Parity: src/overlap.cpp:15-27.
  static std::unique_ptr<Overlap> from_mhap(uint64_t a_id, uint64_t b_id,
                                            double err, uint32_t minmers,
                                            uint32_t a_rc, uint32_t a_begin,
                                            uint32_t a_end, uint32_t a_length,
                                            uint32_t b_rc, uint32_t b_begin,
                                            uint32_t b_end, uint32_t b_length);

  // PAF record. Parity: src/overlap.cpp:29-42.
  static std::unique_ptr<Overlap> from_paf(
      std::string q_name, uint32_t q_length, uint32_t q_begin, uint32_t q_end,
      char orientation, std::string t_name, uint32_t t_length,
      uint32_t t_begin, uint32_t t_end);

  // SAM record (single alignment line). Parity: src/overlap.cpp:44-108.
  static std::unique_ptr<Overlap> from_sam(std::string q_name, uint32_t flag,
                                           std::string t_name, uint32_t pos_1based,
                                           std::string cigar);

  // Resolve q/t to internal sequence ids and validate lengths.
  // Parity: src/overlap.cpp:129-177 (same hard exits on length mismatch).
  void transmute(const std::vector<std::unique_ptr<Sequence>>& sequences,
                 const std::unordered_map<std::string, uint64_t>& name_to_id,
                 const std::unordered_map<uint64_t, uint64_t>& id_to_id);

  // Compute breaking points; if no CIGAR is present the `aligned_cigar`
  // callback result (already computed global alignment) must be installed
  // into `cigar` beforehand, or pass nullptrs to use the built-in host
  // aligner. Parity: src/overlap.cpp:179-203.
  void find_breaking_points(
      const std::vector<std::unique_ptr<Sequence>>& sequences,
      uint32_t window_length);

  // Pointers into the strand-appropriate query/target subsequences that need
  // global alignment (used by both the host aligner and the TPU batch
  // aligner). Only meaningful when cigar is empty.
  void alignment_views(const std::vector<std::unique_ptr<Sequence>>& sequences,
                       const char** q, uint32_t* q_len, const char** t,
                       uint32_t* t_len) const;

  // CIGAR walk emitting per-window match anchors.
  // Parity: src/overlap.cpp:226-292.
  void find_breaking_points_from_cigar(uint32_t window_length);
};

}  // namespace rt
