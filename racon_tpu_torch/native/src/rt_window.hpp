// Window: one POA consensus problem — a backbone slice of a target plus the
// read segments (layers) assigned to it, all as zero-copy views into the
// sequence store.
//
// Capability parity with the reference window
// (racon src/window.{hpp,cpp}): layer admission rules
// (src/window.cpp:42-63), the <3-sequences backbone shortcut (:68-71),
// layer ordering by begin position (:85-86), full-graph vs span-bounded
// alignment selection with the 1% offset rule (:88-107), quality-weighted
// graph updates (:110-119), and the TGS low-coverage end trim with the
// chimera warning (:125-146).
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <vector>

#include "rt_poa.hpp"

namespace rt {

enum class WindowType { kNGS, kTGS };

struct Window {
  uint64_t id;     // target sequence id
  uint32_t rank;   // window ordinal within the target
  WindowType type;
  std::string consensus;

  // views (ptr, len); element 0 is the backbone
  std::vector<std::pair<const char*, uint32_t>> sequences;
  std::vector<std::pair<const char*, uint32_t>> qualities;  // ptr may be null
  std::vector<std::pair<uint32_t, uint32_t>> positions;     // begin, end (inclusive)

  Window(uint64_t id_, uint32_t rank_, WindowType type_, const char* backbone,
         uint32_t backbone_length, const char* quality,
         uint32_t quality_length);

  void add_layer(const char* sequence, uint32_t sequence_length,
                 const char* quality, uint32_t quality_length, uint32_t begin,
                 uint32_t end);

  // CPU oracle / fallback consensus via the host POA engine.
  // Returns true if POA actually ran (>= 2 layers), false when the backbone
  // was copied through unchanged.
  bool generate_consensus(PoaAligner& aligner, bool trim);
};

std::shared_ptr<Window> createWindow(uint64_t id, uint32_t rank,
                                     WindowType type, const char* backbone,
                                     uint32_t backbone_length,
                                     const char* quality,
                                     uint32_t quality_length);

}  // namespace rt
