// Host pairwise global alignment kernels.
//
// Capability parity with the reference's use of edlib
// (racon src/overlap.cpp:205-224: global NW alignment with a path,
// encoded as a standard CIGAR; racon test/racon_test.cpp:14-23:
// plain global edit distance as the accuracy metric).
//
// The implementation is new and self-contained:
//  * align_global_cigar — unit-cost banded Needleman-Wunsch with Ukkonen band
//    doubling and a 2-bit packed traceback, emitting standard "M/I/D" CIGAR
//    (I consumes query, D consumes target — SAM convention).
//  * edit_distance — Myers/Hyyro bit-parallel global Levenshtein distance
//    (distance only), used by tests and benchmarks.
#pragma once

#include <cstdint>
#include <string>

namespace rt {

// Global (NW) unit-cost alignment path as a standard CIGAR string.
// Handles empty inputs (pure I/D CIGARs).
std::string align_global_cigar(const char* q, uint32_t q_len, const char* t,
                               uint32_t t_len);

// Global (NW) Levenshtein distance, bit-parallel.
int64_t edit_distance(const char* q, uint32_t q_len, const char* t,
                      uint32_t t_len);

}  // namespace rt
