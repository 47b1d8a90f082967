// Sequence data model for racon-tpu's native host layer.
//
// Capability parity with the reference data model (see
// racon src/sequence.{hpp,cpp}): uppercased bases, optional PHRED
// quality (dropped when it is all-'!' i.e. carries no information,
// reference: src/sequence.cpp:34-42), lazy reverse complement + reversed
// quality (reference: src/sequence.cpp:49-84), and a field-freeing transmute
// used to keep peak RSS low on large datasets (reference:
// src/sequence.cpp:86-100).
//
// The implementation is new: it is a plain struct designed to hand out
// zero-copy views to the TPU batch packer rather than an OO class hierarchy.
#pragma once

#include <cstdint>
#include <memory>
#include <string>

namespace rt {

struct Sequence {
  std::string name;
  std::string data;                 // uppercased bases
  std::string quality;              // PHRED+33 chars, empty if absent/uninformative
  std::string reverse_complement;   // lazily built
  std::string reverse_quality;      // lazily built

  Sequence() = default;
  Sequence(const char* name_ptr, uint32_t name_len, const char* data_ptr,
           uint32_t data_len);
  Sequence(const char* name_ptr, uint32_t name_len, const char* data_ptr,
           uint32_t data_len, const char* qual_ptr, uint32_t qual_len);
  Sequence(std::string n, std::string d)
      : name(std::move(n)), data(std::move(d)) {}

  // Build reverse complement (A<->T, C<->G, other chars copied verbatim) and
  // reversed quality. Idempotent. Parity: src/sequence.cpp:49-84.
  void create_reverse_complement();

  // Free fields that later phases will never touch.
  // Parity: src/sequence.cpp:86-100.
  void transmute(bool keep_name, bool keep_data, bool need_reverse_data);
};

std::unique_ptr<Sequence> createSequence(const std::string& name,
                                         const std::string& data);

}  // namespace rt
