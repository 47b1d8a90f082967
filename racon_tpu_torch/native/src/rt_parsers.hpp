// Streaming parsers for the five input formats the framework accepts:
// FASTA / FASTQ (sequences, optionally gzipped) and MHAP / PAF / SAM
// (overlaps, optionally gzipped).
//
// Capability parity with the reference's vendored bioparser
// (bioparser::{Fasta,Fastq,Mhap,Paf,Sam}Parser, see
// racon src/polisher.cpp:20-24,85-135) — same format set, same
// transparent gzip handling, and a chunked Parse(max_bytes) pull interface so
// very large read sets can be consumed in bounded memory
// (reference: kChunkSize 1 GiB, src/polisher.cpp:30,226-265).
//
// The implementation is new: a single zlib-backed buffered reader with
// per-format record scanners.
#pragma once

#include <cstdint>
#include <functional>
#include <memory>
#include <string>
#include <vector>

#include "rt_overlap.hpp"
#include "rt_sequence.hpp"

namespace rt {

// Buffered gzFile reader (zlib reads plain files transparently too).
class GzReader {
 public:
  explicit GzReader(const std::string& path);
  ~GzReader();
  GzReader(const GzReader&) = delete;
  GzReader& operator=(const GzReader&) = delete;

  // Read one line (without trailing \n / \r\n) into `line`.
  // Returns false at EOF with no data.
  bool getline(std::string& line);
  bool eof() const { return eof_ && pos_ >= len_; }
  void reset();

 private:
  void fill();
  void* file_ = nullptr;
  std::string path_;
  std::vector<char> buf_;
  size_t pos_ = 0, len_ = 0;
  bool eof_ = false;
};

enum class SeqFormat { kFasta, kFastq };
enum class OvlFormat { kMhap, kPaf, kSam };

// Extension sniffing, same accepted extension sets as the reference factory
// (src/polisher.cpp:85-135). Returns false if the extension is unsupported.
bool sniff_sequence_format(const std::string& path, SeqFormat* fmt);
bool sniff_overlap_format(const std::string& path, OvlFormat* fmt);

class SequenceParser {
 public:
  SequenceParser(const std::string& path, SeqFormat fmt);

  // Parse records until at least `max_bytes` of sequence payload has been
  // produced (or EOF). max_bytes == 0 means parse everything.
  std::vector<std::unique_ptr<Sequence>> parse(uint64_t max_bytes);
  void reset();

 private:
  bool parse_one(std::vector<std::unique_ptr<Sequence>>& dst, uint64_t* bytes);
  GzReader reader_;
  SeqFormat fmt_;
  std::string pending_header_;  // FASTA header lookahead
};

class OverlapParser {
 public:
  OverlapParser(const std::string& path, OvlFormat fmt);
  std::vector<std::unique_ptr<Overlap>> parse(uint64_t max_bytes);
  void reset();

 private:
  GzReader reader_;
  OvlFormat fmt_;
};

}  // namespace rt
