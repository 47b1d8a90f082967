// Polishing pipeline orchestrator: the native runtime that parses inputs,
// filters overlaps, aligns them, slices targets into windows, distributes
// read segments, runs (or delegates) per-window POA consensus, and stitches
// polished contigs.
//
// Capability parity with the reference orchestrator
// (racon src/polisher.{hpp,cpp}): same two-phase
// initialize -> polish flow (src/polisher.cpp:190-464, 490-547), same overlap
// filtering rules (error threshold, self-overlaps, kC longest-per-query;
// :285-309), same window admission rules (2% span, average quality;
// :415-433), same provenance tags on output (:521-524).
//
// The accelerator seam is *phase-granular* instead of subclass-virtual: the
// two hot phases (overlap alignment, window consensus) are exposed as job
// exports + result imports so the TPU driver (Python/JAX) can claim batches
// and the host transparently finishes whatever the device rejected — the same
// graceful-degradation lattice the reference implements in
// src/cuda/cudapolisher.cpp:204-213,354-378.
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <vector>

#include "rt_logger.hpp"
#include "rt_overlap.hpp"
#include "rt_parsers.hpp"
#include "rt_poa.hpp"
#include "rt_sequence.hpp"
#include "rt_threadpool.hpp"
#include "rt_window.hpp"

namespace rt {

struct PipelineParams {
  int type = 0;  // 0 = kC (polish / keep-longest correction), 1 = kF
  uint32_t window_length = 500;
  double quality_threshold = 10.0;
  double error_threshold = 0.3;
  bool trim = true;
  int8_t match = 3;
  int8_t mismatch = -5;
  int8_t gap = -4;
  uint32_t num_threads = 1;
};

class Pipeline {
 public:
  // Exits with a reference-compatible message on unsupported extensions or
  // invalid parameters (parity: src/polisher.cpp:57-135).
  Pipeline(const std::string& sequences_path, const std::string& overlaps_path,
           const std::string& target_path, const PipelineParams& params);

  ~Pipeline() { logger_.total("[racon_tpu::Pipeline::] total ="); }

  // ---- phase 1: data preparation -----------------------------------------
  // Parse + dedup + transmute + filter; stops right before overlap
  // alignment. Parity: src/polisher.cpp:200-382.
  void prepare();

  // Overlaps still lacking a CIGAR (alignment jobs for the device).
  size_t num_align_jobs() const { return align_jobs_.size(); }
  void align_job_views(size_t job, const char** q, uint32_t* q_len,
                       const char** t, uint32_t* t_len) const;
  // Install a device-produced CIGAR for job k (marks it done).
  void set_job_cigar(size_t job, std::string cigar);
  // Host fallback: align every remaining CIGAR-less job on the thread pool.
  void align_jobs_cpu();

  // Breaking-point walks + window creation + layer distribution.
  // Parity: src/polisher.cpp:388-461. Frees overlaps.
  void build_windows();

  // prepare + align_jobs_cpu + build_windows (the pure-CPU initialize()).
  void initialize();

  // ---- phase 2: consensus -------------------------------------------------
  size_t num_windows() const { return windows_.size(); }
  const Window& window(size_t i) const { return *windows_[i]; }

  // Host POA for one window / all unfinished windows (thread pool).
  bool consensus_cpu_one(size_t i);
  void consensus_cpu_all();

  // Install a device-produced consensus for window i.
  void set_consensus(size_t i, std::string consensus, bool polished);
  bool has_consensus(size_t i) const { return done_[i] != 0; }

  // Ordered stitch into polished sequences with LN/RC/XC provenance tags.
  // Parity: src/polisher.cpp:505-537.
  void stitch(bool drop_unpolished_sequences,
              std::vector<std::pair<std::string, std::string>>* dst);

  const PipelineParams& params() const { return params_; }
  WindowType window_type() const { return window_type_; }

 private:
  void remove_invalid_overlaps(std::vector<std::unique_ptr<Overlap>>& overlaps,
                               uint64_t begin, uint64_t end);

  PipelineParams params_;
  std::unique_ptr<SequenceParser> sparser_, tparser_;
  std::unique_ptr<OverlapParser> oparser_;

  std::vector<std::unique_ptr<Sequence>> sequences_;
  uint64_t targets_size_ = 0;
  WindowType window_type_ = WindowType::kTGS;
  std::string dummy_quality_;

  std::vector<std::unique_ptr<Overlap>> overlaps_;
  std::vector<size_t> align_jobs_;  // overlap indices lacking a CIGAR

  std::vector<std::shared_ptr<Window>> windows_;
  bool stitched_ = false;
  std::vector<uint8_t> done_;      // consensus present
  std::vector<uint8_t> polished_;  // POA actually ran
  std::vector<uint64_t> targets_coverages_;

  std::vector<std::unique_ptr<PoaAligner>> aligners_;  // one per thread
  Logger logger_;
  // Declared last: destroyed first, so an exception-abandoned task queue
  // drains (and its tasks' member references stay valid) before any other
  // member is torn down.
  std::unique_ptr<ThreadPool> pool_;
};

}  // namespace rt
