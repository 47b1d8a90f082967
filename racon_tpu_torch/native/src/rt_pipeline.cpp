#include "rt_error.hpp"
#include "rt_pipeline.hpp"

#include "rt_align.hpp"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <future>
#include <unordered_map>

namespace rt {

namespace {
constexpr uint64_t kChunkSize = 1024ull * 1024 * 1024;  // 1 GiB
}

Pipeline::Pipeline(const std::string& sequences_path,
                   const std::string& overlaps_path,
                   const std::string& target_path,
                   const PipelineParams& params)
    : params_(params) {
  if (params_.type != 0 && params_.type != 1) {
    rt::fail("[racon_tpu::createPolisher] error: invalid polisher type!\n");
  }
  if (params_.window_length == 0) {
    rt::fail("[racon_tpu::createPolisher] error: invalid window length!\n");
  }

  SeqFormat sfmt, tfmt;
  OvlFormat ofmt;
  if (!sniff_sequence_format(sequences_path, &sfmt)) {
    rt::fail("[racon_tpu::createPolisher] error: file %s has unsupported "
                 "format extension (valid extensions: .fasta, .fasta.gz, "
                 ".fna, .fna.gz, .fa, .fa.gz, .fastq, .fastq.gz, .fq, "
                 ".fq.gz)!\n",
                 sequences_path.c_str());
  }
  if (!sniff_overlap_format(overlaps_path, &ofmt)) {
    rt::fail("[racon_tpu::createPolisher] error: file %s has unsupported "
                 "format extension (valid extensions: .mhap, .mhap.gz, .paf, "
                 ".paf.gz, .sam, .sam.gz)!\n",
                 overlaps_path.c_str());
  }
  if (!sniff_sequence_format(target_path, &tfmt)) {
    rt::fail("[racon_tpu::createPolisher] error: file %s has unsupported "
                 "format extension (valid extensions: .fasta, .fasta.gz, "
                 ".fna, .fna.gz, .fa, .fa.gz, .fastq, .fastq.gz, .fq, "
                 ".fq.gz)!\n",
                 target_path.c_str());
  }

  sparser_.reset(new SequenceParser(sequences_path, sfmt));
  tparser_.reset(new SequenceParser(target_path, tfmt));
  oparser_.reset(new OverlapParser(overlaps_path, ofmt));

  dummy_quality_.assign(params_.window_length, '!');
  pool_.reset(new ThreadPool(params_.num_threads));
  // One aligner per worker plus one for non-pool callers
  // (ThreadPool::this_thread_index maps them to slot n).
  for (uint32_t i = 0; i < pool_->num_threads() + 1; ++i) {
    aligners_.emplace_back(
        new PoaAligner(params_.match, params_.mismatch, params_.gap));
  }
}

void Pipeline::remove_invalid_overlaps(
    std::vector<std::unique_ptr<Overlap>>& overlaps, uint64_t begin,
    uint64_t end) {
  // Parity: src/polisher.cpp:285-309 — error threshold, self overlap, and
  // (kC) keep only the longest overlap per query group.
  for (uint64_t i = begin; i < end; ++i) {
    if (overlaps[i] == nullptr) {
      continue;
    }
    if (overlaps[i]->error > params_.error_threshold ||
        overlaps[i]->q_id == overlaps[i]->t_id) {
      overlaps[i].reset();
      continue;
    }
    if (params_.type == 0) {  // kC
      for (uint64_t j = i + 1; j < end; ++j) {
        if (overlaps[j] == nullptr) {
          continue;
        }
        if (overlaps[i]->length >= overlaps[j]->length) {
          overlaps[j].reset();
        } else {
          overlaps[i].reset();
          break;
        }
      }
    }
  }
}

void Pipeline::prepare() {
  if (!windows_.empty() || !sequences_.empty()) {
    // Benign (parity: src/polisher.cpp:192-196): repeat initialization is a
    // warning, not an error.
    std::fprintf(stderr,
                 "[racon_tpu::Pipeline::prepare] warning: already "
                 "initialized!\n");
    return;
  }

  // Targets, all at once (parity: src/polisher.cpp:200-208).
  sequences_ = tparser_->parse(0);
  targets_size_ = sequences_.size();
  if (targets_size_ == 0) {
    rt::fail(
        "[racon_tpu::Pipeline::initialize] error: empty target "
        "sequences set!\n");
  }

  std::unordered_map<std::string, uint64_t> name_to_id;
  std::unordered_map<uint64_t, uint64_t> id_to_id;
  for (uint64_t i = 0; i < targets_size_; ++i) {
    name_to_id[sequences_[i]->name + "t"] = i;
    id_to_id[i << 1 | 1] = i;
  }

  logger_.log("[racon_tpu::Pipeline::initialize] loaded target sequences");
  std::vector<bool> has_name(targets_size_, true);
  std::vector<bool> has_data(targets_size_, true);
  std::vector<bool> has_reverse_data(targets_size_, false);

  // Reads, chunked; reads that duplicate a target share its slot
  // (parity: src/polisher.cpp:226-265).
  uint64_t read_ordinal = 0, total_reads_length = 0;
  while (true) {
    auto reads = sparser_->parse(kChunkSize);
    if (reads.empty()) {
      break;
    }
    for (auto& read : reads) {
      total_reads_length += read->data.size();
      auto it = name_to_id.find(read->name + "t");
      if (it != name_to_id.end()) {
        if (read->data.size() != sequences_[it->second]->data.size() ||
            read->quality.size() != sequences_[it->second]->quality.size()) {
          rt::fail("[racon_tpu::Pipeline::initialize] error: duplicate "
                       "sequence %s with unequal data\n",
                       read->name.c_str());
        }
        name_to_id[read->name + "q"] = it->second;
        id_to_id[read_ordinal << 1 | 0] = it->second;
      } else {
        const uint64_t idx = sequences_.size();
        name_to_id[read->name + "q"] = idx;
        id_to_id[read_ordinal << 1 | 0] = idx;
        sequences_.push_back(std::move(read));
      }
      ++read_ordinal;
    }
  }
  if (read_ordinal == 0) {
    rt::fail("[racon_tpu::Pipeline::initialize] error: empty sequences "
                 "set!\n");
  }

  has_name.resize(sequences_.size(), false);
  has_data.resize(sequences_.size(), false);
  has_reverse_data.resize(sequences_.size(), false);

  logger_.log("[racon_tpu::Pipeline::initialize] loaded sequences");
  // Short reads get NGS windows (no trim), long reads TGS
  // (parity: src/polisher.cpp:277-278).
  window_type_ = static_cast<double>(total_reads_length) / read_ordinal <= 1000
                     ? WindowType::kNGS
                     : WindowType::kTGS;

  // Overlaps, chunked, with sequential per-query grouping
  // (parity: src/polisher.cpp:311-351).
  uint64_t group_begin = 0;
  while (true) {
    auto chunk = oparser_->parse(kChunkSize);
    if (chunk.empty()) {
      break;
    }
    for (auto& o : chunk) {
      o->transmute(sequences_, name_to_id, id_to_id);
      if (!o->is_valid) {
        continue;
      }
      // New query group boundary?
      if (!overlaps_.empty() && group_begin < overlaps_.size()) {
        // find first non-null in current group
        while (group_begin < overlaps_.size() &&
               overlaps_[group_begin] == nullptr) {
          ++group_begin;
        }
        if (group_begin < overlaps_.size() &&
            overlaps_[group_begin]->q_id != o->q_id) {
          remove_invalid_overlaps(overlaps_, group_begin, overlaps_.size());
          group_begin = overlaps_.size();
        }
      }
      overlaps_.push_back(std::move(o));
    }
  }
  remove_invalid_overlaps(overlaps_, group_begin, overlaps_.size());

  // Compact.
  {
    std::vector<std::unique_ptr<Overlap>> kept;
    kept.reserve(overlaps_.size());
    for (auto& o : overlaps_) {
      if (o != nullptr) {
        kept.push_back(std::move(o));
      }
    }
    overlaps_.swap(kept);
  }

  if (overlaps_.empty()) {
    rt::fail("[racon_tpu::Pipeline::initialize] error: empty overlap "
                 "set!\n");
  }

  for (const auto& o : overlaps_) {
    if (o->strand) {
      has_reverse_data[o->q_id] = true;
    } else {
      has_data[o->q_id] = true;
    }
  }

  // Per-sequence transmute (free unused fields, build reverse complements)
  // on the pool (parity: src/polisher.cpp:373-382).
  {
    std::vector<std::future<void>> futs;
    for (uint64_t i = 0; i < sequences_.size(); ++i) {
      futs.emplace_back(pool_->submit([this, &has_name, &has_data,
                                       &has_reverse_data, i] {
        sequences_[i]->transmute(has_name[i] || i < targets_size_,
                                 has_data[i] || i < targets_size_,
                                 has_reverse_data[i]);
      }));
    }
    for (auto& f : futs) {
      f.get();
    }
  }

  logger_.log("[racon_tpu::Pipeline::initialize] loaded overlaps");
  // Collect alignment jobs (overlaps without a CIGAR).
  for (size_t i = 0; i < overlaps_.size(); ++i) {
    if (overlaps_[i]->cigar.empty()) {
      align_jobs_.push_back(i);
    }
  }
}

void Pipeline::align_job_views(size_t job, const char** q, uint32_t* q_len,
                               const char** t, uint32_t* t_len) const {
  overlaps_[align_jobs_[job]]->alignment_views(sequences_, q, q_len, t, t_len);
}

void Pipeline::set_job_cigar(size_t job, std::string cigar) {
  overlaps_[align_jobs_[job]]->cigar = std::move(cigar);
}

void Pipeline::align_jobs_cpu() {
  std::vector<std::future<void>> futs;
  for (size_t job : align_jobs_) {
    Overlap* o = overlaps_[job].get();
    if (!o->cigar.empty()) {
      continue;  // device already served this one
    }
    futs.emplace_back(pool_->submit([this, o] {
      const char *q, *t;
      uint32_t q_len, t_len;
      o->alignment_views(sequences_, &q, &q_len, &t, &t_len);
      o->cigar = align_global_cigar(q, q_len, t, t_len);
    }));
  }
  // 20-bin progress bar over alignment jobs
  // (parity: src/polisher.cpp:476-487).
  const size_t step = futs.size() / 20;
  for (size_t i = 0; i < futs.size(); ++i) {
    futs[i].get();
    if (step != 0 && (i + 1) % step == 0 && (i + 1) / step < 20) {
      logger_.bar("[racon_tpu::Pipeline::initialize] aligning overlaps");
    }
  }
  if (step != 0) {
    logger_.bar("[racon_tpu::Pipeline::initialize] aligning overlaps");
  } else if (!futs.empty()) {
    logger_.log("[racon_tpu::Pipeline::initialize] aligned overlaps");
  }
}

void Pipeline::build_windows() {
  // Breaking-point walks on the pool (cheap CIGAR scans now that every
  // overlap has a CIGAR; parity: src/polisher.cpp:466-488).
  {
    std::vector<std::future<void>> futs;
    for (auto& o : overlaps_) {
      Overlap* op = o.get();
      futs.emplace_back(pool_->submit([this, op] {
        op->find_breaking_points(sequences_, params_.window_length);
      }));
    }
    for (auto& f : futs) {
      f.get();
    }
  }

  // Create windows per target (parity: src/polisher.cpp:388-403).
  std::vector<uint64_t> id_to_first_window_id(targets_size_ + 1, 0);
  for (uint64_t i = 0; i < targets_size_; ++i) {
    uint32_t k = 0;
    const auto& target = *sequences_[i];
    const uint32_t t_size = static_cast<uint32_t>(target.data.size());
    for (uint32_t j = 0; j < t_size; j += params_.window_length, ++k) {
      const uint32_t length = std::min(j + params_.window_length, t_size) - j;
      windows_.push_back(createWindow(
          i, k, window_type_, target.data.data() + j, length,
          target.quality.empty() ? dummy_quality_.data()
                                 : target.quality.data() + j,
          length));
    }
    id_to_first_window_id[i + 1] = id_to_first_window_id[i] + k;
  }

  targets_coverages_.assign(targets_size_, 0);

  // Distribute overlap pieces into windows (parity: src/polisher.cpp:407-461).
  for (auto& o : overlaps_) {
    ++targets_coverages_[o->t_id];
    const auto& sequence = sequences_[o->q_id];
    const auto& bp = o->breaking_points;

    for (size_t j = 0; j + 1 < bp.size(); j += 2) {
      if (bp[j + 1].second - bp[j].second <
          0.02 * params_.window_length) {
        continue;
      }

      if (!sequence->quality.empty() || !sequence->reverse_quality.empty()) {
        const auto& quality =
            o->strand ? sequence->reverse_quality : sequence->quality;
        double average_quality = 0;
        for (uint32_t k = bp[j].second; k < bp[j + 1].second; ++k) {
          average_quality += static_cast<uint32_t>(quality[k]) - 33;
        }
        average_quality /= bp[j + 1].second - bp[j].second;
        if (average_quality < params_.quality_threshold) {
          continue;
        }
      }

      const uint64_t window_id =
          id_to_first_window_id[o->t_id] + bp[j].first / params_.window_length;
      const uint32_t window_start =
          (bp[j].first / params_.window_length) * params_.window_length;

      const char* data = o->strand
                             ? sequence->reverse_complement.data() + bp[j].second
                             : sequence->data.data() + bp[j].second;
      const uint32_t data_length = bp[j + 1].second - bp[j].second;

      const char* quality =
          o->strand ? (sequence->reverse_quality.empty()
                           ? nullptr
                           : sequence->reverse_quality.data() + bp[j].second)
                    : (sequence->quality.empty()
                           ? nullptr
                           : sequence->quality.data() + bp[j].second);
      const uint32_t quality_length = quality == nullptr ? 0 : data_length;

      windows_[window_id]->add_layer(data, data_length, quality,
                                     quality_length,
                                     bp[j].first - window_start,
                                     bp[j + 1].first - window_start - 1);
    }
    o.reset();
  }
  overlaps_.clear();
  align_jobs_.clear();

  done_.assign(windows_.size(), 0);
  polished_.assign(windows_.size(), 0);

  logger_.log("[racon_tpu::Pipeline::initialize] transformed data into "
              "windows");
}

void Pipeline::initialize() {
  prepare();
  align_jobs_cpu();
  build_windows();
}

bool Pipeline::consensus_cpu_one(size_t i) {
  const bool polished = windows_[i]->generate_consensus(
      *aligners_[pool_->this_thread_index()], params_.trim);
  done_[i] = 1;
  polished_[i] = polished ? 1 : 0;
  return polished;
}

void Pipeline::consensus_cpu_all() {
  std::vector<std::future<void>> futs;
  for (size_t i = 0; i < windows_.size(); ++i) {
    if (done_[i]) {
      continue;
    }
    futs.emplace_back(pool_->submit([this, i] { consensus_cpu_one(i); }));
  }
  const size_t step = futs.size() / 20;
  for (size_t i = 0; i < futs.size(); ++i) {
    futs[i].get();
    if (step != 0 && (i + 1) % step == 0 && (i + 1) / step < 20) {
      logger_.bar("[racon_tpu::Pipeline::polish] generating consensus");
    }
  }
  if (step != 0) {
    logger_.bar("[racon_tpu::Pipeline::polish] generating consensus");
  } else if (!futs.empty()) {
    logger_.log("[racon_tpu::Pipeline::polish] generated consensus");
  }
}

void Pipeline::set_consensus(size_t i, std::string consensus, bool polished) {
  windows_[i]->consensus = std::move(consensus);
  done_[i] = 1;
  polished_[i] = polished ? 1 : 0;
}

void Pipeline::stitch(bool drop_unpolished_sequences,
                      std::vector<std::pair<std::string, std::string>>* dst) {
  if (stitched_) {
    rt::fail("[racon_tpu::Pipeline::stitch] error: windows already "
                 "consumed by a previous stitch!\n");
  }
  stitched_ = true;

  std::string polished_data;
  uint32_t num_polished_windows = 0;

  for (size_t i = 0; i < windows_.size(); ++i) {
    if (!done_[i]) {
      rt::fail("[racon_tpu::Pipeline::stitch] error: window %zu has no "
                   "consensus!\n",
                   i);
    }
    num_polished_windows += polished_[i] ? 1 : 0;
    polished_data += windows_[i]->consensus;

    if (i == windows_.size() - 1 || windows_[i + 1]->rank == 0) {
      const double polished_ratio =
          num_polished_windows / static_cast<double>(windows_[i]->rank + 1);

      if (!drop_unpolished_sequences || polished_ratio > 0) {
        std::string tags = params_.type == 1 ? "r" : "";
        tags += " LN:i:" + std::to_string(polished_data.size());
        tags += " RC:i:" + std::to_string(targets_coverages_[windows_[i]->id]);
        tags += " XC:f:" + std::to_string(polished_ratio);
        dst->emplace_back(sequences_[windows_[i]->id]->name + tags,
                          polished_data);
      }
      num_polished_windows = 0;
      polished_data.clear();
    }
    windows_[i].reset();
  }
}

}  // namespace rt
