// C ABI for the racon-tpu native runtime, consumed by the Python driver via
// ctypes (no pybind11 dependency). Handles own all memory; strings returned
// to Python live inside the handle or in rt_free()-able buffers.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "rt_align.hpp"
#include "rt_pipeline.hpp"
#include "rt_poa.hpp"
#include "rt_sequence.hpp"
#include "rt_window.hpp"

using rt::Pipeline;
using rt::PipelineParams;

namespace {

struct PipelineHandle {
  std::unique_ptr<Pipeline> pipeline;
  std::vector<std::pair<std::string, std::string>> results;
  bool stitched = false;
};

// Errors cross the C ABI as a thread-local message (the Python binding
// raises after every call that sets it); the CLI binary instead catches
// rt::Error at main() and exits 1 — the reference's observable behavior.
thread_local std::string g_error;

template <typename F>
auto guarded(F&& f, decltype(f()) fallback) -> decltype(f()) {
  g_error.clear();
  try {
    return f();
  } catch (const std::exception& e) {
    g_error = e.what();
    return fallback;
  }
}

template <typename F>
void guarded_void(F&& f) {
  guarded([&]() -> int { f(); return 0; }, 0);
}

}  // namespace

extern "C" {

const char* rt_last_error() {
  return g_error.empty() ? nullptr : g_error.c_str();
}

// ---------- standalone kernels -------------------------------------------

int64_t rt_edit_distance(const char* q, uint32_t q_len, const char* t,
                         uint32_t t_len) {
  return rt::edit_distance(q, q_len, t, t_len);
}

char* rt_align_cigar(const char* q, uint32_t q_len, const char* t,
                     uint32_t t_len) {
  return guarded([&]() -> char* {
    const std::string cigar = rt::align_global_cigar(q, q_len, t, t_len);
    char* out = static_cast<char*>(std::malloc(cigar.size() + 1));
    std::memcpy(out, cigar.c_str(), cigar.size() + 1);
    return out;
  }, nullptr);
}

void rt_free(void* p) { std::free(p); }

// One-shot window consensus (unit-test / differential-test hook).
// layers: concatenated bases; lens/begins/ends per layer; quals may be null
// (then pass has_qual = 0). Returns malloc'd consensus; *polished set to 1 if
// POA ran.
char* rt_window_consensus(const char* backbone, uint32_t backbone_len,
                          const char* backbone_qual, const char* layer_bases,
                          const char* layer_quals, const uint32_t* lens,
                          const uint32_t* begins, const uint32_t* ends,
                          uint32_t n_layers, int has_qual, int window_type,
                          int trim, int8_t match, int8_t mismatch, int8_t gap,
                          int* polished) {
  return guarded([&]() -> char* {
    std::string dummy(backbone_len, '!');
    auto window = rt::createWindow(
        0, 0, window_type == 0 ? rt::WindowType::kNGS : rt::WindowType::kTGS,
        backbone, backbone_len, backbone_qual ? backbone_qual : dummy.data(),
        backbone_len);
    uint64_t off = 0;
    for (uint32_t i = 0; i < n_layers; ++i) {
      window->add_layer(layer_bases + off, lens[i],
                        has_qual ? layer_quals + off : nullptr,
                        has_qual ? lens[i] : 0, begins[i], ends[i]);
      off += lens[i];
    }
    rt::PoaAligner aligner(match, mismatch, gap);
    const bool p = window->generate_consensus(aligner, trim != 0);
    if (polished) {
      *polished = p ? 1 : 0;
    }
    char* out = static_cast<char*>(std::malloc(window->consensus.size() + 1));
    std::memcpy(out, window->consensus.c_str(), window->consensus.size() + 1);
    return out;
  }, nullptr);
}

// ---------- pipeline ------------------------------------------------------

void* rt_pipeline_create(const char* sequences_path, const char* overlaps_path,
                         const char* target_path, int type,
                         uint32_t window_length, double quality_threshold,
                         double error_threshold, int trim, int8_t match,
                         int8_t mismatch, int8_t gap, uint32_t num_threads) {
  return guarded([&]() -> void* {
    PipelineParams params;
    params.type = type;
    params.window_length = window_length;
    params.quality_threshold = quality_threshold;
    params.error_threshold = error_threshold;
    params.trim = trim != 0;
    params.match = match;
    params.mismatch = mismatch;
    params.gap = gap;
    params.num_threads = num_threads;
    auto h = std::make_unique<PipelineHandle>();
    h->pipeline.reset(
        new Pipeline(sequences_path, overlaps_path, target_path, params));
    return h.release();
  }, nullptr);
}

void rt_pipeline_destroy(void* handle) {
  delete static_cast<PipelineHandle*>(handle);
}

void rt_pipeline_prepare(void* handle) {
  guarded_void(
      [&] { static_cast<PipelineHandle*>(handle)->pipeline->prepare(); });
}

uint64_t rt_pipeline_num_align_jobs(void* handle) {
  return static_cast<PipelineHandle*>(handle)->pipeline->num_align_jobs();
}

// Query/target views for alignment job k (zero-copy pointers + lengths).
void rt_pipeline_align_job(void* handle, uint64_t job, const char** q,
                           uint32_t* q_len, const char** t, uint32_t* t_len) {
  guarded_void([&] {
    static_cast<PipelineHandle*>(handle)->pipeline->align_job_views(
        job, q, q_len, t, t_len);
  });
}

// Bulk (q_len, t_len) export: out[2k] = q_len, out[2k+1] = t_len for every
// alignment job k.  One ABI crossing instead of num_align_jobs() of them —
// the Python driver re-reads the length table at each device-engine attempt.
void rt_pipeline_align_job_lengths(void* handle, uint32_t* out) {
  guarded_void([&] {
    auto* p = static_cast<PipelineHandle*>(handle)->pipeline.get();
    const uint64_t n = p->num_align_jobs();
    const char* q = nullptr;
    const char* t = nullptr;
    for (uint64_t k = 0; k < n; ++k) {
      p->align_job_views(k, &q, &out[2 * k], &t, &out[2 * k + 1]);
    }
  });
}

void rt_pipeline_set_job_cigar(void* handle, uint64_t job, const char* cigar) {
  guarded_void([&] {
    static_cast<PipelineHandle*>(handle)->pipeline->set_job_cigar(job, cigar);
  });
}

void rt_pipeline_align_jobs_cpu(void* handle) {
  guarded_void([&] {
    static_cast<PipelineHandle*>(handle)->pipeline->align_jobs_cpu();
  });
}

void rt_pipeline_build_windows(void* handle) {
  guarded_void([&] {
    static_cast<PipelineHandle*>(handle)->pipeline->build_windows();
  });
}

void rt_pipeline_initialize(void* handle) {
  guarded_void([&] {
    static_cast<PipelineHandle*>(handle)->pipeline->initialize();
  });
}

uint64_t rt_pipeline_num_windows(void* handle) {
  return static_cast<PipelineHandle*>(handle)->pipeline->num_windows();
}

// Window metadata: [n_total_seqs (incl. backbone), backbone_len, rank, type,
// total_layer_bytes, target_id]
void rt_pipeline_window_info(void* handle, uint64_t i, uint64_t* out6) {
  guarded_void([&] {
  const auto& w = static_cast<PipelineHandle*>(handle)->pipeline->window(i);
  out6[0] = w.sequences.size();
  out6[1] = w.sequences.front().second;
  out6[2] = w.rank;
  out6[3] = w.type == rt::WindowType::kTGS ? 1 : 0;
  uint64_t total = 0;
  for (size_t k = 1; k < w.sequences.size(); ++k) {
    total += w.sequences[k].second;
  }
  out6[4] = total;
  out6[5] = w.id;
  });
}

// Export a window's backbone and layers, layers sorted by begin
// position (the order the consensus phase consumes them in).
// weights are (PHRED - 33) when quality exists, 1 otherwise; backbone always
// has a quality view (dummy '!' when the target had none).
void rt_pipeline_window_export(void* handle, uint64_t i, uint8_t* bb_bases,
                               uint8_t* bb_weights, uint32_t* lens,
                               uint32_t* begins, uint32_t* ends,
                               uint8_t* bases_concat, uint8_t* weights_concat) {
  guarded_void([&] {
  const auto& w = static_cast<PipelineHandle*>(handle)->pipeline->window(i);
  const uint32_t bl = w.sequences.front().second;
  std::memcpy(bb_bases, w.sequences.front().first, bl);
  for (uint32_t k = 0; k < bl; ++k) {
    bb_weights[k] =
        static_cast<uint8_t>(w.qualities.front().first[k]) - uint8_t('!');
  }

  std::vector<uint32_t> order;
  for (uint32_t k = 1; k < w.sequences.size(); ++k) {
    order.push_back(k);
  }
  // Unstable sort, same comparator and element count as the host path's
  // layer ordering (rt_window.cpp) — introsort is deterministic for a
  // given input, so the device path sees layers in the identical order.
  std::sort(order.begin(), order.end(), [&](uint32_t a, uint32_t b) {
    return w.positions[a].first < w.positions[b].first;
  });

  uint64_t off = 0;
  for (size_t oi = 0; oi < order.size(); ++oi) {
    const uint32_t k = order[oi];
    const uint32_t len = w.sequences[k].second;
    lens[oi] = len;
    begins[oi] = w.positions[k].first;
    ends[oi] = w.positions[k].second;
    std::memcpy(bases_concat + off, w.sequences[k].first, len);
    if (w.qualities[k].first != nullptr) {
      for (uint32_t p = 0; p < len; ++p) {
        weights_concat[off + p] =
            static_cast<uint8_t>(w.qualities[k].first[p]) - uint8_t('!');
      }
    } else {
      std::memset(weights_concat + off, 1, len);
    }
    off += len;
  }
  });
}

int rt_pipeline_consensus_cpu_one(void* handle, uint64_t i) {
  return guarded(
      [&]() -> int {
        return static_cast<PipelineHandle*>(handle)
                       ->pipeline->consensus_cpu_one(i)
                   ? 1
                   : 0;
      },
      -1);
}

void rt_pipeline_consensus_cpu_all(void* handle) {
  guarded_void([&] {
    static_cast<PipelineHandle*>(handle)->pipeline->consensus_cpu_all();
  });
}

void rt_pipeline_set_consensus(void* handle, uint64_t i, const char* consensus,
                               uint32_t len, int polished) {
  guarded_void([&] {
    static_cast<PipelineHandle*>(handle)->pipeline->set_consensus(
        i, std::string(consensus, len), polished != 0);
  });
}

uint64_t rt_pipeline_stitch(void* handle, int drop_unpolished) {
  return guarded(
      [&]() -> uint64_t {
        auto* h = static_cast<PipelineHandle*>(handle);
        if (!h->stitched) {  // idempotent: repeats return cached results
          h->pipeline->stitch(drop_unpolished != 0, &h->results);
          h->stitched = true;
        }
        return h->results.size();
      },
      static_cast<uint64_t>(-1));
}

const char* rt_pipeline_result_name(void* handle, uint64_t i, uint64_t* len) {
  auto* h = static_cast<PipelineHandle*>(handle);
  *len = h->results[i].first.size();
  return h->results[i].first.c_str();
}

const char* rt_pipeline_result_data(void* handle, uint64_t i, uint64_t* len) {
  auto* h = static_cast<PipelineHandle*>(handle);
  *len = h->results[i].second.size();
  return h->results[i].second.c_str();
}

// Per-window consensus as currently stored (set by consensus_cpu_one or
// set_consensus); differential tests read the host result through this.
const char* rt_pipeline_get_consensus(void* handle, uint64_t i,
                                      uint64_t* len) {
  const auto& w = static_cast<PipelineHandle*>(handle)->pipeline->window(i);
  *len = w.consensus.size();
  return w.consensus.c_str();
}

int rt_pipeline_window_type(void* handle) {
  return static_cast<PipelineHandle*>(handle)->pipeline->window_type() ==
                 rt::WindowType::kTGS
             ? 1
             : 0;
}

}  // extern "C"
