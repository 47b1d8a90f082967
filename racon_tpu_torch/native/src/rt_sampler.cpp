#include "rt_sampler.hpp"

#include <algorithm>
#include <cstdio>
#include <numeric>
#include <random>

#include "rt_error.hpp"
#include "rt_parsers.hpp"

namespace rt {

namespace {

struct Fmt {
  SeqFormat fmt;
  const char* ext;
};

Fmt sniff(const std::string& path) {
  SeqFormat fmt;
  if (!sniff_sequence_format(path, &fmt)) {
    fail("[racon_tpu::sampler] error: unsupported extension in %s\n",
         path.c_str());
  }
  return {fmt, fmt == SeqFormat::kFasta ? ".fasta" : ".fastq"};
}

std::string base_name(const std::string& path) {
  const size_t slash = path.find_last_of('/');
  std::string base =
      slash == std::string::npos ? path : path.substr(slash + 1);
  const size_t dot = base.find('.');
  return dot == std::string::npos ? base : base.substr(0, dot);
}

void write_record(std::FILE* f, const Sequence& s, SeqFormat fmt) {
  if (fmt == SeqFormat::kFasta) {
    std::fprintf(f, ">%s\n%s\n", s.name.c_str(), s.data.c_str());
  } else {
    // Reads whose quality was dropped as uninformative still need a
    // placeholder line of the right length.
    const std::string qual =
        s.quality.empty() ? std::string(s.data.size(), '!') : s.quality;
    std::fprintf(f, "@%s\n%s\n+\n%s\n", s.name.c_str(), s.data.c_str(),
                 qual.c_str());
  }
}

std::FILE* open_or_fail(const std::string& path) {
  std::FILE* f = std::fopen(path.c_str(), "w");
  if (f == nullptr) {
    fail("[racon_tpu::sampler] error: unable to create %s\n", path.c_str());
  }
  return f;
}

}  // namespace

std::string sampler_subsample(const std::string& path, uint64_t ref_length,
                              uint32_t coverage, const std::string& outdir,
                              uint64_t seed) {
  const Fmt fmt = sniff(path);
  SequenceParser parser(path, fmt.fmt);
  auto records = parser.parse(0);

  const uint64_t target = ref_length * coverage;
  uint64_t total = 0;
  for (const auto& r : records) {
    total += r->data.size();
  }

  const std::string out_path =
      outdir + "/" + base_name(path) + "_" + std::to_string(coverage) + "x" +
      fmt.ext;
  const std::string tmp_path = out_path + ".tmp";
  std::FILE* f = open_or_fail(tmp_path);

  if (total <= target) {
    for (const auto& r : records) {
      write_record(f, *r, fmt.fmt);
    }
  } else {
    std::vector<size_t> order(records.size());
    std::iota(order.begin(), order.end(), 0);
    std::mt19937_64 rng(seed);
    std::shuffle(order.begin(), order.end(), rng);
    uint64_t picked = 0;
    std::vector<size_t> chosen;
    for (size_t i : order) {
      if (picked >= target) {
        break;
      }
      chosen.push_back(i);
      picked += records[i]->data.size();
    }
    std::sort(chosen.begin(), chosen.end());
    for (size_t i : chosen) {
      write_record(f, *records[i], fmt.fmt);
    }
  }
  std::fclose(f);
  if (std::rename(tmp_path.c_str(), out_path.c_str()) != 0) {
    fail("[racon_tpu::sampler] error: unable to finalize %s\n",
         out_path.c_str());
  }
  return out_path;
}

std::vector<std::string> sampler_split(const std::string& path,
                                       uint64_t chunk_size,
                                       const std::string& outdir) {
  const Fmt fmt = sniff(path);
  SequenceParser parser(path, fmt.fmt);

  std::vector<std::string> outputs;
  std::FILE* f = nullptr;
  uint64_t written = 0;
  uint32_t idx = 0;

  while (true) {
    auto batch = parser.parse(1ull << 26);
    if (batch.empty()) {
      break;
    }
    for (const auto& r : batch) {
      if (f == nullptr || (written >= chunk_size && written > 0)) {
        if (f != nullptr) {
          std::fclose(f);
        }
        const std::string out_path = outdir + "/" + base_name(path) + "_" +
                                     std::to_string(idx) + fmt.ext;
        outputs.push_back(out_path);
        f = open_or_fail(out_path);
        written = 0;
        ++idx;
      }
      write_record(f, *r, fmt.fmt);
      written += r->data.size();
    }
  }
  if (f != nullptr) {
    std::fclose(f);
  }
  return outputs;
}

}  // namespace rt
