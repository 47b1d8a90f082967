// Native sequence subsampler/splitter — the rampler-equivalent tool
// (reference: vendored rampler, invoked by scripts/racon_wrapper.py:63-64,
// 88-89 as `rampler -o DIR subsample <seqs> <ref_len> <cov>` and
// `rampler -o DIR split <seqs> <bytes>`). Exposed as subcommands of the
// racon_tpu binary; output naming matches the wrapper contract
// (<basename>_<cov>x.<ext> / <basename>_<i>.<ext>).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace rt {

// Random whole-read subsample down to ref_length * coverage bases.
// Returns the output path. Atomic (tmp + rename).
std::string sampler_subsample(const std::string& path, uint64_t ref_length,
                              uint32_t coverage, const std::string& outdir,
                              uint64_t seed = 42);

// Split into chunks of ~chunk_size sequence bytes (record-granular).
// Returns the chunk paths.
std::vector<std::string> sampler_split(const std::string& path,
                                       uint64_t chunk_size,
                                       const std::string& outdir);

}  // namespace rt
