#include "rt_error.hpp"
#include "rt_window.hpp"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <limits>
#include <numeric>

namespace rt {

std::shared_ptr<Window> createWindow(uint64_t id, uint32_t rank,
                                     WindowType type, const char* backbone,
                                     uint32_t backbone_length,
                                     const char* quality,
                                     uint32_t quality_length) {
  if (backbone_length == 0 || backbone_length != quality_length) {
    rt::fail("[racon_tpu::createWindow] error: "
                 "empty backbone sequence/unequal quality length!\n");
  }
  return std::make_shared<Window>(id, rank, type, backbone, backbone_length,
                                  quality, quality_length);
}

Window::Window(uint64_t id_, uint32_t rank_, WindowType type_,
               const char* backbone, uint32_t backbone_length,
               const char* quality, uint32_t quality_length)
    : id(id_), rank(rank_), type(type_) {
  sequences.emplace_back(backbone, backbone_length);
  qualities.emplace_back(quality, quality_length);
  positions.emplace_back(0, 0);
}

void Window::add_layer(const char* sequence, uint32_t sequence_length,
                       const char* quality, uint32_t quality_length,
                       uint32_t begin, uint32_t end) {
  if (sequence_length == 0 || begin == end) {
    return;
  }
  if (quality != nullptr && sequence_length != quality_length) {
    rt::fail("[racon_tpu::Window::add_layer] error: "
                 "unequal quality size!\n");
  }
  if (begin >= end || begin > sequences.front().second ||
      end > sequences.front().second) {
    rt::fail("[racon_tpu::Window::add_layer] error: "
                 "layer begin and end positions are invalid!\n");
  }
  sequences.emplace_back(sequence, sequence_length);
  qualities.emplace_back(quality, quality_length);
  positions.emplace_back(begin, end);
}

static std::vector<uint32_t> layer_weights(const char* quality, uint32_t len) {
  std::vector<uint32_t> w(len, 1);
  if (quality != nullptr) {
    for (uint32_t i = 0; i < len; ++i) {
      w[i] = static_cast<uint32_t>(static_cast<uint8_t>(quality[i]) -
                                   static_cast<uint8_t>('!'));
    }
  }
  return w;
}

bool Window::generate_consensus(PoaAligner& aligner, bool trim) {
  if (sequences.size() < 3) {
    consensus.assign(sequences.front().first, sequences.front().second);
    return false;
  }

  PoaGraph graph;
  graph.add_alignment(PoaAlignment(), sequences.front().first,
                      sequences.front().second,
                      layer_weights(qualities.front().first,
                                    qualities.front().second));

  // Layers sorted by begin position with std::sort, NOT stable_sort: the
  // reference sorts unstably (src/window.cpp:85-86), and with the many
  // equal begin keys of window-spanning reads the introsort permutation
  // (deterministic for a given input) decides the graph-growth order.
  // Measured: unstable order improves every golden scenario vs stable.
  std::vector<uint32_t> order(sequences.size());
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin() + 1, order.end(),
            [&](uint32_t a, uint32_t b) {
              return positions[a].first < positions[b].first;
            });

  const uint32_t backbone_len = sequences.front().second;
  const uint32_t offset = static_cast<uint32_t>(0.01 * backbone_len);
  const double inf = std::numeric_limits<double>::infinity();

  for (uint32_t idx = 1; idx < sequences.size(); ++idx) {
    const uint32_t i = order[idx];
    PoaAlignment alignment;
    if (positions[i].first < offset &&
        positions[i].second > backbone_len - offset) {
      alignment =
          aligner.align(sequences[i].first, sequences[i].second, graph, -inf, inf);
    } else {
      alignment = aligner.align(sequences[i].first, sequences[i].second, graph,
                                static_cast<double>(positions[i].first),
                                static_cast<double>(positions[i].second));
    }
    graph.add_alignment(alignment, sequences[i].first, sequences[i].second,
                        layer_weights(qualities[i].first, sequences[i].second));
  }

  std::vector<uint32_t> coverages;
  consensus = graph.generate_consensus(&coverages);

  if (type == WindowType::kTGS && trim) {
    const uint32_t average_coverage =
        (static_cast<uint32_t>(sequences.size()) - 1) / 2;

    int32_t begin = 0, end = static_cast<int32_t>(consensus.size()) - 1;
    for (; begin < static_cast<int32_t>(consensus.size()); ++begin) {
      if (coverages[begin] >= average_coverage) {
        break;
      }
    }
    for (; end >= 0; --end) {
      if (coverages[end] >= average_coverage) {
        break;
      }
    }

    if (begin >= end) {
      std::fprintf(stderr,
                   "[racon_tpu::Window::generate_consensus] warning: "
                   "contig %llu might be chimeric in window %u!\n",
                   static_cast<unsigned long long>(id), rank);
    } else {
      consensus = consensus.substr(begin, end - begin + 1);
    }
  }

  return true;
}

}  // namespace rt
