#include "rt_error.hpp"
#include "rt_overlap.hpp"

#include <algorithm>
#include <cstdio>
#include <cstdlib>

#include "rt_align.hpp"

namespace rt {

static void span_metrics(uint32_t q_span, uint32_t t_span, uint32_t* length,
                         double* error) {
  *length = std::max(q_span, t_span);
  *error = 1.0 - std::min(q_span, t_span) / static_cast<double>(*length);
}

std::unique_ptr<Overlap> Overlap::from_mhap(uint64_t a_id, uint64_t b_id,
                                            double, uint32_t, uint32_t a_rc,
                                            uint32_t a_begin, uint32_t a_end,
                                            uint32_t a_length, uint32_t b_rc,
                                            uint32_t b_begin, uint32_t b_end,
                                            uint32_t b_length) {
  auto o = std::unique_ptr<Overlap>(new Overlap());
  o->is_transmuted = false;
  o->q_id = a_id - 1;  // MHAP ordinals are 1-based (parity: src/overlap.cpp:18)
  o->q_begin = a_begin;
  o->q_end = a_end;
  o->q_length = a_length;
  o->t_id = b_id - 1;
  o->t_begin = b_begin;
  o->t_end = b_end;
  o->t_length = b_length;
  o->strand = (a_rc ^ b_rc) != 0;
  span_metrics(a_end - a_begin, b_end - b_begin, &o->length, &o->error);
  return o;
}

std::unique_ptr<Overlap> Overlap::from_paf(std::string q_name,
                                           uint32_t q_length, uint32_t q_begin,
                                           uint32_t q_end, char orientation,
                                           std::string t_name,
                                           uint32_t t_length, uint32_t t_begin,
                                           uint32_t t_end) {
  auto o = std::unique_ptr<Overlap>(new Overlap());
  o->is_transmuted = false;
  o->q_name = std::move(q_name);
  o->q_begin = q_begin;
  o->q_end = q_end;
  o->q_length = q_length;
  o->t_name = std::move(t_name);
  o->t_begin = t_begin;
  o->t_end = t_end;
  o->t_length = t_length;
  o->strand = orientation == '-';
  span_metrics(q_end - q_begin, t_end - t_begin, &o->length, &o->error);
  return o;
}

std::unique_ptr<Overlap> Overlap::from_sam(std::string q_name, uint32_t flag,
                                           std::string t_name,
                                           uint32_t pos_1based,
                                           std::string cigar) {
  auto o = std::unique_ptr<Overlap>(new Overlap());
  o->is_transmuted = false;
  o->q_name = std::move(q_name);
  o->t_name = std::move(t_name);
  o->t_begin = pos_1based - 1;
  o->strand = (flag & 0x10) != 0;
  o->is_valid = !(flag & 0x4);
  o->cigar = std::move(cigar);

  // Unmapped records are dropped later; mapped records must carry a real
  // alignment (parity: src/overlap.cpp:55-59).
  if (o->cigar.size() < 2 && o->is_valid) {
    rt::fail("[racon_tpu::Overlap::from_sam] error: "
                 "missing alignment from SAM object!\n");
  }

  // Leading clip gives the query start; M/=/X/I/D/N tally the aligned and
  // clipped lengths (parity: src/overlap.cpp:60-107).
  const std::string& c = o->cigar;
  for (uint32_t i = 0; i < c.size(); ++i) {
    if (c[i] == 'S' || c[i] == 'H') {
      o->q_begin = static_cast<uint32_t>(std::atoi(c.c_str()));
      break;
    }
    if (c[i] == 'M' || c[i] == '=' || c[i] == 'I' || c[i] == 'D' ||
        c[i] == 'N' || c[i] == 'P' || c[i] == 'X') {
      break;
    }
  }

  uint32_t q_aln = 0, q_clip = 0, t_aln = 0;
  for (uint32_t i = 0, j = 0; i < c.size(); ++i) {
    char op = c[i];
    if (op == 'M' || op == '=' || op == 'X') {
      uint32_t n = static_cast<uint32_t>(std::atoi(c.c_str() + j));
      j = i + 1;
      q_aln += n;
      t_aln += n;
    } else if (op == 'I') {
      q_aln += static_cast<uint32_t>(std::atoi(c.c_str() + j));
      j = i + 1;
    } else if (op == 'D' || op == 'N') {
      t_aln += static_cast<uint32_t>(std::atoi(c.c_str() + j));
      j = i + 1;
    } else if (op == 'S' || op == 'H') {
      q_clip += static_cast<uint32_t>(std::atoi(c.c_str() + j));
      j = i + 1;
    } else if (op == 'P') {
      j = i + 1;
    }
  }

  o->q_end = o->q_begin + q_aln;
  o->q_length = q_clip + q_aln;
  if (o->strand) {
    uint32_t tmp = o->q_begin;
    o->q_begin = o->q_length - o->q_end;
    o->q_end = o->q_length - tmp;
  }
  o->t_end = o->t_begin + t_aln;
  span_metrics(q_aln, t_aln, &o->length, &o->error);
  return o;
}

template <typename K>
static bool lookup_id(const std::unordered_map<K, uint64_t>& map, const K& key,
                      uint64_t* id) {
  auto it = map.find(key);
  if (it == map.end()) {
    return false;
  }
  *id = it->second;
  return true;
}

void Overlap::transmute(
    const std::vector<std::unique_ptr<Sequence>>& sequences,
    const std::unordered_map<std::string, uint64_t>& name_to_id,
    const std::unordered_map<uint64_t, uint64_t>& id_to_id) {
  if (!is_valid || is_transmuted) {
    return;
  }

  if (!q_name.empty()) {
    if (!lookup_id(name_to_id, q_name + "q", &q_id)) {
      is_valid = false;
      return;
    }
    std::string().swap(q_name);
  } else if (!lookup_id(id_to_id, q_id << 1 | 0, &q_id)) {
    is_valid = false;
    return;
  }

  if (q_length != sequences[q_id]->data.size()) {
    rt::fail("[racon_tpu::Overlap::transmute] error: unequal lengths in "
                 "sequence and overlap file for sequence %s!\n",
                 sequences[q_id]->name.c_str());
  }

  if (!t_name.empty()) {
    if (!lookup_id(name_to_id, t_name + "t", &t_id)) {
      is_valid = false;
      return;
    }
    std::string().swap(t_name);
  } else if (!lookup_id(id_to_id, t_id << 1 | 1, &t_id)) {
    is_valid = false;
    return;
  }

  if (t_length != 0 && t_length != sequences[t_id]->data.size()) {
    rt::fail("[racon_tpu::Overlap::transmute] error: unequal lengths in "
                 "target and overlap file for target %s!\n",
                 sequences[t_id]->name.c_str());
  }
  t_length = sequences[t_id]->data.size();  // SAM carries no target length

  is_transmuted = true;
}

void Overlap::alignment_views(
    const std::vector<std::unique_ptr<Sequence>>& sequences, const char** q,
    uint32_t* q_len, const char** t, uint32_t* t_len) const {
  // Reverse-strand queries align their reverse complement over the mirrored
  // coordinate range (parity: src/overlap.cpp:192-197).
  if (!strand) {
    *q = sequences[q_id]->data.data() + q_begin;
  } else {
    *q = sequences[q_id]->reverse_complement.data() + (q_length - q_end);
  }
  *q_len = q_end - q_begin;
  *t = sequences[t_id]->data.data() + t_begin;
  *t_len = t_end - t_begin;
}

void Overlap::find_breaking_points(
    const std::vector<std::unique_ptr<Sequence>>& sequences,
    uint32_t window_length) {
  if (!is_transmuted) {
    rt::fail("[racon_tpu::Overlap::find_breaking_points] error: overlap "
                 "is not transmuted!\n");
  }
  if (!breaking_points.empty()) {
    return;
  }

  if (cigar.empty()) {
    const char *q, *t;
    uint32_t q_len, t_len;
    alignment_views(sequences, &q, &q_len, &t, &t_len);
    cigar = align_global_cigar(q, q_len, t, t_len);
  }

  find_breaking_points_from_cigar(window_length);
  std::string().swap(cigar);
}

void Overlap::find_breaking_points_from_cigar(uint32_t window_length) {
  // Window end positions on the target (inclusive), then the overlap end.
  // Parity: src/overlap.cpp:229-235.
  std::vector<int32_t> window_ends;
  for (uint32_t i = 0; i < t_end; i += window_length) {
    if (i > t_begin) {
      window_ends.emplace_back(static_cast<int32_t>(i) - 1);
    }
  }
  window_ends.emplace_back(static_cast<int32_t>(t_end) - 1);

  uint32_t w = 0;
  bool found_first = false;
  std::pair<uint32_t, uint32_t> first_match{0, 0}, last_match{0, 0};

  int32_t q_ptr = static_cast<int32_t>(strand ? (q_length - q_end) : q_begin) - 1;
  int32_t t_ptr = static_cast<int32_t>(t_begin) - 1;

  auto flush_window = [&]() {
    if (found_first) {
      breaking_points.emplace_back(first_match);
      breaking_points.emplace_back(last_match);
    }
    found_first = false;
    ++w;
  };

  for (uint32_t i = 0, j = 0; i < cigar.size(); ++i) {
    char op = cigar[i];
    if (op == 'M' || op == '=' || op == 'X') {
      uint32_t n = static_cast<uint32_t>(std::atoi(cigar.c_str() + j));
      j = i + 1;
      for (uint32_t k = 0; k < n; ++k) {
        ++q_ptr;
        ++t_ptr;
        if (!found_first) {
          found_first = true;
          first_match = {static_cast<uint32_t>(t_ptr),
                         static_cast<uint32_t>(q_ptr)};
        }
        last_match = {static_cast<uint32_t>(t_ptr) + 1,
                      static_cast<uint32_t>(q_ptr) + 1};
        if (t_ptr == window_ends[w]) {
          flush_window();
        }
      }
    } else if (op == 'I') {
      q_ptr += std::atoi(cigar.c_str() + j);
      j = i + 1;
    } else if (op == 'D' || op == 'N') {
      uint32_t n = static_cast<uint32_t>(std::atoi(cigar.c_str() + j));
      j = i + 1;
      for (uint32_t k = 0; k < n; ++k) {
        ++t_ptr;
        if (t_ptr == window_ends[w]) {
          flush_window();
        }
      }
    } else if (op == 'S' || op == 'H' || op == 'P') {
      j = i + 1;
    }
  }
}

}  // namespace rt
