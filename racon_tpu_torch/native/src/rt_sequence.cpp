#include "rt_sequence.hpp"

#include <cctype>

namespace rt {

Sequence::Sequence(const char* name_ptr, uint32_t name_len,
                   const char* data_ptr, uint32_t data_len)
    : name(name_ptr, name_len) {
  data.resize(data_len);
  for (uint32_t i = 0; i < data_len; ++i) {
    data[i] = static_cast<char>(std::toupper(static_cast<unsigned char>(data_ptr[i])));
  }
}

Sequence::Sequence(const char* name_ptr, uint32_t name_len,
                   const char* data_ptr, uint32_t data_len,
                   const char* qual_ptr, uint32_t qual_len)
    : Sequence(name_ptr, name_len, data_ptr, data_len) {
  // An all-'!' quality string carries zero information; treat it as absent
  // (parity: src/sequence.cpp:34-42).
  uint64_t quality_sum = 0;
  for (uint32_t i = 0; i < qual_len; ++i) {
    quality_sum += static_cast<uint8_t>(qual_ptr[i]) - static_cast<uint8_t>('!');
  }
  if (quality_sum > 0) {
    quality.assign(qual_ptr, qual_len);
  }
}

void Sequence::create_reverse_complement() {
  if (!reverse_complement.empty()) {
    return;
  }
  reverse_complement.reserve(data.size());
  for (auto it = data.rbegin(); it != data.rend(); ++it) {
    char c;
    switch (*it) {
      case 'A': c = 'T'; break;
      case 'T': c = 'A'; break;
      case 'C': c = 'G'; break;
      case 'G': c = 'C'; break;
      default: c = *it; break;
    }
    reverse_complement += c;
  }
  reverse_quality.assign(quality.rbegin(), quality.rend());
}

void Sequence::transmute(bool keep_name, bool keep_data,
                         bool need_reverse_data) {
  if (!keep_name) {
    std::string().swap(name);
  }
  if (need_reverse_data) {
    create_reverse_complement();
  }
  if (!keep_data) {
    std::string().swap(data);
    std::string().swap(quality);
  }
}

std::unique_ptr<Sequence> createSequence(const std::string& name,
                                         const std::string& data) {
  return std::unique_ptr<Sequence>(new Sequence(name, data));
}

}  // namespace rt
