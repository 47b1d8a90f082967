#include "rt_error.hpp"
#include "rt_parsers.hpp"

#include <zlib.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace rt {

GzReader::GzReader(const std::string& path) : path_(path), buf_(1 << 20) {
  file_ = gzopen(path.c_str(), "rb");
  if (file_ == nullptr) {
    rt::fail("[racon_tpu::GzReader] error: unable to open file %s!\n",
                 path.c_str());
  }
  gzbuffer(static_cast<gzFile>(file_), 1 << 20);
}

GzReader::~GzReader() {
  if (file_ != nullptr) {
    gzclose(static_cast<gzFile>(file_));
  }
}

void GzReader::reset() {
  gzrewind(static_cast<gzFile>(file_));
  pos_ = len_ = 0;
  eof_ = false;
}

void GzReader::fill() {
  if (eof_) {
    return;
  }
  const int n =
      gzread(static_cast<gzFile>(file_), buf_.data(), static_cast<unsigned>(buf_.size()));
  if (n < 0) {
    rt::fail("[racon_tpu::GzReader] error: failed reading %s!\n",
                 path_.c_str());
  }
  pos_ = 0;
  len_ = static_cast<size_t>(n);
  if (n == 0) {
    eof_ = true;
  }
}

bool GzReader::getline(std::string& line) {
  line.clear();
  while (true) {
    if (pos_ >= len_) {
      fill();
      if (pos_ >= len_) {
        break;
      }
    }
    const char* start = buf_.data() + pos_;
    const char* nl =
        static_cast<const char*>(std::memchr(start, '\n', len_ - pos_));
    if (nl != nullptr) {
      line.append(start, nl - start);
      pos_ += (nl - start) + 1;
      if (!line.empty() && line.back() == '\r') {
        line.pop_back();
      }
      return true;
    }
    line.append(start, len_ - pos_);
    pos_ = len_;
  }
  if (!line.empty()) {
    if (line.back() == '\r') {
      line.pop_back();
    }
    return true;
  }
  return false;
}

static bool has_suffix(const std::string& src, const std::string& suffix) {
  return src.size() >= suffix.size() &&
         src.compare(src.size() - suffix.size(), suffix.size(), suffix) == 0;
}

bool sniff_sequence_format(const std::string& path, SeqFormat* fmt) {
  static const char* fasta_ext[] = {".fasta", ".fasta.gz", ".fna", ".fna.gz",
                                    ".fa", ".fa.gz"};
  static const char* fastq_ext[] = {".fastq", ".fastq.gz", ".fq", ".fq.gz"};
  for (const char* e : fasta_ext) {
    if (has_suffix(path, e)) {
      *fmt = SeqFormat::kFasta;
      return true;
    }
  }
  for (const char* e : fastq_ext) {
    if (has_suffix(path, e)) {
      *fmt = SeqFormat::kFastq;
      return true;
    }
  }
  return false;
}

bool sniff_overlap_format(const std::string& path, OvlFormat* fmt) {
  if (has_suffix(path, ".mhap") || has_suffix(path, ".mhap.gz")) {
    *fmt = OvlFormat::kMhap;
    return true;
  }
  if (has_suffix(path, ".paf") || has_suffix(path, ".paf.gz")) {
    *fmt = OvlFormat::kPaf;
    return true;
  }
  if (has_suffix(path, ".sam") || has_suffix(path, ".sam.gz")) {
    *fmt = OvlFormat::kSam;
    return true;
  }
  return false;
}

SequenceParser::SequenceParser(const std::string& path, SeqFormat fmt)
    : reader_(path), fmt_(fmt) {}

void SequenceParser::reset() {
  reader_.reset();
  pending_header_.clear();
}

bool SequenceParser::parse_one(std::vector<std::unique_ptr<Sequence>>& dst,
                               uint64_t* bytes) {
  std::string line;
  if (fmt_ == SeqFormat::kFasta) {
    std::string header;
    if (!pending_header_.empty()) {
      header.swap(pending_header_);
    } else {
      while (reader_.getline(line)) {
        if (!line.empty() && line[0] == '>') {
          header = line;
          break;
        }
      }
      if (header.empty()) {
        return false;
      }
    }
    std::string data;
    while (reader_.getline(line)) {
      if (!line.empty() && line[0] == '>') {
        pending_header_ = line;
        break;
      }
      data += line;
    }
    if (data.empty() && pending_header_.empty() && header.empty()) {
      return false;
    }
    // Name = first whitespace-delimited token after '>'.
    size_t name_end = header.find_first_of(" \t", 1);
    if (name_end == std::string::npos) {
      name_end = header.size();
    }
    dst.emplace_back(new Sequence(header.data() + 1,
                                  static_cast<uint32_t>(name_end - 1),
                                  data.data(), static_cast<uint32_t>(data.size())));
    *bytes += data.size();
    return true;
  }

  // FASTQ: strict 4-line records (multi-line FASTQ is handled by counting
  // sequence length against the '+' separator).
  std::string header;
  while (reader_.getline(line)) {
    if (!line.empty() && line[0] == '@') {
      header = line;
      break;
    }
  }
  if (header.empty()) {
    return false;
  }
  std::string data, qual;
  while (reader_.getline(line)) {
    if (!line.empty() && line[0] == '+') {
      break;
    }
    data += line;
  }
  while (qual.size() < data.size() && reader_.getline(line)) {
    qual += line;
  }
  if (qual.size() != data.size()) {
    rt::fail("[racon_tpu::SequenceParser] error: malformed FASTQ record "
                 "(quality length mismatch)!\n");
  }
  size_t name_end = header.find_first_of(" \t", 1);
  if (name_end == std::string::npos) {
    name_end = header.size();
  }
  dst.emplace_back(new Sequence(
      header.data() + 1, static_cast<uint32_t>(name_end - 1), data.data(),
      static_cast<uint32_t>(data.size()), qual.data(),
      static_cast<uint32_t>(qual.size())));
  *bytes += data.size() + qual.size();
  return true;
}

std::vector<std::unique_ptr<Sequence>> SequenceParser::parse(
    uint64_t max_bytes) {
  std::vector<std::unique_ptr<Sequence>> dst;
  uint64_t bytes = 0;
  while (parse_one(dst, &bytes)) {
    if (max_bytes != 0 && bytes >= max_bytes) {
      break;
    }
  }
  return dst;
}

OverlapParser::OverlapParser(const std::string& path, OvlFormat fmt)
    : reader_(path), fmt_(fmt) {}

void OverlapParser::reset() { reader_.reset(); }

static std::vector<std::string> split_tabs(const std::string& line) {
  std::vector<std::string> out;
  size_t start = 0;
  while (start <= line.size()) {
    size_t end = line.find('\t', start);
    if (end == std::string::npos) {
      out.emplace_back(line.substr(start));
      break;
    }
    out.emplace_back(line.substr(start, end - start));
    start = end + 1;
  }
  return out;
}

static std::vector<std::string> split_spaces(const std::string& line) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < line.size()) {
    while (i < line.size() && (line[i] == ' ' || line[i] == '\t')) {
      ++i;
    }
    size_t start = i;
    while (i < line.size() && line[i] != ' ' && line[i] != '\t') {
      ++i;
    }
    if (i > start) {
      out.emplace_back(line.substr(start, i - start));
    }
  }
  return out;
}

std::vector<std::unique_ptr<Overlap>> OverlapParser::parse(uint64_t max_bytes) {
  std::vector<std::unique_ptr<Overlap>> dst;
  uint64_t bytes = 0;
  std::string line;
  while ((max_bytes == 0 || bytes < max_bytes) && reader_.getline(line)) {
    bytes += line.size();
    if (line.empty()) {
      continue;
    }
    if (fmt_ == OvlFormat::kMhap) {
      // MHAP: A-id B-id jaccard shared-minmers A-rc A-begin A-end A-len
      //       B-rc B-begin B-end B-len (space or tab separated)
      auto f = split_spaces(line);
      if (f.size() < 12) {
        rt::fail("[racon_tpu::OverlapParser] error: malformed MHAP line!\n");
      }
      dst.push_back(Overlap::from_mhap(
          std::strtoull(f[0].c_str(), nullptr, 10),
          std::strtoull(f[1].c_str(), nullptr, 10), std::atof(f[2].c_str()),
          static_cast<uint32_t>(std::strtoul(f[3].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[4].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[5].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[6].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[7].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[8].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[9].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[10].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[11].c_str(), nullptr, 10))));
    } else if (fmt_ == OvlFormat::kPaf) {
      auto f = split_tabs(line);
      if (f.size() < 9) {
        rt::fail("[racon_tpu::OverlapParser] error: malformed PAF line!\n");
      }
      dst.push_back(Overlap::from_paf(
          f[0], static_cast<uint32_t>(std::strtoul(f[1].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[2].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[3].c_str(), nullptr, 10)),
          f[4][0], f[5],
          static_cast<uint32_t>(std::strtoul(f[6].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[7].c_str(), nullptr, 10)),
          static_cast<uint32_t>(std::strtoul(f[8].c_str(), nullptr, 10))));
    } else {
      if (line[0] == '@') {
        continue;  // header
      }
      auto f = split_tabs(line);
      if (f.size() < 11) {
        rt::fail("[racon_tpu::OverlapParser] error: malformed SAM line!\n");
      }
      dst.push_back(Overlap::from_sam(
          f[0], static_cast<uint32_t>(std::strtoul(f[1].c_str(), nullptr, 10)),
          f[2], static_cast<uint32_t>(std::strtoul(f[3].c_str(), nullptr, 10)),
          f[5]));
    }
  }
  return dst;
}

}  // namespace rt
