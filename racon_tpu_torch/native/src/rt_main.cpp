// Native CLI binary of racon_tpu_torch for the pure-host path: racon's
// flags (racon src/main.cpp:18-38,166-229) and rampler's split and
// subsample. The card's path lives behind the Python driver (python -m
// racon_tpu_torch.cli), which shares this same native pipeline through the
// C ABI; `python -m racon_tpu_torch.cli --host` gives this binary's bytes.
#include <getopt.h>
#include <sys/stat.h>

#include <exception>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "rt_pipeline.hpp"
#include "rt_sampler.hpp"

#ifndef RT_VERSION
#define RT_VERSION "0.1.0"
#endif

namespace {

struct option long_options[] = {
    {"include-unpolished", no_argument, nullptr, 'u'},
    {"fragment-correction", no_argument, nullptr, 'f'},
    {"window-length", required_argument, nullptr, 'w'},
    {"quality-threshold", required_argument, nullptr, 'q'},
    {"error-threshold", required_argument, nullptr, 'e'},
    {"no-trimming", no_argument, nullptr, 'T'},
    {"match", required_argument, nullptr, 'm'},
    {"mismatch", required_argument, nullptr, 'x'},
    {"gap", required_argument, nullptr, 'g'},
    {"threads", required_argument, nullptr, 't'},
    {"version", no_argument, nullptr, 'v'},
    {"help", no_argument, nullptr, 'h'},
    {nullptr, 0, nullptr, 0}};

void help() {
  std::printf(
      "usage: racon_tpu_torch [options ...] <sequences> <overlaps> <target "
      "sequences>\n"
      "\n"
      "    #default output is stdout\n"
      "    <sequences>    FASTA/FASTQ (may be gzipped) reads\n"
      "    <overlaps>     MHAP/PAF/SAM (may be gzipped) overlaps\n"
      "    <target sequences> FASTA/FASTQ (may be gzipped) draft targets\n"
      "\n"
      "    options:\n"
      "        -u, --include-unpolished  output unpolished target sequences\n"
      "        -f, --fragment-correction fragment correction mode\n"
      "        -w, --window-length <int>     default: 500\n"
      "        -q, --quality-threshold <float> default: 10.0\n"
      "        -e, --error-threshold <float>   default: 0.3\n"
      "        --no-trimming             disable consensus end trimming\n"
      "        -m, --match <int>             default: 3\n"
      "        -x, --mismatch <int>          default: -5\n"
      "        -g, --gap <int>               default: -4\n"
      "        -t, --threads <int>           default: 1\n"
      "        --version                 print version\n"
      "        -h, --help                print usage\n"
      "\n"
      "    the card's path: python -m racon_tpu_torch.cli ...\n");
}

}  // namespace

namespace {

// rampler-compatible subcommands:
//   racon_tpu_torch [-o DIR] subsample <sequences> <ref_length> <coverage>
//   racon_tpu_torch [-o DIR] split <sequences> <chunk_size>
int sampler_main(int argc, char** argv) {
  std::string outdir = ".";
  int i = 1;
  if (std::string(argv[i]) == "-o" || std::string(argv[i]) == "--out-directory") {
    if (i + 1 >= argc) {
      std::fprintf(stderr, "[racon_tpu_torch::sampler] error: -o needs a value\n");
      return 1;
    }
    outdir = argv[i + 1];
    i += 2;
  }
  ::mkdir(outdir.c_str(), 0755);  // EEXIST is fine
  const std::string mode = argv[i];
  try {
    if (mode == "subsample") {
      if (i + 3 >= argc) {
        std::fprintf(stderr, "usage: racon_tpu_torch [-o DIR] subsample "
                             "<sequences> <ref_length> <coverage>\n");
        return 1;
      }
      rt::sampler_subsample(argv[i + 1], std::strtoull(argv[i + 2], nullptr, 10),
                            static_cast<uint32_t>(std::atoi(argv[i + 3])),
                            outdir);
    } else {
      if (i + 2 >= argc) {
        std::fprintf(stderr, "usage: racon_tpu_torch [-o DIR] split "
                             "<sequences> "
                             "<chunk_size>\n");
        return 1;
      }
      rt::sampler_split(argv[i + 1],
                        std::strtoull(argv[i + 2], nullptr, 10), outdir);
    }
  } catch (const std::exception& e) {
    std::fprintf(stderr, "%s", e.what());
    return 1;
  }
  return 0;
}

bool is_sampler_invocation(int argc, char** argv) {
  // Subcommand must be argv[1], or argv[3] after a leading -o DIR.
  const auto is_mode = [](const char* a) {
    const std::string s = a;
    return s == "subsample" || s == "split";
  };
  if (argc > 1 && is_mode(argv[1])) {
    return true;
  }
  if (argc > 3 && (std::string(argv[1]) == "-o" ||
                   std::string(argv[1]) == "--out-directory")) {
    return is_mode(argv[3]);
  }
  return false;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc > 1 && is_sampler_invocation(argc, argv)) {
    return sampler_main(argc, argv);
  }

  rt::PipelineParams params;
  bool drop_unpolished = true;

  int arg;
  while ((arg = getopt_long(argc, argv, "ufw:q:e:m:x:g:t:h", long_options,
                            nullptr)) != -1) {
    switch (arg) {
      case 'u': drop_unpolished = false; break;
      case 'f': params.type = 1; break;
      case 'w': params.window_length = std::atoi(optarg); break;
      case 'q': params.quality_threshold = std::atof(optarg); break;
      case 'e': params.error_threshold = std::atof(optarg); break;
      case 'T': params.trim = false; break;
      case 'm': params.match = static_cast<int8_t>(std::atoi(optarg)); break;
      case 'x': params.mismatch = static_cast<int8_t>(std::atoi(optarg)); break;
      case 'g': params.gap = static_cast<int8_t>(std::atoi(optarg)); break;
      case 't': params.num_threads = std::atoi(optarg); break;
      case 'v': std::printf("%s\n", RT_VERSION); return 0;
      case 'h': help(); return 0;
      default: return 1;
    }
  }

  std::vector<std::string> inputs;
  for (int i = optind; i < argc; ++i) {
    inputs.emplace_back(argv[i]);
  }
  if (inputs.size() < 3) {
    std::fprintf(stderr, "[racon_tpu_torch::] error: missing input "
                         "file(s)!\n");
    help();
    return 1;
  }

  try {
    rt::Pipeline pipeline(inputs[0], inputs[1], inputs[2], params);
    pipeline.initialize();
    pipeline.consensus_cpu_all();

    std::vector<std::pair<std::string, std::string>> dst;
    pipeline.stitch(drop_unpolished, &dst);
    for (const auto& it : dst) {
      std::fprintf(stdout, ">%s\n%s\n", it.first.c_str(), it.second.c_str());
    }
  } catch (const std::exception& e) {
    std::fprintf(stderr, "%s", e.what());
    return 1;
  }
  return 0;
}
