// Concurrency stress harness for the port's native runtime
// (racon_tpu_torch/native/src), meant to run under
// the sanitizer builds (`make tsan|asan|ubsan`). Where rt_test.cpp checks
// functional behaviour, this file hammers the concurrent seams:
//
//   1. submit storm        — many producer threads racing submit()
//   2. shutdown w/ backlog — destructor drains a loaded queue
//   3. mid-flight cancel   — cancel_pending() vs running workers; dropped
//                            futures must break, not hang; pool reusable
//   4. pool churn          — rapid create/submit/destroy cycles
//   5. CIGAR install race  — concurrent set_job_cigar on disjoint jobs,
//                            then pooled host alignment for the rest
//                            (the device/host alignment hand-off)
//   6. consensus hand-off  — device-style set_consensus installs racing
//                            host consensus_cpu_one on disjoint windows
//                            (the device/host consensus hand-off; one
//                            external consensus caller only — that thread
//                            owns the shared aligner slot n)
//
// In the port these are the seams its polisher drives from two threads:
// under --pipeline-phases the align-worker thread installs CIGARs
// (set_job_cigar, case 5) while the main thread runs consensus
// (set_consensus, case 6).
//
// Build + run:  make -C racon_tpu_torch/native stress   (or tsan/asan/ubsan)
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <future>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include "../src/rt_pipeline.hpp"
#include "../src/rt_threadpool.hpp"

// Atomic because CHECKs fire from racer threads too.
static std::atomic<int> g_failures{0};
static std::atomic<int> g_checks{0};

#define CHECK(cond)                                                        \
  do {                                                                     \
    ++g_checks;                                                            \
    if (!(cond)) {                                                         \
      ++g_failures;                                                        \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
    }                                                                      \
  } while (0)

#define CHECK_EQ(a, b)                                                     \
  do {                                                                     \
    ++g_checks;                                                            \
    auto va = (a);                                                         \
    auto vb = (b);                                                         \
    if (!(va == vb)) {                                                     \
      ++g_failures;                                                        \
      std::fprintf(stderr, "FAIL %s:%d: %s != %s\n", __FILE__, __LINE__,   \
                   #a, #b);                                                \
    }                                                                      \
  } while (0)

static std::string g_tmpdir;

static std::string write_file(const std::string& name,
                              const std::string& content) {
  const std::string path = g_tmpdir + "/" + name;
  std::ofstream(path) << content;
  return path;
}

// ---- 1. submit storm -------------------------------------------------------
// Many producers race submit() against 4 workers; every future resolves and
// every job runs exactly once. Producers also probe this_thread_index()
// concurrently — non-pool callers must all map to the shared slot n.
static void stress_submit_storm() {
  constexpr int kProducers = 8;
  constexpr int kJobsPerProducer = 200;
  rt::ThreadPool pool(4);
  std::atomic<int> ran{0};
  std::vector<std::thread> producers;
  producers.reserve(kProducers);
  for (int p = 0; p < kProducers; ++p) {
    producers.emplace_back([&pool, &ran] {
      CHECK_EQ(pool.this_thread_index(), pool.num_threads());
      std::vector<std::future<void>> futs;
      futs.reserve(kJobsPerProducer);
      for (int i = 0; i < kJobsPerProducer; ++i) {
        futs.emplace_back(pool.submit([&ran] {
          ran.fetch_add(1, std::memory_order_relaxed);
        }));
      }
      for (auto& f : futs) {
        f.get();
      }
    });
  }
  for (auto& t : producers) {
    t.join();
  }
  CHECK_EQ(ran.load(), kProducers * kJobsPerProducer);
}

// ---- 2. shutdown with a loaded queue --------------------------------------
// The destructor must let workers drain everything already queued; no job
// is lost and no worker pops from a destructed queue.
static void stress_shutdown_backlog() {
  std::atomic<int> ran{0};
  constexpr int kJobs = 1000;
  {
    rt::ThreadPool pool(4);
    for (int i = 0; i < kJobs; ++i) {
      pool.submit([&ran] { ran.fetch_add(1, std::memory_order_relaxed); });
    }
    // destructor runs here with most of the queue still pending
  }
  CHECK_EQ(ran.load(), kJobs);
}

// ---- 3. mid-flight cancellation -------------------------------------------
// cancel_pending() from another thread while workers chew slow jobs: every
// submitted job either ran or its future throws broken_promise, the two
// counts add up, and the pool keeps working afterwards.
static void stress_cancellation() {
  rt::ThreadPool pool(2);
  std::atomic<int> ran{0};
  constexpr int kJobs = 64;
  std::vector<std::future<void>> futs;
  futs.reserve(kJobs);
  for (int i = 0; i < kJobs; ++i) {
    futs.emplace_back(pool.submit([&ran] {
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
      ran.fetch_add(1, std::memory_order_relaxed);
    }));
  }
  std::size_t dropped = 0;
  std::thread canceller([&pool, &dropped] {
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
    dropped = pool.cancel_pending();
  });
  canceller.join();
  int broken = 0;
  for (auto& f : futs) {
    try {
      f.get();
    } catch (const std::future_error&) {
      ++broken;
    }
  }
  CHECK_EQ(static_cast<std::size_t>(broken), dropped);
  CHECK_EQ(ran.load() + broken, kJobs);
  // the pool survives a cancellation and still serves new work
  std::atomic<int> again{0};
  std::vector<std::future<void>> futs2;
  for (int i = 0; i < 8; ++i) {
    futs2.emplace_back(pool.submit([&again] {
      again.fetch_add(1, std::memory_order_relaxed);
    }));
  }
  for (auto& f : futs2) {
    f.get();
  }
  CHECK_EQ(again.load(), 8);
}

// ---- 4. pool churn ---------------------------------------------------------
// Rapid create/submit/destroy cycles: constructor/worker-startup and
// destructor/worker-drain handshakes under repetition.
static void stress_pool_churn() {
  std::atomic<int> ran{0};
  constexpr int kCycles = 20;
  constexpr int kJobs = 50;
  for (int c = 0; c < kCycles; ++c) {
    rt::ThreadPool pool(4);
    for (int i = 0; i < kJobs; ++i) {
      pool.submit([&ran] { ran.fetch_add(1, std::memory_order_relaxed); });
    }
  }
  CHECK_EQ(ran.load(), kCycles * kJobs);
}

// ---- pipeline fixtures -----------------------------------------------------

// Deterministic pseudo-random truth (same generator as rt_test.cpp, longer
// so the pipeline has enough windows/jobs to race over).
static std::string make_truth(int length) {
  std::string truth;
  uint64_t x = 0x9E3779B97F4A7C15ull;
  for (int i = 0; i < length; ++i) {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    truth += "ACGT"[x & 3];
  }
  return truth;
}

static std::string make_draft(const std::string& truth) {
  std::string draft = truth;
  for (size_t i = 50; i < draft.size(); i += 100) {
    draft[i] = draft[i] == 'A' ? 'C' : 'A';
  }
  return draft;
}

// ---- 5. concurrent CIGAR installs -----------------------------------------
// PAF input (no CIGARs) so every overlap is an alignment job; several
// installer threads stamp device-style CIGARs onto disjoint jobs while the
// pool host-aligns the rest, mirroring the device/host alignment hand-off.
static void stress_cigar_install() {
  const int kLen = 6000;
  const int kReads = 8;
  const std::string truth = make_truth(kLen);
  const std::string draft = make_draft(truth);

  std::string reads, paf;
  for (int i = 0; i < kReads; ++i) {
    const std::string rn = "r" + std::to_string(i);
    reads += ">" + rn + "\n" + truth + "\n";
    paf += rn + "\t" + std::to_string(kLen) + "\t0\t" + std::to_string(kLen) +
           "\t+\ttgt\t" + std::to_string(kLen) + "\t0\t" +
           std::to_string(kLen) + "\t" + std::to_string(kLen - 60) + "\t" +
           std::to_string(kLen) + "\t60\n";
  }
  const std::string reads_p = write_file("cig_reads.fasta", reads);
  const std::string paf_p = write_file("cig_ovl.paf", paf);
  const std::string tgt_p = write_file("cig_tgt.fasta", ">tgt\n" + draft + "\n");

  rt::PipelineParams params;
  params.window_length = 500;
  params.num_threads = 4;
  rt::Pipeline pipe(reads_p, paf_p, tgt_p, params);
  pipe.prepare();
  const size_t n_jobs = pipe.num_align_jobs();
  CHECK_EQ(n_jobs, static_cast<size_t>(kReads));

  // Device installers: two threads stamp perfect-match CIGARs onto
  // disjoint halves of the even jobs; odd jobs are left for the host.
  const std::string cigar = std::to_string(kLen) + "M";
  std::vector<std::thread> installers;
  for (int half = 0; half < 2; ++half) {
    installers.emplace_back([&pipe, &cigar, half, n_jobs] {
      for (size_t j = half * 2; j < n_jobs; j += 4) {
        const char *q, *t;
        uint32_t q_len, t_len;
        pipe.align_job_views(j, &q, &q_len, &t, &t_len);
        CHECK(q_len > 0 && t_len > 0);
        pipe.set_job_cigar(j, cigar);
      }
    });
  }
  for (auto& t : installers) {
    t.join();
  }
  pipe.align_jobs_cpu();  // host finishes the odd jobs on the pool
  pipe.build_windows();
  CHECK(pipe.num_windows() > 0);
  pipe.consensus_cpu_all();
  std::vector<std::pair<std::string, std::string>> out;
  pipe.stitch(true, &out);
  CHECK_EQ(out.size(), 1u);
  CHECK_EQ(out[0].second, truth);
}

// ---- 6. consensus hand-off -------------------------------------------------
// Device-style installs (set_consensus from installer threads) racing host
// consensus (consensus_cpu_one from one external thread) on disjoint
// windows — the overlap-free interleaving the drivers rely on. Exactly one
// external consensus caller: that thread owns the shared aligner slot n.
static void stress_consensus_handoff() {
  const int kLen = 6000;
  const std::string truth = make_truth(kLen);
  const std::string draft = make_draft(truth);

  std::string reads, sam = "@HD\tVN:1.6\n@SQ\tSN:tgt\tLN:" +
                           std::to_string(kLen) + "\n";
  for (int i = 0; i < 5; ++i) {
    const std::string rn = "r" + std::to_string(i);
    reads += ">" + rn + "\n" + truth + "\n";
    sam += rn + "\t0\ttgt\t1\t60\t" + std::to_string(kLen) + "M\t*\t0\t0\t" +
           truth + "\t*\n";
  }
  const std::string reads_p = write_file("con_reads.fasta", reads);
  const std::string sam_p = write_file("con_ovl.sam", sam);
  const std::string tgt_p = write_file("con_tgt.fasta", ">tgt\n" + draft + "\n");

  rt::PipelineParams params;
  params.window_length = 200;
  params.match = 5;
  params.mismatch = -4;
  params.gap = -8;
  params.num_threads = 4;
  rt::Pipeline pipe(reads_p, sam_p, tgt_p, params);
  pipe.initialize();
  const size_t n = pipe.num_windows();
  CHECK_EQ(n, static_cast<size_t>(kLen / 200));

  // Installer threads serve even windows with the device result (here: the
  // truth slice the POA would converge to); one external host thread
  // serves the odd windows.
  std::vector<std::thread> racers;
  for (int half = 0; half < 2; ++half) {
    racers.emplace_back([&pipe, &truth, half, n] {
      for (size_t i = half * 2; i < n; i += 4) {
        pipe.set_consensus(i, truth.substr(i * 200, 200), true);
      }
    });
  }
  racers.emplace_back([&pipe, n] {
    for (size_t i = 1; i < n; i += 2) {
      CHECK(pipe.consensus_cpu_one(i));
    }
  });
  for (auto& t : racers) {
    t.join();
  }
  for (size_t i = 0; i < n; ++i) {
    CHECK(pipe.has_consensus(i));
  }
  std::vector<std::pair<std::string, std::string>> out;
  pipe.stitch(true, &out);
  CHECK_EQ(out.size(), 1u);
  CHECK_EQ(out[0].second, truth);
}

int main() {
  g_tmpdir = "/tmp/rt_stress_" + std::to_string(::getpid());
  ::mkdir(g_tmpdir.c_str(), 0755);
  stress_submit_storm();
  stress_shutdown_backlog();
  stress_cancellation();
  stress_pool_churn();
  stress_cigar_install();
  stress_consensus_handoff();
  if (g_failures.load()) {
    std::fprintf(stderr, "%d/%d stress checks FAILED (artifacts in %s)\n",
                 g_failures.load(), g_checks.load(), g_tmpdir.c_str());
    return 1;
  }
  std::system(("rm -rf '" + g_tmpdir + "'").c_str());
  std::printf("all %d stress checks passed\n", g_checks.load());
  return 0;
}
