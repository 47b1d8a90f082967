// Native unit tests for the port's host runtime (racon_tpu_torch/native/src,
// the C++ twin of the pytest layer — racon keeps its unit tests
// native in test/racon_test.cpp; the port's end-to-end tests,
// tests/test_torch_polish.py among them, exercise this same code through
// the C ABI).
//
// Plain CHECK macros instead of a vendored gtest: the framework must build
// with zero network access, and the assertions here are simple equality
// checks. Build + run:  make -C racon_tpu_torch/native test
#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <memory>
#include <set>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

#include "../src/rt_align.hpp"
#include "../src/rt_error.hpp"
#include "../src/rt_overlap.hpp"
#include "../src/rt_parsers.hpp"
#include "../src/rt_pipeline.hpp"
#include "../src/rt_poa.hpp"
#include "../src/rt_sampler.hpp"
#include "../src/rt_sequence.hpp"
#include "../src/rt_threadpool.hpp"
#include "../src/rt_window.hpp"

static int g_failures = 0;
static int g_checks = 0;

#define CHECK(cond)                                                       \
  do {                                                                    \
    ++g_checks;                                                           \
    if (!(cond)) {                                                        \
      ++g_failures;                                                       \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
    }                                                                     \
  } while (0)

#define CHECK_EQ(a, b)                                                    \
  do {                                                                    \
    ++g_checks;                                                           \
    auto va = (a);                                                        \
    auto vb = (b);                                                        \
    if (!(va == vb)) {                                                    \
      ++g_failures;                                                       \
      std::fprintf(stderr, "FAIL %s:%d: %s != %s\n", __FILE__, __LINE__,  \
                   #a, #b);                                               \
    }                                                                     \
  } while (0)

// ---- Sequence -------------------------------------------------------------

static void test_sequence() {
  // uppercasing (racon src/sequence.cpp:24-27)
  rt::Sequence s("r", 1, "acgtn", 5);
  CHECK_EQ(s.data, std::string("ACGTN"));

  // informative quality is kept
  rt::Sequence q("r", 1, "ACGT", 4, "!!5!", 4);
  CHECK_EQ(q.quality, std::string("!!5!"));

  // all-'!' quality carries no information and is dropped
  // (racon src/sequence.cpp:34-42)
  rt::Sequence z("r", 1, "ACGT", 4, "!!!!", 4);
  CHECK(z.quality.empty());

  // reverse complement + reversed quality, idempotent
  // (racon src/sequence.cpp:49-84)
  q.create_reverse_complement();
  CHECK_EQ(q.reverse_complement, std::string("ACGT"));
  rt::Sequence r("r", 1, "AACG", 4, "!05!", 4);
  r.create_reverse_complement();
  CHECK_EQ(r.reverse_complement, std::string("CGTT"));
  CHECK_EQ(r.reverse_quality, std::string("!50!"));
  r.create_reverse_complement();
  CHECK_EQ(r.reverse_complement, std::string("CGTT"));
}

// ---- alignment kernels -----------------------------------------------------

static void test_align() {
  // pinned small distances
  CHECK_EQ(rt::edit_distance("kitten", 6, "sitting", 7), 3);
  CHECK_EQ(rt::edit_distance("", 0, "abc", 3), 3);
  CHECK_EQ(rt::edit_distance("ACGT", 4, "ACGT", 4), 0);
  // symmetry
  CHECK_EQ(rt::edit_distance("ACGTACGT", 8, "AGTACGGT", 8),
           rt::edit_distance("AGTACGGT", 8, "ACGTACGT", 8));

  // the CIGAR's edit count must equal the exact distance, and its spans
  // must cover both sequences
  const std::string qs = "ACGTTTACGGTACGT";
  const std::string ts = "ACGTACGGTACGTTT";
  std::string cig = rt::align_global_cigar(qs.data(), qs.size(), ts.data(),
                                           ts.size());
  int64_t q_span = 0, t_span = 0, edits = 0;
  uint32_t run = 0;
  for (char c : cig) {
    if (c >= '0' && c <= '9') {
      run = run * 10 + (c - '0');
      continue;
    }
    if (c == 'M' || c == '=') {
      q_span += run;
      t_span += run;
    } else if (c == 'X') {
      q_span += run;
      t_span += run;
      edits += run;
    } else if (c == 'I') {
      q_span += run;
      edits += run;
    } else if (c == 'D') {
      t_span += run;
      edits += run;
    }
    run = 0;
  }
  CHECK_EQ(q_span, (int64_t)qs.size());
  CHECK_EQ(t_span, (int64_t)ts.size());
  CHECK_EQ(edits, rt::edit_distance(qs.data(), qs.size(), ts.data(),
                                    ts.size()));
}

// ---- Overlap ---------------------------------------------------------------

static void test_overlap() {
  // PAF ctor + span-ratio error metric (racon src/overlap.cpp:24-42)
  auto paf = rt::Overlap::from_paf("q", 100, 0, 80, '+', "t", 200, 10, 110);
  CHECK_EQ(paf->length, 100u);
  CHECK(paf->error > 0.19 && paf->error < 0.21);  // 1 - 80/100
  CHECK(!paf->strand);

  // MHAP ctor: 1-based ordinals, rc flags (racon src/overlap.cpp:15-27)
  auto mhap = rt::Overlap::from_mhap(1, 2, 0.1, 10, 0, 0, 80, 100, 1, 10,
                                     110, 200);
  CHECK(mhap->strand);

  // SAM ctor scans the CIGAR for spans (racon src/overlap.cpp:44-108)
  auto sam = rt::Overlap::from_sam("q", 0, "t", 11, "20M5I20M5D20M");
  CHECK_EQ(sam->q_begin, 0u);
  CHECK_EQ(sam->q_end, 65u);        // 20+5+20+20 query bases
  CHECK_EQ(sam->t_begin, 10u);      // pos is 1-based
  CHECK_EQ(sam->t_end, 10u + 65u);  // 20+20+5+20 target bases

  // transmute resolves names and validates lengths
  // (racon src/overlap.cpp:129-177)
  std::vector<std::unique_ptr<rt::Sequence>> seqs;
  seqs.push_back(rt::createSequence("q", std::string(100, 'A')));
  seqs.push_back(rt::createSequence("t", std::string(200, 'C')));
  // keys carry a q/t suffix, racon's disambiguation scheme for a
  // name that is both a read and a target (src/polisher.cpp:210-215)
  std::unordered_map<std::string, uint64_t> name_to_id{{"qq", 0}, {"tt", 1}};
  std::unordered_map<uint64_t, uint64_t> id_to_id;
  paf->transmute(seqs, name_to_id, id_to_id);
  CHECK(paf->is_transmuted);
  CHECK_EQ(paf->q_id, 0u);
  CHECK_EQ(paf->t_id, 1u);

  // breaking points from a pure-match CIGAR land on window boundaries
  // (racon src/overlap.cpp:226-292)
  auto bp = rt::Overlap::from_sam("q", 0, "t", 1, "100M");
  bp->transmute(seqs, name_to_id, id_to_id);
  bp->find_breaking_points(seqs, 50);
  CHECK_EQ(bp->breaking_points.size(), 4u);  // two windows x (first, last)
  CHECK_EQ(bp->breaking_points[0].first, 0u);
  CHECK_EQ(bp->breaking_points[1].first, 50u);
  CHECK_EQ(bp->breaking_points[2].first, 50u);
  CHECK_EQ(bp->breaking_points[3].first, 100u);
}

// ---- POA graph -------------------------------------------------------------

static void test_poa() {
  // three identical layers over a backbone with one error: the consensus
  // recovers the majority base, coverage counts the paths through the
  // chosen nodes
  const std::string backbone = "ACGTACGT";
  const std::string truth = "ACGAACGT";  // backbone has T where truth has A
  rt::PoaGraph g;
  std::vector<uint32_t> w1(backbone.size(), 1);
  g.add_alignment({}, backbone.data(), backbone.size(), w1);
  rt::PoaAligner aligner(5, -4, -8);
  const double inf = 1e300;
  for (int i = 0; i < 3; ++i) {
    auto aln = aligner.align(truth.data(), truth.size(), g, -inf, inf);
    std::vector<uint32_t> w(truth.size(), 1);
    g.add_alignment(aln, truth.data(), truth.size(), w);
  }
  std::vector<uint32_t> cov;
  std::string cons = g.generate_consensus(&cov);
  CHECK_EQ(cons, truth);
  CHECK_EQ(cov.size(), cons.size());
  CHECK_EQ(cov[3], 3u);  // the corrected base: 3 supporting layers
  CHECK_EQ(cov[0], 4u);  // agreeing base: backbone + 3 layers
}

// ---- temp-file helpers -----------------------------------------------------

static std::string g_tmpdir;

static std::string write_file(const std::string& name,
                              const std::string& content) {
  const std::string path = g_tmpdir + "/" + name;
  std::ofstream f(path, std::ios::binary);
  f << content;
  return path;
}

static std::string write_gz(const std::string& name,
                            const std::string& content) {
  const std::string path = g_tmpdir + "/" + name;
  gzFile f = gzopen(path.c_str(), "wb");
  gzwrite(f, content.data(), static_cast<unsigned>(content.size()));
  gzclose(f);
  return path;
}

// ---- parsers ---------------------------------------------------------------
// Format coverage parity with racon's vendored bioparser formats
// (racon factory: src/polisher.cpp:85-135).

static void test_parsers() {
  // extension sniffing: racon's accepted extension sets
  rt::SeqFormat sf;
  rt::OvlFormat of;
  CHECK(rt::sniff_sequence_format("x.fasta", &sf) && sf == rt::SeqFormat::kFasta);
  CHECK(rt::sniff_sequence_format("x.fq.gz", &sf) && sf == rt::SeqFormat::kFastq);
  CHECK(!rt::sniff_sequence_format("x.txt", &sf));
  CHECK(rt::sniff_overlap_format("x.paf.gz", &of) && of == rt::OvlFormat::kPaf);
  CHECK(rt::sniff_overlap_format("x.mhap", &of) && of == rt::OvlFormat::kMhap);
  CHECK(rt::sniff_overlap_format("x.sam", &of) && of == rt::OvlFormat::kSam);
  CHECK(!rt::sniff_overlap_format("x.bam", &of));

  // multi-line FASTA, name ends at first whitespace
  const std::string fasta = ">r1 comment here\nACGT\nACGT\n>r2\nTTTT\n";
  rt::SequenceParser fp(write_file("t.fasta", fasta), rt::SeqFormat::kFasta);
  auto seqs = fp.parse(0);
  CHECK_EQ(seqs.size(), 2u);
  CHECK_EQ(seqs[0]->name, std::string("r1"));
  CHECK_EQ(seqs[0]->data, std::string("ACGTACGT"));
  CHECK_EQ(seqs[1]->data, std::string("TTTT"));

  // chunked parse: max_bytes=1 pulls one record per call; reset rewinds
  fp.reset();
  auto first = fp.parse(1);
  CHECK_EQ(first.size(), 1u);
  auto second = fp.parse(1);
  CHECK_EQ(second.size(), 1u);
  CHECK_EQ(second[0]->name, std::string("r2"));
  CHECK_EQ(fp.parse(1).size(), 0u);

  // FASTQ with informative quality
  const std::string fastq = "@q1\nACGT\n+\n!5!5\n";
  rt::SequenceParser qp(write_file("t.fastq", fastq), rt::SeqFormat::kFastq);
  auto qseqs = qp.parse(0);
  CHECK_EQ(qseqs.size(), 1u);
  CHECK_EQ(qseqs[0]->quality, std::string("!5!5"));

  // transparent gzip through the same parser (racon bioparser + zlib)
  rt::SequenceParser gz(write_gz("t2.fasta.gz", fasta), rt::SeqFormat::kFasta);
  CHECK_EQ(gz.parse(0).size(), 2u);

  // PAF / SAM (headers skipped) / MHAP overlap records
  rt::OverlapParser pp(
      write_file("t.paf", "q\t100\t0\t80\t+\tt\t200\t10\t110\t70\t100\t60\n"),
      rt::OvlFormat::kPaf);
  auto povl = pp.parse(0);
  CHECK_EQ(povl.size(), 1u);
  CHECK_EQ(povl[0]->t_begin, 10u);

  rt::OverlapParser sp(
      write_file("t.sam",
                 "@HD\tVN:1.6\n@SQ\tSN:t\tLN:200\n"
                 "q\t0\tt\t11\t60\t20M5I20M5D20M\t*\t0\t0\t*\t*\n"),
      rt::OvlFormat::kSam);
  auto sovl = sp.parse(0);
  CHECK_EQ(sovl.size(), 1u);
  CHECK_EQ(sovl[0]->q_end, 65u);

  rt::OverlapParser mp(
      write_file("t.mhap", "1 2 0.1 10 0 0 80 100 1 10 110 200\n"),
      rt::OvlFormat::kMhap);
  auto movl = mp.parse(0);
  CHECK_EQ(movl.size(), 1u);
  CHECK(movl[0]->strand);

  // library error channel, not exit(): missing file and malformed records
  // throw rt::Error (the CLI catches at main, rt_main.cpp)
  bool threw = false;
  try {
    rt::GzReader bad(g_tmpdir + "/does_not_exist.fasta");
  } catch (const rt::Error& e) {
    threw = std::string(e.what()).find("unable to open") != std::string::npos;
  }
  CHECK(threw);

  threw = false;
  try {
    rt::SequenceParser mq(write_file("bad.fastq", "@q\nACGT\n+\n!!\n"),
                          rt::SeqFormat::kFastq);
    mq.parse(0);
  } catch (const rt::Error&) {
    threw = true;
  }
  CHECK(threw);
}

// ---- window semantics ------------------------------------------------------
// Reference: src/window.cpp — backbone passthrough (:68-71), layer position
// validation, TGS low-coverage end trim + chimera guard (:125-146).

static void test_window() {
  const std::string bb = "ACGTACGTACGTACGTACGT";  // 20 bp
  const std::string qual(bb.size(), '5');

  // <3 sequences: backbone passthrough, POA did not run
  auto w = rt::createWindow(7, 0, rt::WindowType::kTGS, bb.data(),
                            bb.size(), qual.data(), qual.size());
  rt::PoaAligner aligner(5, -4, -8);
  CHECK(!w->generate_consensus(aligner, true));
  CHECK_EQ(w->consensus, bb);

  // invalid layer positions throw through the library error channel
  bool threw = false;
  try {
    w->add_layer(bb.data(), 4, nullptr, 0, 10, 30);  // end > backbone
  } catch (const rt::Error&) {
    threw = true;
  }
  CHECK(threw);

  // zero-length / empty-span layers are silently ignored
  w->add_layer(bb.data(), 0, nullptr, 0, 0, 10);
  w->add_layer(bb.data(), 4, nullptr, 0, 5, 5);
  CHECK_EQ(w->sequences.size(), 1u);

  // TGS trim: 4 perfect layers covering only [5, 15) -> consensus trimmed
  // to the covered span (ends have backbone-only coverage 1 < avg 2)
  auto t = rt::createWindow(7, 1, rt::WindowType::kTGS, bb.data(),
                            bb.size(), qual.data(), qual.size());
  const std::string mid = bb.substr(5, 10);
  for (int i = 0; i < 4; ++i) {
    t->add_layer(mid.data(), mid.size(), nullptr, 0, 5, 14);
  }
  CHECK(t->generate_consensus(aligner, true));
  CHECK_EQ(t->consensus, mid);

  // same window untrimmed (NGS type or trim=false keeps full span)
  auto n = rt::createWindow(7, 2, rt::WindowType::kNGS, bb.data(),
                            bb.size(), qual.data(), qual.size());
  for (int i = 0; i < 4; ++i) {
    n->add_layer(mid.data(), mid.size(), nullptr, 0, 5, 14);
  }
  CHECK(n->generate_consensus(aligner, true));
  CHECK_EQ(n->consensus, bb);
}

// ---- thread pool -----------------------------------------------------------

static void test_threadpool() {
  rt::ThreadPool pool(4);
  CHECK_EQ(pool.num_threads(), 4u);
  // the calling (non-worker) thread gets the dedicated slot n
  CHECK_EQ(pool.this_thread_index(), 4u);

  std::atomic<uint32_t> sum{0};
  std::set<uint32_t> seen;
  std::mutex m;
  std::vector<std::future<void>> futs;
  for (int i = 0; i < 64; ++i) {
    futs.push_back(pool.submit([&] {
      sum.fetch_add(1);
      std::lock_guard<std::mutex> lock(m);
      seen.insert(pool.this_thread_index());
    }));
  }
  for (auto& f : futs) {
    f.get();
  }
  CHECK_EQ(sum.load(), 64u);
  // every observed worker index is a real worker slot (one aggregate
  // CHECK: how many distinct workers ran is scheduling-dependent, and a
  // per-element loop would make the total check count vary by build)
  uint32_t max_idx = 0;
  for (uint32_t idx : seen) {
    max_idx = idx > max_idx ? idx : max_idx;
  }
  CHECK(!seen.empty() && max_idx < 4u);
}

// ---- sampler (rampler parity) ----------------------------------------------

static void test_sampler() {
  std::string fasta;
  for (int i = 0; i < 4; ++i) {
    fasta += ">s" + std::to_string(i) + "\n" + std::string(100, 'A') + "\n";
  }
  const std::string path = write_file("sample.fasta", fasta);

  // split: record-granular ~200-byte chunks -> 2 files, all records kept
  auto chunks = rt::sampler_split(path, 200, g_tmpdir);
  CHECK_EQ(chunks.size(), 2u);
  size_t records = 0;
  for (const auto& c : chunks) {
    rt::SequenceParser p(c, rt::SeqFormat::kFasta);
    records += p.parse(0).size();
  }
  CHECK_EQ(records, 4u);

  // subsample to ref_length*coverage = 200 bases -> 2 whole reads
  const std::string sub = rt::sampler_subsample(path, 100, 2, g_tmpdir);
  rt::SequenceParser p(sub, rt::SeqFormat::kFasta);
  auto kept = p.parse(0);
  uint64_t bases = 0;
  for (const auto& s : kept) {
    bases += s->data.size();
  }
  CHECK_EQ(bases, 200u);
}

// ---- parser fuzz -----------------------------------------------------------
// Seeded random byte soup through every parser: malformed input must
// surface as rt::Error (or parse to something), never as a crash or
// sanitizer report — this block rides the ASan and TSan CI builds.

static void test_parser_fuzz() {
  uint64_t x = 0x2545F4914F6CDD1Dull;
  auto next = [&x]() {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    return x;
  };
  const char alphabet[] = ">@+ACGTacgt0123\t -\n\r!I~";
  for (int round = 0; round < 40; ++round) {
    std::string blob;
    const size_t len = next() % 2048;
    for (size_t i = 0; i < len; ++i) {
      // bias toward structural characters, sprinkle raw bytes
      blob += (next() % 8) ? alphabet[next() % (sizeof(alphabet) - 1)]
                           : static_cast<char>(next() & 0xFF);
    }
    const std::string p = write_file("fuzz.bin", blob);
    for (rt::SeqFormat f : {rt::SeqFormat::kFasta, rt::SeqFormat::kFastq}) {
      try {
        rt::SequenceParser sp(p, f);
        auto out = sp.parse(0);
        ++g_checks;  // parsed (possibly to zero records) without crashing
      } catch (const rt::Error&) {
        ++g_checks;  // clean library error is an acceptable outcome
      }
    }
    for (rt::OvlFormat f :
         {rt::OvlFormat::kMhap, rt::OvlFormat::kPaf, rt::OvlFormat::kSam}) {
      try {
        rt::OverlapParser op(p, f);
        auto out = op.parse(0);
        ++g_checks;
      } catch (const rt::Error&) {
        ++g_checks;
      }
    }
  }
}

// ---- pipeline end-to-end (pure native, no Python) --------------------------
// A miniature of the λ golden flow (racon test/racon_test.cpp): perfect
// reads over a known truth must polish the draft back to the truth.

static void test_pipeline() {
  // deterministic pseudo-random truth
  std::string truth;
  uint64_t x = 0x9E3779B97F4A7C15ull;
  for (int i = 0; i < 600; ++i) {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    truth += "ACGT"[x & 3];
  }
  // draft: truth with a substitution every 100 bases
  std::string draft = truth;
  for (size_t i = 50; i < draft.size(); i += 100) {
    draft[i] = draft[i] == 'A' ? 'C' : 'A';
  }

  std::string reads, sam = "@HD\tVN:1.6\n@SQ\tSN:tgt\tLN:600\n";
  for (int i = 0; i < 5; ++i) {
    reads += ">r" + std::to_string(i) + "\n" + truth + "\n";
    sam += "r" + std::to_string(i) + "\t0\ttgt\t1\t60\t600M\t*\t0\t0\t" +
           truth + "\t*\n";
  }
  const std::string reads_p = write_file("e2e_reads.fasta", reads);
  const std::string sam_p = write_file("e2e_ovl.sam", sam);
  const std::string tgt_p = write_file("e2e_tgt.fasta", ">tgt\n" + draft + "\n");

  rt::PipelineParams params;
  params.window_length = 200;
  params.match = 5;
  params.mismatch = -4;
  params.gap = -8;
  params.num_threads = 4;  // pooled paths under the sanitizer builds
  rt::Pipeline pipe(reads_p, sam_p, tgt_p, params);
  pipe.initialize();
  CHECK_EQ(pipe.num_windows(), 3u);
  pipe.consensus_cpu_all();
  std::vector<std::pair<std::string, std::string>> out;
  pipe.stitch(true, &out);
  CHECK_EQ(out.size(), 1u);
  CHECK_EQ(out[0].second, truth);
  // provenance tags (racon src/polisher.cpp:521-524)
  CHECK(out[0].first.find("LN:i:600") != std::string::npos);
  CHECK(out[0].first.find("RC:i:5") != std::string::npos);

  // bad extension: racon-compatible library error, not an exit
  bool threw = false;
  try {
    rt::Pipeline bad(g_tmpdir + "/x.txt", sam_p, tgt_p, params);
  } catch (const rt::Error&) {
    threw = true;
  }
  CHECK(threw);
}

int main() {
  g_tmpdir = "/tmp/rt_test_" + std::to_string(::getpid());
  ::mkdir(g_tmpdir.c_str(), 0755);
  test_sequence();
  test_align();
  test_overlap();
  test_poa();
  test_parsers();
  test_window();
  test_threadpool();
  test_sampler();
  test_parser_fuzz();
  test_pipeline();
  if (g_failures) {
    // keep g_tmpdir for post-mortem
    std::fprintf(stderr, "%d/%d checks FAILED (artifacts in %s)\n",
                 g_failures, g_checks, g_tmpdir.c_str());
    return 1;
  }
  std::system(("rm -rf '" + g_tmpdir + "'").c_str());
  std::printf("all %d checks passed\n", g_checks);
  return 0;
}
