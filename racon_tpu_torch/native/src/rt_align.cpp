#include "rt_error.hpp"
#include "rt_align.hpp"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace rt {

namespace {

constexpr int32_t kInf = std::numeric_limits<int32_t>::max() / 4;
constexpr uint64_t kHigh = 1ull << 63;

// Append `count` copies of `op` to a CIGAR under construction (run-length).
void push_op(std::string& cigar, char op, uint32_t count) {
  if (count == 0) {
    return;
  }
  cigar += std::to_string(count);
  cigar += op;
}

// Run-length encode reversed op characters into a forward CIGAR.
std::string cigar_from_reversed_ops(const std::string& rev_ops) {
  std::string cigar;
  uint32_t run = 0;
  char run_op = 0;
  for (auto it = rev_ops.rbegin(); it != rev_ops.rend(); ++it) {
    if (*it == run_op) {
      ++run;
    } else {
      push_op(cigar, run_op, run);
      run_op = *it;
      run = 1;
    }
  }
  push_op(cigar, run_op, run);
  return cigar;
}

// One Myers/Hyyro bit-parallel block step (64 rows of one DP column).
// Updates vp/vn in place; returns the horizontal delta out of the block's
// bottom row.
inline int myers_block_step(uint64_t eq, uint64_t& vp, uint64_t& vn,
                            int hin) {
  const uint64_t pv = vp, mv = vn;
  const uint64_t xv = eq | mv;
  if (hin < 0) {
    eq |= 1;
  }
  const uint64_t xh = (((eq & pv) + pv) ^ pv) | eq;
  uint64_t ph = mv | ~(xh | pv);
  uint64_t mh = pv & xh;
  int hout = 0;
  if (ph & kHigh) {
    hout = 1;
  } else if (mh & kHigh) {
    hout = -1;
  }
  ph <<= 1;
  mh <<= 1;
  if (hin < 0) {
    mh |= 1;
  } else if (hin > 0) {
    ph |= 1;
  }
  vp = mh | ~(xv | ph);
  vn = ph & xv;
  return hout;
}

}  // namespace

namespace {
std::string myers_banded_cigar(const char* q, uint32_t n, const char* t,
                               uint32_t m, int64_t dist);
std::string scalar_banded_cigar(const char* q, uint32_t q_len, const char* t,
                                uint32_t t_len, int64_t dist_exact);
}  // namespace

std::string align_global_cigar(const char* q, uint32_t q_len, const char* t,
                               uint32_t t_len) {
  if (q_len == 0 || t_len == 0) {
    std::string cigar;
    push_op(cigar, 'D', t_len);
    push_op(cigar, 'I', q_len);
    return cigar;
  }

  // One bit-parallel distance pass first: the exact distance gives an exact
  // band, so the path pass runs exactly once with no retries.
  const int64_t dist_exact = edit_distance(q, q_len, t, t_len);

  // Large problems: banded block-Myers with popcount traceback
  // (edlib-class throughput). Small problems: plain banded scalar DP.
  if (static_cast<uint64_t>(q_len) * t_len > (1ull << 22)) {
    std::string cigar = myers_banded_cigar(q, q_len, t, t_len, dist_exact);
    if (!cigar.empty()) {
      return cigar;
    }
    // verification failed (shouldn't happen): fall through to scalar DP
  }
  return scalar_banded_cigar(q, q_len, t, t_len, dist_exact);
}

namespace {

// Banded unit-cost NW over diagonals d = j - i, d in [dmin, dmax].
// Traceback moves: 0 = diag (M), 1 = left (D, consumes target),
// 2 = up (I, consumes query). Directions are packed 4-per-byte.
std::string scalar_banded_cigar(const char* q, uint32_t q_len, const char* t,
                                uint32_t t_len, int64_t dist_exact) {
  const int64_t diff = static_cast<int64_t>(t_len) - static_cast<int64_t>(q_len);
  int64_t k = std::max<int64_t>(1, dist_exact);
  const int64_t k_cap =
      static_cast<int64_t>(std::max(q_len, t_len)) + 1;

  std::vector<int32_t> prev_row, cur_row;
  std::vector<uint8_t> tb;

  while (true) {
    const int64_t dmin = std::min<int64_t>(0, diff) - k;
    const int64_t dmax = std::max<int64_t>(0, diff) + k;
    const int64_t width = dmax - dmin + 1;

    // Traceback storage: (q_len + 1) rows x width diagonals, 2 bits each.
    const size_t tb_bytes =
        (static_cast<size_t>(q_len + 1) * static_cast<size_t>(width) + 3) / 4;
    if (tb_bytes > (3ull << 30)) {
      rt::fail("[racon_tpu::align_global_cigar] error: alignment of "
                   "%u x %u exceeds memory budget!\n",
                   q_len, t_len);
    }
    tb.assign(tb_bytes, 0);
    prev_row.assign(width, kInf);
    cur_row.assign(width, kInf);

    auto set_tb = [&](uint32_t i, int64_t w, uint8_t move) {
      const size_t idx = static_cast<size_t>(i) * width + w;
      tb[idx >> 2] |= move << ((idx & 3) << 1);
    };

    // Row 0: D[0][j] = j for j in band.
    for (int64_t w = 0; w < width; ++w) {
      const int64_t j = dmin + w;  // i == 0
      if (j >= 0 && j <= static_cast<int64_t>(t_len)) {
        prev_row[w] = static_cast<int32_t>(j);
        if (j > 0) {
          set_tb(0, w, 1);
        }
      }
    }

    for (uint32_t i = 1; i <= q_len; ++i) {
      std::fill(cur_row.begin(), cur_row.end(), kInf);
      const int64_t j_lo = std::max<int64_t>(0, dmin + i);
      const int64_t j_hi = std::min<int64_t>(t_len, dmax + i);
      for (int64_t j = j_lo; j <= j_hi; ++j) {
        const int64_t w = j - i - dmin;
        int32_t best;
        uint8_t move;
        if (j == 0) {
          best = static_cast<int32_t>(i);
          move = 2;
        } else {
          // Diagonal (same w in previous row).
          const int32_t sub =
              prev_row[w] == kInf
                  ? kInf
                  : prev_row[w] + (q[i - 1] == t[j - 1] ? 0 : 1);
          best = sub;
          move = 0;
          // Left: consume target, w-1 in the same row.
          if (w > 0 && cur_row[w - 1] != kInf && cur_row[w - 1] + 1 < best) {
            best = cur_row[w - 1] + 1;
            move = 1;
          }
          // Up: consume query, w+1 in the previous row.
          if (w + 1 < width && prev_row[w + 1] != kInf &&
              prev_row[w + 1] + 1 < best) {
            best = prev_row[w + 1] + 1;
            move = 2;
          }
        }
        cur_row[w] = best;
        set_tb(i, w, move);
      }
      prev_row.swap(cur_row);
    }

    const int64_t w_final = diff - dmin;
    const int32_t dist =
        (w_final >= 0 && w_final < width) ? prev_row[w_final] : kInf;

    // Ukkonen criterion: a distance within the band radius is optimal.
    if (dist <= k || k >= k_cap) {
      std::string rev_ops;
      rev_ops.reserve(q_len + t_len);
      uint32_t i = q_len;
      int64_t j = t_len;
      while (i > 0 || j > 0) {
        const int64_t w = j - i - dmin;
        const size_t idx = static_cast<size_t>(i) * width + w;
        const uint8_t move = (tb[idx >> 2] >> ((idx & 3) << 1)) & 3;
        if (i > 0 && j > 0 && move == 0) {
          rev_ops += 'M';
          --i;
          --j;
        } else if (j > 0 && move == 1) {
          rev_ops += 'D';
          --j;
        } else {
          rev_ops += 'I';
          --i;
        }
      }

      return cigar_from_reversed_ops(rev_ops);
    }
    k *= 2;
  }
}

// Banded block-Myers (Hyyro) with per-column VP/VN snapshots and a
// popcount-based traceback. Band half-width k = dist + 65: the optimal path
// deviates at most `dist` diagonals from the endpoint diagonals, so it stays
// a full block away from the band edge, where the +1 boundary approximation
// (an overestimate, hence never winning a min) lives.
std::string myers_banded_cigar(const char* q, uint32_t n, const char* t,
                               uint32_t m, int64_t dist) {
  const int64_t k = dist + 65;
  const int64_t diff = static_cast<int64_t>(m) - static_cast<int64_t>(n);
  const int64_t dmin = std::min<int64_t>(0, diff) - k;
  const int64_t dmax = std::max<int64_t>(0, diff) + k;
  const uint32_t W = (n + 63) / 64;

  // Block range per column j (1-based): rows i in [max(1, j-dmax),
  // min(n, j-dmin)], bit r = i-1.
  auto blo = [&](int64_t j) -> int64_t {
    const int64_t top = std::max<int64_t>(1, j - dmax);
    return (top - 1) / 64;
  };
  auto bhi = [&](int64_t j) -> int64_t {
    const int64_t bot = std::min<int64_t>(n, j - dmin);
    return (bot - 1) / 64;
  };

  std::vector<uint64_t> peq(static_cast<size_t>(W) * 256, 0);
  for (uint32_t i = 0; i < n; ++i) {
    peq[static_cast<size_t>(i / 64) * 256 + static_cast<uint8_t>(q[i])] |=
        1ull << (i % 64);
  }

  std::vector<uint64_t> vp(W, ~0ull), vn(W, 0);

  // Per-column snapshot storage.
  std::vector<size_t> col_off(m + 1, 0);
  std::vector<int32_t> col_blo(m + 1, 0), col_bhi(m + 1, -1);
  std::vector<int64_t> col_bot(m + 1, 0);  // score at row (bhi+1)*64 (virtual)
  size_t total_blocks = 0;
  for (int64_t j = 1; j <= m; ++j) {
    total_blocks += static_cast<size_t>(bhi(j) - blo(j) + 1);
  }
  if (total_blocks * 16 > (3ull << 30)) {
    return std::string();  // too big; caller falls back
  }
  std::vector<uint64_t> svp(total_blocks), svn(total_blocks);

  // Column 0 snapshot is implicit: D[i][0] = i.
  int64_t bot_score = 64ll * (bhi(1) + 1);  // virtual bottom of col 0 band
  size_t off = 0;
  int64_t prev_bhi = bhi(1);
  // initialize bands below: vp preinitialized ~0 handles fresh blocks

  for (int64_t j = 1; j <= m; ++j) {
    const int64_t lo_b = blo(j), hi_b = bhi(j);
    // Entering new bottom blocks: extend the bottom anchor (fresh blocks are
    // all-VP, +1 per row).
    if (hi_b > prev_bhi) {
      bot_score += 64ll * (hi_b - prev_bhi);
      prev_bhi = hi_b;
    }

    const uint8_t c = static_cast<uint8_t>(t[j - 1]);
    int hin = 1;  // top boundary (row 0 or band top) advances +1 per column
    for (int64_t b = lo_b; b <= hi_b; ++b) {
      hin = myers_block_step(peq[static_cast<size_t>(b) * 256 + c], vp[b],
                             vn[b], hin);
    }
    bot_score += hin;

    col_off[j] = off;
    col_blo[j] = static_cast<int32_t>(lo_b);
    col_bhi[j] = static_cast<int32_t>(hi_b);
    col_bot[j] = bot_score;
    for (int64_t b = lo_b; b <= hi_b; ++b) {
      svp[off] = vp[b];
      svn[off] = vn[b];
      ++off;
    }
  }

  // D(i, j) from the column-j snapshot: walk up from the bottom anchor.
  auto cell = [&](int64_t i, int64_t j) -> int64_t {
    if (j == 0) {
      return i;
    }
    if (i == 0) {
      return j;
    }
    const int64_t lo_b = col_blo[j], hi_b = col_bhi[j];
    int64_t score = col_bot[j];
    // rows (r+1) for bits r; peel rows strictly above the anchor down to i.
    for (int64_t b = hi_b; b >= lo_b; --b) {
      const int64_t base = b * 64;  // bit r covers row r+1
      if (base + 1 > i) {
        // whole block rows are > i: peel all 64
        const uint64_t p = svp[col_off[j] + (b - lo_b)];
        const uint64_t mn = svn[col_off[j] + (b - lo_b)];
        score -= __builtin_popcountll(p);
        score += __builtin_popcountll(mn);
      } else {
        // partial: peel rows i+1 .. base+64 -> bits (i-base) .. 63
        const int shift = static_cast<int>(i - base);
        const uint64_t mask = shift >= 64 ? 0 : (~0ull << shift);
        const uint64_t p = svp[col_off[j] + (b - lo_b)] & mask;
        const uint64_t mn = svn[col_off[j] + (b - lo_b)] & mask;
        score -= __builtin_popcountll(p);
        score += __builtin_popcountll(mn);
        break;
      }
    }
    return score;
  };

  if (cell(n, m) != dist) {
    return std::string();  // boundary approximation violated; fall back
  }

  std::string rev_ops;
  rev_ops.reserve(n + m);
  int64_t i = n, j = m;
  int64_t cur = dist;  // cell(n, m), carried forward between steps
  while (i > 0 || j > 0) {
    int64_t next;
    if (i > 0 && j > 0 &&
        (next = cell(i - 1, j - 1)) + (q[i - 1] == t[j - 1] ? 0 : 1) == cur) {
      rev_ops += 'M';
      --i;
      --j;
    } else if (j > 0 && (next = cell(i, j - 1)) + 1 == cur) {
      rev_ops += 'D';
      --j;
    } else {
      next = cur - 1;  // vertical move always costs 1
      rev_ops += 'I';
      --i;
    }
    cur = next;
  }

  return cigar_from_reversed_ops(rev_ops);
}

}  // namespace

// Myers/Hyyro bit-parallel global edit distance over 64-row blocks.
namespace {

// One banded block-Myers scoring pass with half-width k. Returns the
// in-band distance D(n, m) — an overestimate of the true distance when
// the optimal path leaves the band, exact when the result is <= k (the
// Ukkonen criterion: every path of cost <= k stays within k diagonals of
// the endpoint diagonals, and the band-top boundary only overestimates).
int64_t banded_distance_pass(const std::vector<uint64_t>& peq, uint32_t n,
                             const char* t, uint32_t m, int64_t k,
                             std::vector<uint64_t>& vp,
                             std::vector<uint64_t>& vn) {
  const int64_t diff = static_cast<int64_t>(m) - static_cast<int64_t>(n);
  const int64_t dmin = std::min<int64_t>(0, diff) - k;
  const int64_t dmax = std::max<int64_t>(0, diff) + k;
  const uint32_t W = (n + 63) / 64;
  auto blo = [&](int64_t j) -> int64_t {
    return (std::max<int64_t>(1, j - dmax) - 1) / 64;
  };
  auto bhi = [&](int64_t j) -> int64_t {
    return (std::min<int64_t>(n, j - dmin) - 1) / 64;
  };

  vp.assign(W, ~0ull);
  vn.assign(W, 0);
  int64_t bot = 64ll * (bhi(1) + 1);  // score at the virtual band bottom
  int64_t prev_bhi = bhi(1);
  for (int64_t j = 1; j <= static_cast<int64_t>(m); ++j) {
    const int64_t lo_b = blo(j), hi_b = bhi(j);
    if (hi_b > prev_bhi) {  // fresh bottom blocks are all-VP (+1 per row)
      bot += 64ll * (hi_b - prev_bhi);
      prev_bhi = hi_b;
    }
    const uint8_t c = static_cast<uint8_t>(t[j - 1]);
    int hin = 1;  // +1 per column at row 0 / band top (overestimate)
    for (int64_t b = lo_b; b <= hi_b; ++b) {
      hin = myers_block_step(peq[static_cast<size_t>(b) * 256 + c], vp[b],
                             vn[b], hin);
    }
    bot += hin;
  }
  // Peel virtual rows below n off the final column.
  int64_t score = bot;
  for (int64_t r = 64ll * (bhi(m) + 1) - 1; r >= static_cast<int64_t>(n);
       --r) {
    const uint32_t b = static_cast<uint32_t>(r / 64);
    const uint64_t bit = 1ull << (r % 64);
    if (vp[b] & bit) {
      --score;
    } else if (vn[b] & bit) {
      ++score;
    }
  }
  return score;
}

}  // namespace

int64_t edit_distance(const char* q, uint32_t q_len, const char* t,
                      uint32_t t_len) {
  if (q_len == 0) {
    return t_len;
  }
  if (t_len == 0) {
    return q_len;
  }

  const uint32_t W = (q_len + 63) / 64;
  // Peq[block][symbol]: match mask for the 64 query rows of the block.
  std::vector<uint64_t> peq(static_cast<size_t>(W) * 256, 0);
  for (uint32_t i = 0; i < q_len; ++i) {
    const uint8_t c = static_cast<uint8_t>(q[i]);
    peq[static_cast<size_t>(i / 64) * 256 + c] |= 1ull << (i % 64);
  }

  std::vector<uint64_t> vp(W), vn(W);

  // Ukkonen doubling: banded passes cost O(n*k/64) instead of the full
  // O(n*m/64); a result <= k is exact. Typical long-read pairs resolve at
  // k ~ 2*distance, several times cheaper than the full pass. Seeding at
  // |m - n| skips passes that cannot possibly satisfy d <= k (distance is
  // always >= the length difference).
  const int64_t full = std::max(q_len, t_len);
  const int64_t diff = std::llabs(static_cast<int64_t>(t_len) -
                                  static_cast<int64_t>(q_len));
  for (int64_t k = std::max<int64_t>(256, diff); k < full; k *= 4) {
    const int64_t d = banded_distance_pass(peq, q_len, t, t_len, k, vp, vn);
    if (d <= k) {
      return d;
    }
  }

  // Band covering everything == the classic full pass.
  return banded_distance_pass(peq, q_len, t, t_len, full, vp, vn);
}

}  // namespace rt
