// Phase timing + stderr progress bar.
//
// Capability parity with the reference logger
// (racon src/logger.{hpp,cpp}): wall-clock per-phase timings
// printed as "[...] phase = N.nnnnnn s", a 20-bin progress bar with
// percentage, and a total-runtime line on teardown.
#pragma once

#include <chrono>
#include <cstdio>
#include <string>

namespace rt {

class Logger {
 public:
  Logger()
      : start_(clock_t::now()), phase_(clock_t::now()), bar_state_(0) {}

  // Begin a new phase (silent).
  void log() { phase_ = clock_t::now(); }

  // Finish the current phase with a message.
  void log(const std::string& msg) {
    const double s = seconds_since(phase_);
    std::fprintf(stderr, "%s %.6f s\n", msg.c_str(), s);
    phase_ = clock_t::now();
  }

  // Advance a 20-bin progress bar; completes (prints elapsed + newline) on
  // the 20th tick.
  void bar(const std::string& msg) {
    ++bar_state_;
    const int bars = bar_state_;
    std::string b(bars, '=');
    if (bars < 20) {
      b += '>';
    }
    std::fprintf(stderr, "%s [%-20s] %3d%%\r", msg.c_str(), b.c_str(),
                 bars * 5);
    if (bars == 20) {
      const double s = seconds_since(phase_);
      std::fprintf(stderr, "\n%s %.6f s\n", msg.c_str(), s);
      bar_state_ = 0;
      phase_ = clock_t::now();
    }
  }

  void total(const std::string& msg) {
    std::fprintf(stderr, "%s %.6f s\n", msg.c_str(), seconds_since(start_));
  }

 private:
  using clock_t = std::chrono::steady_clock;
  static double seconds_since(clock_t::time_point t) {
    return std::chrono::duration<double>(clock_t::now() - t).count();
  }

  clock_t::time_point start_, phase_;
  int bar_state_;
};

}  // namespace rt
