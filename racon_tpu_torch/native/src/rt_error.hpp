// Error type for the native runtime. Library consumers (the ctypes ABI)
// surface these as Python exceptions; the CLI binary catches at main() and
// exits 1 with the message — preserving the reference's observable
// stderr/exit behavior (the reference exits inline:
// e.g. racon src/polisher.cpp:65-71, overlap.cpp:148-153).
#pragma once

#include <cstdarg>
#include <cstdio>
#include <stdexcept>
#include <string>

namespace rt {

class Error : public std::runtime_error {
 public:
  explicit Error(std::string msg) : std::runtime_error(std::move(msg)) {}
};

// printf-style constructor helper.
[[noreturn]] inline void fail(const char* fmt, ...) {
  char buf[1024];
  va_list args;
  va_start(args, fmt);
  std::vsnprintf(buf, sizeof(buf), fmt, args);
  va_end(args);
  throw Error(buf);
}

}  // namespace rt
