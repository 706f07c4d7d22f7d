// Native monotonic stopwatch with split slots.
//
// Counterpart of the reference's StopwatchHost
// (Adl/Host/AdlStopwatchHost.inl:26-107: QPC/gettimeofday with
// 64 split slots). clock_gettime(CLOCK_MONOTONIC) here. C ABI for ctypes.

#include <cstdint>
#include <ctime>

namespace {
constexpr int kMaxSplits = 64;  // reference capacity, AdlStopwatchHost.inl

struct Stopwatch {
  uint64_t t0 = 0;
  uint64_t splits[kMaxSplits];
  int n_splits = 0;
};

uint64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}
}  // namespace

extern "C" {

void* oclpt_stopwatch_new() { return new Stopwatch(); }
void oclpt_stopwatch_free(void* h) { delete static_cast<Stopwatch*>(h); }

void oclpt_stopwatch_start(void* h) {
  auto* s = static_cast<Stopwatch*>(h);
  s->t0 = now_ns();
  s->n_splits = 0;
}

// Records a split; returns elapsed ns since start.
uint64_t oclpt_stopwatch_split(void* h) {
  auto* s = static_cast<Stopwatch*>(h);
  uint64_t dt = now_ns() - s->t0;
  if (s->n_splits < kMaxSplits) s->splits[s->n_splits++] = dt;
  return dt;
}

uint64_t oclpt_stopwatch_elapsed_ns(void* h) {
  return now_ns() - static_cast<Stopwatch*>(h)->t0;
}

int oclpt_stopwatch_n_splits(void* h) {
  return static_cast<Stopwatch*>(h)->n_splits;
}

uint64_t oclpt_stopwatch_get_split(void* h, int i) {
  return static_cast<Stopwatch*>(h)->splits[i];
}

}  // extern "C"
