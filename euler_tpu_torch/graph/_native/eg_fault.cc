#include "eg_fault.h"

#include <signal.h>

#include <chrono>
#include <cstdlib>
#include <thread>

#include "eg_stats.h"

namespace eg {

namespace {

// Exception-free number parsing: a malformed spec must land in error_,
// never throw through Configure's C-ABI callers.
bool ParseDouble(const std::string& s, double* out) {
  if (s.empty()) return false;
  char* end = nullptr;
  *out = std::strtod(s.c_str(), &end);
  return end == s.c_str() + s.size();
}

bool ParseI64(const std::string& s, int64_t* out) {
  if (s.empty()) return false;
  char* end = nullptr;
  *out = std::strtoll(s.c_str(), &end, 10);
  return end == s.c_str() + s.size();
}

int FaultIdOf(const std::string& name) {
  for (int i = 0; i < kFaultIdCount; ++i)
    if (name == kFaultNames[i]) return i;
  return -1;
}

}  // namespace

bool FaultInjector::Configure(const std::string& spec, uint64_t seed) {
  Point fresh[kFaultIdCount];
  bool any = false;
  size_t pos = 0;
  while (pos < spec.size()) {
    size_t comma = spec.find(',', pos);
    std::string item = spec.substr(
        pos, comma == std::string::npos ? std::string::npos : comma - pos);
    pos = comma == std::string::npos ? spec.size() : comma + 1;
    if (item.empty()) continue;

    size_t colon = item.find(':');
    if (colon == std::string::npos) {
      error_ = "fault spec '" + item + "' wants <point>:<action>@<param>";
      return false;
    }
    int id = FaultIdOf(item.substr(0, colon));
    if (id < 0) {
      error_ = "unknown failpoint '" + item.substr(0, colon) + "'";
      return false;
    }
    if (fresh[id].configured) {
      error_ = "duplicate failpoint '" + item.substr(0, colon) + "'";
      return false;
    }
    std::string action = item.substr(colon + 1);
    int64_t limit = -1;
    size_t hash = action.find('#');
    if (hash != std::string::npos) {
      if (!ParseI64(action.substr(hash + 1), &limit) || limit < 0) {
        error_ = "bad fire limit in '" + item + "'";
        return false;
      }
      action = action.substr(0, hash);
    }
    Point p;
    p.limit = limit;
    if (action.compare(0, 4, "err@") == 0) {
      p.err = true;
      if (!ParseDouble(action.substr(4), &p.prob) || p.prob <= 0.0 ||
          p.prob > 1.0) {
        error_ = "bad err probability in '" + item + "' (want (0,1])";
        return false;
      }
    } else if (action.compare(0, 6, "delay@") == 0) {
      std::string params = action.substr(6);
      size_t at = params.find('@');
      std::string ms_s = at == std::string::npos ? params
                                                 : params.substr(0, at);
      double ms = 0;
      if (!ParseDouble(ms_s, &ms) || ms < 0) {
        error_ = "bad delay ms in '" + item + "'";
        return false;
      }
      p.delay_ms = static_cast<int>(ms);
      if (at != std::string::npos) {
        if (!ParseDouble(params.substr(at + 1), &p.prob) || p.prob <= 0.0 ||
            p.prob > 1.0) {
          error_ = "bad delay probability in '" + item + "' (want (0,1])";
          return false;
        }
      }
    } else {
      error_ = "unknown fault action in '" + item + "' (want err@<p> or "
               "delay@<ms>[@<p>])";
      return false;
    }
    // Per-point stream: the decision sequence at a point depends only on
    // (seed, point, hit index), never on other points' traffic.
    p.rng = Rng(seed ^ (0x9E3779B97F4A7C15ULL * (id + 1)));
    p.configured = true;
    fresh[id] = p;
    any = true;
  }
  {
    std::lock_guard<std::mutex> l(mu_);
    for (int i = 0; i < kFaultIdCount; ++i) points_[i] = fresh[i];
  }
  enabled_.store(any, std::memory_order_relaxed);
  return true;
}

void FaultInjector::Clear() {
  enabled_.store(false, std::memory_order_relaxed);
  std::lock_guard<std::mutex> l(mu_);
  for (auto& p : points_) p = Point();
}

bool FaultInjector::Fire(FaultId id) {
  int delay_ms = 0;
  bool fail = false;
  {
    std::lock_guard<std::mutex> l(mu_);
    Point& p = points_[id];
    if (!p.configured) return false;
    if (p.limit >= 0 && p.fired >= p.limit) return false;
    if (p.prob < 1.0 && p.rng.NextDouble() >= p.prob) return false;
    ++p.fired;
    delay_ms = p.delay_ms;
    fail = p.err;
  }
  if (id == kFaultCrash) {
    // Postmortem drill (FAULTS.md): the action params pick the signal —
    // err@p raises SIGSEGV, delay@SIG reuses the ms slot as the signal
    // number (6 = SIGABRT). The ledger entry lands BEFORE the raise so
    // the blackbox signal handler's counter snapshot includes this fire
    // (the client audits the dead shard's postmortem against it).
    Counters::Global().Add(kCtrCrash);
    int sig = fail ? SIGSEGV : (delay_ms > 0 ? delay_ms : SIGABRT);
    ::raise(sig);
    return true;  // unreachable for fatal dispositions; honest otherwise
  }
  if (delay_ms > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(delay_ms));
  return fail;
}

uint64_t FaultInjector::injected(FaultId id) const {
  std::lock_guard<std::mutex> l(mu_);
  return static_cast<uint64_t>(points_[id].fired);
}

void FaultInjector::SnapshotInjected(uint64_t* out) const {
  std::lock_guard<std::mutex> l(mu_);
  for (int i = 0; i < kFaultIdCount; ++i)
    out[i] = static_cast<uint64_t>(points_[i].fired);
}

}  // namespace eg
