#include "eg_phase.h"

namespace eg {

namespace {

void AppendU64(std::string* out, uint64_t v) {
  char buf[24];
  int n = 0;
  do {
    buf[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) out->push_back(buf[--n]);
}

void AppendCell(std::string* out, bool* first, const char* key,
                const std::atomic<uint64_t>* buckets,
                const std::atomic<uint64_t>& total) {
  if (!*first) out->push_back(',');
  *first = false;
  out->push_back('"');
  out->append(key);
  out->append("\":{\"b\":[");
  uint64_t count = 0;
  for (int b = 0; b < kHistBuckets; ++b) {
    uint64_t v = buckets[b].load(std::memory_order_relaxed);
    count += v;
    if (b) out->push_back(',');
    AppendU64(out, v);
  }
  out->append("],\"count\":");
  AppendU64(out, count);
  out->append(",\"sum_us\":");
  AppendU64(out, total.load(std::memory_order_relaxed));
  out->push_back('}');
}

}  // namespace

PhaseStats& PhaseStats::Global() {
  static PhaseStats p;
  return p;
}

void PhaseStats::Reset() {
  for (auto& c : phases_) {
    for (auto& b : c.buckets) b.store(0, std::memory_order_relaxed);
    c.total.store(0, std::memory_order_relaxed);
  }
  for (auto& c : gauges_) {
    for (auto& b : c.buckets) b.store(0, std::memory_order_relaxed);
    c.total.store(0, std::memory_order_relaxed);
  }
  for (auto& c : serve_) {
    for (auto& b : c.buckets) b.store(0, std::memory_order_relaxed);
    c.total.store(0, std::memory_order_relaxed);
  }
  for (auto& b : serve_batch_.buckets)
    b.store(0, std::memory_order_relaxed);
  serve_batch_.total.store(0, std::memory_order_relaxed);
}

void PhaseStats::HistJsonInto(std::string* out, bool* first) const {
  for (int p = 0; p < kPhaseCount; ++p) {
    std::string key = std::string("phase:") + kPhaseNames[p];
    AppendCell(out, first, key.c_str(), phases_[p].buckets,
               phases_[p].total);
  }
  for (int g = 0; g < kGaugeCount; ++g) {
    AppendCell(out, first, kPrefetchGaugeKeys[g], gauges_[g].buckets,
               gauges_[g].total);
  }
  for (int s = 0; s < kServePhaseCount; ++s) {
    std::string key = std::string("serve:") + kServePhaseNames[s];
    AppendCell(out, first, key.c_str(), serve_[s].buckets,
               serve_[s].total);
  }
  AppendCell(out, first, kServeBatchKey, serve_batch_.buckets,
             serve_batch_.total);
}

}  // namespace eg
