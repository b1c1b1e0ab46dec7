#include "eg_telemetry.h"

#include <algorithm>

#include "eg_blackbox.h"
#include "eg_devprof.h"
#include "eg_heat.h"
#include "eg_phase.h"
#include "eg_stats.h"

namespace eg {

namespace {

// splitmix64 finalizer (same mix as eg::Rng) over a process-global
// counter: unique, well-distributed trace ids with one atomic RMW.
uint64_t Mix(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

void AppendU64(std::string* out, uint64_t v) {
  char buf[24];
  int n = 0;
  do {
    buf[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) out->push_back(buf[--n]);
}

void AppendI64(std::string* out, int64_t v) {
  if (v < 0) {
    out->push_back('-');
    AppendU64(out, static_cast<uint64_t>(-v));
  } else {
    AppendU64(out, static_cast<uint64_t>(v));
  }
}

void AppendKey(std::string* out, const char* k) {
  out->push_back('"');
  out->append(k);
  out->append("\":");
}

}  // namespace

uint64_t NextTraceId() {
  static std::atomic<uint64_t> counter{0x9E3779B97F4A7C15ULL};
  uint64_t id = Mix(counter.fetch_add(0x9E3779B97F4A7C15ULL,
                                      std::memory_order_relaxed));
  return id ? id : 1;  // 0 means "no trace" on the wire
}

Telemetry& Telemetry::Global() {
  static Telemetry t;
  return t;
}

void Telemetry::SetSlowCapacity(int n) {
  if (n < 1) n = 1;
  std::lock_guard<std::mutex> l(span_mu_);
  span_cap_ = n;
  if (static_cast<int>(spans_.size()) > span_cap_) {
    // keep the slowest span_cap_ entries
    std::sort(spans_.begin(), spans_.end(),
              [](const TelemetrySpan& a, const TelemetrySpan& b) {
                return a.total_us > b.total_us;
              });
    spans_.resize(span_cap_);
  }
  bool full = static_cast<int>(spans_.size()) >= span_cap_;
  span_full_.store(full, std::memory_order_relaxed);
  uint64_t floor = 0;
  if (full) {
    floor = spans_[0].total_us;
    for (const auto& s : spans_) floor = std::min(floor, s.total_us);
  }
  span_floor_.store(floor, std::memory_order_relaxed);
}

int Telemetry::slow_capacity() const {
  std::lock_guard<std::mutex> l(span_mu_);
  return span_cap_;
}

void Telemetry::RecordSpan(const TelemetrySpan& span) {
  if (!enabled()) return;
  // Hot-path reject: a full journal only admits spans over its floor.
  if (span_full_.load(std::memory_order_relaxed) &&
      span.total_us <= span_floor_.load(std::memory_order_relaxed))
    return;
  TelemetrySpan s = span;
  if (s.end_us == 0) s.end_us = TelemetryNowUs();
  std::lock_guard<std::mutex> l(span_mu_);
  if (static_cast<int>(spans_.size()) < span_cap_) {
    spans_.push_back(s);
  } else {
    // evict the FASTEST resident span (the journal keeps the slowest-N)
    size_t min_i = 0;
    for (size_t i = 1; i < spans_.size(); ++i)
      if (spans_[i].total_us < spans_[min_i].total_us) min_i = i;
    if (s.total_us <= spans_[min_i].total_us) return;  // raced under floor
    spans_[min_i] = s;
  }
  bool full = static_cast<int>(spans_.size()) >= span_cap_;
  span_full_.store(full, std::memory_order_relaxed);
  if (full) {
    uint64_t floor = spans_[0].total_us;
    for (const auto& sp : spans_) floor = std::min(floor, sp.total_us);
    span_floor_.store(floor, std::memory_order_relaxed);
  }
}

std::vector<TelemetrySpan> Telemetry::SlowSpans() const {
  std::vector<TelemetrySpan> out;
  {
    std::lock_guard<std::mutex> l(span_mu_);
    out = spans_;
  }
  std::stable_sort(out.begin(), out.end(),
                   [](const TelemetrySpan& a, const TelemetrySpan& b) {
                     return a.total_us > b.total_us;
                   });
  return out;
}

void Telemetry::Reset() {
  for (auto& per_kind : cells_)
    for (auto& c : per_kind) {
      for (auto& b : c.buckets) b.store(0, std::memory_order_relaxed);
      c.total_us.store(0, std::memory_order_relaxed);
    }
  std::lock_guard<std::mutex> l(span_mu_);
  spans_.clear();
  span_full_.store(false, std::memory_order_relaxed);
  span_floor_.store(0, std::memory_order_relaxed);
}

std::string Telemetry::Json(int shard, const TelemetryGauges* g) const {
  std::string o;
  o.reserve(16384);
  o.push_back('{');
  AppendKey(&o, "shard");
  AppendI64(&o, shard);
  o.push_back(',');
  AppendKey(&o, "enabled");
  AppendI64(&o, enabled() ? 1 : 0);

  // counters: every id, zeros included — byte-parity with the
  // eg_counters_* snapshot Python reads in-process.
  o.push_back(',');
  AppendKey(&o, "counters");
  o.push_back('{');
  uint64_t ctr[kCtrCount];
  Counters::Global().Snapshot(ctr);
  for (int i = 0; i < kCtrCount; ++i) {
    if (i) o.push_back(',');
    AppendKey(&o, kCounterNames[i]);
    AppendU64(&o, ctr[i]);
  }
  o.push_back('}');

  // span-timer stats (raw ints; non-zero ops only, like native.stats())
  o.push_back(',');
  AppendKey(&o, "stats");
  o.push_back('{');
  uint64_t sc[kStatOpCount], st[kStatOpCount], sm[kStatOpCount];
  Stats::Global().Snapshot(sc, st, sm);
  bool first = true;
  for (int i = 0; i < kStatOpCount; ++i) {
    if (sc[i] == 0) continue;
    if (!first) o.push_back(',');
    first = false;
    AppendKey(&o, kStatNames[i]);
    o.push_back('[');
    AppendU64(&o, sc[i]);
    o.push_back(',');
    AppendU64(&o, st[i]);
    o.push_back(',');
    AppendU64(&o, sm[i]);
    o.push_back(']');
  }
  o.push_back('}');

  // histograms: per-op kinds emit EVERY wire op (the exposition must
  // cover the full RPC surface even before traffic); scalar kinds emit
  // their single series.
  o.push_back(',');
  AppendKey(&o, "hist");
  o.push_back('{');
  first = true;
  for (int k = 0; k < kHistKindCount; ++k) {
    int lo = kHistKindPerOp[k] ? 1 : 0;
    int hi = kHistKindPerOp[k] ? kHistOpSlots : 1;
    for (int op = lo; op < hi; ++op) {
      const Cell& c = cells_[k][op];
      if (!first) o.push_back(',');
      first = false;
      o.push_back('"');
      o.append(kHistKindNames[k]);
      if (kHistKindPerOp[k]) {
        o.push_back(':');
        o.append(kWireOpNames[op]);
      }
      o.append("\":{");
      AppendKey(&o, "b");
      o.push_back('[');
      uint64_t count = 0;
      for (int b = 0; b < kHistBuckets; ++b) {
        uint64_t v = c.buckets[b].load(std::memory_order_relaxed);
        count += v;
        if (b) o.push_back(',');
        AppendU64(&o, v);
      }
      o.append("],");
      AppendKey(&o, "count");
      AppendU64(&o, count);
      o.push_back(',');
      AppendKey(&o, "sum_us");
      AppendU64(&o, c.total_us.load(std::memory_order_relaxed));
      o.push_back('}');
    }
  }
  // step-phase + prefetch-gauge histograms (eg_phase.h) join the same
  // map, so every surface downstream of this dump — metrics_text,
  // snapshot, the STATS scrape, metrics_dump — sees them for free
  PhaseStats::Global().HistJsonInto(&o, &first);
  // per-op shards-touched value histograms (eg_heat.h) ride the same
  // map for the same reason — keys heat_spread:<op>
  Heat::Global().SpreadJsonInto(&o, &first);
  o.push_back('}');

  // process resource gauges (eg_blackbox.h): RSS / open fds / live
  // threads / cache bytes — emitted into the same dump every metrics
  // surface reads, so metrics_text()/snapshot()/the STATS scrape pick
  // them up with zero new plumbing (and a postmortem's frozen values
  // can be compared against what the live surfaces showed)
  Blackbox::Global().ResourceJsonInto(&o);

  // live serve-SLO gauges (eg_devprof.h): the windowed p50/p99 and
  // lifetime violation count euler_tpu/serving/slo.py pushes through
  // the ABI — always emitted (zeros included) so metrics_text renders
  // the eg_serve_slo_* families unconditionally
  Devprof::Global().ServeSloJsonInto(&o);

  // data-plane heat (eg_heat.h): hot-vertex top-K, sketch totals,
  // per-op ids ledger, fan-out attribution, cache-efficacy classes —
  // one section in the same dump, so the whole surface chain
  // (metrics_text/snapshot/STATS scrape/metrics_dump) inherits it
  Heat::Global().JsonInto(&o);

  if (g) {
    o.push_back(',');
    AppendKey(&o, "gauges");
    o.push_back('{');
    AppendKey(&o, "workers");
    AppendI64(&o, g->workers);
    o.push_back(',');
    AppendKey(&o, "workers_active");
    AppendI64(&o, g->active);
    o.push_back(',');
    AppendKey(&o, "queue_depth");
    AppendI64(&o, g->queue_depth);
    o.push_back(',');
    AppendKey(&o, "conns");
    AppendI64(&o, g->conns);
    o.push_back(',');
    AppendKey(&o, "draining");
    AppendI64(&o, g->draining);
    o.push_back(',');
    AppendKey(&o, "epoch");
    AppendI64(&o, g->epoch);
    o.push_back('}');
  }

  o.push_back(',');
  AppendKey(&o, "slow_spans");
  o.push_back('[');
  std::vector<TelemetrySpan> spans = SlowSpans();
  for (size_t i = 0; i < spans.size(); ++i) {
    const TelemetrySpan& s = spans[i];
    if (i) o.push_back(',');
    o.push_back('{');
    AppendKey(&o, "side");
    o.push_back('"');
    o.append(s.side == kSpanServer ? "server" : "client");
    o.append("\",");
    AppendKey(&o, "op");
    o.push_back('"');
    o.append(kWireOpNames[s.op < kHistOpSlots ? s.op : 0]);
    o.append("\",");
    // decimal STRING: a u64 trace id can exceed JSON's 2^53 safe-int
    // range, and Python int() round-trips the string exactly
    AppendKey(&o, "trace");
    o.push_back('"');
    AppendU64(&o, s.trace);
    o.append("\",");
    AppendKey(&o, "shard");
    AppendI64(&o, s.shard);
    o.push_back(',');
    AppendKey(&o, "queue_us");
    AppendU64(&o, s.queue_us);
    o.push_back(',');
    AppendKey(&o, "handler_us");
    AppendU64(&o, s.handler_us);
    o.push_back(',');
    AppendKey(&o, "wire_us");
    AppendU64(&o, s.wire_us);
    o.push_back(',');
    AppendKey(&o, "total_us");
    AppendU64(&o, s.total_us);
    o.push_back(',');
    AppendKey(&o, "end_us");
    AppendI64(&o, s.end_us);
    o.push_back(',');
    AppendKey(&o, "outcome");
    o.push_back('"');
    o.append(kSpanOutcomeNames[s.outcome < 6 ? s.outcome : 1]);
    o.push_back('"');
    o.push_back('}');
  }
  o.append("]}");
  return o;
}

}  // namespace eg
