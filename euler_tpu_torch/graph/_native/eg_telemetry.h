// Native observability: latency histograms, slow-span journals, and the
// cluster scrape substrate.
//
// PRs 2-4 gave the remote path counters (eg_stats.h Counters) and
// count/total/max span timers (Stats) — enough to know THAT the
// transport fought, never WHERE a request's time went. Distributed-GNN
// throughput tuning lives or dies on exactly that decomposition
// (FastSample, arXiv:2311.17847; pipelined sampling, arXiv:2110.08450:
// client queue vs wire vs handler), so this layer records:
//
//   * lock-cheap log2-bucketed latency HISTOGRAMS (fixed 1µs..60s+
//     buckets, one relaxed fetch_add per bucket hit) per RPC op on the
//     client (whole ConnPool::Call) and the server (admission handler
//     time, queue-wait time), plus dial and retry-backoff histograms;
//   * a fixed-size SLOW-SPAN journal of the slowest-N requests each
//     side has seen (op, trace id, shard, queue/handler/wire µs,
//     outcome), correlated across processes by a splitmix64 trace id
//     stamped into the wire-v3 request envelope (eg_wire.h);
//   * one JSON dump (Json below) serving both the local
//     euler_tpu.metrics_text() surface and the remote kStats scrape —
//     the same builder on both paths is what makes the scrape-vs-local
//     parity test meaningful.
//
// Cost contract: disabled (telemetry=0) every hook is one relaxed load;
// enabled, a histogram record is two relaxed RMWs and a span record is
// one relaxed load unless the span beats the journal's current floor
// (then a short mutex). Nothing here blocks the hot path on the
// journal lock for ordinary-latency requests.
#ifndef EG_TELEMETRY_H_
#define EG_TELEMETRY_H_

#include "eg_common.h"

#include <atomic>
#include <chrono>
#include <cstdint>
#include <mutex>
#include <string>
#include <vector>

namespace eg {

// log2 microsecond buckets: bucket 0 = [0, 1µs); bucket b (1..26) =
// [2^(b-1), 2^b) µs; bucket 27 = [2^26 µs, inf) — 1µs to ~67s in 28
// fixed buckets (60 s lands in bucket 26). Shared with the Python
// renderer (euler_tpu/telemetry.py bucket_of), pinned by tests.
constexpr int kHistBuckets = 28;

inline int HistBucketOf(uint64_t us) {
  if (us == 0) return 0;
  int b = 64 - __builtin_clzll(us);  // floor(log2(us)) + 1
  return b < kHistBuckets - 1 ? b : kHistBuckets - 1;
}

// Histogram families. Per-op kinds index their cells by wire op code
// (eg_wire.h WireOp, 1..17); scalar kinds use slot 0.
enum HistKind : int {
  kHistClientCall = 0,  // whole ConnPool::Call per op (retries included)
  kHistServerHandler,   // admission worker: decode+execute+encode per op
  kHistServerQueue,     // poller-ready -> handler pickup wait
  kHistDial,            // DialTcp (success or failure)
  kHistBackoff,         // retry backoff sleeps
  kHistKindCount,
};

const char* const kHistKindNames[kHistKindCount] = {
    "client_call", "server_handler", "server_queue", "dial", "backoff",
};

const bool kHistKindPerOp[kHistKindCount] = {true, true, false, false,
                                             false};

// Per-op cell slots: wire ops 1..21 plus slot 0 for out-of-range ops.
constexpr int kHistOpSlots = 22;

// Fixed-order wire-op names (index == WireOp value; slot 0 = unknown).
const char* const kWireOpNames[kHistOpSlots] = {
    "other",          "ping",
    "info",           "sample_node",
    "sample_edge",    "node_type",
    "sample_neighbor", "full_neighbor",
    "topk_neighbor",  "dense_feature",
    "edge_dense_feature", "sparse_feature",
    "edge_sparse_feature", "binary_feature",
    "edge_binary_feature", "node_weight",
    "sample_neighbor_uniq", "stats",
    "history",        "heat",
    "placement",      "load_delta",
};

enum SpanSide : uint8_t { kSpanClient = 0, kSpanServer = 1 };

enum SpanOutcome : uint8_t {
  kOutcomeOk = 0,
  kOutcomeError = 1,
  kOutcomeBusy = 2,
  kOutcomeDeadline = 3,
  kOutcomeFailed = 4,   // call exhausted retries / pool empty
  kOutcomeDropped = 5,  // reply dropped (failpoint / peer gone)
};

const char* const kSpanOutcomeNames[6] = {
    "ok", "error", "busy", "deadline", "failed", "dropped",
};

struct TelemetrySpan {
  uint8_t side = kSpanClient;
  uint8_t op = 0;
  uint8_t outcome = kOutcomeOk;
  int32_t shard = -1;     // client: target shard; server: own shard idx
  uint64_t trace = 0;     // 0 = none propagated (v1/v2 peer)
  uint64_t queue_us = 0;
  uint64_t handler_us = 0;
  uint64_t wire_us = 0;
  uint64_t total_us = 0;
  // CLOCK_MONOTONIC µs when the span ENDED (stamped by RecordSpan when
  // left 0). The machine-wide monotonic epoch is what lets the trace
  // exporter (euler_tpu/trace.py) place client and shard spans from
  // different processes on one host onto a single Perfetto timeline.
  int64_t end_us = 0;
};

// Admission-layer gauges carried in the kStats scrape reply (the
// PR-4 survivability state a remote operator could not see before).
struct TelemetryGauges {
  int workers = 0;      // fixed handler pool size
  int active = 0;       // workers currently serving
  int queue_depth = 0;  // ready conns waiting for a worker
  int conns = 0;        // admitted open connections
  int draining = 0;     // 1 while Drain() is in progress / done
  int64_t epoch = 0;    // current serving snapshot epoch (eg_epoch.h)
};

inline int64_t TelemetryNowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Process-global trace-id source: splitmix64 over an atomic counter, so
// ids are unique per process and well-mixed without any locking. (Not
// eg::ThreadRng — trace ids must not perturb the seeded sampler
// streams the determinism tests replay.)
uint64_t NextTraceId();

class Telemetry {
 public:
  static Telemetry& Global();

  bool enabled() const { return enabled_.load(std::memory_order_relaxed); }
  void SetEnabled(bool on) {
    enabled_.store(on, std::memory_order_relaxed);
  }

  // Slow-span journal capacity (slow_spans= config key; default 32).
  void SetSlowCapacity(int n);
  int slow_capacity() const;

  // One histogram sample. Cost: two relaxed fetch_adds (bucket + sum);
  // a single relaxed load when disabled.
  void Record(HistKind kind, int op, uint64_t us) {
    if (!enabled()) return;
    if (op < 0 || op >= kHistOpSlots || !kHistKindPerOp[kind]) op = 0;
    Cell& c = cells_[kind][op];
    c.buckets[HistBucketOf(us)].fetch_add(1, std::memory_order_relaxed);
    c.total_us.fetch_add(us, std::memory_order_relaxed);
  }

  // Offer a span to the slowest-N journal. Fast reject (one relaxed
  // load) when the journal is full and the span is under its floor.
  void RecordSpan(const TelemetrySpan& s);

  // Journal snapshot, slowest first.
  std::vector<TelemetrySpan> SlowSpans() const;

  // Full JSON dump: counters (eg_stats.h), span-timer stats, every
  // histogram, the slow-span journal, and (when `gauges` is non-null,
  // i.e. in a serving process) the admission gauges. `shard` is the
  // reporting process's shard index (-1 = not a shard server). One
  // builder for the local surface AND the kStats reply.
  std::string Json(int shard, const TelemetryGauges* gauges) const;

  // Zero histograms and the journal (not the enabled flag/capacity).
  void Reset();

 private:
  struct Cell {
    std::atomic<uint64_t> buckets[kHistBuckets];
    std::atomic<uint64_t> total_us;
  };

  std::atomic<bool> enabled_{true};
  Cell cells_[kHistKindCount][kHistOpSlots] = {};
  mutable std::mutex span_mu_;  // guards spans_ + span_cap_
  std::vector<TelemetrySpan> spans_ EG_GUARDED_BY(span_mu_);
  int span_cap_ EG_GUARDED_BY(span_mu_) = 32;
  std::atomic<bool> span_full_{false};
  std::atomic<uint64_t> span_floor_{0};  // min total_us once full
};

}  // namespace eg

#endif  // EG_TELEMETRY_H_
