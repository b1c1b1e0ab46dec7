// Step-phase profiler substrate: where a TRAINING step's time goes.
//
// eg_telemetry answers "where did this RPC's time go"; nothing answers
// "where did this training STEP's time go" — sampling vs host→device
// transfer vs device compute vs consumer stall on the prefetch queue.
// Pipelined-sampling work (arXiv:2110.08450) and FastSample
// (arXiv:2311.17847) both show input stalls dominating GNN step time
// exactly while they are invisible; ROADMAP item 1's acceptance
// criterion (`input_stall_ms -> ~0`) needs this measurement layer to
// exist before the pipelining PR can be judged against it.
//
// Two recorders, both the same lock-free cell shape as eg_telemetry:
//
//   * per-phase µs HISTOGRAMS (input_stall / sample / h2d / device /
//     host / step) — recorded by the Python training loop and prefetch
//     pipeline through the eg_phase_record ABI;
//   * prefetch pipeline VALUE histograms (queue depth at dequeue,
//     workers busy at dequeue) — dimensionless log2 buckets, so
//     count/sum give dequeues and mean depth and the bucket shape
//     distinguishes "queue always empty" (starved consumer) from
//     "queue deep but workers idle" (slow shard, not slow workers).
//
// The kill-switch is shared with eg_telemetry (`telemetry=0` disables
// both), and PhaseStats::HistJsonInto emits into the SAME "hist" map
// Telemetry::Json builds — keys "phase:<name>" / "prefetch_depth" /
// "prefetch_busy" — so metrics_text(), snapshot(), the STATS scrape,
// and every percentile helper pick the phases up with zero new plumbing.
#ifndef EG_PHASE_H_
#define EG_PHASE_H_

#include <atomic>
#include <cstdint>
#include <string>

#include "eg_telemetry.h"

namespace eg {

// Fixed phase order — the Python twin (euler_tpu/telemetry.py PHASES)
// indexes by this enum through the eg_phase_record ABI, pinned by tests.
enum StepPhase : int {
  kPhaseInputStall = 0,  // consumer blocked on the prefetch queue
  kPhaseSample,          // worker make_batch produce time (graph engine)
  kPhaseH2d,             // host->device transfer (shard_batch/device_put)
  kPhaseDevice,          // device compute, fenced via block_until_ready
  kPhaseHost,            // optimizer/bookkeeping tail on the host
  kPhaseStep,            // whole-step wall (the sum check for the rest)
  kPhaseCompile,         // XLA backend compile (jax.monitoring via
                         // euler_tpu/devprof.py — NOT part of the
                         // step-sum identity; compiles overlap steps)
  kPhaseCount,
};

const char* const kPhaseNames[kPhaseCount] = {
    "input_stall", "sample", "h2d", "device", "host", "step", "compile",
};

// Prefetch pipeline gauges recorded as value histograms.
enum PrefetchGauge : int {
  kGaugeQueueDepth = 0,  // ready batches at consumer dequeue
  kGaugeWorkersBusy,     // workers inside make_batch at dequeue
  kGaugeCount,
};

// Scalar hist-map keys (no per-op label, like "dial"/"backoff").
const char* const kPrefetchGaugeKeys[kGaugeCount] = {
    "prefetch_depth", "prefetch_busy",
};

// Serve-request phase order (euler_tpu/serving, OBSERVABILITY.md
// "Serve phases") — where one inference request's time goes, the
// request-level twin of the training StepPhase above. The Python twin
// (euler_tpu/telemetry.py SERVE_PHASES) indexes by this enum through
// the eg_serve_record ABI, pinned by tests.
enum ServePhase : int {
  kServeQueueWait = 0,  // submit -> micro-batch collect (coalescing wait)
  kServeSample,         // neighborhood sampling via the graph client
  kServeDispatch,       // h2d + jitted forward, fenced block_until_ready
  kServeTotal,          // submit -> reply wall (the sum check)
  kServePhaseCount,
};

const char* const kServePhaseNames[kServePhaseCount] = {
    "queue_wait", "sample", "dispatch", "total",
};

// Scalar hist-map key for the micro-batch size value histogram
// (dimensionless log2 buckets: count = device dispatches, sum = unique
// ids dispatched — their ratio is the coalescing factor the micro-
// batcher exists to produce).
const char kServeBatchKey[] = "serve_batch";

class PhaseStats {
 public:
  static PhaseStats& Global();

  // One µs sample for a step phase. Same cost contract as
  // Telemetry::Record: two relaxed RMWs, one relaxed load when the
  // shared telemetry kill-switch is off.
  void Record(int phase, uint64_t us) {
    if (!Telemetry::Global().enabled()) return;
    if (phase < 0 || phase >= kPhaseCount) return;
    Cell& c = phases_[phase];
    c.buckets[HistBucketOf(us)].fetch_add(1, std::memory_order_relaxed);
    c.total.fetch_add(us, std::memory_order_relaxed);
  }

  // One dimensionless sample for a prefetch gauge (depth, busy count).
  void RecordGauge(int which, uint64_t value) {
    if (!Telemetry::Global().enabled()) return;
    if (which < 0 || which >= kGaugeCount) return;
    Cell& c = gauges_[which];
    c.buckets[HistBucketOf(value)].fetch_add(1, std::memory_order_relaxed);
    c.total.fetch_add(value, std::memory_order_relaxed);
  }

  // One µs sample for a serve-request phase (eg::ServePhase order).
  // Same kill-switch and cost contract as Record, so `telemetry=0`
  // leaves the serve hot path histogram-free.
  void RecordServe(int phase, uint64_t us) {
    if (!Telemetry::Global().enabled()) return;
    if (phase < 0 || phase >= kServePhaseCount) return;
    Cell& c = serve_[phase];
    c.buckets[HistBucketOf(us)].fetch_add(1, std::memory_order_relaxed);
    c.total.fetch_add(us, std::memory_order_relaxed);
  }

  // One micro-batch dispatch: `ids` = unique ids in the device batch.
  void RecordServeBatch(uint64_t ids) {
    if (!Telemetry::Global().enabled()) return;
    Cell& c = serve_batch_;
    c.buckets[HistBucketOf(ids)].fetch_add(1, std::memory_order_relaxed);
    c.total.fetch_add(ids, std::memory_order_relaxed);
  }

  void Reset();

  // Append this recorder's series to an in-progress JSON "hist" map
  // (caller owns the braces; `first` tracks comma state across both
  // emitters). Keys: "phase:<name>" and the scalar gauge keys above,
  // each {"b": [...], "count": n, "sum_us": s} — identical shape to the
  // telemetry histograms so one Python renderer serves both.
  void HistJsonInto(std::string* out, bool* first) const;

 private:
  struct Cell {
    std::atomic<uint64_t> buckets[kHistBuckets];
    std::atomic<uint64_t> total;
  };

  Cell phases_[kPhaseCount] = {};
  Cell gauges_[kGaugeCount] = {};
  Cell serve_[kServePhaseCount] = {};
  Cell serve_batch_ = {};
};

}  // namespace eg

#endif  // EG_PHASE_H_
