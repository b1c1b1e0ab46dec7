// Span-timer statistics for the sampling engine and service.
//
// The reference ships only a thread-local stopwatch used in one perf test
// (reference euler/common/timmer.cc:24-33) and glog lines; SURVEY §5.1
// calls for a real span timer in the TPU build's sampling service. This is
// it: lock-free per-op accumulators (count / total ns / max ns) recorded
// at the C-ABI choke point, so every query — embedded engine, remote
// client round-trip, or service-side request — is measured with one
// mechanism. Snapshots are racy-but-consistent-enough reads of relaxed
// atomics; overhead per call is two clock reads + three relaxed RMWs.
#ifndef EG_STATS_H_
#define EG_STATS_H_

#include <atomic>
#include <chrono>
#include <cstdint>

namespace eg {

enum StatOp : int {
  kStatSampleNode = 0,
  kStatSampleEdge,
  kStatSampleNeighbor,
  kStatSampleFanout,
  kStatFullNeighbor,
  kStatTopKNeighbor,
  kStatRandomWalk,
  kStatDenseFeature,
  kStatSparseFeature,
  kStatBinaryFeature,
  kStatNodeType,
  kStatServiceRequest,  // one per served RPC (service side)
  kStatOpCount,
};

// Fixed-order names; Python reads them at runtime via eg_stat_name(i).
const char* const kStatNames[kStatOpCount] = {
    "sample_node",    "sample_edge",   "sample_neighbor", "sample_fanout",
    "full_neighbor",  "topk_neighbor", "random_walk",     "dense_feature",
    "sparse_feature", "binary_feature", "node_type",      "service_request",
};

class Stats {
 public:
  static Stats& Global() {
    static Stats s;
    return s;
  }

  void Record(StatOp op, uint64_t ns) {
    auto& c = cells_[op];
    c.count.fetch_add(1, std::memory_order_relaxed);
    c.total_ns.fetch_add(ns, std::memory_order_relaxed);
    uint64_t prev = c.max_ns.load(std::memory_order_relaxed);
    while (prev < ns &&
           !c.max_ns.compare_exchange_weak(prev, ns,
                                           std::memory_order_relaxed)) {
    }
  }

  void Snapshot(uint64_t* counts, uint64_t* total_ns, uint64_t* max_ns) const {
    for (int i = 0; i < kStatOpCount; ++i) {
      counts[i] = cells_[i].count.load(std::memory_order_relaxed);
      total_ns[i] = cells_[i].total_ns.load(std::memory_order_relaxed);
      max_ns[i] = cells_[i].max_ns.load(std::memory_order_relaxed);
    }
  }

  void Reset() {
    for (auto& c : cells_) {
      c.count.store(0, std::memory_order_relaxed);
      c.total_ns.store(0, std::memory_order_relaxed);
      c.max_ns.store(0, std::memory_order_relaxed);
    }
  }

 private:
  struct Cell {
    std::atomic<uint64_t> count{0};
    std::atomic<uint64_t> total_ns{0};
    std::atomic<uint64_t> max_ns{0};
  };
  Cell cells_[kStatOpCount];
};

// Failure counters for the remote transport: where the span timers above
// measure how long the sampling tier takes, these count how often it has
// to fight for an answer (retries, quarantines, failovers, deadline
// aborts, rejected frames, registry churn). Same mechanism — relaxed
// atomics recorded at the choke points, snapshot into Python through the
// stats surface — so a production run and the chaos soak (FAULTS.md)
// read identical ledgers.
enum CounterId : int {
  kCtrDialFail = 0,      // DialTcp failed inside ConnPool::Call
  kCtrRetry,             // attempts beyond the first within one Call
  kCtrQuarantine,        // a replica marked bad (timed quarantine)
  kCtrFailover,          // a Call that succeeded after >=1 failed attempt
  kCtrCallFail,          // a Call that exhausted retries/deadline
  kCtrDeadlineExceeded,  // a Call aborted by its overall deadline
  kCtrFrameReject,       // oversize/malformed/error-status frame rejected
  kCtrRediscover,        // background registry re-LIST applied to pools
  kCtrHeartbeatMiss,     // a service registry heartbeat that had to redial
  // Remote hot-path efficiency ledger (perf counters, not failures —
  // same mechanism so one snapshot covers both): how many ids the
  // client did NOT have to put on the wire, and how its requests were
  // shaped. On power-law graphs duplicate hub ids dominate a batch, so
  // these are the terms of the communication-win accounting
  // (ids_on_wire_after = ids_requested - ids_deduped - cache_hits).
  kCtrIdsDeduped,        // duplicate ids coalesced before wire encode
  kCtrCacheHit,          // feature-row cache hits (per unique id probed)
  kCtrCacheMiss,         // feature-row cache misses (row fetched remotely)
  kCtrRpcChunk,          // chunked sub-requests (counted per chunk when a
                         // per-shard request was split; unsplit adds 0)
  kCtrRpcError,          // a per-shard op failed after all transport
                         // retries (its rows degraded to defaults, or the
                         // call raised under strict=)
  // Server-side survivability ledger (eg_admission.h): how often the
  // shard service shed, refused, or reclaimed work instead of wedging —
  // plus the client-side reactions that keep those events invisible to
  // training (fail-fast failover, wire downgrade).
  kCtrBusyReject,        // admission answered BUSY instead of queueing
  kCtrBusyFailover,      // client treated a BUSY reply as an immediate
                         // failover (no backoff burned, no quarantine)
  kCtrHandlerTimeout,    // a handler abandoned a wedged connection on an
                         // SO_RCVTIMEO/SO_SNDTIMEO expiry (slot freed)
  kCtrDeadlineReject,    // a handler refused a request whose stamped
                         // deadline had already expired (no dead compute)
  kCtrDraining,          // a server entered drain (dereg + finish + close)
  kCtrWireDowngrade,     // a replica negotiated down to wire v1 (old
                         // server detected on its first exchange)
  // Prefetch pipeline ledger (euler_tpu/parallel/prefetch.py bumps
  // these through the eg_counter_add ABI): how the training input
  // pipeline behaved — produced vs dropped batches, and workers that
  // DIED after init (a dead worker otherwise only surfaces as the
  // consumer's exception at that step; the counter makes it visible in
  // any scrape, see OBSERVABILITY.md "Step phases").
  kCtrPrefetchProduced,     // batches produced by prefetch workers
  kCtrPrefetchDropped,      // produced batches never consumed (consumer
                            // abandoned the iterator / error teardown)
  kCtrPrefetchWorkerError,  // a prefetch worker killed by an exception
  // Postmortem ledger (eg_blackbox.h / FAULTS.md): fires of the seeded
  // `crash` failpoint, bumped BEFORE the signal is raised so the
  // fatal-signal dump's counter snapshot includes the fire that killed
  // the process — the exact-arithmetic anchor the blackbox tests audit
  // a dead shard's postmortem against.
  kCtrCrash,
  // Locality ledger (eg_placement.h / eg_cache.h): how the routing and
  // caching layers exploit access skew. nbr_cache hits/misses mirror
  // the feature-cache pair for the client-side neighbor-list cache (a
  // hit samples a hub hop locally — zero wire bytes, zero shard work);
  // cache_admit_rejects counts candidates the frequency-aware (TinyLFU-
  // shaped) admission turned away because the FIFO victim was hotter;
  // placement_fallbacks counts clients that asked for a placement map
  // and degraded to hash routing (old server or hash-sharded data).
  kCtrNbrCacheHit,
  kCtrNbrCacheMiss,
  kCtrCacheAdmitReject,
  kCtrPlacementFallback,
  // Serving ledger (euler_tpu/serving bumps these through the
  // eg_counter_add ABI): how the embedding inference path admitted and
  // shed load. serve_requests counts every submitted embed request;
  // serve_busy_rejects counts requests the micro-batcher's bounded
  // queue (or the frontend's connection cap) answered BUSY — the
  // serve-side twin of busy_rejects; serve_deadline_rejects counts
  // requests whose deadline expired before their batch dispatched
  // (answered DEADLINE, never sent to the device); serve_batches
  // counts device dispatches — serve_requests/serve_batches is the
  // request-coalescing factor the micro-batcher exists to produce.
  kCtrServeRequest,
  kCtrServeBusyReject,
  kCtrServeDeadlineReject,
  kCtrServeBatch,
  // Device-plane ledger (euler_tpu/devprof.py bumps these through the
  // eg_counter_add ABI): the XLA side of the step. device_compiles
  // counts every backend compile observed (jax.monitoring listener, or
  // the wrapped-jit fallback where events are unavailable);
  // device_recompiles counts compiles AFTER a watched function's
  // warmup — each one is journaled with the arg-shape/dtype diff that
  // triggered it, because a silent recompile is the classic way a
  // fixed-bucket device program quietly becomes 100x slower.
  // serve_recompiles is the eg_serve compile-storm guard's twin (the
  // padded fixed-bucket forward must compile exactly once); h2d/d2h
  // count transfer bytes bracketing the train/serve device boundaries.
  kCtrDeviceCompile,
  kCtrDeviceRecompile,
  kCtrServeRecompile,
  kCtrH2dBytes,
  kCtrD2hBytes,
  // Async-sampler ledger (eg_remote.cc SampleFanoutAsync): the
  // completion-queue pipeline's shape. async_submits counts whole-step
  // async ops submitted; async_inflight_peak is a high-water mark (via
  // Counters::Max) of ops concurrently in flight — at sampler_depth=N
  // it should read N, proving the pipeline really overlapped;
  // async_continuations counts hop/slice continuations fired on the
  // dispatcher pool (jobs enqueued by a completing worker, never by a
  // blocked caller — the mechanism of arXiv 2110.08450's overlap).
  kCtrAsyncSubmit,
  kCtrAsyncInflightPeak,
  kCtrAsyncContinuation,
  // Snapshot-epoch ledger (eg_epoch.h): the mutable-graph refresh path.
  // epoch_flips counts published flips (a delta load that swapped the
  // serving snapshot); epoch_drains counts superseded snapshots whose
  // last pinned reader released (counted once per retired epoch — flips
  // with no in-flight readers drain immediately, so every flip
  // eventually produces exactly one drain while the snapshot is still
  // in the keep window); epoch_stale_hits_evicted counts client cache
  // entries (feature/neighbor/sample) evicted on a generation-stale
  // hit; delta_loads_failed counts kLoadDelta requests refused (parse/
  // validate/merge failure, or the delta_load/epoch_flip failpoints) —
  // the graph keeps serving its current epoch in every failure case.
  kCtrEpochFlip,
  kCtrEpochDrain,
  kCtrEpochStaleEvict,
  kCtrDeltaLoadFail,
  kCtrCount,
};

const char* const kCounterNames[kCtrCount] = {
    "dials_failed",       "retries",          "quarantines",
    "failovers",          "calls_failed",     "deadlines_exceeded",
    "frames_rejected",    "rediscoveries",    "heartbeat_misses",
    "ids_deduped",        "cache_hits",       "cache_misses",
    "rpc_chunks",         "rpc_errors",       "busy_rejects",
    "busy_failovers",     "handler_timeouts", "deadline_rejects",
    "draining",           "wire_downgrades",  "prefetch_produced",
    "prefetch_dropped",   "prefetch_worker_errors", "crashes",
    "nbr_cache_hits",     "nbr_cache_misses",
    "cache_admit_rejects", "placement_fallbacks",
    "serve_requests",     "serve_busy_rejects",
    "serve_deadline_rejects", "serve_batches",
    "device_compiles",    "device_recompiles",
    "serve_recompiles",   "h2d_bytes",        "d2h_bytes",
    "async_submits",      "async_inflight_peak", "async_continuations",
    "epoch_flips",        "epoch_drains",
    "epoch_stale_hits_evicted", "delta_loads_failed",
};

class Counters {
 public:
  static Counters& Global() {
    static Counters c;
    return c;
  }

  void Add(CounterId id, uint64_t n = 1) {
    cells_[id].fetch_add(n, std::memory_order_relaxed);
  }

  // CAS-max for high-water-mark counters (async_inflight_peak): the
  // cell monotonically tracks the largest value ever reported.
  void Max(CounterId id, uint64_t v) {
    uint64_t prev = cells_[id].load(std::memory_order_relaxed);
    while (prev < v &&
           !cells_[id].compare_exchange_weak(prev, v,
                                             std::memory_order_relaxed)) {
    }
  }

  uint64_t Get(CounterId id) const {
    return cells_[id].load(std::memory_order_relaxed);
  }

  void Snapshot(uint64_t* out) const {
    for (int i = 0; i < kCtrCount; ++i)
      out[i] = cells_[i].load(std::memory_order_relaxed);
  }

  void Reset() {
    for (auto& c : cells_) c.store(0, std::memory_order_relaxed);
  }

 private:
  std::atomic<uint64_t> cells_[kCtrCount]{};
};

// RAII span: records wall time from construction to destruction.
class SpanTimer {
 public:
  explicit SpanTimer(StatOp op)
      : op_(op), start_(std::chrono::steady_clock::now()) {}
  ~SpanTimer() {
    auto ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                  std::chrono::steady_clock::now() - start_)
                  .count();
    Stats::Global().Record(op_, static_cast<uint64_t>(ns));
  }
  SpanTimer(const SpanTimer&) = delete;
  SpanTimer& operator=(const SpanTimer&) = delete;

 private:
  StatOp op_;
  std::chrono::steady_clock::time_point start_;
};

}  // namespace eg

#endif  // EG_STATS_H_
