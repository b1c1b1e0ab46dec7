// Data-plane access profiler: WHICH vertices the cluster touches.
//
// PRs 5-7 made the control plane observable — how long calls take
// (eg_telemetry), where a step's time goes (eg_phase), what a dying
// process was doing (eg_blackbox). None of it can say which vertex ids
// are hot, how a hop's frontier fans out across shards, or why the
// feature cache hits — the exact measurements ROADMAP item 5
// (locality-aware sharding + hot-vertex caching) needs before it can be
// built or judged. GNNSampler (arXiv:2108.11571) and FastSample
// (arXiv:2311.17847) both show power-law access skew as the dominant
// distributed-GNN lever; this layer quantifies that skew on live
// workloads with fixed memory:
//
//   * a SPACE-SAVING top-K hot-key tracker per side (client/server):
//     K fixed slots + a fixed open-addressed index, no allocation ever.
//     Space-saving guarantees count >= true >= count - err per tracked
//     id, and exact counts (err == 0) whenever K covers the stream's
//     distinct ids — the property tests/test_heat.py pins;
//   * a COUNT-MIN sketch per side (depth x width atomic counters,
//     relaxed fetch_adds only): point estimates over the whole id
//     space, est >= true and est <= true + (e/width) * N with
//     probability 1 - e^-depth — the frequency oracle the
//     cache-efficacy classes and the top-K admission answer read;
//   * per-hop FAN-OUT ATTRIBUTION on the client: for each
//     SampleNeighbor/GetDenseFeature call, ids_requested /
//     ids_after_dedup / cache_hits / ids_on_wire and a shards-touched
//     value histogram per op (emitted into the shared "hist" map as
//     heat_spread:<op>), plus request/reply bytes per shard;
//   * CACHE-EFFICACY classes: eg_cache hits/misses/evictions bucketed
//     by the key's current sketch-estimated frequency class — the
//     direct "would a frequency-aware cache help" answer.
//
// Feed points: client-side in the eg_remote per-shard encode lambdas
// (post-coalesce — one feed per unique id per call, exactly what goes
// on the wire plus cache hits), server-side in Service::Dispatch
// (pre-execute, tagged by op + the requesting conn ServeConn stamps
// into a thread-local).
//
// Cost contract: behind the existing telemetry kill-switch plus its own
// `heat=` flag — disabled, every hook is two relaxed loads. Enabled,
// one splitmix64 hash per id drives the sketch rows AND the top-K index
// probe; the tracker mutex is taken ONCE per batch (not per id) and —
// because that mutex serializes every sketch writer — the cells
// increment with plain relaxed load+store pairs, not locked RMWs. No
// allocation on the hot path (fixed arrays, tombstoned open
// addressing). Priced by the remote_bench heat on/off A/B under the
// <2% contract (PERF.md "Data-plane heat").
#ifndef EG_HEAT_H_
#define EG_HEAT_H_

#include "eg_common.h"

#include <atomic>
#include <cstdint>
#include <mutex>
#include <string>
#include <vector>

#include "eg_telemetry.h"

namespace eg {

enum HeatSide : int { kHeatClient = 0, kHeatServer = 1, kHeatSideCount };

const char* const kHeatSideNames[kHeatSideCount] = {"client", "server"};

// Count-min sketch geometry: a cache-line-BLOCKED sketch — 8192 cells
// per side arranged as 1024 blocks of 8 (one 64-byte line each). An id
// hashes to ONE block and two cells inside it, so a feed touches a
// single cache line per id: the sketch walk's cold-line misses, not
// its arithmetic, were the measured majority of the heat cost on the
// remote hot path (the <2% remote_bench contract is what forces the
// blocked layout). Estimates keep the count-min shape — est >= true
// always, overestimates ~eps * N with eps = e/width per query w.h.p.;
// in-block cell correlation trades a small constant in that bound for
// half the memory traffic, and the exactness tests pin the realized
// bound empirically.
constexpr int kHeatCmsDepth = 2;        // cells read per estimate
constexpr int kHeatCmsWidth = 8192;     // total cells (power of two)
constexpr int kHeatCmsBlockCells = 8;   // cells per 64-byte block
constexpr int kHeatCmsBlocks = kHeatCmsWidth / kHeatCmsBlockCells;

// Top-K tracker pool bounds. `heat_topk=` (default kHeatDefaultTopK)
// selects the live capacity within the fixed pool.
constexpr int kHeatMaxTopK = 1024;
constexpr int kHeatDefaultTopK = 128;
// Open-addressed id -> slot index; power of two, load factor <= 25%.
constexpr int kHeatIndexSlots = 4096;

// Frequency classes for cache-efficacy accounting: class c covers
// sketch estimates in [2^(c-1), 2^c) (class 0 = estimate 0, never seen;
// the last class is open-ended).
constexpr int kHeatClasses = 8;

inline int HeatClassOf(uint64_t est) {
  if (est == 0) return 0;
  int b = 64 - __builtin_clzll(est);  // bit_length
  return b < kHeatClasses ? b : kHeatClasses - 1;
}

enum HeatCacheEvent : int {
  kHeatCacheHit = 0,
  kHeatCacheMiss,
  kHeatCacheEvict,
  kHeatCacheEventCount,
};

const char* const kHeatCacheEventNames[kHeatCacheEventCount] = {
    "hit", "miss", "evict",
};

// Per-shard wire-byte ledger and per-conn server attribution bounds
// (fixed pools; overflow lands in the last slot, counted as such).
constexpr int kHeatMaxShards = 64;
constexpr int kHeatMaxConns = 64;

// Requesting-conn tag for server-side feeds: AdmissionServer::ServeConn
// stamps the conn fd into a thread-local before dispatching, so
// Service::Dispatch can tag its feeds without widening the handler
// signature. -1 = no conn (client side / local engine).
void HeatSetConn(int conn);
int HeatConn();

class Heat {
 public:
  static Heat& Global();

  // Effective switch: own flag AND the process-global telemetry
  // kill-switch (telemetry=0 silences this subsystem too).
  bool enabled() const {
    return flag_.load(std::memory_order_relaxed) &&
           Telemetry::Global().enabled();
  }
  bool flag() const { return flag_.load(std::memory_order_relaxed); }
  void SetEnabled(bool on) {
    flag_.store(on, std::memory_order_relaxed);
  }

  // Live top-K capacity (`heat_topk=`); clamped to [1, kHeatMaxTopK].
  // Resets both sides' tables: space-saving guarantees are only
  // meaningful for a capacity held over the whole stream.
  void SetTopK(int k);
  int topk_capacity() const;

  // Feed one batch of ids (one side, one op, optional server conn).
  // Sketch updates are relaxed atomics per id; the top-K mutex is taken
  // once for the whole batch.
  void Record(int side, int op, const uint64_t* keys, int64_t n,
              int conn = -1);
  // Gather form: feed base[rows[i]] for i in [0, n) — the dense-feature
  // path's unique ids live scattered behind a row-index plan, and
  // staging them into a contiguous scratch vector would cost an
  // allocation per call on the hot path. When `out_classes` is
  // non-null it receives each id's frequency class INCLUDING this
  // access, computed from the fetch_add return values the feed already
  // paid for — the dense path's cache-efficacy accounting reads these
  // instead of a second sketch walk per probed id.
  void RecordRows(int side, int op, const uint64_t* base,
                  const int32_t* rows, int64_t n, int conn = -1,
                  uint8_t* out_classes = nullptr);

  // Point estimate from the side's sketch (>= true feed count).
  uint64_t Estimate(int side, uint64_t id) const;

  // Client fan-out attribution for one whole SampleNeighbor /
  // GetDenseFeature call. ids_on_wire is MEASURED (ids actually
  // encoded), so `ids_on_wire == ids_requested - ids_deduped -
  // cache_hits` is a cross-check the tests assert, not an identity
  // baked in here.
  void RecordFanout(int op, uint64_t ids_requested, uint64_t ids_deduped,
                    uint64_t cache_hits, uint64_t ids_on_wire,
                    int shards_touched);

  // Request/reply bytes one shard exchange moved (client side).
  void AddShardBytes(int shard, uint64_t req_bytes, uint64_t reply_bytes);

  // One cache event for vertex `id`, bucketed by the CLIENT sketch's
  // current estimate class — the eviction hook in eg_cache.cc (rare:
  // one per evicted row; hits/misses use the batched form below).
  void RecordCacheEvent(int event, uint64_t id);
  // Batched hit/miss class accounting: per-class counts a dense call
  // accumulated locally from RecordRows' out_classes (one call per
  // GetDenseFeature instead of two sketch reads per probed id).
  void AddCacheClasses(const uint32_t* hits, const uint32_t* misses);

  struct TopEntry {
    uint64_t id = 0;
    uint64_t count = 0;  // upper bound on the true feed count
    uint64_t err = 0;    // overestimate bound: true >= count - err
  };
  // Snapshot of one side's tracker, sorted by count descending.
  std::vector<TopEntry> TopK(int side) const;

  // Total ids fed per side (sketch stream length N in the eps bound).
  uint64_t Total(int side) const {
    return total_[side].load(std::memory_order_relaxed);
  }

  // Full dump: {"shard","enabled","topk_capacity","sketch","topk",
  // "ids","fanout","shard_bytes","conns","cache_class"} — the kHeat
  // wire reply and the eg_heat_json local surface.
  std::string Json(int shard) const;
  // Append `,"heat":{...}` (same body) to an in-progress JSON object —
  // Telemetry::Json calls this, so metrics_text(), snapshot(), the
  // STATS scrape and metrics_dump inherit the heat state for free.
  void JsonInto(std::string* out) const;
  // Append the per-op shards-touched value histograms to the shared
  // "hist" map (keys heat_spread:<op>, same cell shape as the phase
  // histograms so one Python renderer serves all of them).
  void SpreadJsonInto(std::string* out, bool* first) const;

  // Zero everything except the enabled flag and top-K capacity.
  void Reset();

 private:
  Heat();

  struct TopTable {
    mutable std::mutex mu;
    int size EG_GUARDED_BY(mu) = 0;
    int tombstones EG_GUARDED_BY(mu) = 0;
    // cached minimum level: counts only grow, so any slot whose count
    // equals min_count IS a true minimum — replacements resume a
    // rotating scan at that level instead of an O(cap) argmin per
    // untracked arrival (amortized O(1); a full rescan only when the
    // level is exhausted, which itself raised cap slots one level)
    uint64_t min_count EG_GUARDED_BY(mu) = 0;
    int scan_pos EG_GUARDED_BY(mu) = 0;
    uint64_t ids[kHeatMaxTopK] EG_GUARDED_BY(mu);
    uint64_t counts[kHeatMaxTopK] EG_GUARDED_BY(mu);
    uint64_t errs[kHeatMaxTopK] EG_GUARDED_BY(mu);
    // -1 empty, -2 tombstone, >= 0 slot index
    int32_t index[kHeatIndexSlots] EG_GUARDED_BY(mu);
  };

  struct SpreadCell {
    std::atomic<uint64_t> buckets[kHistBuckets];
    std::atomic<uint64_t> total;
  };

  // Slot helpers mutate TopTable freely; callers take t.mu first.
  static int FindSlot(const TopTable& t, uint64_t id, uint64_t h)
      EG_REQUIRES(mu);
  static void InsertSlot(TopTable* t, uint64_t h, int slot) EG_REQUIRES(mu);
  static void EraseSlot(TopTable* t, uint64_t id) EG_REQUIRES(mu);
  static void RebuildIndex(TopTable* t) EG_REQUIRES(mu);
  void UpdateTop(TopTable* t, uint64_t id, uint64_t h, int cap)
      EG_REQUIRES(mu);

  std::atomic<bool> flag_{true};
  std::atomic<int> cap_{kHeatDefaultTopK};

  // flat blocked layout; 64-byte aligned so block == cache line
  alignas(64) std::atomic<uint64_t> cms_[kHeatSideCount][kHeatCmsWidth] =
      {};
  std::atomic<uint64_t> total_[kHeatSideCount] = {};
  TopTable top_[kHeatSideCount];

  // per (side, op) ids fed
  std::atomic<uint64_t> ids_by_op_[kHeatSideCount][kHistOpSlots] = {};

  // client fan-out attribution per op
  std::atomic<uint64_t> fan_calls_[kHistOpSlots] = {};
  std::atomic<uint64_t> fan_requested_[kHistOpSlots] = {};
  std::atomic<uint64_t> fan_deduped_[kHistOpSlots] = {};
  std::atomic<uint64_t> fan_cache_hits_[kHistOpSlots] = {};
  std::atomic<uint64_t> fan_on_wire_[kHistOpSlots] = {};
  SpreadCell spread_[kHistOpSlots] = {};

  // per-shard wire bytes (client side; slot kHeatMaxShards-1 absorbs
  // out-of-range shard indices)
  std::atomic<uint64_t> shard_req_bytes_[kHeatMaxShards] = {};
  std::atomic<uint64_t> shard_reply_bytes_[kHeatMaxShards] = {};

  // server-side requesting-conn ledger: fd-labeled fixed pool
  // (conn_fd_ slots start at -1 = unclaimed, set in the constructor)
  std::atomic<int> conn_fd_[kHeatMaxConns];
  std::atomic<uint64_t> conn_ids_[kHeatMaxConns] = {};
  std::atomic<uint64_t> conn_overflow_{0};

  std::atomic<uint64_t> cache_class_[kHeatCacheEventCount][kHeatClasses] =
      {};
};

}  // namespace eg

#endif  // EG_HEAT_H_
