// Client-side caches for the remote graph client: dense feature rows
// and (new) neighbor adjacency slices, both frequency-aware.
//
// Each SNAPSHOT of the graph is immutable (eg_epoch.h: a delta load
// builds a fresh snapshot and flips the serving epoch; nothing mutates
// in place), so anything fetched once is valid for as long as the
// client's cache GENERATION stands. Every Get/Put/Sample carries the
// caller's current generation (RemoteGraph bumps it when any shard's
// announced epoch moves): entries remember the generation they were
// filled under, and a hit from an older generation is erased on the
// spot (counted in `epoch_stale_hits_evicted`) and reported as a miss —
// lazy invalidation, no flush sweep, no wrong-epoch row ever returned.
// Static deployments never bump the generation and keep the original
// fetched-once-valid-forever behavior. On heavy-tail graphs the same
// hub rows are refetched endlessly
// by successive batches (hubs carry most edge mass, so every fanout
// lands on them); caching them client-side removes those rows from the
// wire entirely.
//
// Admission (the locality work): pure FIFO held 86.4% on the
// reddit_heavytail stream with its misses concentrated in a churn tail
// (PERF.md "Data-plane heat" cache-efficacy classes). Both caches now
// default to FREQUENCY-AWARE admission in the TinyLFU shape: when a
// stripe is full, the candidate is admitted only if its estimated
// access frequency beats the FIFO victim's — the estimator is eg_heat's
// client count-min sketch, which the query paths already feed with
// every id PRE-cache (so a candidate's current access is counted).
// Hot hub rows therefore pin instead of churning; a cold scan cannot
// flush them. `cache_policy=fifo` restores unconditional admission, and
// the policy silently degrades to FIFO while the heat estimator is
// disabled (no estimates -> no grounds to reject). Rejections are
// counted (`cache_admit_rejects`).
//
// FeatureCache — keyed by (feature-spec hash, node id): the same id
// requested with different fids/dims is a different row, so the spec
// participates in the key and is verified on hit (a 64-bit map-key
// collision degrades to a miss, never to a wrong row). Striped locking,
// FIFO eviction order under the admission filter. Config key
// `feature_cache_mb=` (remote graphs; default on, 0 disables).
//
// NeighborCache — keyed by (edge-type-spec hash, node id): one entry is
// a node's FULL adjacency slice over the requested edge types (ids,
// weights, types, plus the weight prefix sums), fetched once via
// kFullNeighbor when the heat sketch marks the node hot, then every
// later SampleNeighbor draw for it is served locally: Sample() draws
// proportional to edge weight against the stored prefix sums — the
// exact distribution the shard engine samples from
// (GraphStore::SampleNeighbors), so repeated hub hops stop crossing the
// wire at all while staying distribution-identical. Config key
// `neighbor_cache_mb=` (remote graphs; default on, 0 disables);
// counters `nbr_cache_hits`/`nbr_cache_misses`.
#ifndef EG_CACHE_H_
#define EG_CACHE_H_

#include <atomic>
#include <cstdint>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

#include "eg_common.h"

namespace eg {

// Process-global resident-byte gauges (one per cache kind, in practice
// one cache of each per RemoteGraph): stripes add/subtract their deltas
// so the blackbox resource sampler (eg_blackbox.h) and the fatal-signal
// dump can read cache pressure with one relaxed load — a postmortem
// must not walk stripe mutexes.
std::atomic<int64_t>& GlobalCacheBytes();
std::atomic<int64_t>& GlobalNbrCacheBytes();

// Admission policies (`cache_policy=` config key, shared by both
// caches; default frequency-aware).
enum CachePolicy : int {
  kCachePolicyFifo = 0,  // always admit; evict FIFO
  kCachePolicyFreq = 1,  // TinyLFU shape: admit only over the victim
};

// The shared TinyLFU admission decision: should `candidate` displace
// `victim`? True when the client heat sketch estimates the candidate's
// access frequency strictly above the victim's; always true under FIFO
// policy or while the estimator is disabled. Exposed (rather than
// private to the caches) so tests can pin the decision against a
// hand-computed sketch without driving a full eviction scenario.
bool CacheAdmit(int policy, uint64_t candidate, uint64_t victim);

class FeatureCache {
 public:
  ~FeatureCache();  // returns resident bytes to the global gauge

  // Total byte budget across stripes; 0 disables (Get misses, Put drops).
  void SetCapacity(size_t budget);
  bool enabled() const { return cap_ != 0; }
  // Admission policy (CachePolicy); default frequency-aware.
  void SetPolicy(int policy) { policy_ = policy; }
  int policy() const { return policy_; }

  // FNV-1a over the (fids, dims) request shape — the spec half of the key.
  static uint64_t SpecHash(const int32_t* fids, const int32_t* dims, int nf);

  // On hit, copy row_dim floats into out and return true. `gen` is the
  // caller's cache generation: an entry filled under an older one is
  // evicted here (epoch_stale_hits_evicted) and the probe misses.
  bool Get(uint64_t spec, uint64_t id, float* out, size_t row_dim,
           uint64_t gen);
  // Insert a fetched row tagged with the caller's generation (no-op
  // when disabled, already present at this generation, or rejected by
  // frequency-aware admission — rejections counted). A resident entry
  // from an older generation is replaced, not kept.
  void Put(uint64_t spec, uint64_t id, const float* row, size_t row_dim,
           uint64_t gen);

  // Resident payload bytes (approximate: entry overhead included) —
  // observability for tests pinning the capacity bound.
  size_t bytes() const;

 private:
  struct Entry {
    uint64_t spec;
    uint64_t id;
    uint64_t gen;  // cache generation the row was filled under
    std::vector<float> row;
  };
  struct Stripe {
    mutable std::mutex mu;
    std::unordered_map<uint64_t, Entry> map EG_GUARDED_BY(mu);
    // insertion order of map keys
    std::deque<uint64_t> fifo EG_GUARDED_BY(mu);
    size_t bytes EG_GUARDED_BY(mu) = 0;
  };
  static constexpr int kStripes = 16;
  // ~per-entry bookkeeping cost charged against the budget on top of the
  // row payload (map node + fifo slot + Entry header).
  static constexpr size_t kEntryOverhead = 96;

  static uint64_t Mix(uint64_t spec, uint64_t id);

  size_t cap_ = 0;
  int policy_ = kCachePolicyFreq;
  Stripe stripes_[kStripes];
};

// Minimum client-sketch frequency estimate at which SampleNeighbor
// promotes a missed node into the neighbor cache (fetching its full
// adjacency costs one kFullNeighbor round; a node must be provably hot
// before that spend amortizes). Deliberately a small power of two so
// the promotion point is easy to drive deterministically in tests.
constexpr uint64_t kNbrPromoteMinFreq = 8;

class NeighborCache {
 public:
  ~NeighborCache();  // returns resident bytes to the global gauge

  void SetCapacity(size_t budget);
  bool enabled() const { return cap_ != 0; }
  void SetPolicy(int policy) { policy_ = policy; }

  // FNV-1a over the requested edge-type set — the spec half of the key
  // (the same id asked with different etypes is a different slice).
  static uint64_t SpecHash(const int32_t* etypes, int net);

  // On hit, draw `count` neighbors proportional to edge weight from the
  // cached slice into out_* (the GraphStore::SampleNeighbors
  // distribution: weight-proportional across the union of the
  // requested edge-type groups; an empty or zero-weight slice fills
  // default_id/-1 like the engine does) and return true. A slice filled
  // under an older generation than `gen` is evicted and the probe
  // misses (epoch_stale_hits_evicted).
  bool Sample(uint64_t spec, uint64_t id, int count, uint64_t default_id,
              Rng& rng, uint64_t* out_ids, float* out_w, int32_t* out_t,
              uint64_t gen);

  // Insert one node's full adjacency slice over the spec's edge types
  // (parallel arrays, n entries; n == 0 caches the empty slice — a
  // leaf hub's "no neighbors" answer is as cacheable as any other),
  // tagged with the caller's cache generation.
  void Put(uint64_t spec, uint64_t id, const uint64_t* nbr_ids,
           const float* nbr_w, const int32_t* nbr_t, size_t n,
           uint64_t gen);

  size_t bytes() const;

 private:
  struct Entry {
    uint64_t spec;
    uint64_t id;
    uint64_t gen;  // cache generation the slice was filled under
    std::vector<uint64_t> ids;
    std::vector<float> w;
    std::vector<int32_t> t;
    std::vector<double> cum;  // weight prefix sums (sampling table)
  };
  struct Stripe {
    mutable std::mutex mu;
    std::unordered_map<uint64_t, Entry> map EG_GUARDED_BY(mu);
    std::deque<uint64_t> fifo EG_GUARDED_BY(mu);
    size_t bytes EG_GUARDED_BY(mu) = 0;
  };
  static constexpr int kStripes = 16;
  static constexpr size_t kEntryOverhead = 160;  // 4 vectors + map node

  static size_t EntryCost(size_t n) {
    return n * (sizeof(uint64_t) + sizeof(float) + sizeof(int32_t) +
                sizeof(double)) +
           kEntryOverhead;
  }
  static uint64_t Mix(uint64_t spec, uint64_t id);

  size_t cap_ = 0;
  int policy_ = kCachePolicyFreq;
  Stripe stripes_[kStripes];
};

}  // namespace eg

#endif  // EG_CACHE_H_
