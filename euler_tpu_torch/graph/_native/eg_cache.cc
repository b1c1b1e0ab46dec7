#include "eg_cache.h"

#include <algorithm>
#include <cstring>

#include "eg_heat.h"
#include "eg_stats.h"

namespace eg {

std::atomic<int64_t>& GlobalCacheBytes() {
  static std::atomic<int64_t> total{0};
  return total;
}

std::atomic<int64_t>& GlobalNbrCacheBytes() {
  static std::atomic<int64_t> total{0};
  return total;
}

bool CacheAdmit(int policy, uint64_t candidate, uint64_t victim) {
  if (policy != kCachePolicyFreq) return true;
  Heat& heat = Heat::Global();
  // No estimator -> no grounds to reject: degrade to FIFO admission
  // rather than rejecting everything on zero-vs-zero estimates.
  if (!heat.enabled()) return true;
  // TinyLFU shape: the candidate must beat the victim STRICTLY — on a
  // tie the resident row wins (it has already paid its fetch).
  return heat.Estimate(kHeatClient, candidate) >
         heat.Estimate(kHeatClient, victim);
}

// ---------------- FeatureCache ----------------

FeatureCache::~FeatureCache() {
  for (auto& st : stripes_)
    GlobalCacheBytes().fetch_sub(static_cast<int64_t>(st.bytes),
                                 std::memory_order_relaxed);
}

void FeatureCache::SetCapacity(size_t budget) {
  cap_ = budget;
  if (cap_ != 0) return;
  for (auto& st : stripes_) {
    std::lock_guard<std::mutex> l(st.mu);
    st.map.clear();
    st.fifo.clear();
    GlobalCacheBytes().fetch_sub(static_cast<int64_t>(st.bytes),
                                 std::memory_order_relaxed);
    st.bytes = 0;
  }
}

uint64_t FeatureCache::SpecHash(const int32_t* fids, const int32_t* dims,
                                int nf) {
  uint64_t h = 0xCBF29CE484222325ULL;  // FNV-1a
  auto mix = [&h](int32_t v) {
    for (int b = 0; b < 4; ++b) {
      h ^= static_cast<uint64_t>((v >> (8 * b)) & 0xFF);
      h *= 0x100000001B3ULL;
    }
  };
  for (int k = 0; k < nf; ++k) mix(fids[k]);
  for (int k = 0; k < nf; ++k) mix(dims[k]);
  return h;
}

uint64_t FeatureCache::Mix(uint64_t spec, uint64_t id) {
  // splitmix64 finalizer over the combined key
  uint64_t z = spec ^ (id + 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

bool FeatureCache::Get(uint64_t spec, uint64_t id, float* out,
                       size_t row_dim, uint64_t gen) {
  if (cap_ == 0) return false;
  uint64_t key = Mix(spec, id);
  Stripe& st = stripes_[key % kStripes];
  std::lock_guard<std::mutex> l(st.mu);
  auto it = st.map.find(key);
  // the full (spec, id, dim) identity is verified: a key collision is a
  // miss, never somebody else's row. (Cache-efficacy hit/miss classes
  // are accounted by the dense-feature caller, which already holds each
  // probed id's frequency class from its heat feed — see eg_heat.h
  // AddCacheClasses; the eviction hook below stays here because only
  // the cache knows its victims.)
  if (it == st.map.end() || it->second.spec != spec || it->second.id != id ||
      it->second.row.size() != row_dim)
    return false;
  if (it->second.gen != gen) {
    // Pre-flip row: evict lazily right here (its fifo slot becomes a
    // harmless dangling key the eviction walk skips) and miss — the
    // caller refetches against the new epoch's snapshot.
    size_t freed = it->second.row.size() * sizeof(float) + kEntryOverhead;
    st.bytes -= freed;
    GlobalCacheBytes().fetch_sub(static_cast<int64_t>(freed),
                                 std::memory_order_relaxed);
    st.map.erase(it);
    Counters::Global().Add(kCtrEpochStaleEvict);
    return false;
  }
  std::memcpy(out, it->second.row.data(), row_dim * sizeof(float));
  return true;
}

void FeatureCache::Put(uint64_t spec, uint64_t id, const float* row,
                       size_t row_dim, uint64_t gen) {
  if (cap_ == 0) return;
  size_t cost = row_dim * sizeof(float) + kEntryOverhead;
  size_t stripe_cap = cap_ / kStripes;
  if (cost > stripe_cap) return;  // a single over-budget row never caches
  uint64_t key = Mix(spec, id);
  Stripe& st = stripes_[key % kStripes];
  std::lock_guard<std::mutex> l(st.mu);
  auto resident = st.map.find(key);
  if (resident != st.map.end()) {
    // racing fetchers at the same generation: first insert wins
    if (resident->second.gen == gen) return;
    // pre-flip row being refreshed: evict it so the new-epoch row lands
    size_t freed =
        resident->second.row.size() * sizeof(float) + kEntryOverhead;
    st.bytes -= freed;
    GlobalCacheBytes().fetch_sub(static_cast<int64_t>(freed),
                                 std::memory_order_relaxed);
    st.map.erase(resident);
    Counters::Global().Add(kCtrEpochStaleEvict);
  }
  while (st.bytes + cost > stripe_cap && !st.fifo.empty()) {
    auto victim = st.map.find(st.fifo.front());
    if (victim != st.map.end()) {
      // Frequency-aware admission (TinyLFU shape): the candidate must
      // beat the FIFO victim's sketch-estimated frequency to displace
      // it — a cold scan row cannot flush a pinned hub row. The dense
      // path feeds the sketch PRE-cache, so the candidate's current
      // access is already in its estimate.
      if (!CacheAdmit(policy_, id, victim->second.id)) {
        Counters::Global().Add(kCtrCacheAdmitReject);
        return;
      }
      size_t freed =
          victim->second.row.size() * sizeof(float) + kEntryOverhead;
      st.bytes -= freed;
      GlobalCacheBytes().fetch_sub(static_cast<int64_t>(freed),
                                   std::memory_order_relaxed);
      // eviction bucketed by the VICTIM's frequency class: a hot row
      // evicted despite admission filtering is exactly the event the
      // cache-efficacy classes exist to expose (ROADMAP item 5)
      Heat::Global().RecordCacheEvent(kHeatCacheEvict, victim->second.id);
      st.map.erase(victim);
    }
    st.fifo.pop_front();
  }
  Entry e;
  e.spec = spec;
  e.id = id;
  e.gen = gen;
  e.row.assign(row, row + row_dim);
  st.map.emplace(key, std::move(e));
  st.fifo.push_back(key);
  st.bytes += cost;
  GlobalCacheBytes().fetch_add(static_cast<int64_t>(cost),
                               std::memory_order_relaxed);
}

size_t FeatureCache::bytes() const {
  size_t total = 0;
  for (const auto& st : stripes_) {
    std::lock_guard<std::mutex> l(st.mu);
    total += st.bytes;
  }
  return total;
}

// ---------------- NeighborCache ----------------

NeighborCache::~NeighborCache() {
  for (auto& st : stripes_)
    GlobalNbrCacheBytes().fetch_sub(static_cast<int64_t>(st.bytes),
                                    std::memory_order_relaxed);
}

void NeighborCache::SetCapacity(size_t budget) {
  cap_ = budget;
  if (cap_ != 0) return;
  for (auto& st : stripes_) {
    std::lock_guard<std::mutex> l(st.mu);
    st.map.clear();
    st.fifo.clear();
    GlobalNbrCacheBytes().fetch_sub(static_cast<int64_t>(st.bytes),
                                    std::memory_order_relaxed);
    st.bytes = 0;
  }
}

uint64_t NeighborCache::SpecHash(const int32_t* etypes, int net) {
  uint64_t h = 0xCBF29CE484222325ULL;  // FNV-1a
  for (int k = 0; k < net; ++k) {
    int32_t v = etypes[k];
    for (int b = 0; b < 4; ++b) {
      h ^= static_cast<uint64_t>((v >> (8 * b)) & 0xFF);
      h *= 0x100000001B3ULL;
    }
  }
  return h;
}

uint64_t NeighborCache::Mix(uint64_t spec, uint64_t id) {
  uint64_t z = spec ^ (id + 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

bool NeighborCache::Sample(uint64_t spec, uint64_t id, int count,
                           uint64_t default_id, Rng& rng, uint64_t* out_ids,
                           float* out_w, int32_t* out_t, uint64_t gen) {
  if (cap_ == 0) return false;
  uint64_t key = Mix(spec, id);
  Stripe& st = stripes_[key % kStripes];
  std::lock_guard<std::mutex> l(st.mu);
  auto it = st.map.find(key);
  if (it == st.map.end() || it->second.spec != spec || it->second.id != id)
    return false;
  if (it->second.gen != gen) {
    // pre-flip adjacency slice: evict lazily and miss — sampling from
    // it could draw a removed edge or miss an added one
    size_t freed = EntryCost(it->second.ids.size());
    st.bytes -= freed;
    GlobalNbrCacheBytes().fetch_sub(static_cast<int64_t>(freed),
                                    std::memory_order_relaxed);
    st.map.erase(it);
    Counters::Global().Add(kCtrEpochStaleEvict);
    return false;
  }
  const Entry& e = it->second;
  double total = e.cum.empty() ? 0.0 : e.cum.back();
  if (total <= 0.0) {
    // empty (or zero-weight) slice: the engine answers defaults — so
    // does the cache, and the answer is a HIT (no wire trip needed)
    for (int j = 0; j < count; ++j) {
      out_ids[j] = default_id;
      out_w[j] = 0.f;
      out_t[j] = -1;
    }
    return true;
  }
  // Weight-proportional draw against the prefix sums — the same
  // distribution GraphStore::SampleNeighbors realizes shard-side
  // (group-prefix walk + in-group cumulative search flatten to one
  // cumulative search over the concatenated groups).
  for (int j = 0; j < count; ++j) {
    double r = rng.NextDouble() * total;
    size_t k = static_cast<size_t>(
        std::lower_bound(e.cum.begin(), e.cum.end(), r) - e.cum.begin());
    if (k >= e.ids.size()) k = e.ids.size() - 1;  // float rounding spill
    out_ids[j] = e.ids[k];
    out_w[j] = e.w[k];
    out_t[j] = e.t[k];
  }
  return true;
}

void NeighborCache::Put(uint64_t spec, uint64_t id, const uint64_t* nbr_ids,
                        const float* nbr_w, const int32_t* nbr_t, size_t n,
                        uint64_t gen) {
  if (cap_ == 0) return;
  size_t cost = EntryCost(n);
  size_t stripe_cap = cap_ / kStripes;
  if (cost > stripe_cap) return;  // an over-budget slice never caches
  uint64_t key = Mix(spec, id);
  Stripe& st = stripes_[key % kStripes];
  std::lock_guard<std::mutex> l(st.mu);
  auto resident = st.map.find(key);
  if (resident != st.map.end()) {
    // racing fetchers at the same generation: first insert wins
    if (resident->second.gen == gen) return;
    // pre-flip slice being refreshed: evict so the new epoch's lands
    size_t freed = EntryCost(resident->second.ids.size());
    st.bytes -= freed;
    GlobalNbrCacheBytes().fetch_sub(static_cast<int64_t>(freed),
                                    std::memory_order_relaxed);
    st.map.erase(resident);
    Counters::Global().Add(kCtrEpochStaleEvict);
  }
  while (st.bytes + cost > stripe_cap && !st.fifo.empty()) {
    auto victim = st.map.find(st.fifo.front());
    if (victim != st.map.end()) {
      if (!CacheAdmit(policy_, id, victim->second.id)) {
        Counters::Global().Add(kCtrCacheAdmitReject);
        return;
      }
      size_t freed = EntryCost(victim->second.ids.size());
      st.bytes -= freed;
      GlobalNbrCacheBytes().fetch_sub(static_cast<int64_t>(freed),
                                      std::memory_order_relaxed);
      st.map.erase(victim);
    }
    st.fifo.pop_front();
  }
  Entry e;
  e.spec = spec;
  e.id = id;
  e.gen = gen;
  e.ids.assign(nbr_ids, nbr_ids + n);
  e.w.assign(nbr_w, nbr_w + n);
  e.t.assign(nbr_t, nbr_t + n);
  e.cum.resize(n);
  double run = 0.0;
  for (size_t k = 0; k < n; ++k) {
    // negative weights cannot enter the sampling mass (the engine's
    // cumulative arrays are built from non-negative edge weights)
    run += nbr_w[k] > 0.f ? static_cast<double>(nbr_w[k]) : 0.0;
    e.cum[k] = run;
  }
  st.map.emplace(key, std::move(e));
  st.fifo.push_back(key);
  st.bytes += cost;
  GlobalNbrCacheBytes().fetch_add(static_cast<int64_t>(cost),
                                  std::memory_order_relaxed);
}

size_t NeighborCache::bytes() const {
  size_t total = 0;
  for (const auto& st : stripes_) {
    std::lock_guard<std::mutex> l(st.mu);
    total += st.bytes;
  }
  return total;
}

}  // namespace eg
