// Locality-aware placement map: explicit id -> partition routing.
//
// Hash sharding (shard(id) = (id % P) % S) spreads every vertex
// uniformly, so on power-law graphs every sampled hop fans out to every
// shard — the eg_heat profiler measured a 49.8% edge-cut on the
// reddit_heavytail fixture (PERF.md "Data-plane heat"). The degree-aware
// partitioner in euler_tpu/graph/convert.py closes that gap by
// co-locating hub vertices with their sampled neighborhoods and emitting
// a compact placement artifact (`<prefix>.placement`) next to the .dat
// partitions. GNNSampler (arXiv:2108.11571) and FastSample
// (arXiv:2311.17847) both report skew-aware partitioning as the dominant
// remaining locality lever at scale.
//
// Artifact format (little-endian, written by convert.py, parsed here):
//   [u32 magic 'EGP1'][i32 num_partitions][i64 count]
//   [u64 ids[count]][i32 parts[count]]
//
// Both sides consume it:
//   * shards load the artifact at Service::Start and serve the raw blob
//     through the kPlacement wire op (eg_wire.h). A shard whose data dir
//     has no artifact answers the STOCK "unknown op" error — byte-
//     identical to a genuine pre-placement server, so the client needs
//     exactly one fallback path for both;
//   * clients parse the blob into this read-only open-addressed table
//     and route ShardOf(id) = map[id] % num_shards, hash fallback for
//     unmapped ids (negotiated passively, like wire v2/v3: no extra
//     round trip, old servers and old data keep working unchanged).
//
// Lookup cost: one splitmix64 hash + a short linear probe over a table
// held at <= 50% load — the routing hot path runs it once per unique id
// per query, so it must stay allocation-free and lock-free (the table is
// immutable after Parse).
#ifndef EG_PLACEMENT_H_
#define EG_PLACEMENT_H_

#include <cstdint>
#include <string>
#include <vector>

namespace eg {

constexpr uint32_t kPlacementMagic = 0x31504745;  // "EGP1" little-endian

class PlacementMap {
 public:
  // Parse a serialized artifact into the probe table. False + *err on a
  // malformed blob (bad magic, truncated arrays, out-of-range partition,
  // duplicate id) — a corrupt artifact must fail routing LOUDLY, never
  // misroute quietly. Leaves the map empty on failure.
  bool Parse(const std::string& bytes, std::string* err);

  bool loaded() const { return size_ != 0; }
  int32_t num_partitions() const { return num_partitions_; }
  int64_t size() const { return size_; }

  // Partition of one id; -1 when the id is not mapped (callers fall
  // back to hash routing). Immutable after Parse — safe from any
  // thread without synchronization.
  int32_t Lookup(uint64_t id) const {
    if (size_ == 0) return -1;
    uint64_t mask = static_cast<uint64_t>(slots_.size()) - 1;
    uint64_t i = Hash(id) & mask;
    while (true) {
      const Slot& s = slots_[i];
      if (s.part < 0) return -1;  // empty slot: id absent
      if (s.id == id) return s.part;
      i = (i + 1) & mask;
    }
  }

  void Clear();

 private:
  struct Slot {
    uint64_t id = 0;
    int32_t part = -1;  // -1 = empty
  };

  static uint64_t Hash(uint64_t x) {
    // splitmix64 finalizer — the id-hash family the sketch/cache use
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
  }

  std::vector<Slot> slots_;
  int64_t size_ = 0;
  int32_t num_partitions_ = 0;
};

// Scan `dir` for the converter's "*.placement" artifact and read it into
// *blob. Returns false + *err on an IO error or MULTIPLE artifacts (an
// ambiguous dir must fail the service start, not route by whichever file
// sorts first); a dir with no artifact succeeds with an empty blob — the
// hash-sharded common case.
bool ReadPlacementDir(const std::string& dir, std::string* blob,
                      std::string* err);

}  // namespace eg

#endif  // EG_PLACEMENT_H_
