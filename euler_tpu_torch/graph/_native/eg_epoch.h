// Snapshot epochs: the mutable-graph refresh path over an immutable core.
//
// GraphStore is deliberately immutable after Build() — that is what makes
// every read lock-free (eg_graph.h). This layer adds mutation WITHOUT
// giving that up: a graph refresh builds a completely fresh immutable
// snapshot (base partitions merged with every delta applied so far) and
// then FLIPS the serving pointer, RCU-style. Readers pin the epoch they
// started on; a flip retires the previous epoch only after its in-flight
// readers drain (refcount, not a reader lock — the read path stays
// wait-free). The table keeps a window of kEpochKeep epochs (current +
// previous) so multi-hop operations that began just before a flip finish
// against the exact snapshot they started on; epoch N-2 is dropped at the
// flip to N, and its engine memory is freed when the last pin releases.
//
// Ledger contract (eg_stats.h): every flip counts epoch_flips; every
// retired snapshot counts epoch_drains exactly once — at the flip when
// nothing was pinned, or when its last pinned reader releases. The two
// counters together account for every dropped epoch: flips == drains
// once the system is quiescent.
//
// Delta files (`<prefix>.delta.<n>`, magic EGD1) carry the refresh
// payload: removed node ids, removed edge keys, and a standard .dat
// block stream of added/replaced records (updated feature rows are full
// replacement records — GraphStore::Build's first-occurrence-wins dedup
// makes the newest delta authoritative when stagings are merged
// newest-first). A flip rebuilds from base + ALL deltas, so the flipped
// store is bit-identical to a fresh load of the same merged inputs.
#ifndef EG_EPOCH_H_
#define EG_EPOCH_H_

#include <atomic>
#include <cstdint>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_set>
#include <vector>

#include "eg_common.h"
#include "eg_engine.h"
#include "eg_graph.h"

namespace eg {

// One immutable published snapshot. `pins` counts in-flight readers;
// `superseded` flips true when a newer epoch is published; the drain is
// counted exactly once via `drain_counted` (flip and release race to the
// exchange, whichever observes pins==0 with superseded set wins).
struct EpochSnapshot {
  uint64_t epoch = 0;
  std::shared_ptr<Engine> engine;
  std::atomic<int64_t> pins{0};
  std::atomic<bool> superseded{false};
  std::atomic<bool> drain_counted{false};
};

// RAII reader pin. Holds the snapshot alive (shared_ptr) AND holds its
// drain back (refcount) for the pin's lifetime; move-only.
class EpochPin {
 public:
  EpochPin() = default;
  explicit EpochPin(std::shared_ptr<EpochSnapshot> snap)
      : snap_(std::move(snap)) {}
  EpochPin(EpochPin&& o) noexcept : snap_(std::move(o.snap_)) {}
  EpochPin& operator=(EpochPin&& o) noexcept {
    if (this != &o) {
      Release();
      snap_ = std::move(o.snap_);
    }
    return *this;
  }
  EpochPin(const EpochPin&) = delete;
  EpochPin& operator=(const EpochPin&) = delete;
  ~EpochPin() { Release(); }

  explicit operator bool() const { return snap_ != nullptr; }
  Engine* engine() const { return snap_ ? snap_->engine.get() : nullptr; }
  uint64_t epoch() const { return snap_ ? snap_->epoch : 0; }

 private:
  void Release();

  std::shared_ptr<EpochSnapshot> snap_;
};

// The per-shard epoch table. Pin() is the only read entry point; Flip()
// the only publish. current() is a lock-free peek for gauges and reply
// stamping.
class EpochTable {
 public:
  // Epochs kept pinnable: current + previous. In-flight ops started on
  // the previous epoch finish there; anything older is already drained
  // by construction (it was superseded one whole flip ago).
  static constexpr int kEpochKeep = 2;

  // Install the initial snapshot (epoch `epoch`, usually 0 for a plain
  // base load). Not a flip: nothing is counted, nothing superseded.
  void Reset(std::shared_ptr<Engine> engine, uint64_t epoch = 0);

  uint64_t current() const {
    return current_.load(std::memory_order_acquire);
  }

  // Pin a snapshot: `requested` = 0 pins current; nonzero pins that
  // epoch IF the table still holds it, else falls back to current (the
  // wire contract — a too-old pin gets the freshest answer rather than
  // an error). Returns an empty pin only before Reset().
  EpochPin Pin(uint64_t requested = 0) const;

  // Publish `next` as epoch current+1, supersede the previous epoch
  // (counting its drain immediately when nothing is pinned), and drop
  // epoch N-2 from the keep window. Returns the new epoch.
  uint64_t Flip(std::shared_ptr<Engine> next);

 private:
  mutable std::mutex mu_;
  // Ascending by epoch; back() is current. Never more than kEpochKeep.
  std::vector<std::shared_ptr<EpochSnapshot>> held_ EG_GUARDED_BY(mu_);
  std::atomic<uint64_t> current_{0};
};

// ---- delta files ----

// Parsed `<prefix>.delta.<n>` file. Layout (all WireReader-framed,
// little-endian, counts bounded by remaining() before allocation):
//   "EGD1" [u32 version=1] [u64 seq]
//   [Arr u64 removed_nodes]
//   [Arr u64 rme_src] [Arr u64 rme_dst] [Arr i32 rme_type]
//   [Str dat_blob]            -- standard .dat block stream of
//                                added/replaced node + edge records
struct DeltaFile {
  uint64_t seq = 0;
  std::vector<uint64_t> removed_nodes;
  std::vector<uint64_t> rme_src, rme_dst;  // removed edge keys
  std::vector<int32_t> rme_type;
  std::string dat_blob;
  Staging staged;  // dat_blob parsed; reused (copied) every flip

  // Parse + stage. False + *error on bad magic/version, truncation,
  // trailing bytes, mismatched removed-edge columns, or a dat_blob
  // parse failure.
  bool Parse(const char* data, size_t size, std::string* error);
  // Reject contradictory edits: duplicate node records, duplicate edge
  // records, duplicate removal entries, a node both removed and
  // present, an edge both removed and re-emitted. Run after Parse and
  // BEFORE shard filtering (contradictions are authoring bugs — every
  // shard must refuse the file identically).
  bool Validate(std::string* error) const;
};

// Which delta records a shard keeps: nodes it owns (and edge records
// whose src it owns), mirroring the partition-file routing of
// Engine::Load — partition p = id mod num_partitions, shard owns
// p ≡ shard_idx (mod shard_num).
struct ShardOwnership {
  int shard_idx = 0;
  int shard_num = 1;
  int num_partitions = 1;

  bool OwnsNode(uint64_t id) const {
    if (shard_num <= 1) return true;
    uint64_t p = num_partitions > 0
                     ? id % static_cast<uint64_t>(num_partitions)
                     : id;
    return p % static_cast<uint64_t>(shard_num) ==
           static_cast<uint64_t>(shard_idx);
  }
};

// Drop added records the shard does not own (node records by id, edge
// records by src). Removal sets are deliberately NOT filtered: removals
// are cheap id sets, and an edge record referencing a node removed on
// ANOTHER shard must still be dropped here.
bool FilterDeltaToShard(DeltaFile* d, const ShardOwnership& own,
                        std::string* error);

// Drop removed nodes (record + feature slices), removed adjacency
// entries (the (src, nbr, type) keys in rm_edges, with group counts and
// weights adjusted), and removed/endpoint-removed edge records from a
// staging. Adjacency entries pointing AT a removed node in other nodes'
// groups are left in place — they resolve like any missing-node
// neighbor. False + *error when the staging's internal shapes are
// inconsistent (slice counts overrun the value arrays).
bool FilterStaging(
    Staging* s, const std::unordered_set<uint64_t>& rm_nodes,
    const std::unordered_set<EdgeKey, EdgeKeyHash>& rm_edges,
    std::string* error);

// Build one fresh Engine from base partition files merged with every
// delta (ascending seq, already Validated and shard-filtered). Stagings
// are ordered newest-delta-first then base, each filtered by the
// removal sets of strictly NEWER deltas — with Build's first-wins
// dedup, the result is bit-identical to a fresh load of the same
// merged inputs. Base files parse in a strided worker pool.
bool BuildMergedEngine(std::vector<std::string> base_files,
                       const std::vector<DeltaFile>& deltas,
                       std::shared_ptr<Engine>* out, std::string* error);

// Local (embedded) graph path: parse + validate `delta_paths`, merge
// them over `base_files`, and adopt the result into `eng` in place (the
// C-ABI handle identity stays stable). Epoch ends at the delta count.
bool LoadEngineWithDeltas(Engine* eng,
                          std::vector<std::string> base_files,
                          const std::vector<std::string>& delta_paths,
                          std::string* error);

}  // namespace eg

#endif  // EG_EPOCH_H_
