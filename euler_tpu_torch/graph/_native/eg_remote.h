// Remote sharded graph client.
//
// Role equivalent of the reference RemoteGraph + RpcManager stack
// (reference euler/client/remote_graph.{h,cc}, remote_graph_shard.cc,
// rpc_manager.{h,cc}, rpc_client.cc): partition routing
// shard(id) = (id % num_partitions) % num_shards (remote_graph.h:118-129),
// per-request scatter by shard + ordered gather merge
// (remote_graph.cc:33-66,241-261), weighted cross-shard global sampling
// proportional to per-shard weight sums (REMOTE_SAMPLE,
// remote_graph.cc:195-221), node2vec-biased walking via client-side
// sorted-neighbor merge (graph.cc:120-151), and per-shard replica pools with
// retry + timed bad-host quarantine (rpc_manager.h:68-122,
// rpc_client.cc:29-49). Differences: the transport is the zero-dependency
// wire protocol of eg_wire.h instead of gRPC, calls are batch-synchronous,
// and discovery is the flat-file registry of eg_service.h instead of
// ZooKeeper.
//
// Hot-path shape (this file's perf contract, PERF.md "Remote path"):
//   * scatter/gather runs on a PERSISTENT worker pool (eg_dispatch.h) —
//     no thread create/join per query; large per-shard requests are
//     split into `chunk_ids=`-bounded chunks issued concurrently over
//     multiple pooled sockets (`rpc_chunks` counter);
//   * duplicate ids are COALESCED before wire encode (`coalesce=1`
//     default; `ids_deduped` counter) — one wire id and one shard lookup
//     per unique id, replies scattered back through the row maps; for
//     SampleNeighbor the kSampleNeighborUniq op carries repeat counts so
//     duplicate rows still receive independent draws;
//   * dense feature rows are served from a capacity-bounded client cache
//     (eg_cache.h, `feature_cache_mb=`, `cache_hits`/`cache_misses`) —
//     each SNAPSHOT is immutable, so cached rows only invalidate when a
//     shard announces a new epoch (eg_epoch.h): every v4 Ok reply stamps
//     the shard's serving epoch, ObserveEpoch bumps the client cache
//     generation on change, and stale-generation entries evict lazily on
//     their next probe (`epoch_stale_hits_evicted`).
#ifndef EG_REMOTE_H_
#define EG_REMOTE_H_

#include <atomic>
#include <condition_variable>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include "eg_api.h"
#include "eg_async.h"
#include "eg_cache.h"
#include "eg_dispatch.h"
#include "eg_engine.h"
#include "eg_placement.h"
#include "eg_sampling.h"
#include "eg_wire.h"

namespace eg {

// Connection pool over the replicas of one shard: round-robin with
// quarantine of failing hosts, idle-socket reuse, retry across replicas.
// The replica set is mutable at runtime (mid-run re-discovery, the role
// of the reference's ZK watch callbacks adding/removing channels while
// training runs, rpc_manager.h:77-80): Call snapshots the shared_ptr
// vector under a brief lock, so Update never invalidates an in-flight
// exchange — a dropped replica's sockets close when its last reference
// (pool or call) goes away.
class ConnPool {
 public:
  struct Replica {
    ~Replica();  // closes pooled sockets
    std::string host;
    int port = 0;
    std::atomic<int64_t> bad_until_ms{0};
    // Negotiated wire version: 0 = unknown (probe with the newest
    // envelope and learn from the first reply), 1 = downgraded to raw
    // v1 (pre-envelope server), 2..kWireVersion = pinned at the highest
    // version the replica accepted (the BadVersion ladder steps down
    // one version per refusal). See eg_wire.h for the contract.
    std::atomic<int> wire_version{0};
    std::mutex mu;
    std::vector<int> idle;  // pooled connected sockets
  };

  void AddReplica(const std::string& host, int port);
  // Which shard this pool serves — stamped into client-side telemetry
  // spans (eg_telemetry.h) so a slow call names its shard.
  void SetShard(int s) { shard_ = s; }
  // Replace the replica set: existing (host, port) entries keep their
  // Replica object (pooled sockets + quarantine state survive), new
  // addresses are added, missing ones dropped. An empty `addrs` is a
  // no-op — a transiently empty/unreachable listing must never strand
  // the pool with zero replicas.
  void Update(const std::vector<std::pair<std::string, int>>& addrs);

  size_t num_replicas() const;

  // Pin every replica's wire version instead of negotiating: 1 emulates
  // a pre-envelope client (raw v1 requests, no deadline stamped), 2
  // forces the deadline envelope without a trace id, 3 the trace
  // envelope without an epoch, 4 the full epoch envelope. 0 (default)
  // negotiates per replica (v4 probe; an old server's reply walks the
  // replica down the 4 -> 3 -> 2 -> 1 ladder).
  void SetForcedWireVersion(int v) { forced_version_ = v; }

  // Install the flip-announcement hook (eg_epoch.h): called with the
  // serving epoch stamped on every v4 Ok reply, after the stamp is
  // stripped from the reply body. Runs on whatever thread completed the
  // exchange (dispatcher workers) — the observer must be thread-safe.
  // Set once at init, before any Call.
  void SetEpochObserver(std::function<void(uint64_t)> fn) {
    epoch_observer_ = std::move(fn);
  }

  // One request/reply exchange; retries across replicas with exponential
  // backoff (full jitter, base backoff_ms, capped at 2 s) between
  // attempts and an overall deadline spanning all of them (deadline_ms;
  // 0 = timeout_ms * (retries + 1), the previous worst case). The clock
  // is re-sampled per attempt so quarantine verdicts and the deadline see
  // time spent in earlier attempts. Returns false when every attempt
  // failed or the deadline expired (reply undefined). Failure counters
  // (eg_stats.h Counters) record dial failures, retries, quarantines,
  // failovers, deadline aborts, and exhausted calls.
  //
  // Server survivability reactions (wire v2, eg_admission.h):
  //   * the call's REMAINING deadline is stamped into each attempt's
  //     envelope, so a drowning server can refuse dead work;
  //   * a kStatusBusy reply fails over to the next replica IMMEDIATELY —
  //     no backoff burned, no quarantine (the server is alive, just
  //     shedding), counted in busy_failovers; only the overall deadline
  //     bounds a fully-busy cluster;
  //   * a kStatusDeadline reply ends the call at once (the budget is
  //     gone either way), counted like a client-side deadline abort;
  //   * an old server's "unknown op" answer to the envelope downgrades
  //     the replica to v1 and resends raw on the same connection
  //     (wire_downgrades).
  // Thread-safe: chunked requests Call the same pool concurrently from
  // several dispatcher workers, each exchange on its own pooled socket.
  //
  // `req_epoch` (eg_epoch.h) rides the v4 envelope: 0 asks for the
  // shard's current snapshot, nonzero pins the request to that epoch
  // when the shard still holds it (an in-flight multi-hop step keeps
  // reading the snapshot it started on across a flip). Replicas
  // negotiated below v4 simply drop the field — they serve their only
  // epoch anyway.
  bool Call(const std::string& req, std::string* reply, int retries,
            int timeout_ms, int quarantine_ms, int backoff_ms = 20,
            int deadline_ms = 0, uint64_t req_epoch = 0) const;

 private:
  mutable std::mutex mu_;  // guards replicas_ (the vector, not the pools)
  std::vector<std::shared_ptr<Replica>> replicas_;
  mutable std::atomic<size_t> rr_{0};
  int forced_version_ = 0;  // 0 = negotiate per replica
  int shard_ = -1;          // telemetry label only
  // v4 reply-stamp hook (SetEpochObserver); empty = stamps discarded.
  std::function<void(uint64_t)> epoch_observer_;
};

class RemoteGraph : public GraphAPI {
 public:
  // Config: semicolon-separated k=v (string form shared with the reference's
  // GraphConfig, graph_config.cc:33-56). Keys:
  //   registry=<dir>        flat-file registry written by Service::Start, OR
  //   shards=<h:p|h:p,...>  explicit per-shard replica lists
  //                         (',' separates shards, '|' separates replicas)
  //   retries (default 3), timeout_ms (5000), quarantine_ms (3000),
  //   backoff_ms (20): base of the exponential retry backoff (full
  //   jitter, doubling per attempt, capped at 2 s; 0 = no backoff),
  //   deadline_ms (0 = timeout_ms * (retries + 1)): overall wall-clock
  //   budget of ONE Call spanning all of its retry attempts,
  //   fault= / fault_seed=: deterministic transport failpoints
  //   (process-global FaultInjector, see eg_fault.h and FAULTS.md),
  //   rediscover_ms (default 3000 with registry=, 0 = off): period of the
  //   background registry re-LIST that diffs shard addresses into the
  //   ConnPools — the reference's ZK watch-children semantics
  //   (zk_server_monitor.cc:252-260 OnAddChild/OnRemoveChild) by polling,
  //   so a shard restarted on a NEW address is re-learned mid-run.
  // Hot-path keys (all optional):
  //   coalesce (default 1): dedup duplicate ids before wire encode
  //     (`ids_deduped`); 0 restores the pre-dedup wire shape (the bench
  //     A/B baseline),
  //   feature_cache_mb (default 64; 0 = off): byte budget of the
  //     client-side dense-feature-row cache (eg_cache.h),
  //   neighbor_cache_mb (default 16; 0 = off): byte budget of the
  //     client-side neighbor-list cache (eg_cache.h NeighborCache):
  //     nodes the heat sketch marks hot get their full adjacency slice
  //     fetched once (kFullNeighbor) and every later SampleNeighbor
  //     draw for them is served locally — distribution-identical to
  //     the shard engine (`nbr_cache_hits`/`nbr_cache_misses`),
  //   cache_policy (default "freq"; "fifo" restores PR-3 behavior):
  //     admission policy of BOTH client caches — "freq" is TinyLFU-
  //     shaped (a candidate displaces the FIFO victim only when the
  //     heat sketch estimates it hotter; `cache_admit_rejects`),
  //   placement (default 1; 0 = never ask): fetch the shard's
  //     placement map at init (kPlacement) and route ids through it
  //     (shard = map[id] % num_shards), hash fallback for unmapped ids
  //     and for servers without a map — old servers answer the stock
  //     unknown-op error, counted in `placement_fallbacks`,
  //   chunk_ids (default 16384): max unique ids per wire request; larger
  //     per-shard requests split into concurrent chunks (`rpc_chunks`),
  //   dispatch_workers (default 0 = auto: min(64, max(8, 2*shards))):
  //     size of the persistent dispatcher pool,
  //   strict (default 0): a shard call that fails after all transport
  //     retries raises through the C ABI (eg_remote_strict_error) instead
  //     of silently degrading its rows to defaults. Either way the
  //     failure is counted in `rpc_errors`.
  // Observability keys (eg_telemetry.h / eg_heat.h; process-global):
  //   telemetry (default 1): 0 disables histograms + slow-span journals
  //     (counters and stats keep recording — the kill-switch covers the
  //     new subsystem only),
  //   slow_spans (default 32): slowest-N span journal capacity,
  //   heat (default 1): 0 disables the data-plane access profiler
  //     (hot-vertex top-K + sketch feeds, fan-out attribution,
  //     cache-efficacy classes; telemetry=0 silences it too),
  //   heat_topk (default 128, max 1024): hot-key tracker capacity
  //     (resizing resets the tables).
  bool Init(const std::string& config);
  ~RemoteGraph() override;  // stops the re-discovery thread + dispatcher
  const std::string& error() const { return error_; }

  int num_shards() const { return num_shards_; }
  int num_partitions() const { return num_partitions_; }
  size_t num_replicas(int shard) const {
    return shard >= 0 && shard < num_shards_ ? pools_[shard].num_replicas()
                                             : 0;
  }
  // Liveness probe of one live shard (kPing opcode): one empty
  // request/ok-reply round trip through the full transport stack —
  // retries, deadline and wire-version negotiation included — so a
  // health checker exercises exactly the path real calls take. False
  // on transport failure / bad shard index.
  bool PingShard(int shard) const;
  // Telemetry scrape of one live shard (kStats opcode, eg_telemetry.h):
  // the shard's counters + span-timer stats + latency histograms +
  // admission gauges + slow-span journal as one JSON string — the same
  // document Telemetry::Json builds locally, so scrape-vs-local parity
  // is a field compare. False on transport failure / bad shard index.
  bool ScrapeShard(int shard, std::string* json) const;
  // Resource-gauge history of one live shard (kHistory opcode,
  // eg_blackbox.h): the shard's background-sampled RSS/fds/threads/
  // cache ring as JSON — the live twin of a postmortem's frozen
  // resource_history. False on transport failure / bad shard index.
  bool HistoryShard(int shard, std::string* json) const;
  // Data-plane heat of one live shard (kHeat opcode, eg_heat.h): the
  // shard's full hot-vertex top-K table, sketch totals, per-op ids
  // ledger and cache classes as JSON — the targeted scrape
  // scripts/heat_dump.py builds its skew report from. False on
  // transport failure / bad shard index.
  bool HeatShard(int shard, std::string* json) const;
  // ---- snapshot epochs (eg_epoch.h) ----
  // Highest serving epoch observed across shards (v4 reply stamps +
  // registry heartbeat tokens); 0 until any shard announces a flip.
  uint64_t Epoch() const override;
  // Per-shard last-observed epoch (metrics surface; 0 = none observed).
  uint64_t ShardEpoch(int shard) const {
    return shard_epoch_ && shard >= 0 && shard < num_shards_
               ? shard_epoch_[shard].load(std::memory_order_relaxed)
               : 0;
  }
  // Cache generation: bumped whenever any shard's observed epoch moves.
  // Python-side sample caches key on this the same way the native
  // feature/neighbor caches do.
  uint64_t cache_gen() const {
    return cache_gen_.load(std::memory_order_acquire);
  }
  // Ask one shard to merge a delta file and flip (kLoadDelta). The Ok
  // reply's epoch stamp doubles as the flip announcement, so this
  // client's caches invalidate before the call returns. False + *error
  // on transport failure or a shard-side load/validate/merge error.
  bool LoadDelta(int shard, const std::string& path, uint64_t* new_epoch,
                 std::string* error) const;

  // True when init fetched + parsed a placement map and ids route
  // through it (false = hash routing, the compat fallback).
  bool has_placement() const { return placement_.loaded(); }
  // Resolve the serving shard of each id through the SAME routing the
  // query paths use (placement map when loaded, hash otherwise) — the
  // observability hook scripts/heat_dump.py measures edge-cut with.
  void RouteShards(const uint64_t* ids, int n, int32_t* out) const {
    for (int i = 0; i < n; ++i) out[i] = ShardOf(ids[i]);
  }
  // ---- Async whole-step sampling (the eg_remote_sample_async ABI) ----
  // Submit one whole SampleFanout as an in-flight async op: returns a
  // slot handle >= 0, or -1 when all kMaxAsyncOps slots are busy (the
  // caller falls back to the sync path). The request arrays are COPIED;
  // the per-hop output buffers are borrowed and must stay pinned until
  // TakeAsync returns. The hop chain runs entirely on the dispatcher
  // pool: hop h+1's jobs are enqueued by hop h's completion continuation
  // (Dispatcher::SubmitDetached), never by a blocked caller thread —
  // `async_submits` / `async_inflight_peak` / `async_continuations`
  // count the pipeline's shape.
  int SampleFanoutAsync(const uint64_t* ids, int n,
                        const int32_t* etypes_flat,
                        const int32_t* etype_counts, const int32_t* counts,
                        int nhops, uint64_t default_id, uint64_t** out_ids,
                        float** out_w, int32_t** out_t) const;
  // 1 = complete, 0 = still running, -1 = bad/free slot. Non-blocking.
  int PollAsync(int slot) const;
  // Block until the op completes, then recycle its slot (0; -1 on a
  // bad/free slot). Shard failures inside the op degrade exactly like
  // the sync path: default rows + rpc_errors, and under strict= the
  // pending error the Python client polls after the take.
  int TakeAsync(int slot) const;

  // Pending strict-mode failure: copies + clears the first recorded
  // message. Empty string = no pending failure. (The fixed-shape query
  // ABI returns void, so strict failures surface through this side
  // channel — eg_remote_strict_error — which the Python client polls
  // after every remote call.)
  std::string TakeStrictError() const;

  // ---- GraphAPI ----
  int64_t NumNodes() const override { return num_nodes_; }
  int64_t NumEdges() const override { return num_edges_; }
  int32_t NodeTypeNum() const override { return node_type_num_; }
  int32_t EdgeTypeNum() const override { return edge_type_num_; }
  int32_t FeatureNum(int kind) const override {
    return kind >= 0 && kind < 6 ? fnum_[kind] : -1;
  }
  void TypeWeightSums(int kind, float* out) const override;

  void SampleNode(int count, int32_t type, uint64_t* out) const override;
  void SampleEdge(int count, int32_t type, uint64_t* out_src,
                  uint64_t* out_dst, int32_t* out_type) const override;
  void SampleNodeWithSrc(const uint64_t* src, int n, int count,
                         uint64_t* out) const override;
  void GetNodeType(const uint64_t* ids, int n, int32_t* out) const override;
  bool GetNodeWeight(const uint64_t* ids, int n, float* out) const override;

  void SampleNeighbor(const uint64_t* ids, int n, const int32_t* etypes,
                      int net, int count, uint64_t default_id,
                      uint64_t* out_ids, float* out_w,
                      int32_t* out_t) const override;
  void SampleFanout(const uint64_t* ids, int n, const int32_t* etypes_flat,
                    const int32_t* etype_counts, const int32_t* counts,
                    int nhops, uint64_t default_id, uint64_t** out_ids,
                    float** out_w, int32_t** out_t) const override;
  EGResult* GetFullNeighbor(const uint64_t* ids, int n, const int32_t* etypes,
                            int net, bool sorted) const override;
  void GetTopKNeighbor(const uint64_t* ids, int n, const int32_t* etypes,
                       int net, int k, uint64_t default_id, uint64_t* out_ids,
                       float* out_w, int32_t* out_t) const override;

  void RandomWalk(const uint64_t* ids, int n, const int32_t* etypes_flat,
                  const int32_t* etype_counts, int walk_len, float p, float q,
                  uint64_t default_id, uint64_t* out) const override;

  void GetDenseFeature(const uint64_t* ids, int n, const int32_t* fids,
                       const int32_t* dims, int nf,
                       float* out) const override;
  void GetEdgeDenseFeature(const uint64_t* src, const uint64_t* dst,
                           const int32_t* types, int n, const int32_t* fids,
                           const int32_t* dims, int nf,
                           float* out) const override;
  EGResult* GetSparseFeature(const uint64_t* ids, int n, const int32_t* fids,
                             int nf) const override;
  EGResult* GetEdgeSparseFeature(const uint64_t* src, const uint64_t* dst,
                                 const int32_t* types, int n,
                                 const int32_t* fids, int nf) const override;
  EGResult* GetBinaryFeature(const uint64_t* ids, int n, const int32_t* fids,
                             int nf) const override;
  EGResult* GetEdgeBinaryFeature(const uint64_t* src, const uint64_t* dst,
                                 const int32_t* types, int n,
                                 const int32_t* fids, int nf) const override;

 private:
  // ShardPlan lives in eg_async.h now (the async op state embeds one);
  // Build the plan (dedup when coalesce=1; identity grouping otherwise).
  // Adds `coalesced` to the ids_deduped counter.
  void BuildPlan(const uint64_t* ids, int n, ShardPlan* plan) const;
  // Identity plan routed by src id, no dedup — the edge ops key on the
  // (src, dst, type) triple, which node-id coalescing cannot collapse.
  void BuildEdgePlan(const uint64_t* src, int n, ShardPlan* plan) const;

  // One pass of discovery from the recorded source (tcp registry LIST or
  // flat-dir scan) into shard -> replica address lists. False when the
  // source is unreachable (callers keep the current pools). timeout_ms
  // bounds the registry dial: Init passes the full client timeout, the
  // background loop a short one so ~RemoteGraph never waits long for an
  // in-flight re-LIST against a blackholed registry.
  bool Discover(
      std::map<int, std::vector<std::pair<std::string, int>>>* shards,
      int timeout_ms) const;
  // Background poll: Discover + per-shard ConnPool::Update.
  void RediscoverLoop();

  // Partition routing: the placement map (when init fetched one) names
  // each id's partition explicitly — shard = map[id] % S, the inverse
  // of the service's partition-ownership rule p ≡ shard (mod S) — with
  // the hash rule as the fallback for unmapped ids and map-less
  // clusters (old servers / hash-sharded data keep working unchanged).
  inline int ShardOf(uint64_t id) const {
    if (placement_.loaded()) {
      int32_t p = placement_.Lookup(id);
      if (p >= 0)
        return static_cast<int>(static_cast<uint64_t>(p) %
                                static_cast<uint64_t>(num_shards_));
    }
    return static_cast<int>((id % static_cast<uint64_t>(num_partitions_)) %
                            static_cast<uint64_t>(num_shards_));
  }
  // rows[s] = ascending list of row indices owned by shard s (no dedup;
  // the edge ops and the fixed global-sampling ops use this form).
  void GroupByShard(const uint64_t* ids, int n,
                    std::vector<std::vector<int32_t>>* rows) const;
  // Issue req to shard; decode reply past the status byte into *reply.
  // False on transport failure or error status. `epoch` pins the
  // request to a snapshot the shard may still hold (0 = current).
  bool Call(int shard, const std::string& req, std::string* reply,
            uint64_t epoch = 0) const;
  // Flip-announcement sink (ConnPool epoch observer + registry epoch
  // tokens): raises shard_epoch_[shard] monotonically and bumps
  // cache_gen_ on every raise.
  void ObserveEpoch(int shard, uint64_t epoch) const;
  // Record a per-shard op failure: rpc_errors counter, plus the pending
  // strict-mode error under strict=1.
  void ShardFailed(int shard, const char* what) const;
  // Run fn(s) on the persistent dispatcher for every shard with rows;
  // fn returns false on failure (affected rows keep their prefilled
  // defaults; the failure is counted and, under strict=, recorded).
  void ForShards(const std::vector<std::vector<int32_t>>& rows,
                 const char* what,
                 const std::function<bool(int)>& fn) const;
  // Run chunk_fn(s, b, e) over [b, e) slices of lists[s] on the
  // dispatcher, splitting slices longer than chunk_ids_ into concurrent
  // chunks (counted in rpc_chunks when a shard's list splits).
  void RunChunked(const std::vector<std::vector<int32_t>>& lists,
                  const char* what,
                  const std::function<bool(int, int32_t, int32_t)>& chunk_fn)
      const;
  // Weighted multinomial draw of a shard per sample; type==-1 uses totals.
  void DrawShards(bool edges, int32_t type, int count, int* out) const;

  // ---- SampleNeighbor phases (shared by the sync + async paths) ----
  // The former monolithic SampleNeighbor body, split at its natural
  // barriers so the async hop chain can run the middle phase as a
  // detached dispatcher batch. Sync SampleNeighbor is now literally
  // Prep + BuildJobs + dispatcher Run + Finish over a stack NbrCall.
  // Prefill outputs, build the shard plan, split unique entries into
  // CACHED (served locally now) / PROMOTE / FETCH, size the staging.
  void NbrPrep(NbrCall* c) const;
  // One wire chunk of the FETCH (kSampleNeighbor[Uniq]) / PROMOTE
  // (kFullNeighbor + cache + local draw) lists; false on failure
  // (affected entries keep defaults). Run on dispatcher workers.
  bool NbrFetchChunk(NbrCall* c, int s, int32_t b, int32_t e) const;
  bool NbrPromoteChunk(NbrCall* c, int s, int32_t b, int32_t e) const;
  // Emit the chunked fetch + promote jobs (one combined batch — their
  // writes are disjoint) with the standard failure wrapping; counts
  // rpc_chunks exactly like RunChunked.
  void NbrBuildJobs(NbrCall* c,
                    std::vector<std::function<void()>>* jobs) const;
  // Heat fan-out attribution + scatter staged draws to the output rows.
  void NbrFinish(NbrCall* c) const;

  // ---- async hop chain ----
  // Drive op forward from its cursor: prep slices until one has wire
  // work (submit it detached with an OnSliceDone continuation and
  // return) or the fan-out completes (mark kDone, wake waiters).
  void StartSlice(AsyncSampleOp* op) const;
  // Continuation body: finish the completed slice, advance the cursor,
  // keep driving.
  void OnSliceDone(AsyncSampleOp* op) const;
  // Gather merges for variable-length sub-results (ordered re-assembly, the
  // role of the reference's MergeCallback, remote_graph.cc:241-261),
  // scattering each shard's per-unique-row segments back to every
  // original row through the plan's row maps.
  // FullNeighbor layout: u64[0]/f32[0]/i32[0] values + i32[1] row counts.
  EGResult* MergeFullNeighbor(const ShardPlan& plan,
                              std::vector<EGResult>& sub,
                              const std::vector<char>& ok, int n) const;
  // Sparse/binary features: nf slots, values in u64[k] or bytes[k], row
  // counts in i32[k].
  EGResult* MergeSlotted(const ShardPlan& plan, std::vector<EGResult>& sub,
                         const std::vector<char>& ok, int n, int nf,
                         bool u64_vals, bool byte_vals) const;

  std::string error_;
  int num_shards_ = 0, num_partitions_ = 1;
  int retries_ = 3, timeout_ms_ = 5000, quarantine_ms_ = 3000;
  int backoff_ms_ = 20, deadline_ms_ = 0;
  bool coalesce_ = true;
  bool strict_ = false;
  int chunk_ids_ = 16384;
  int dispatch_workers_ = 0;  // 0 = auto

  // discovery source recorded by Init for the periodic re-LIST
  // (empty reg_host_ AND empty reg_dir_ = static shards=, no re-discovery)
  std::string reg_host_;
  int reg_port_ = 0;
  std::string reg_dir_;
  int rediscover_ms_ = 0;
  std::thread rediscover_thread_;
  std::atomic<bool> rediscover_stop_{false};

  int64_t num_nodes_ = 0, num_edges_ = 0;
  int32_t node_type_num_ = 0, edge_type_num_ = 0;
  int32_t fnum_[6] = {0, 0, 0, 0, 0, 0};
  std::vector<float> node_wsum_agg_, edge_wsum_agg_;
  // Per-shard per-type weight sums [shard][type] and totals.
  std::vector<std::vector<float>> shard_node_wsum_, shard_edge_wsum_;

  std::vector<ConnPool> pools_;
  // Persistent scatter/gather pool (created by Init once the shard count
  // is known; jobs are leaf encode/Call/decode closures).
  std::unique_ptr<Dispatcher> dispatcher_;
  // Client-side dense-feature-row cache (safe to mutate from const query
  // methods: internally striped-locked).
  mutable FeatureCache fcache_;
  // Client-side neighbor-list cache (hot nodes' adjacency slices; same
  // striping/mutability story as fcache_).
  mutable NeighborCache ncache_;
  // id -> partition routing map fetched at init (empty = hash routing).
  PlacementMap placement_;
  bool placement_enabled_ = true;  // placement= config key
  // ---- snapshot-epoch client state (eg_epoch.h) ----
  // Last epoch each shard announced (reply stamps / registry tokens);
  // allocated by Init once num_shards_ is known. Mutable: announcements
  // arrive inside const query paths.
  mutable std::unique_ptr<std::atomic<uint64_t>[]> shard_epoch_;
  // Monotonic cache generation; every epoch raise bumps it, and all
  // cache probes/fills (native + the Python sample cache via
  // eg_remote_cache_gen) carry the bump's value.
  mutable std::atomic<uint64_t> cache_gen_{0};
  mutable std::mutex strict_mu_;        // guards strict_error_
  mutable std::string strict_error_;    // first pending strict failure
  // Async op slot pool (SampleFanoutAsync). Sized for the pipeline's
  // worst case — sampler_depth in-flight steps plus poll-side slack —
  // not for generality; a full pool answers -1 and the caller degrades
  // to sync. async_mu_ guards every op's `state` and the in-flight
  // count; the cv wakes TakeAsync waiters and the draining destructor.
  static constexpr int kMaxAsyncOps = 8;
  mutable std::mutex async_mu_;
  mutable std::condition_variable async_cv_;
  mutable AsyncSampleOp async_ops_[kMaxAsyncOps];
  mutable int async_inflight_ EG_GUARDED_BY(async_mu_) = 0;
  // Cross-shard samplers: per type a table over shards, plus totals tables.
  std::vector<PrefixTable> node_shard_by_type_, edge_shard_by_type_;
  PrefixTable node_shard_total_, edge_shard_total_;
};

}  // namespace eg

#endif  // EG_REMOTE_H_
