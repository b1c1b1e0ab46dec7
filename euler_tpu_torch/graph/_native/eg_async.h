// Staging state of the asynchronous remote sampler.
//
// The sync remote path (eg_remote.cc SampleNeighbor) keeps its whole
// scatter/gather state on the caller's stack: the caller blocks in
// Dispatcher::Run, so stack lifetime covers every worker job. The async
// path (SampleFanoutAsync) has no blocked caller — hop h+1's jobs are
// enqueued by hop h's completion continuation on the dispatcher pool
// (arXiv 2110.08450's overlap, FastSample's communication-tax cut) — so
// the same state must live in heap objects that survive the submitting
// frame. This header holds those objects; both paths run the SAME
// NbrPrep/NbrFetchChunk/NbrPromoteChunk/NbrFinish member functions over
// them, which is what pins async sampling distribution-identical to
// sync (tests/test_async_parity.py).
#ifndef EG_ASYNC_H_
#define EG_ASYNC_H_

#include <cstdint>
#include <memory>
#include <vector>

#include "eg_common.h"

namespace eg {

// How one request's ids scatter to shards after (optional) coalescing:
// per shard the unique ids' first-occurrence row list plus per-entry
// duplicate counts, and for every ORIGINAL row the (shard, unique
// position, occurrence index) it resolves to — the row maps replies
// scatter back through. (Hoisted out of RemoteGraph so the async op
// state below can embed one; built by RemoteGraph::BuildPlan.)
struct ShardPlan {
  std::vector<std::vector<int32_t>> rows;  // [shard] -> unique rows
  std::vector<std::vector<int32_t>> reps;  // [shard] -> dup count/unique
  std::vector<int32_t> shard_of;           // [orig row]
  std::vector<int32_t> pos_of;             // [orig row] -> unique pos
  std::vector<int32_t> occ_of;             // [orig row] -> occurrence
  int64_t coalesced = 0;                   // rows removed from the wire
};

// One SampleNeighbor call's inputs + per-shard staging, factored out of
// the former monolithic method body. Input pointers are BORROWED — they
// must outlive the call (the sync path borrows the caller's arguments;
// the async path points into its op's owned copies and the previous
// hop's output buffers). Staging buffers are written by dispatcher
// workers in disjoint blocks (each unique entry owns
// reps[j] * count draws at rep_off[j] * count), so the batch needs no
// lock of its own: the dispatcher's batch completion is the barrier.
struct NbrCall {
  // inputs
  const uint64_t* ids = nullptr;
  int n = 0;
  const int32_t* etypes = nullptr;
  int net = 0;
  int count = 0;
  uint64_t default_id = 0;
  uint64_t* out_ids = nullptr;
  float* out_w = nullptr;
  int32_t* out_t = nullptr;
  // staging (filled by RemoteGraph::NbrPrep)
  ShardPlan plan;
  std::vector<std::vector<int64_t>> rep_off;  // [shard] rep prefix sums
  std::vector<std::vector<uint64_t>> sid;     // [shard] staged draw ids
  std::vector<std::vector<float>> sw;         // [shard] staged weights
  std::vector<std::vector<int32_t>> st;       // [shard] staged types
  std::vector<std::vector<char>> ok;          // [shard] per-unique entry
  std::vector<std::vector<int32_t>> fetch;    // unique pos on the wire
  std::vector<std::vector<int32_t>> promote;  // unique pos to promote
  uint64_t nspec = 0;          // NeighborCache::SpecHash(etypes, net)
  uint64_t nbr_hits = 0, nbr_misses = 0;
  bool heat_on = false;
  bool use_ncache = false;
  // Snapshot-epoch capture (eg_epoch.h): `gen` keys every cache probe/
  // fill of this call, `pin[s]` is the epoch requested from shard s in
  // v4 envelopes — so all of a call's chunks read ONE snapshot even
  // when a delta flip lands mid-call. NbrPrep captures both from the
  // graph's last-observed state unless the async chain already stamped
  // the whole op's capture (epoch_captured).
  uint64_t gen = 0;
  std::vector<uint64_t> pin;  // [shard] requested epoch; empty = current
  bool epoch_captured = false;
};

// One in-flight whole-step async fan-out (RemoteGraph::SampleFanoutAsync
// slot). The op OWNS copies of the request arrays — the submitting
// caller's frame (a ctypes call from the Python pipeline driver) unwinds
// immediately — but only BORROWS the per-hop output buffers, which the
// caller pins until TakeAsync returns (graph.py's handle object holds
// the numpy arrays).
//
// Cursor discipline: hop/slice_off/cur/cur_n/et/call are written by
// exactly one thread at a time — the submitter until the first
// SubmitDetached, then whichever worker runs each completion
// continuation — with the dispatcher's queue and batch mutexes
// supplying the happens-before edge between writers. `state` is the
// only field read concurrently (Poll/Take/destructor vs the chain) and
// is guarded by RemoteGraph::async_mu_.
struct AsyncSampleOp {
  enum State { kFree = 0, kRunning, kDone };

  // owned request copies
  std::vector<uint64_t> ids;
  std::vector<int32_t> etypes_flat, etype_counts, counts;
  int n = 0, nhops = 0;
  uint64_t default_id = 0;
  // borrowed per-hop output buffers (pinned by the caller)
  std::vector<uint64_t*> out_ids;
  std::vector<float*> out_w;
  std::vector<int32_t*> out_t;

  // hop/slice cursor (single-writer handoff, see above)
  int hop = 0;
  int64_t slice_off = 0;
  int64_t cur_n = 0;
  const uint64_t* cur = nullptr;
  const int32_t* et = nullptr;
  std::unique_ptr<NbrCall> call;  // current slice's staging
  // Whole-op epoch capture (eg_epoch.h), stamped at submit and copied
  // into every slice's NbrCall: an in-flight step keeps reading the
  // snapshot it started on even when a shard flips between its hops
  // (the server holds the previous epoch for exactly this reader).
  uint64_t gen = 0;
  std::vector<uint64_t> pin;

  int state EG_GUARDED_BY(async_mu_) = kFree;
};

}  // namespace eg

#endif  // EG_ASYNC_H_
