// Persistent shard-request dispatcher for the remote client — now with
// a completion-queue API.
//
// The pre-dispatcher ForShards fan-out spawned and joined one ephemeral
// std::thread per shard on EVERY query (9 call sites in eg_remote.cc) —
// at Reddit-scale batch rates that is thousands of thread create/join
// pairs per second of pure overhead on the hot path, exactly the
// communication tax FastSample (PAPERS.md, arxiv 2311.17847) and the
// pipelined-sampling line (arxiv 2110.08450) say to cut. This replaces
// it with a single long-lived worker pool owned by the RemoteGraph.
//
// Three submission shapes over the same pool:
//
//   * Run(jobs) — the original blocking batch: submit, sleep until
//     every job drained. All pre-async call sites (ForShards /
//     RunChunked / SampleNodeWithSrc) use this unchanged; it is now
//     literally Submit + Wait.
//   * Submit(jobs) -> BatchHandle, then Poll(h) / Wait(h) — the
//     completion-queue form: the caller keeps running and collects
//     completion later. Handles are recycled from a fixed slot pool
//     (the slot owns the job storage, so the caller's frame may unwind
//     immediately); Wait releases the slot.
//   * SubmitDetached(jobs, on_done) — fire-and-continue: the worker
//     that completes the LAST job of the batch runs `on_done` (outside
//     every dispatcher lock), then the slot self-releases. This is the
//     hop-chain primitive of the async sampler (eg_remote.cc
//     SampleFanoutAsync): hop h+1's jobs are enqueued by hop h's
//     completion continuation, never by a blocked caller thread.
//
// One pool shared across all shards rather than one thread per
// ConnPool: chunked requests to a single shard must be issuable
// concurrently over multiple pooled sockets, which a strict
// one-worker-per-pool design cannot do. Per-shard fairness comes from
// FIFO submission order; the ConnPools themselves stay per-shard.
//
// Concurrency contract: jobs must never call Run()/Wait() themselves (a
// job waiting on workers while holding a worker slot can starve the
// pool). Every eg_remote job is a leaf — encode / Call / decode — so
// this holds by construction. Continuations may SUBMIT new batches
// (that is their purpose) but must not block on them. Multiple client
// threads (prefetch workers) may submit concurrently; batches
// interleave on the shared queue and complete independently.
#ifndef EG_DISPATCH_H_
#define EG_DISPATCH_H_

#include "eg_common.h"

#include <condition_variable>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace eg {

class Dispatcher {
 public:
  // Slot index into the fixed batch pool; valid from Submit until the
  // Wait that releases it.
  using BatchHandle = int;

  // Starts `workers` long-lived threads (clamped to >= 1).
  explicit Dispatcher(int workers);
  // Drains the queue, then stops and joins every worker. No batch may
  // be in flight (the owning RemoteGraph is being destroyed; it drains
  // its async ops first).
  ~Dispatcher();

  Dispatcher(const Dispatcher&) = delete;
  Dispatcher& operator=(const Dispatcher&) = delete;

  // Run every job on the worker pool and block until all complete. The
  // job closures are copied into the batch slot. A throwing job counts
  // as completed: its effects degrade exactly like a failed shard call
  // (callers wrap jobs so failure is recorded before the exception
  // would escape).
  void Run(const std::vector<std::function<void()>>& jobs) const;

  // Non-blocking batch: enqueue `jobs` (storage moves into the slot)
  // and return its handle. Blocks only in the pathological case of all
  // kMaxBatches slots being in flight at once.
  BatchHandle Submit(std::vector<std::function<void()>> jobs) const;

  // True when every job of the batch has completed. Non-blocking; the
  // handle stays valid (poll-loop friendly) until Wait releases it.
  bool Poll(BatchHandle h) const;

  // Block until the batch completes, then recycle its slot. The handle
  // is dead after this returns.
  void Wait(BatchHandle h) const;

  // Detached batch: no handle. The worker completing the last job runs
  // `on_done` (outside the dispatcher and slot locks; exceptions are
  // swallowed — continuations record their own failures), then the
  // slot self-releases. Empty `jobs` runs `on_done` inline on the
  // calling thread.
  void SubmitDetached(std::vector<std::function<void()>> jobs,
                      std::function<void()> on_done) const;

  int workers() const { return static_cast<int>(threads_.size()); }

 private:
  // One slot of the recyclable batch pool. The slot owns its jobs'
  // storage (queue_ tasks point into it) from acquire until release.
  struct Batch {
    std::mutex mu;
    std::condition_variable done;
    size_t remaining EG_GUARDED_BY(mu) = 0;
    bool detached EG_GUARDED_BY(mu) = false;
    std::vector<std::function<void()>> jobs;
    std::function<void()> on_done;
  };
  struct Task {
    const std::function<void()>* fn;  // points into batch->jobs
    Batch* batch;
  };

  // Bounded only to keep handles small and recycling trivial: the sync
  // paths hold at most one slot per calling thread, the async sampler
  // at most one per in-flight op.
  static constexpr int kMaxBatches = 64;

  // Take a free slot (blocking when all are in flight) and arm it.
  int AcquireSlot(std::vector<std::function<void()>> jobs, bool detached,
                  std::function<void()> on_done) const;
  void ReleaseSlot(int slot) const;
  // Push the armed slot's jobs onto the shared queue and wake workers.
  void Enqueue(int slot) const;
  void WorkerLoop();

  mutable std::mutex mu_;  // guards queue_ and stop_
  mutable std::condition_variable cv_;
  mutable std::deque<Task> queue_ EG_GUARDED_BY(mu_);
  bool stop_ EG_GUARDED_BY(mu_) = false;

  // Slot pool. The Batch objects themselves live for the dispatcher's
  // lifetime; free_ holds the indices currently available.
  mutable std::mutex pool_mu_;
  mutable std::condition_variable pool_cv_;
  mutable std::deque<int> free_ EG_GUARDED_BY(pool_mu_);
  mutable std::unique_ptr<Batch[]> batches_;

  std::vector<std::thread> threads_;
};

}  // namespace eg

#endif  // EG_DISPATCH_H_
