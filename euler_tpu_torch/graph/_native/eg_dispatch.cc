#include "eg_dispatch.h"

namespace eg {

Dispatcher::Dispatcher(int workers) {
  if (workers < 1) workers = 1;
  batches_.reset(new Batch[kMaxBatches]);
  for (int i = 0; i < kMaxBatches; ++i) free_.push_back(i);
  threads_.reserve(static_cast<size_t>(workers));
  for (int i = 0; i < workers; ++i)
    threads_.emplace_back([this] {
      try {
        WorkerLoop();
      } catch (...) {
        // std::terminate barrier (eg-lint: thread-catch): a dead worker
        // only shrinks the pool; remaining workers keep draining
      }
    });
}

Dispatcher::~Dispatcher() {
  {
    std::lock_guard<std::mutex> l(mu_);
    stop_ = true;
  }
  cv_.notify_all();
  for (auto& t : threads_) t.join();
}

void Dispatcher::WorkerLoop() {
  for (;;) {
    Task task{nullptr, nullptr};
    {
      std::unique_lock<std::mutex> l(mu_);
      cv_.wait(l, [this] { return stop_ || !queue_.empty(); });
      if (queue_.empty()) return;  // stop_ set and everything drained
      task = queue_.front();
      queue_.pop_front();
    }
    try {
      (*task.fn)();
    } catch (...) {
      // a throwing job degrades like a failed shard call: its rows keep
      // their prefilled defaults (callers record the failure themselves)
    }
    std::function<void()> cont;
    bool detached_last = false;
    {
      // notify while holding the batch lock: Wait() may release the
      // slot the instant its wait observes remaining == 0, and a fresh
      // Submit may re-arm it — the notify must not race a spurious
      // wakeup into signalling the WRONG generation of the slot
      std::lock_guard<std::mutex> l(task.batch->mu);
      if (--task.batch->remaining == 0) {
        detached_last = task.batch->detached;
        if (detached_last) cont = std::move(task.batch->on_done);
        task.batch->done.notify_all();
      }
    }
    if (detached_last) {
      // continuation runs on THIS worker, outside every dispatcher
      // lock, so it may submit the next batch of a hop chain without
      // deadlock — but it must never block on one
      if (cont) {
        try {
          cont();
        } catch (...) {
          // a throwing continuation must not kill the worker; the
          // async op records its own failures (ShardFailed et al.)
        }
      }
      ReleaseSlot(static_cast<int>(task.batch - batches_.get()));
    }
  }
}

int Dispatcher::AcquireSlot(std::vector<std::function<void()>> jobs,
                            bool detached,
                            std::function<void()> on_done) const {
  int slot;
  {
    std::unique_lock<std::mutex> l(pool_mu_);
    pool_cv_.wait(l, [this] { return !free_.empty(); });
    slot = free_.front();
    free_.pop_front();
  }
  // the slot is exclusively ours between acquire and release; jobs and
  // on_done are only touched by this thread until Enqueue publishes
  // them, so only the worker-visible fields need the batch lock
  Batch& b = batches_[slot];
  b.jobs = std::move(jobs);
  b.on_done = std::move(on_done);
  {
    std::lock_guard<std::mutex> l(b.mu);
    b.remaining = b.jobs.size();
    b.detached = detached;
  }
  return slot;
}

void Dispatcher::ReleaseSlot(int slot) const {
  Batch& b = batches_[slot];
  b.jobs.clear();
  b.on_done = nullptr;
  {
    std::lock_guard<std::mutex> l(pool_mu_);
    free_.push_back(slot);
  }
  pool_cv_.notify_one();
}

void Dispatcher::Enqueue(int slot) const {
  Batch& b = batches_[slot];
  {
    std::lock_guard<std::mutex> l(mu_);
    for (const auto& j : b.jobs) queue_.push_back(Task{&j, &b});
  }
  cv_.notify_all();
}

Dispatcher::BatchHandle Dispatcher::Submit(
    std::vector<std::function<void()>> jobs) const {
  int slot = AcquireSlot(std::move(jobs), false, nullptr);
  Enqueue(slot);  // an empty batch enqueues nothing; Poll/Wait see 0
  return slot;
}

bool Dispatcher::Poll(BatchHandle h) const {
  Batch& b = batches_[h];
  std::lock_guard<std::mutex> l(b.mu);
  return b.remaining == 0;
}

void Dispatcher::Wait(BatchHandle h) const {
  Batch& b = batches_[h];
  {
    std::unique_lock<std::mutex> l(b.mu);
    b.done.wait(l, [&b] { return b.remaining == 0; });
  }
  ReleaseSlot(h);
}

void Dispatcher::SubmitDetached(std::vector<std::function<void()>> jobs,
                                std::function<void()> on_done) const {
  if (jobs.empty()) {
    // nothing will ever complete to fire it: run inline on the caller
    // (initial submit thread or the previous hop's continuation worker)
    if (on_done) on_done();
    return;
  }
  int slot = AcquireSlot(std::move(jobs), true, std::move(on_done));
  Enqueue(slot);
}

void Dispatcher::Run(const std::vector<std::function<void()>>& jobs) const {
  if (jobs.empty()) return;
  Wait(Submit(jobs));
}

}  // namespace eg
