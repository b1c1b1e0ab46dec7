// Bounded-admission connection server: the survivability layer under
// the shard service (eg_service.h).
//
// The 2019-Euler shape this replaces — an accept loop spawning one
// unbounded detached handler thread per connection — dies at the first
// connection storm (thread exhaustion), wedges a handler forever on a
// stalled client, and has no way to say "not now" besides letting the
// backlog grow. Production sampling tiers live or die on exactly this
// (FastSample, arXiv:2311.17847; pipelined sampling, arXiv:2110.08450):
// the service must shed load it cannot serve, refuse work whose answers
// nobody will read, and hand back its registry slot before it stops.
//
// Shape: one poller thread multiplexes every idle connection (idle
// connections cost a poll slot, never a handler), a FIXED pool of
// `workers` handler threads serves connections that have a request
// ready, and admission is bounded — when in-flight work reaches
// `workers + pending` (or open connections reach `max_conns`), a new
// connection is answered with one kStatusBusy frame and closed instead
// of queueing unboundedly. The client's ConnPool::Call treats BUSY as
// an immediate fail-fast failover (eg_remote.cc), so shed load moves to
// a replica instead of piling onto the struggling server.
//
// Deadlines: v2 requests stamp their remaining budget (eg_wire.h
// envelope); workers check it against the time the request became
// readable and answer kStatusDeadline instead of computing dead
// answers. SO_RCVTIMEO/SO_SNDTIMEO on every accepted socket bound how
// long a wedged peer can pin a handler slot (`handler_timeouts`).
//
// Drain: Drain() stops accepting, closes idle connections, lets
// in-flight requests finish (condvar, bounded by `drain_ms`), then
// closes — the server half of a rolling restart (DEPLOY.md runbook).
//
// Failpoints (eg_fault.h): `accept` drops/delays accepted connections,
// `handler_stall` stalls or wedges a worker pre-dispatch, `busy_force`
// forces the admission check to report overload — all seeded and
// countable, so every path above is deterministically testable.
#ifndef EG_ADMISSION_H_
#define EG_ADMISSION_H_

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include "eg_common.h"
#include "eg_wire.h"

namespace eg {

struct AdmissionOptions {
  int workers = 0;           // handler pool size; 0 = 2 * hw threads
  int pending = 64;          // admitted-work headroom beyond the pool:
                             // BUSY when active + ready >= workers+pending
  int max_conns = 1024;      // absolute open-connection cap (idle incl.)
  int io_timeout_ms = 5000;  // SO_RCVTIMEO/SO_SNDTIMEO per connection
  int idle_timeout_ms = 0;   // close connections idle this long; 0 = never
  int linger_ms = 2;         // post-reply wait for a follow-up request
                             // before handing the conn back to the poller
  int drain_ms = 5000;       // Drain()/Stop() grace for in-flight work
  bool legacy_wire = false;  // emulate a wire-v1 server (answer envelopes
                             // with the stock unknown-op error) — the
                             // cross-version compatibility test hook
  bool v2_only = false;      // emulate a wire-v2 server (kStatusBadVersion
                             // to v3 envelopes; v2 served normally) — the
                             // trace-id downgrade drill's other direction
  bool v3_only = false;      // emulate a wire-v3 server (kStatusBadVersion
                             // to v4 epoch envelopes; v3 served normally) —
                             // the epoch-stamp downgrade drill's hook
  int telemetry = -1;        // -1 = leave the process-global telemetry
                             // switch alone; 0/1 set it (eg_telemetry.h)
  int slow_spans = 0;        // >0 = slow-span journal capacity
  int blackbox = -1;         // -1 = leave the process-global blackbox
                             // switch alone; 0/1 set it (eg_blackbox.h)
  int heat = -1;             // -1 = leave the process-global heat
                             // profiler alone; 0/1 set it (eg_heat.h)
  int heat_topk = 0;         // >0 = hot-key tracker capacity (resets it)
  std::string postmortem_dir;  // non-empty: arm the fatal-signal dump
                               // path for this serving process
  int shard_idx = -1;        // set programmatically by Service::Start so
                             // server-side spans carry their shard
};

// Parse "k=v;k=v" admission options (workers/pending/max_conns/
// io_timeout_ms/idle_timeout_ms/linger_ms/drain_ms/wire_version/
// telemetry/slow_spans/blackbox/heat/heat_topk/postmortem_dir).
// Unknown keys and malformed numbers fail loudly: false + *err.
bool ParseAdmissionOptions(const std::string& spec, AdmissionOptions* opt,
                           std::string* err);

class AdmissionServer {
 public:
  // Request handler: decode body (envelope already stripped), write the
  // reply payload. `env` is the parsed request envelope — the service
  // reads the v4 pinned epoch from it and stamps ok replies with the
  // current epoch. Must not throw for ordinary malformed input (the
  // worker adds a catch-all barrier regardless).
  using Handler = std::function<void(const char* req, size_t len,
                                     const Envelope& env,
                                     std::string* reply)>;

  ~AdmissionServer() { Stop(); }

  // Takes ownership of a bound listening fd and starts the poller +
  // worker pool. False + *err when thread/pipe setup fails.
  bool Start(int listen_fd, const AdmissionOptions& opt, Handler handler,
             std::string* err);

  // Stop accepting, close idle connections, let queued/in-flight
  // requests finish (up to grace_ms; <0 = opt.drain_ms), then close.
  // Idempotent; counted once in the `draining` counter.
  void Drain(int grace_ms = -1);

  // Drain (default grace), then join every thread and close every fd.
  // Idempotent; the destructor calls it.
  void Stop();

  bool draining() const {
    return draining_.load(std::memory_order_acquire);
  }
  int workers() const { return opt_.workers; }
  // Live admission gauges for the kStats scrape (eg_telemetry.h
  // TelemetryGauges): how loaded this server is RIGHT NOW — the
  // operator-visible half of bounded admission.
  int active() const { return active_.load(std::memory_order_relaxed); }
  int queue_depth() const {
    return ready_count_.load(std::memory_order_relaxed);
  }
  int conns() const { return conns_.load(std::memory_order_relaxed); }

 private:
  struct ReadyConn {
    int fd = -1;
    int64_t ready_ms = 0;  // when the poller saw the request readable —
                           // the base the stamped deadline counts from
  };

  void PollerLoop();
  void WorkerLoop();
  // Serve one connection until it goes idle (returned to the poller),
  // errors, times out, or the server drains.
  void ServeConn(ReadyConn c);
  void AcceptBurst(std::map<int, int64_t>* idle,
                   std::map<int, int64_t>* dying, int64_t now);
  void CloseConn(int fd);   // close + accounting + drain notification
  void ReturnConn(int fd);  // hand an idle conn back to the poller
  void Wake();              // nudge the poller out of poll()

  AdmissionOptions opt_;
  Handler handler_;
  int listen_fd_ = -1;
  int wake_r_ = -1, wake_w_ = -1;
  bool started_ = false;
  std::thread poller_;
  std::vector<std::thread> workers_;

  // PosixMutex + condition_variable_any (not std::mutex): servers are
  // created and destroyed repeatedly in one process (rolling restarts,
  // tests), and a recycled heap block would otherwise carry the
  // previous server's stale TSAN mutex shadow state — see PosixMutex
  // in eg_common.h.
  mutable PosixMutex mu_;  // guards ready_, returned_, all_fds_, stop_
  PosixCondVar ready_cv_;    // workers wait for ready conns
  PosixCondVar drained_cv_;  // Drain waits for conns_ == 0
  std::deque<ReadyConn> ready_ EG_GUARDED_BY(mu_);
  std::vector<int> returned_ EG_GUARDED_BY(mu_);
  // every open conn fd, for forced shutdown
  std::set<int> all_fds_ EG_GUARDED_BY(mu_);
  bool stop_ EG_GUARDED_BY(mu_) = false;
  std::atomic<bool> draining_{false};
  std::atomic<int> active_{0};       // workers currently serving
  std::atomic<int> ready_count_{0};  // mirrors ready_.size() lock-free
  std::atomic<int> conns_{0};        // total admitted open connections
};

}  // namespace eg

#endif  // EG_ADMISSION_H_
