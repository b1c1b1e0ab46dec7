// Always-on flight recorder + fatal-signal postmortem dumps.
//
// Everything the observability stack built so far — counters, span
// timers, histograms, journals, the STATS scrape — lives in process
// memory and answers questions about a LIVE process. When a shard
// SIGSEGVs, a handler deadlocks into an abort, or an OOM kill takes a
// replica, all of it evaporates with the address space: the operator
// learns that a process died, never what it was doing in its final
// seconds. Production GNN serving treats that gap as unacceptable (the
// operational failure analyses behind FastSample, arXiv:2311.17847,
// and pipelined sampling, arXiv:2110.08450, attribute most lost
// cluster time to UNATTRIBUTED stalls and crashes). This layer closes
// it with three pieces:
//
//   * a lock-free per-thread ring FLIGHT RECORDER: fixed-slot event
//     records (point, op, shard, trace id, wire bytes / µs value,
//     outcome, CLOCK_MONOTONIC µs) written with a handful of relaxed
//     stores per event and zero allocation on the hot path, fed from
//     the same hook points eg_telemetry already instruments
//     (ConnPool::Call, AdmissionServer::ServeConn, the dispatcher
//     workers, eg_phase);
//   * a FATAL-SIGNAL path: async-signal-safe handlers for
//     SIGSEGV/SIGBUS/SIGABRT/SIGFPE that write a postmortem file —
//     the raw rings, the full eg_counters ledger, the admission
//     gauges, a backtrace, and the resource-gauge history — using
//     only open/write/atomic loads and a fixed-format integer writer
//     (no malloc, no stdio, no locks), then re-raise with the default
//     disposition so the exit status still names the signal;
//   * RESOURCE GAUGES (RSS, open fds, live threads, client cache
//     bytes) sampled by a low-rate background thread into a 60-entry
//     history ring, answerable live through Telemetry::Json (the
//     "resource" section every metrics surface inherits) and the
//     kHistory wire opcode, and frozen into every postmortem.
//
// Postmortem file format (OBSERVABILITY.md "Postmortems"): line 1 is
// one JSON document; any following lines are backtrace_symbols_fd
// output (human-readable frames — produced OUTSIDE the JSON because
// symbolization must not allocate inside a signal handler).
// euler_tpu.postmortem_read() parses both halves.
//
// Kill-switch: `blackbox=` (graph config key / service option /
// eg_blackbox_set_enabled), default ON — disabled, every hook is one
// relaxed load and a fatal signal writes NOTHING (the handler still
// re-raises). Handlers install only when a postmortem dir is set.
#ifndef EG_BLACKBOX_H_
#define EG_BLACKBOX_H_

#include "eg_common.h"

#include <atomic>
#include <cstdint>
#include <string>

namespace eg {

// Where in the stack an event was recorded. Fixed order — the JSON
// emitters and euler_tpu/blackbox.py name points by this table.
enum BlackboxPoint : uint8_t {
  kBbClientCall = 0,  // ConnPool::Call finished (ok or failed)
  kBbServerRecv,      // admission worker decoded a request envelope
  kBbServerReply,     // admission worker sent (or dropped) its reply
  kBbDispatch,        // dispatcher worker began a per-shard job
  kBbPhase,           // step-phase sample (op = StepPhase index)
  kBbApp,             // app-level event via the eg_blackbox_record ABI
  kBbPointCount,
};

const char* const kBbPointNames[kBbPointCount] = {
    "client_call", "server_recv", "server_reply",
    "dispatch",    "phase",       "app",
};

// One fixed ring slot. Fields are individually-atomic so concurrent
// live readers (eg_blackbox_json, the signal handler on another
// thread's stack) race benignly under TSAN: a torn EVENT (half old,
// half new) is possible at the ring seam, a torn FIELD is not.
struct BlackboxEvent {
  std::atomic<int64_t> t_us{0};    // CLOCK_MONOTONIC µs at record
  std::atomic<uint64_t> trace{0};  // wire-v3 trace id; 0 = none
  std::atomic<uint64_t> value{0};  // wire bytes (rpc), µs (phase), free
  std::atomic<int32_t> shard{-1};
  std::atomic<uint8_t> point{0};
  std::atomic<uint8_t> op{0};
  std::atomic<uint8_t> outcome{0};
};

constexpr int kBbRingSlots = 256;  // per-thread tail, ~the final seconds
constexpr int kBbMaxRings = 64;    // fixed pool: no allocation, ever

// Single-writer ring. head counts events EVER written by the owning
// thread; slot (head % kBbRingSlots) is the next write target, so the
// resident window is [head - min(head, slots), head) oldest-first —
// the eviction order the wraparound test pins. Rings outlive their
// threads: a worker that died an hour ago still shows its tail in the
// postmortem.
struct BlackboxRing {
  std::atomic<uint64_t> head{0};
  std::atomic<uint64_t> tid{0};  // OS tid label; 0 = slot unclaimed
  BlackboxEvent slots[kBbRingSlots];
};

// One resource-gauge sample as read from /proc (plain fields — a
// local value, never shared).
struct ResourceSample {
  int64_t t_us = 0;
  int64_t rss_bytes = 0;    // /proc/self/statm resident pages * pagesize
  int64_t open_fds = 0;     // entries in /proc/self/fd
  int64_t threads = 0;      // /proc/self/status Threads:
  int64_t cache_bytes = 0;  // client feature-cache bytes (eg_cache.h)
  int64_t nbr_cache_bytes = 0;  // client neighbor-list cache bytes
  int64_t device_mem_bytes = 0;  // device bytes in use (eg_devprof.h —
                                 // memory_stats() or live-array census)
  int64_t device_buffers = 0;    // live device buffer count
};

// A history-ring slot: individually-atomic fields, same reasoning as
// BlackboxEvent — the sampler overwrites wrapped slots while dumps and
// scrapes read them, and a torn SAMPLE at the seam is acceptable where
// a torn FIELD is not.
struct ResourceCell {
  std::atomic<int64_t> t_us{0};
  std::atomic<int64_t> rss_bytes{0};
  std::atomic<int64_t> open_fds{0};
  std::atomic<int64_t> threads{0};
  std::atomic<int64_t> cache_bytes{0};
  std::atomic<int64_t> device_mem_bytes{0};

  void Store(const ResourceSample& s) {
    t_us.store(s.t_us, std::memory_order_relaxed);
    rss_bytes.store(s.rss_bytes, std::memory_order_relaxed);
    open_fds.store(s.open_fds, std::memory_order_relaxed);
    threads.store(s.threads, std::memory_order_relaxed);
    cache_bytes.store(s.cache_bytes, std::memory_order_relaxed);
    device_mem_bytes.store(s.device_mem_bytes, std::memory_order_relaxed);
  }
  ResourceSample Load() const {
    ResourceSample s;
    s.t_us = t_us.load(std::memory_order_relaxed);
    s.rss_bytes = rss_bytes.load(std::memory_order_relaxed);
    s.open_fds = open_fds.load(std::memory_order_relaxed);
    s.threads = threads.load(std::memory_order_relaxed);
    s.cache_bytes = cache_bytes.load(std::memory_order_relaxed);
    s.device_mem_bytes = device_mem_bytes.load(std::memory_order_relaxed);
    return s;
  }
};

constexpr int kBbHistorySlots = 60;

// Last-refreshed admission gauges (eg_admission.cc PollerLoop stores
// them every cycle, <=250 ms stale): the signal handler must not call
// into a server object that may be mid-teardown, so it reads this POD
// snapshot instead.
struct AdmissionSnap {
  std::atomic<int> registered{0};
  std::atomic<int> workers{0};
  std::atomic<int> active{0};
  std::atomic<int> queue_depth{0};
  std::atomic<int> conns{0};
  std::atomic<int> draining{0};
};

AdmissionSnap& AdmissionGaugeSnap();

class Blackbox {
 public:
  static Blackbox& Global();

  bool enabled() const { return enabled_.load(std::memory_order_relaxed); }
  void SetEnabled(bool on) {
    enabled_.store(on, std::memory_order_relaxed);
  }

  // One flight-recorder event: a handful of relaxed stores into this
  // thread's ring (claimed from the fixed pool on first use); a single
  // relaxed load when disabled. Never allocates, never locks.
  void Record(uint8_t point, uint8_t op, int32_t shard, uint64_t trace,
              uint64_t value, uint8_t outcome);

  // Arm the postmortem path: remember the dump directory + this
  // process's shard index, install the fatal-signal handlers
  // (SIGSEGV/SIGBUS/SIGABRT/SIGFPE), and start the resource sampler
  // thread (period sample_ms, min 50; 0 keeps a previous/default
  // period). Re-invocable: later calls update dir/shard. False +
  // error() when the directory is not writable.
  bool Install(const std::string& postmortem_dir, int shard,
               int sample_ms = 0);
  std::string error() const {
    std::lock_guard<std::mutex> l(install_mu_);
    return error_;
  }
  int shard() const { return shard_.load(std::memory_order_relaxed); }

  // One fresh resource sample read from /proc (NOT signal-safe; the
  // sampler thread and the JSON surfaces use it — the signal handler
  // reads the history ring instead).
  static ResourceSample SampleResources();

  // Write a postmortem dump to `path` (manual path: run_loop's
  // crash-on-unhandled-exception hook, tests). sig 0 = not a signal.
  // Uses the same async-signal-safe builder as the handler. False on
  // open failure or blackbox disabled.
  bool WriteDump(const char* path, int sig);

  // Live JSON: {"enabled","shard","postmortem_dir","dropped","rings":
  // [{tid,head,events:[...]}],"resource":{...},"history":[...]} — the
  // console `stats blackbox` / eg_blackbox_json surface.
  std::string LiveJson();

  // Resource history JSON for the kHistory wire reply:
  // {"shard","resource":{latest},"history":[{t_us,rss_bytes,...}]}.
  std::string HistoryJson(int shard);

  // Append `,"resource":{...}` (latest live sample + history depth) to
  // an in-progress JSON object — Telemetry::Json calls this so every
  // existing metrics surface (metrics_text, snapshot, STATS scrape,
  // metrics_dump) inherits the gauges with zero new plumbing.
  void ResourceJsonInto(std::string* out);

  // Reset the rings + drop ledger (NOT the enabled flag or the
  // installed handlers) — the clean-slate primitive tests use.
  void Reset();

  // -- internals shared with the signal handler (must stay signal-safe)
  void DumpToFd(int fd, int sig);
  const char* postmortem_path() const { return dump_path_; }

 private:
  Blackbox() = default;
  BlackboxRing* ThreadRing();
  void SamplerLoop();
  void AppendHistory(const ResourceSample& s);
  // `{rss_bytes,...,history_depth}` object body shared by the live
  // surfaces (NOT the signal path — it samples /proc).
  void ResourceJsonBody(std::string* out);

  std::atomic<bool> enabled_{true};
  std::atomic<int> shard_{-1};
  std::atomic<int> next_ring_{0};
  std::atomic<uint64_t> dropped_{0};  // events lost to pool exhaustion
  BlackboxRing rings_[kBbMaxRings];

  // resource history: single writer (sampler thread), atomic head
  std::atomic<uint64_t> hist_head_{0};
  ResourceCell history_[kBbHistorySlots];

  // fixed-size dump path: composed at Install so the handler never
  // touches std::string
  char dump_path_[512] = {0};
  std::atomic<bool> installed_{false};
  std::atomic<int> sample_ms_{1000};
  std::atomic<bool> sampler_running_{false};
  // Install/config strings: written only under install_mu_ (Install is
  // the cold init path); surfaces that read them take the same lock.
  mutable std::mutex install_mu_;
  std::string error_ EG_GUARDED_BY(install_mu_);
  std::string dir_ EG_GUARDED_BY(install_mu_);
};

}  // namespace eg

#endif  // EG_BLACKBOX_H_
