#include "eg_admission.h"

#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <cstdlib>
#include <cstring>

#include "eg_blackbox.h"
#include "eg_fault.h"
#include "eg_heat.h"
#include "eg_stats.h"
#include "eg_telemetry.h"
#include "eg_wire.h"

namespace eg {

namespace {

int64_t NowMs() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

void SetConnTimeouts(int fd, int timeout_ms) {
  if (timeout_ms <= 0) return;
  timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

// Exception-free int parse (this runs under the C ABI: a malformed
// option must land in *err, never throw through eg_capi).
bool ParseIntOpt(const std::string& s, int* out) {
  if (s.empty()) return false;
  char* end = nullptr;
  long v = std::strtol(s.c_str(), &end, 10);
  if (end != s.c_str() + s.size()) return false;
  *out = static_cast<int>(v);
  return true;
}

}  // namespace

bool ParseAdmissionOptions(const std::string& spec, AdmissionOptions* opt,
                           std::string* err) {
  size_t pos = 0;
  while (pos < spec.size()) {
    size_t semi = spec.find(';', pos);
    std::string item = spec.substr(
        pos, semi == std::string::npos ? std::string::npos : semi - pos);
    pos = semi == std::string::npos ? spec.size() : semi + 1;
    if (item.empty()) continue;
    size_t eq = item.find('=');
    if (eq == std::string::npos) {
      *err = "service option '" + item + "' wants key=value";
      return false;
    }
    std::string key = item.substr(0, eq);
    if (key == "postmortem_dir") {
      // the one string-valued option: where the fatal-signal handler
      // writes this serving process's dump (eg_blackbox.h)
      opt->postmortem_dir = item.substr(eq + 1);
      continue;
    }
    int v = 0;
    if (!ParseIntOpt(item.substr(eq + 1), &v)) {
      *err = "bad integer in service option '" + item + "'";
      return false;
    }
    if (key == "workers") {
      opt->workers = v;
    } else if (key == "pending") {
      opt->pending = v;
    } else if (key == "max_conns") {
      opt->max_conns = v;
    } else if (key == "io_timeout_ms") {
      opt->io_timeout_ms = v;
    } else if (key == "idle_timeout_ms") {
      opt->idle_timeout_ms = v;
    } else if (key == "linger_ms") {
      opt->linger_ms = v;
    } else if (key == "drain_ms") {
      opt->drain_ms = v;
    } else if (key == "wire_version") {
      if (v < 1 || v > kWireVersion) {
        *err = "wire_version must be 1.." + std::to_string(kWireVersion) +
               " (this build speaks " + std::to_string(kWireVersion) + ")";
        return false;
      }
      opt->legacy_wire = v == 1;
      opt->v2_only = v == 2;
      opt->v3_only = v == 3;
    } else if (key == "telemetry") {
      opt->telemetry = v != 0 ? 1 : 0;
    } else if (key == "slow_spans") {
      if (v < 1) {
        *err = "slow_spans must be >= 1 (journal capacity)";
        return false;
      }
      opt->slow_spans = v;
    } else if (key == "blackbox") {
      opt->blackbox = v != 0 ? 1 : 0;
    } else if (key == "heat") {
      opt->heat = v != 0 ? 1 : 0;
    } else if (key == "heat_topk") {
      if (v < 1 || v > kHeatMaxTopK) {
        *err = "heat_topk must be 1.." + std::to_string(kHeatMaxTopK) +
               " (fixed top-K tracker pool)";
        return false;
      }
      opt->heat_topk = v;
    } else {
      // loudness rule: a typo'd key must not be dropped silently
      *err = "unknown service option '" + key +
             "' (known: workers, pending, max_conns, io_timeout_ms, "
             "idle_timeout_ms, linger_ms, drain_ms, wire_version, "
             "telemetry, slow_spans, blackbox, heat, heat_topk, "
             "postmortem_dir)";
      return false;
    }
  }
  return true;
}

bool AdmissionServer::Start(int listen_fd, const AdmissionOptions& opt,
                            Handler handler, std::string* err) {
  opt_ = opt;
  // telemetry=/slow_spans= options act on the process-global telemetry
  // switch (eg_telemetry.h) — the server half of the kill-switch the
  // client reaches through its graph config
  if (opt_.telemetry >= 0)
    Telemetry::Global().SetEnabled(opt_.telemetry != 0);
  if (opt_.slow_spans > 0)
    Telemetry::Global().SetSlowCapacity(opt_.slow_spans);
  // blackbox=/postmortem_dir= options: the server half of the flight-
  // recorder kill-switch and the fatal-signal dump path (eg_blackbox.h)
  if (opt_.blackbox >= 0) Blackbox::Global().SetEnabled(opt_.blackbox != 0);
  // heat=/heat_topk= options: the server half of the data-plane heat
  // profiler's switches (eg_heat.h)
  if (opt_.heat >= 0) Heat::Global().SetEnabled(opt_.heat != 0);
  if (opt_.heat_topk > 0) Heat::Global().SetTopK(opt_.heat_topk);
  if (!opt_.postmortem_dir.empty() &&
      !Blackbox::Global().Install(opt_.postmortem_dir, opt_.shard_idx)) {
    *err = Blackbox::Global().error();
    return false;
  }
  if (opt_.workers <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    opt_.workers = 2 * static_cast<int>(hc ? hc : 2);
  }
  if (opt_.pending < 1) opt_.pending = 1;
  if (opt_.max_conns < opt_.workers + opt_.pending)
    opt_.max_conns = opt_.workers + opt_.pending;
  if (opt_.linger_ms < 0) opt_.linger_ms = 0;
  handler_ = std::move(handler);
  listen_fd_ = listen_fd;
  // non-blocking listen: the poller accept-bursts until EAGAIN, so one
  // poll wakeup drains a whole storm of pending connects
  int fl = ::fcntl(listen_fd_, F_GETFL, 0);
  ::fcntl(listen_fd_, F_SETFL, fl | O_NONBLOCK);
  int pfds[2];
  if (::pipe(pfds) != 0) {
    *err = "admission: cannot create wake pipe";
    return false;
  }
  wake_r_ = pfds[0];
  wake_w_ = pfds[1];
  ::fcntl(wake_r_, F_SETFL, O_NONBLOCK);
  ::fcntl(wake_w_, F_SETFL, O_NONBLOCK);
  {
    // poller thread not spawned yet, but take the lock anyway: the
    // guarded-by contract is simpler than a start-ordering argument
    std::lock_guard<PosixMutex> l(mu_);
    stop_ = false;
  }
  draining_.store(false, std::memory_order_release);
  poller_ = std::thread([this] {
    try {
      PollerLoop();
    } catch (...) {
      // std::terminate barrier (eg-lint: thread-catch): a dead poller
      // stops admitting and re-arming connections until restart; the
      // workers drain what is already queued
    }
  });
  workers_.reserve(static_cast<size_t>(opt_.workers));
  for (int i = 0; i < opt_.workers; ++i)
    workers_.emplace_back([this] {
      try {
        WorkerLoop();
      } catch (...) {
        // std::terminate barrier (eg-lint: thread-catch): a dead worker
        // shrinks the pool; the siblings keep serving
      }
    });
  started_ = true;
  return true;
}

void AdmissionServer::Wake() {
  if (wake_w_ >= 0) {
    char b = 1;
    // best effort: a full pipe already guarantees a pending wakeup
    (void)!::write(wake_w_, &b, 1);
  }
}

void AdmissionServer::CloseConn(int fd) {
  {
    std::lock_guard<PosixMutex> l(mu_);
    all_fds_.erase(fd);
  }
  ::close(fd);
  if (conns_.fetch_sub(1, std::memory_order_acq_rel) == 1 &&
      draining_.load(std::memory_order_acquire)) {
    std::lock_guard<PosixMutex> l(mu_);
    drained_cv_.notify_all();
  }
}

void AdmissionServer::ReturnConn(int fd) {
  bool close_now;
  {
    std::lock_guard<PosixMutex> l(mu_);
    close_now = stop_ || draining_.load(std::memory_order_relaxed);
    if (!close_now) returned_.push_back(fd);
  }
  if (close_now) {
    CloseConn(fd);
    return;
  }
  Wake();
}

void AdmissionServer::AcceptBurst(std::map<int, int64_t>* idle,
                                  std::map<int, int64_t>* dying,
                                  int64_t now) {
  for (;;) {
    int fd = ::accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) return;  // EAGAIN (burst drained) or listener gone
    // kFaultAccept: err drops the connection at the door (accept-path
    // flakiness); delay slows admission without dropping.
    if (FaultHit(kFaultAccept)) {
      ::close(fd);
      continue;
    }
    SetConnTimeouts(fd, opt_.io_timeout_ms);
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // Bounded admission: when in-flight work already saturates the pool
    // plus its pending headroom (or the fd budget is gone), answer one
    // BUSY frame and close — the client fails over immediately instead
    // of this server queueing work it cannot start.
    bool busy = FaultHit(kFaultBusyForce);
    if (!busy) {
      int in_flight = active_.load(std::memory_order_relaxed) +
                      ready_count_.load(std::memory_order_relaxed);
      busy = in_flight >= opt_.workers + opt_.pending ||
             conns_.load(std::memory_order_relaxed) >= opt_.max_conns;
    }
    if (busy) {
      Counters::Global().Add(kCtrBusyReject);
      SendFrame(fd, StatusReply(kStatusBusy,
                                "server busy: admission queue full"));
      // Half-close and drain to EOF instead of closing outright: a
      // close with the client's request bytes still arriving turns into
      // an RST that can clobber the unread BUSY reply — the client
      // would see a reset (quarantine + backoff) instead of the
      // fail-fast failover the reply exists to trigger.
      ::shutdown(fd, SHUT_WR);
      if (static_cast<int>(dying->size()) < 256)
        (*dying)[fd] = now + 500;
      else
        ::close(fd);  // reject storm beyond the drain budget: RST it is
      continue;
    }
    conns_.fetch_add(1, std::memory_order_acq_rel);
    {
      std::lock_guard<PosixMutex> l(mu_);
      all_fds_.insert(fd);
    }
    (*idle)[fd] = now;
  }
}

void AdmissionServer::PollerLoop() {
  // fd -> since-when-idle (ms); an idle connection costs a poll slot,
  // never a handler — the fix for pooled client sockets pinning the
  // old thread-per-connection servers
  std::map<int, int64_t> idle;
  // BUSY-rejected fds being drained to EOF (fd -> give-up deadline)
  std::map<int, int64_t> dying;
  std::vector<pollfd> pfds;
  bool listen_open = listen_fd_ >= 0;
  for (;;) {
    {
      std::lock_guard<PosixMutex> l(mu_);
      if (stop_) break;
    }
    bool draining = draining_.load(std::memory_order_acquire);
    if (draining && listen_open) {
      ::close(listen_fd_);
      listen_fd_ = -1;
      listen_open = false;
    }
    if (draining && !idle.empty()) {
      for (const auto& [fd, since] : idle) CloseConn(fd);
      idle.clear();
    }
    pfds.clear();
    pfds.push_back({wake_r_, POLLIN, 0});
    if (listen_open) pfds.push_back({listen_fd_, POLLIN, 0});
    for (const auto& [fd, since] : idle) pfds.push_back({fd, POLLIN, 0});
    size_t ndying = dying.size();
    for (const auto& [fd, until] : dying) pfds.push_back({fd, POLLIN, 0});
    int rc = ::poll(pfds.data(), static_cast<nfds_t>(pfds.size()), 250);
    if (rc < 0 && errno != EINTR) {
      std::this_thread::sleep_for(std::chrono::milliseconds(5));
      continue;
    }
    int64_t now = NowMs();
    // Refresh the blackbox's POD gauge snapshot every cycle (<=250 ms
    // stale): the fatal-signal dump reads THIS, never the live server
    // object a crashing process may already be tearing down.
    {
      AdmissionSnap& snap = AdmissionGaugeSnap();
      snap.workers.store(opt_.workers, std::memory_order_relaxed);
      snap.active.store(active_.load(std::memory_order_relaxed),
                        std::memory_order_relaxed);
      snap.queue_depth.store(ready_count_.load(std::memory_order_relaxed),
                             std::memory_order_relaxed);
      snap.conns.store(conns_.load(std::memory_order_relaxed),
                       std::memory_order_relaxed);
      snap.draining.store(draining ? 1 : 0, std::memory_order_relaxed);
      snap.registered.store(1, std::memory_order_relaxed);
    }
    size_t k = 0;
    if (pfds[k].revents & POLLIN) {
      char buf[64];
      while (::read(wake_r_, buf, sizeof(buf)) > 0) {
      }
    }
    ++k;
    // conns workers handed back: re-arm (or close when draining raced)
    std::vector<int> back;
    {
      std::lock_guard<PosixMutex> l(mu_);
      back.swap(returned_);
    }
    for (int fd : back) {
      if (draining_.load(std::memory_order_acquire))
        CloseConn(fd);
      else
        idle[fd] = now;
    }
    if (listen_open) {
      if (pfds[k].revents & POLLIN) AcceptBurst(&idle, &dying, now);
      ++k;
    }
    bool any_ready = false;
    size_t idle_end = pfds.size() - ndying;
    for (; k < idle_end; ++k) {
      if (pfds[k].revents == 0) continue;
      int fd = pfds[k].fd;
      if (idle.erase(fd) == 0) continue;  // already re-armed this cycle
      {
        std::lock_guard<PosixMutex> l(mu_);
        ready_.push_back({fd, now});
      }
      ready_count_.fetch_add(1, std::memory_order_acq_rel);
      any_ready = true;
    }
    if (any_ready) ready_cv_.notify_all();
    // BUSY'd fds draining to EOF: discard arriving bytes, close on
    // EOF/error or when the give-up deadline passes
    for (size_t d = idle_end; d < pfds.size(); ++d) {
      if (pfds[d].revents == 0) continue;
      char scratch[4096];
      ssize_t r = ::recv(pfds[d].fd, scratch, sizeof(scratch), MSG_DONTWAIT);
      if (r == 0 || (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
        ::close(pfds[d].fd);
        dying.erase(pfds[d].fd);
      }
    }
    for (auto it = dying.begin(); it != dying.end();) {
      if (now >= it->second) {
        ::close(it->first);
        it = dying.erase(it);
      } else {
        ++it;
      }
    }
    if (opt_.idle_timeout_ms > 0) {
      for (auto it = idle.begin(); it != idle.end();) {
        if (now - it->second > opt_.idle_timeout_ms) {
          CloseConn(it->first);
          it = idle.erase(it);
        } else {
          ++it;
        }
      }
    }
  }
  // stop: the accounting owner for idle and dying conns is this thread
  for (const auto& [fd, since] : idle) CloseConn(fd);
  for (const auto& [fd, until] : dying) ::close(fd);
  if (listen_open) {
    ::close(listen_fd_);
    listen_fd_ = -1;
  }
}

void AdmissionServer::WorkerLoop() {
  for (;;) {
    ReadyConn c;
    bool drop = false;
    {
      std::unique_lock<PosixMutex> l(mu_);
      ready_cv_.wait(l, [this] { return stop_ || !ready_.empty(); });
      if (ready_.empty()) return;  // stop_ and nothing left to drop
      c = ready_.front();
      ready_.pop_front();
      ready_count_.fetch_sub(1, std::memory_order_acq_rel);
      drop = stop_;
      if (!drop) active_.fetch_add(1, std::memory_order_acq_rel);
    }
    if (drop) {
      CloseConn(c.fd);
      continue;
    }
    ServeConn(c);
    active_.fetch_sub(1, std::memory_order_acq_rel);
    if (draining_.load(std::memory_order_acquire)) {
      std::lock_guard<PosixMutex> l(mu_);
      drained_cv_.notify_all();
    }
  }
}

void AdmissionServer::ServeConn(ReadyConn c) {
  Counters& ctr = Counters::Global();
  // Requesting-conn tag for the data-plane heat feeds (eg_heat.h):
  // Service::Dispatch runs on this thread and reads it back, so the
  // shard's per-conn id ledger can name WHO generates the hot traffic
  // without widening the handler signature.
  HeatSetConn(c.fd);
  std::string req, reply;
  int64_t ready_ms = c.ready_ms;
  for (;;) {
    IoStatus rs = RecvFrameEx(c.fd, &req);
    if (rs != IoStatus::kOk) {
      // kTimeout: the peer began a frame and wedged mid-send — the
      // socket timeout freed this handler slot
      if (rs == IoStatus::kTimeout) ctr.Add(kCtrHandlerTimeout);
      CloseConn(c.fd);
      return;
    }
    // Telemetry (eg_telemetry.h): queue wait = poller-ready to here;
    // handler time = everything between recv and the reply being ready
    // (the stall failpoint included, so delay faults land requests in
    // deterministic buckets); wire time = the reply send.
    Telemetry& tel = Telemetry::Global();
    const bool rec = tel.enabled();
    uint64_t queue_us = 0;
    if (rec) {
      int64_t waited_ms = NowMs() - ready_ms;
      queue_us = waited_ms > 0 ? static_cast<uint64_t>(waited_ms) * 1000
                               : 0;
      tel.Record(kHistServerQueue, 0, queue_us);
    }
    const int64_t t_handle = rec ? TelemetryNowUs() : 0;
    Envelope env;
    uint8_t op = 0;
    reply.clear();
    if (!PeekEnvelope(req, &env)) {
      ctr.Add(kCtrFrameReject);
      reply = StatusReply(kStatusError, "truncated request envelope");
    } else {
      if (req.size() > env.body_off)
        op = static_cast<uint8_t>(req[env.body_off]);
      // flight recorder (eg_blackbox.h): the decoded request — op,
      // trace id, wire bytes — BEFORE anything can go wrong serving
      // it, so a handler that dies mid-dispatch leaves the fatal
      // call's trace id in its ring tail (the postmortem merge keys
      // the incident timeline on exactly this event)
      Blackbox::Global().Record(kBbServerRecv, op, opt_.shard_idx,
                                env.trace_id, req.size(), 0);
      if (opt_.legacy_wire && env.versioned) {
        // v1-server emulation (wire_version=1 option): answer exactly
        // what a pre-envelope build answers, so the client's downgrade
        // negotiation can be pinned against a real service
        reply = StatusReply(kStatusError,
                            "unknown op " + std::to_string(kWireEnvelope));
      } else if (opt_.v2_only && env.versioned && env.version > 2) {
        // v2-server emulation (wire_version=2 option): refuse the v3
        // trace envelope the way a pre-telemetry build does, driving
        // the client's pin-at-v2 downgrade path
        ctr.Add(kCtrFrameReject);
        reply = StatusReply(
            kStatusBadVersion,
            "unsupported wire version " + std::to_string(env.version) +
                " (server speaks up to 2)");
      } else if (opt_.v3_only && env.versioned && env.version > 3) {
        // v3-server emulation (wire_version=3 option): refuse the v4
        // epoch envelope the way a pre-epoch build does, driving the
        // client's progressive 4 -> 3 downgrade path
        ctr.Add(kCtrFrameReject);
        reply = StatusReply(
            kStatusBadVersion,
            "unsupported wire version " + std::to_string(env.version) +
                " (server speaks up to 3)");
      } else if (env.versioned && env.version > kWireVersion) {
        ctr.Add(kCtrFrameReject);
        reply = StatusReply(
            kStatusBadVersion,
            "unsupported wire version " + std::to_string(env.version) +
                " (server speaks up to " + std::to_string(kWireVersion) +
                ")");
      } else {
        // kFaultHandlerStall sits between recv and the deadline check:
        // a delay fault ages the request so the deadline path below
        // fires deterministically; an err fault wedges the handler,
        // which abandons the connection (the client sees a reset and
        // retries)
        if (FaultHit(kFaultHandlerStall)) {
          CloseConn(c.fd);
          return;
        }
        // kFaultCrash at the handler point (FAULTS.md): the server
        // half of the postmortem drill — Fire raises the configured
        // fatal signal AFTER the kBbServerRecv record above, so the
        // dump's ring tail carries the fatal call's trace id.
        (void)FaultHit(kFaultCrash);
        if (env.deadline_ms >= 0 && NowMs() - ready_ms > env.deadline_ms) {
          // the client's budget is gone: an answer would be dead compute
          ctr.Add(kCtrDeadlineReject);
          reply = StatusReply(kStatusDeadline,
                              "deadline expired before dispatch");
        } else {
          try {
            handler_(req.data() + env.body_off, req.size() - env.body_off,
                     env, &reply);
          } catch (const std::exception& ex) {
            // a malformed request must come back as an error reply, not
            // tear down the connection (let alone the worker)
            reply = StatusReply(kStatusError,
                                std::string("server error: ") + ex.what());
          } catch (...) {
            reply = StatusReply(kStatusError, "server error");
          }
        }
      }
    }
    const uint64_t handler_us =
        rec ? static_cast<uint64_t>(TelemetryNowUs() - t_handle) : 0;
    if (rec) tel.Record(kHistServerHandler, op, handler_us);
    const uint8_t status =
        reply.empty() ? static_cast<uint8_t>(kStatusError)
                      : static_cast<uint8_t>(reply[0]);
    auto record_span = [&](uint64_t wire_us, uint8_t outcome) {
      if (!rec) return;
      TelemetrySpan sp;
      sp.side = kSpanServer;
      sp.op = op < kHistOpSlots ? op : 0;
      sp.shard = opt_.shard_idx;
      sp.trace = env.trace_id;
      sp.queue_us = queue_us;
      sp.handler_us = handler_us;
      sp.wire_us = wire_us;
      sp.total_us = queue_us + handler_us + wire_us;
      sp.outcome = outcome;
      tel.RecordSpan(sp);
    };
    // kFaultServiceReply drops the computed reply on the floor and
    // closes the connection — the client sees a mid-exchange reset and
    // must retry (possibly on another replica).
    if (FaultHit(kFaultServiceReply)) {
      record_span(0, kOutcomeDropped);
      CloseConn(c.fd);
      return;
    }
    const int64_t t_send = rec ? TelemetryNowUs() : 0;
    IoStatus ss = SendFrameEx(c.fd, reply);
    const uint8_t reply_outcome =
        ss != IoStatus::kOk         ? kOutcomeDropped
        : status == kStatusOk       ? kOutcomeOk
        : status == kStatusBusy     ? kOutcomeBusy
        : status == kStatusDeadline ? kOutcomeDeadline
                                    : kOutcomeError;
    record_span(rec ? static_cast<uint64_t>(TelemetryNowUs() - t_send) : 0,
                reply_outcome);
    Blackbox::Global().Record(kBbServerReply, op, opt_.shard_idx,
                              env.trace_id, reply.size(), reply_outcome);
    if (ss != IoStatus::kOk) {
      // kTimeout: the peer stopped reading and the send buffer filled —
      // again the socket timeout frees the slot
      if (ss == IoStatus::kTimeout) ctr.Add(kCtrHandlerTimeout);
      CloseConn(c.fd);
      return;
    }
    bool stopping;
    {
      std::lock_guard<PosixMutex> l(mu_);
      stopping = stop_;
    }
    if (stopping || draining_.load(std::memory_order_acquire)) {
      CloseConn(c.fd);
      return;
    }
    // fairness: with work waiting, hand the connection back; otherwise
    // linger briefly — a synchronous client's next request lands within
    // microseconds on loopback, and skipping the poller round-trip
    // keeps the hot path at thread-per-conn latency
    if (ready_count_.load(std::memory_order_relaxed) > 0) {
      ReturnConn(c.fd);
      return;
    }
    pollfd p{c.fd, POLLIN, 0};
    int pr = ::poll(&p, 1, opt_.linger_ms);
    if (pr <= 0 || !(p.revents & POLLIN)) {
      ReturnConn(c.fd);
      return;
    }
    ready_ms = NowMs();
  }
}

void AdmissionServer::Drain(int grace_ms) {
  if (!started_) return;
  bool first = false;
  {
    std::lock_guard<PosixMutex> l(mu_);
    if (!draining_.load(std::memory_order_relaxed)) {
      draining_.store(true, std::memory_order_release);
      first = true;
    }
  }
  if (first) Counters::Global().Add(kCtrDraining);
  Wake();
  if (grace_ms < 0) grace_ms = opt_.drain_ms;
  std::unique_lock<PosixMutex> l(mu_);
  drained_cv_.wait_for_ms(l, grace_ms, [this] {
    return conns_.load(std::memory_order_acquire) == 0;
  });
}

void AdmissionServer::Stop() {
  if (!started_) return;
  Drain(-1);
  {
    std::lock_guard<PosixMutex> l(mu_);
    stop_ = true;
    // grace expired with work still in flight: force every blocked IO
    // to return so the joins below stay prompt
    for (int fd : all_fds_) ::shutdown(fd, SHUT_RDWR);
  }
  ready_cv_.notify_all();
  Wake();
  if (poller_.joinable()) poller_.join();
  for (auto& t : workers_)
    if (t.joinable()) t.join();
  workers_.clear();
  std::set<int> leftover;
  {
    std::lock_guard<PosixMutex> l(mu_);
    leftover.swap(all_fds_);
    ready_.clear();
    returned_.clear();
  }
  for (int fd : leftover) ::close(fd);
  conns_.store(0, std::memory_order_release);
  ready_count_.store(0, std::memory_order_release);
  if (wake_r_ >= 0) ::close(wake_r_);
  if (wake_w_ >= 0) ::close(wake_w_);
  wake_r_ = wake_w_ = -1;
  started_ = false;
}

}  // namespace eg
