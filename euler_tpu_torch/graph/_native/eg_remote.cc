#include "eg_remote.h"

#include <dirent.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <sstream>
#include <thread>
#include <unordered_map>

#include "eg_blackbox.h"
#include "eg_fault.h"
#include "eg_heat.h"
#include "eg_registry.h"
#include "eg_stats.h"
#include "eg_telemetry.h"

namespace eg {

namespace {

int64_t NowMs() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Semicolon k=v parser — the string config form shared with the reference
// (reference euler/client/graph_config.cc:33-56, create_graph.cc:50-60).
std::map<std::string, std::string> ParseConfig(const std::string& s) {
  std::map<std::string, std::string> out;
  std::stringstream ss(s);
  std::string item;
  while (std::getline(ss, item, ';')) {
    size_t eq = item.find('=');
    if (eq == std::string::npos) continue;
    out[item.substr(0, eq)] = item.substr(eq + 1);
  }
  return out;
}

bool ParseHostPort(const std::string& s, std::string* host, int* port) {
  size_t c = s.rfind(':');
  if (c == std::string::npos) return false;
  *host = s.substr(0, c);
  *port = std::atoi(s.c_str() + c + 1);
  return *port > 0;
}

// Decode an EGResult encoded by the service (see WriteResult in
// eg_service.cc). Every encoded slot costs at least 8 bytes (its i64
// length prefix), so a slot count beyond remaining()/8 cannot be honest:
// reject it before the resize below turns a hostile count from a
// malformed reply into a multi-GB zero-fill (the round-2 service crash
// class, service-side fix in OversizedResult; this is the client side).
bool ReadResultBody(WireReader* r, EGResult* out) {
  int32_t n = r->I32();
  if (n < 0 || static_cast<uint64_t>(n) > r->remaining() / 8) return false;
  out->u64.resize(n);
  for (auto& v : out->u64) r->Vec(&v);
  n = r->I32();
  if (n < 0 || static_cast<uint64_t>(n) > r->remaining() / 8) return false;
  out->f32.resize(n);
  for (auto& v : out->f32) r->Vec(&v);
  n = r->I32();
  if (n < 0 || static_cast<uint64_t>(n) > r->remaining() / 8) return false;
  out->i32.resize(n);
  for (auto& v : out->i32) r->Vec(&v);
  n = r->I32();
  if (n < 0 || static_cast<uint64_t>(n) > r->remaining() / 8) return false;
  out->bytes.resize(n);
  for (auto& s : out->bytes) s = r->Str();
  return r->ok();
}

bool ReadResult(WireReader* r, EGResult* out) {
  if (ReadResultBody(r, out)) return true;
  Counters::Global().Add(kCtrFrameReject);
  return false;
}

// Weight-proportional draws from one adjacency slice just fetched by a
// neighbor-cache promote (kFullNeighbor) — the client-side twin of
// GraphStore::SampleNeighbors for the case where the slice is in hand
// rather than cached (NeighborCache::Sample covers the cached case).
void DrawFromSlice(const uint64_t* nid, const float* nw, const int32_t* nt,
                   int64_t len, int64_t draws, uint64_t default_id,
                   Rng& rng, uint64_t* out_ids, float* out_w,
                   int32_t* out_t) {
  std::vector<double> cum(static_cast<size_t>(len));
  double total = 0.0;
  for (int64_t k = 0; k < len; ++k) {
    total += nw[k] > 0.f ? static_cast<double>(nw[k]) : 0.0;
    cum[static_cast<size_t>(k)] = total;
  }
  if (total <= 0.0) {
    for (int64_t j = 0; j < draws; ++j) {
      out_ids[j] = default_id;
      out_w[j] = 0.f;
      out_t[j] = -1;
    }
    return;
  }
  for (int64_t j = 0; j < draws; ++j) {
    double r = rng.NextDouble() * total;
    size_t k = static_cast<size_t>(
        std::lower_bound(cum.begin(), cum.end(), r) - cum.begin());
    if (k >= cum.size()) k = cum.size() - 1;  // float rounding spill
    out_ids[j] = nid[k];
    out_w[j] = nw[k];
    out_t[j] = nt[k];
  }
}

// The stock error a pre-envelope (wire v1) server answers when it reads
// the v2 envelope marker as an op code — the downgrade-negotiation
// signal (see eg_wire.h). Matched exactly: a v2 server's genuine
// unknown-op errors name ops in the real op range, never the marker.
bool IsLegacyUnknownOpReply(const std::string& reply) {
  WireReader r(reply);
  if (r.U8() != kStatusError) return false;
  std::string msg = r.Str();
  return r.ok() && r.remaining() == 0 &&
         msg == "unknown op " + std::to_string(kWireEnvelope);
}

}  // namespace

// ---------------- ConnPool ----------------

ConnPool::Replica::~Replica() {
  for (int fd : idle) ::close(fd);
}

void ConnPool::AddReplica(const std::string& host, int port) {
  auto r = std::make_shared<Replica>();
  r->host = host;
  r->port = port;
  std::lock_guard<std::mutex> l(mu_);
  replicas_.push_back(std::move(r));
}

void ConnPool::Update(const std::vector<std::pair<std::string, int>>& addrs) {
  if (addrs.empty()) return;
  std::lock_guard<std::mutex> l(mu_);
  std::vector<std::shared_ptr<Replica>> next;
  next.reserve(addrs.size());
  for (const auto& [host, port] : addrs) {
    bool dup = false;
    for (const auto& r : next)
      if (r->host == host && r->port == port) dup = true;
    if (dup) continue;
    std::shared_ptr<Replica> keep;
    for (const auto& r : replicas_)
      if (r->host == host && r->port == port) keep = r;
    if (!keep) {
      keep = std::make_shared<Replica>();
      keep->host = host;
      keep->port = port;
    }
    next.push_back(std::move(keep));
  }
  replicas_.swap(next);
  // dropped replicas die (and close their pooled sockets) when the last
  // in-flight Call snapshot releases them
}

size_t ConnPool::num_replicas() const {
  std::lock_guard<std::mutex> l(mu_);
  return replicas_.size();
}

bool ConnPool::Call(const std::string& req, std::string* reply, int retries,
                    int timeout_ms, int quarantine_ms, int backoff_ms,
                    int deadline_ms, uint64_t req_epoch) const {
  // Telemetry (eg_telemetry.h): the whole call — every retry, backoff
  // and failover included — is one client_call histogram sample and one
  // candidate slow span; the span's trace id rides the v3 envelope so
  // the serving shard's journal shows the same request.
  Telemetry& tel = Telemetry::Global();
  const bool rec = tel.enabled();
  const uint8_t op = req.empty() ? 0 : static_cast<uint8_t>(req[0]);
  const uint64_t trace = rec ? NextTraceId() : 0;
  const int64_t t_call = rec ? TelemetryNowUs() : 0;
  uint64_t wire_us = 0;  // io time of the decisive (last) exchange
  auto finish = [&](bool ok, uint8_t outcome) {
    if (rec) {
      uint64_t total = static_cast<uint64_t>(TelemetryNowUs() - t_call);
      tel.Record(kHistClientCall, op, total);
      TelemetrySpan sp;
      sp.side = kSpanClient;
      sp.op = op < kHistOpSlots ? op : 0;
      sp.outcome = outcome;
      sp.shard = shard_;
      sp.trace = trace;
      sp.wire_us = wire_us;
      sp.total_us = total;
      tel.RecordSpan(sp);
    }
    // flight recorder (eg_blackbox.h): every finished call — trace id,
    // shard, and the wire bytes moved — lands in this thread's ring,
    // so a postmortem shows what the process was asking for when it
    // died (its own kill-switch; a failed call still records, reply
    // bytes count only when one arrived)
    Blackbox::Global().Record(
        kBbClientCall, op, shard_, trace,
        req.size() + (ok ? reply->size() : 0), outcome);
    return ok;
  };
  // snapshot: Update() may swap the set mid-call; shared_ptrs keep every
  // replica this exchange touches alive. Refreshed at every attempt
  // (below) so a call already mid-retry against a restarted shard picks
  // up the re-discovered address instead of burning its whole budget on
  // the dead one — the rolling-restart drill's zero-failed-calls bar.
  std::vector<std::shared_ptr<Replica>> reps;
  {
    std::lock_guard<std::mutex> l(mu_);
    reps = replicas_;
  }
  if (reps.empty()) return finish(false, kOutcomeFailed);
  Counters& ctr = Counters::Global();
  // Overall wall-clock budget spanning every attempt; the 0 default keeps
  // the previous worst case (each attempt bounded by timeout_ms).
  const int64_t deadline =
      NowMs() + (deadline_ms > 0
                     ? deadline_ms
                     : static_cast<int64_t>(timeout_ms) * (retries + 1));
  bool failed_before = false;
  int busy_streak = 0;
  for (int attempt = 0; attempt <= retries; ++attempt) {
    // Re-sample the clock each attempt: a slow earlier attempt must age
    // quarantine verdicts and count against the deadline (the old single
    // pre-loop NowMs() went stale across attempts).
    int64_t now = NowMs();
    if (attempt > 0) {
      ctr.Add(kCtrRetry);
      // Exponential backoff with full jitter: sleep uniform in
      // [0, base << (attempt-1)], capped at 2 s and at the remaining
      // deadline — a hot retry loop against a struggling shard is a
      // self-inflicted DDoS.
      int64_t cap = std::min<int64_t>(
          static_cast<int64_t>(backoff_ms) << std::min(attempt - 1, 16),
          2000);
      int64_t sleep_ms = cap > 0
                             ? static_cast<int64_t>(ThreadRng().NextLess(
                                   static_cast<uint64_t>(cap) + 1))
                             : 0;
      sleep_ms = std::min(sleep_ms, deadline - now);
      if (sleep_ms > 0) {
        std::this_thread::sleep_for(std::chrono::milliseconds(sleep_ms));
        if (rec)
          tel.Record(kHistBackoff, 0,
                     static_cast<uint64_t>(sleep_ms) * 1000);
        now = NowMs();
      }
      if (now >= deadline) {
        ctr.Add(kCtrDeadlineExceeded);
        break;
      }
      // re-snapshot: the background re-discovery may have learned a
      // restarted replica's new address while this call backed off
      {
        std::lock_guard<std::mutex> l(mu_);
        if (!replicas_.empty()) reps = replicas_;
      }
    }
    // One attempt may loop through several BUSY failovers: a shedding
    // server ANSWERED (it is alive, just refusing new work), so BUSY
    // burns neither a retry nor backoff nor a quarantine — only the
    // overall deadline bounds a fully busy replica set.
    for (;;) {
      // Round-robin replica choice skipping quarantined hosts; if every
      // host is quarantined, use the nominal one anyway (matches the
      // reference's bad-host re-admission behavior, rpc_manager.cc:64).
      size_t start = rr_.fetch_add(1) % reps.size();
      Replica* rep = reps[start].get();
      for (size_t k = 0; k < reps.size(); ++k) {
        Replica* cand = reps[(start + k) % reps.size()].get();
        if (cand->bad_until_ms.load(std::memory_order_relaxed) <= now) {
          rep = cand;
          break;
        }
      }
      // kFaultCrash at the dial point (FAULTS.md): the client half of
      // the postmortem drill — Fire raises the configured fatal signal
      // in THIS process (the blackbox handler dumps, then the default
      // disposition kills).
      (void)FaultHit(kFaultCrash);
      int fd = -1;
      {
        std::lock_guard<std::mutex> l(rep->mu);
        if (!rep->idle.empty()) {
          fd = rep->idle.back();
          rep->idle.pop_back();
        }
      }
      if (fd < 0) {
        const int64_t t_dial = rec ? TelemetryNowUs() : 0;
        fd = DialTcp(rep->host, rep->port, timeout_ms);
        if (rec)
          tel.Record(kHistDial, 0,
                     static_cast<uint64_t>(TelemetryNowUs() - t_dial));
      }
      if (fd < 0) {
        ctr.Add(kCtrDialFail);
        ctr.Add(kCtrQuarantine);
        rep->bad_until_ms.store(now + quarantine_ms,
                                std::memory_order_relaxed);
        failed_before = true;
        break;  // next attempt (through the backoff above)
      }
      // Wire envelope: stamp the call's REMAINING budget so the server
      // can refuse work nobody will read; v3 adds the trace id, v4 the
      // requested snapshot epoch (eg_epoch.h). Replicas that negotiated
      // down (old servers) get the raw v1 request.
      int ver = forced_version_
                    ? forced_version_
                    : rep->wire_version.load(std::memory_order_relaxed);
      bool sent_envelope = ver != 1;
      // version of the decisive exchange — the reply-stamp parse below
      // keys on it (only v4 Ok replies carry the epoch)
      int eff_ver = sent_envelope ? (ver ? ver : kWireVersion) : 1;
      auto exchange = [&](const std::string& payload) {
        const int64_t t_io = rec ? TelemetryNowUs() : 0;
        bool ok = SendFrame(fd, payload) && RecvFrame(fd, reply);
        if (rec) wire_us = static_cast<uint64_t>(TelemetryNowUs() - t_io);
        return ok;
      };
      auto wrap = [&](int v) {
        int64_t remaining = deadline - NowMs();
        if (remaining < 0) remaining = 0;
        eff_ver = v;
        return WrapEnvelope(req, remaining, v, v >= 3 ? trace : 0,
                            v >= 4 ? req_epoch : 0);
      };
      bool io_ok;
      if (sent_envelope) {
        io_ok = exchange(wrap(ver ? ver : kWireVersion));
      } else {
        io_ok = exchange(req);
      }
      if (io_ok && sent_envelope && ver == 0) {
        // First exchange against this replica: learn its wire version.
        if (IsLegacyUnknownOpReply(*reply)) {
          eff_ver = 1;
          rep->wire_version.store(1, std::memory_order_relaxed);
          ctr.Add(kCtrWireDowngrade);
          // the old server answered its stock error and kept the
          // connection healthy: resend the raw request on it
          io_ok = exchange(req);
        } else {
          // Progressive BadVersion ladder: each refusal only says "too
          // new", so step down ONE version per answer (4 -> 3 -> 2) and
          // resend on the same connection until the replica accepts.
          // The replica pins at the highest version it spoke; one
          // wire_downgrades count per replica pinned below this build.
          int probe = kWireVersion;
          while (io_ok && probe > 2 && !reply->empty() &&
                 static_cast<uint8_t>((*reply)[0]) == kStatusBadVersion) {
            --probe;
            io_ok = exchange(wrap(probe));
          }
          if (io_ok) {
            rep->wire_version.store(probe, std::memory_order_relaxed);
            if (probe < kWireVersion) ctr.Add(kCtrWireDowngrade);
          }
        }
      }
      if (io_ok) {
        uint8_t status = reply->empty()
                             ? static_cast<uint8_t>(kStatusError)
                             : static_cast<uint8_t>((*reply)[0]);
        if (status == kStatusBusy) {
          // admission shed this connection (and closed it server-side):
          // fail over to the next replica NOW, no backoff burned
          ::close(fd);
          ctr.Add(kCtrBusyFailover);
          failed_before = true;
          now = NowMs();
          if (now >= deadline) {
            ctr.Add(kCtrDeadlineExceeded);
            ctr.Add(kCtrCallFail);
            return finish(false, kOutcomeDeadline);
          }
          if (++busy_streak >= static_cast<int>(reps.size())) {
            // every replica shedding: pace the loop a little instead of
            // hammering the cluster at wire speed
            std::this_thread::sleep_for(std::chrono::milliseconds(2));
            busy_streak = 0;
          }
          continue;  // same attempt, next replica
        }
        busy_streak = 0;
        if (status == kStatusDeadline) {
          // the server refused dead work — the budget is gone client-
          // side too, so end the call; the connection stays healthy
          {
            std::lock_guard<std::mutex> l(rep->mu);
            rep->idle.push_back(fd);
          }
          ctr.Add(kCtrDeadlineExceeded);
          ctr.Add(kCtrCallFail);
          return finish(false, kOutcomeDeadline);
        }
        if (failed_before) ctr.Add(kCtrFailover);
        {
          std::lock_guard<std::mutex> l(rep->mu);
          rep->idle.push_back(fd);
        }
        // v4 Ok replies carry the shard's serving epoch right after the
        // status byte (the passive flip announcement, eg_epoch.h):
        // strip it so every downstream decoder sees the versionless
        // body, then hand it to the observer (which bumps the client
        // cache generation when the epoch moved). Error/BUSY/deadline
        // replies are never stamped.
        if (status == kStatusOk && eff_ver >= 4 && reply->size() >= 9) {
          uint64_t ep;
          std::memcpy(&ep, reply->data() + 1, sizeof(ep));
          reply->erase(1, 8);
          if (epoch_observer_) epoch_observer_(ep);
        }
        return finish(true, kOutcomeOk);
      }
      ::close(fd);
      ctr.Add(kCtrQuarantine);
      rep->bad_until_ms.store(now + quarantine_ms,
                              std::memory_order_relaxed);
      failed_before = true;
      break;  // next attempt
    }
  }
  ctr.Add(kCtrCallFail);
  return finish(false, kOutcomeFailed);
}

// ---------------- RemoteGraph ----------------

RemoteGraph::~RemoteGraph() {
  if (rediscover_thread_.joinable()) {
    rediscover_stop_.store(true, std::memory_order_release);
    rediscover_thread_.join();
  }
  // Drain in-flight async ops (SampleFanoutAsync chains): their hop
  // continuations run on the dispatcher pool and touch this object, so
  // every chain must reach kDone before the members destruct. A handle
  // abandoned without TakeAsync only parks its slot until here.
  {
    std::unique_lock<std::mutex> l(async_mu_);
    async_cv_.wait(l, [this] { return async_inflight_ == 0; });
  }
  // dispatcher_ (a member) destructs after this body: by then no query
  // is in flight, so its queue is empty and the workers join promptly
}

bool RemoteGraph::Discover(
    std::map<int, std::vector<std::pair<std::string, int>>>* shards,
    int timeout_ms) const {
  shards->clear();
  if (!reg_host_.empty()) {
    // TCP registry discovery (eg_registry.h): LIST returns only live
    // (unexpired) entries — the watch-children analog of the reference's
    // ZK monitor (zk_server_monitor.cc:50-64).
    std::map<int, std::vector<std::string>> listed;
    std::map<std::pair<int, std::string>, uint64_t> epochs;
    if (!RegistryList(reg_host_, reg_port_, timeout_ms, &listed, &epochs))
      return false;
    for (auto& [shard, addrs] : listed) {
      for (auto& a : addrs) {
        std::string host;
        int port;
        if (ParseHostPort(a, &host, &port)) {
          (*shards)[shard].emplace_back(host, port);
          // heartbeat epoch tokens are the discovery half of the flip
          // announcement — a client that goes quiet between steps still
          // learns a flip within one registry poll (no-op before Init
          // allocates the epoch table)
          auto it = epochs.find({shard, a});
          if (it != epochs.end() && it->second)
            ObserveEpoch(shard, it->second);
        }
      }
    }
    return true;
  }
  if (!reg_dir_.empty()) {
    DIR* d = opendir(reg_dir_.c_str());
    if (!d) return false;
    while (dirent* ent = readdir(d)) {
      std::string name = ent->d_name;
      size_t hash = name.find('#');
      if (hash == std::string::npos || hash == 0) continue;
      int shard = std::atoi(name.substr(0, hash).c_str());
      std::ifstream f(reg_dir_ + "/" + name);
      std::string line;
      if (!std::getline(f, line)) continue;
      std::string host;
      int port;
      if (ParseHostPort(line, &host, &port))
        (*shards)[shard].emplace_back(host, port);
    }
    closedir(d);
    return true;
  }
  return false;
}

void RemoteGraph::RediscoverLoop() {
  // The polled form of the reference's ZK watch subscription
  // (rpc_manager.h:77-80 + zk_server_monitor.cc:252-260): each pass
  // re-LISTs the registry and diffs addresses into the pools, so a shard
  // that died and came back on a new host:port serves again without the
  // client being rebuilt. Shards absent from one listing keep their old
  // replicas (quarantine handles them if truly gone) — TTL expiry is
  // transient during a slow restart.
  while (!rediscover_stop_.load(std::memory_order_acquire)) {
    for (int slept = 0;
         slept < rediscover_ms_ &&
         !rediscover_stop_.load(std::memory_order_acquire);
         slept += 50)
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
    if (rediscover_stop_.load(std::memory_order_acquire)) break;
    std::map<int, std::vector<std::pair<std::string, int>>> shards;
    // short dial budget: a blackholed registry must not pin this thread
    // (and thus ~RemoteGraph's join) for the full client timeout
    if (!Discover(&shards, std::min(timeout_ms_, 1000))) continue;
    for (int s = 0; s < num_shards_; ++s) {
      auto it = shards.find(s);
      if (it != shards.end()) pools_[s].Update(it->second);
    }
    Counters::Global().Add(kCtrRediscover);
  }
}

bool RemoteGraph::Init(const std::string& config) {
  auto cfg = ParseConfig(config);
  if (cfg.count("retries")) retries_ = std::stoi(cfg["retries"]);
  if (cfg.count("timeout_ms")) timeout_ms_ = std::stoi(cfg["timeout_ms"]);
  if (cfg.count("quarantine_ms"))
    quarantine_ms_ = std::stoi(cfg["quarantine_ms"]);
  if (cfg.count("backoff_ms")) backoff_ms_ = std::stoi(cfg["backoff_ms"]);
  if (cfg.count("deadline_ms")) deadline_ms_ = std::stoi(cfg["deadline_ms"]);
  if (cfg.count("coalesce")) coalesce_ = std::stoi(cfg["coalesce"]) != 0;
  if (cfg.count("strict")) strict_ = std::stoi(cfg["strict"]) != 0;
  if (cfg.count("chunk_ids")) chunk_ids_ = std::stoi(cfg["chunk_ids"]);
  if (chunk_ids_ < 1) chunk_ids_ = 1;
  if (cfg.count("dispatch_workers"))
    dispatch_workers_ = std::stoi(cfg["dispatch_workers"]);
  // wire_version=1 emulates a pre-envelope client (compat testing and an
  // operational escape hatch); 2 forces the deadline envelope without a
  // trace id; 3 forces the full trace envelope; absent = negotiate per
  // replica (the default — old servers are detected and downgraded).
  int wire_version = 0;
  if (cfg.count("wire_version")) {
    wire_version = std::stoi(cfg["wire_version"]);
    if (wire_version < 1 || wire_version > kWireVersion) {
      error_ = "wire_version must be 1.." + std::to_string(kWireVersion) +
               " (this build speaks " + std::to_string(kWireVersion) + ")";
      return false;
    }
  }
  // Observability kill-switch + slow-span journal capacity
  // (eg_telemetry.h) — process-global, like the failpoint registry.
  if (cfg.count("telemetry"))
    Telemetry::Global().SetEnabled(std::stoi(cfg["telemetry"]) != 0);
  // Data-plane heat profiler (eg_heat.h) — process-global: heat=0
  // stops id feeds/fan-out/cache-class recording, heat_topk= resizes
  // (and resets) the hot-key tracker.
  if (cfg.count("heat"))
    Heat::Global().SetEnabled(std::stoi(cfg["heat"]) != 0);
  if (cfg.count("heat_topk")) {
    int k = std::stoi(cfg["heat_topk"]);
    if (k < 1 || k > kHeatMaxTopK) {
      error_ = "heat_topk must be 1.." + std::to_string(kHeatMaxTopK) +
               " (fixed top-K tracker pool)";
      return false;
    }
    Heat::Global().SetTopK(k);
  }
  if (cfg.count("slow_spans")) {
    int cap = std::stoi(cfg["slow_spans"]);
    if (cap < 1) {
      error_ = "slow_spans must be >= 1 (journal capacity)";
      return false;
    }
    Telemetry::Global().SetSlowCapacity(cap);
  }
  // Dense-feature-row cache: default ON for remote graphs (the embedded
  // engine has no cache — its rows are already local memory); 0 disables.
  int cache_mb = 64;
  if (cfg.count("feature_cache_mb"))
    cache_mb = std::stoi(cfg["feature_cache_mb"]);
  if (cache_mb < 0) cache_mb = 0;
  fcache_.SetCapacity(static_cast<size_t>(cache_mb) << 20);
  // Neighbor-list cache: hot nodes' adjacency slices sampled locally
  // instead of per-hop wire round trips (eg_cache.h NeighborCache).
  int nbr_mb = 16;
  if (cfg.count("neighbor_cache_mb"))
    nbr_mb = std::stoi(cfg["neighbor_cache_mb"]);
  if (nbr_mb < 0) nbr_mb = 0;
  ncache_.SetCapacity(static_cast<size_t>(nbr_mb) << 20);
  // Shared admission policy of both caches: frequency-aware (TinyLFU
  // shape over the heat sketch) by default, fifo restores PR-3.
  if (cfg.count("cache_policy")) {
    const std::string& pol = cfg["cache_policy"];
    int policy;
    if (pol == "freq" || pol == "lfu") {
      policy = kCachePolicyFreq;
    } else if (pol == "fifo") {
      policy = kCachePolicyFifo;
    } else {
      error_ = "cache_policy must be 'freq' (TinyLFU-shaped admission, "
               "the default) or 'fifo' (unconditional admission)";
      return false;
    }
    fcache_.SetPolicy(policy);
    ncache_.SetPolicy(policy);
  }
  // placement=0 disables the init-time map fetch (always hash-route);
  // default 1 asks and falls back passively when no map exists.
  if (cfg.count("placement"))
    placement_enabled_ = std::stoi(cfg["placement"]) != 0;

  // Deterministic transport failpoints (eg_fault.h). Installed BEFORE the
  // per-shard kInfo fetches below, so even Init's own calls replay under
  // the configured faults — the seed owns the whole session.
  if (cfg.count("fault")) {
    uint64_t fseed = 0;
    if (cfg.count("fault_seed")) fseed = std::stoull(cfg["fault_seed"]);
    if (!FaultInjector::Global().Configure(cfg["fault"], fseed)) {
      error_ = FaultInjector::Global().error();
      return false;
    }
  }

  // shard -> replica address list
  std::map<int, std::vector<std::pair<std::string, int>>> shards;
  if (cfg.count("registry") &&
      cfg["registry"].compare(0, 6, "tcp://") == 0) {
    if (!ParseTcpRegistry(cfg["registry"], &reg_host_, &reg_port_)) {
      error_ = "bad tcp registry url " + cfg["registry"] +
               " (want tcp://host:port)";
      return false;
    }
    if (!Discover(&shards, timeout_ms_)) {
      error_ = "cannot reach tcp registry " + cfg["registry"];
      return false;
    }
  } else if (cfg.count("registry")) {
    reg_dir_ = cfg["registry"];
    if (!Discover(&shards, timeout_ms_)) {
      error_ = "cannot open registry dir " + cfg["registry"];
      return false;
    }
  } else if (cfg.count("shards")) {
    std::stringstream ss(cfg["shards"]);
    std::string shard_s;
    int idx = 0;
    while (std::getline(ss, shard_s, ',')) {
      std::stringstream rs(shard_s);
      std::string rep;
      while (std::getline(rs, rep, '|')) {
        std::string host;
        int port;
        if (ParseHostPort(rep, &host, &port))
          shards[idx].emplace_back(host, port);
      }
      ++idx;
    }
  } else {
    error_ = "remote config needs registry= or shards=";
    return false;
  }

  num_shards_ = shards.empty() ? 0 : shards.rbegin()->first + 1;
  if (num_shards_ <= 0) {
    error_ = "no shards discovered";
    return false;
  }
  pools_ = std::vector<ConnPool>(num_shards_);
  for (int s = 0; s < num_shards_; ++s) {
    if (!shards.count(s) || shards[s].empty()) {
      error_ = "no replicas for shard " + std::to_string(s);
      return false;
    }
    // set before the kInfo fetches below so even Init's own calls speak
    // the pinned version
    if (wire_version) pools_[s].SetForcedWireVersion(wire_version);
    pools_[s].SetShard(s);
    for (auto& [host, port] : shards[s]) pools_[s].AddReplica(host, port);
  }
  // Snapshot-epoch client state (eg_epoch.h): per-shard last-observed
  // epoch + the cache generation. Observers installed before the kInfo
  // fetches below, so even Init's own calls learn an already-flipped
  // cluster's epochs.
  shard_epoch_.reset(new std::atomic<uint64_t>[num_shards_]);
  for (int s = 0; s < num_shards_; ++s) {
    shard_epoch_[s].store(0, std::memory_order_relaxed);
    pools_[s].SetEpochObserver(
        [this, s](uint64_t e) { ObserveEpoch(s, e); });
  }

  // Persistent scatter/gather pool: sized so every shard can be in
  // flight at once with headroom for chunk fan-out and multiple client
  // threads (prefetch workers) sharing the graph.
  int workers = dispatch_workers_ > 0
                    ? dispatch_workers_
                    : std::min(64, std::max(8, 2 * num_shards_));
  dispatcher_ = std::make_unique<Dispatcher>(workers);

  // Per-shard meta: weight sums for cross-shard weighted sampling (the role
  // of the reference's ZK shard_meta node_sum_weight/edge_sum_weight,
  // graph_service.cc:141-142 <-> remote_graph.cc:122-155).
  shard_node_wsum_.resize(num_shards_);
  shard_edge_wsum_.resize(num_shards_);
  for (int s = 0; s < num_shards_; ++s) {
    WireWriter req;
    req.U8(kInfo);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) {
      error_ = "cannot fetch info from shard " + std::to_string(s);
      return false;
    }
    WireReader r(reply);
    r.U8();  // status already checked in Call
    int64_t nn = r.I64(), ne = r.I64();
    int32_t ntn = r.I32(), etn = r.I32();
    int32_t f[6];
    for (int k = 0; k < 6; ++k) f[k] = r.I32();
    r.I32();  // shard_idx
    int32_t shard_num = r.I32(), nparts = r.I32();
    r.Vec(&shard_node_wsum_[s]);
    r.Vec(&shard_edge_wsum_[s]);
    if (!r.ok()) {
      error_ = "malformed info reply from shard " + std::to_string(s);
      return false;
    }
    // Type/slot counts are derived from each shard's local records, so a
    // shard holding no nodes of the highest types reports fewer types —
    // the global view is the max (weight vectors are zero-padded below).
    node_type_num_ = std::max(node_type_num_, ntn);
    edge_type_num_ = std::max(edge_type_num_, etn);
    for (int k = 0; k < 6; ++k) fnum_[k] = std::max(fnum_[k], f[k]);
    if (s == 0) {
      num_partitions_ = nparts;
    } else if (nparts != num_partitions_) {
      error_ = "inconsistent num_partitions across shards";
      return false;
    }
    if (shard_num != num_shards_) {
      error_ = "shard " + std::to_string(s) + " was started with shard_num " +
               std::to_string(shard_num) + " but " +
               std::to_string(num_shards_) + " shards are registered";
      return false;
    }
    num_nodes_ += nn;
    num_edges_ += ne;
  }
  // eg-lint: allow(config-parity) `cfg` here is the shard's registry/kInfo
  // reply map, not operator config: num_partitions is written by the
  // partitioner and read back, never a user-facing key.
  if (cfg.count("num_partitions"))
    num_partitions_ = std::stoi(cfg["num_partitions"]);
  if (num_partitions_ <= 0) num_partitions_ = num_shards_;

  // Placement-map fetch (eg_placement.h): one kPlacement exchange with
  // shard 0 (every shard serves the same artifact). Negotiated
  // passively like wire v2/v3: an old server — or a shard on
  // hash-sharded data, which answers the identical stock error —
  // degrades this client to hash routing (placement_fallbacks). A map
  // that ARRIVES but is corrupt or inconsistent fails init loudly:
  // routing by a half-trusted map would misroute silently.
  if (placement_enabled_) {
    WireWriter preq;
    preq.U8(kPlacement);
    std::string reply;
    bool got = pools_[0].Call(preq.buf(), &reply, retries_, timeout_ms_,
                              quarantine_ms_, backoff_ms_, deadline_ms_) &&
               !reply.empty() &&
               static_cast<uint8_t>(reply[0]) == kStatusOk;
    if (got) {
      WireReader r(reply);
      r.U8();
      std::string blob = r.Str();
      if (!r.ok()) {
        error_ = "malformed placement reply from shard 0";
        return false;
      }
      if (!placement_.Parse(blob, &error_)) return false;
      if (placement_.num_partitions() != num_partitions_) {
        error_ = "placement map declares " +
                 std::to_string(placement_.num_partitions()) +
                 " partitions but the cluster reports " +
                 std::to_string(num_partitions_);
        return false;
      }
    } else {
      Counters::Global().Add(kCtrPlacementFallback);
    }
  }

  // Aggregate weight sums + cross-shard samplers.
  node_wsum_agg_.assign(node_type_num_, 0.f);
  edge_wsum_agg_.assign(edge_type_num_, 0.f);
  std::vector<float> node_tot(num_shards_, 0.f), edge_tot(num_shards_, 0.f);
  for (int s = 0; s < num_shards_; ++s) {
    shard_node_wsum_[s].resize(node_type_num_, 0.f);
    shard_edge_wsum_[s].resize(edge_type_num_, 0.f);
    for (int t = 0; t < node_type_num_; ++t) {
      node_wsum_agg_[t] += shard_node_wsum_[s][t];
      node_tot[s] += shard_node_wsum_[s][t];
    }
    for (int t = 0; t < edge_type_num_; ++t) {
      edge_wsum_agg_[t] += shard_edge_wsum_[s][t];
      edge_tot[s] += shard_edge_wsum_[s][t];
    }
  }
  node_shard_total_.Build(node_tot);
  edge_shard_total_.Build(edge_tot);
  node_shard_by_type_.resize(node_type_num_);
  edge_shard_by_type_.resize(edge_type_num_);
  std::vector<float> w(num_shards_);
  for (int t = 0; t < node_type_num_; ++t) {
    for (int s = 0; s < num_shards_; ++s) w[s] = shard_node_wsum_[s][t];
    node_shard_by_type_[t].Build(w);
  }
  for (int t = 0; t < edge_type_num_; ++t) {
    for (int s = 0; s < num_shards_; ++s) w[s] = shard_edge_wsum_[s][t];
    edge_shard_by_type_[t].Build(w);
  }

  // Mid-run re-discovery (registry modes only; static shards= lists have
  // no source to poll). Default 3000 ms; rediscover_ms=0 disables.
  rediscover_ms_ = cfg.count("rediscover_ms")
                       ? std::stoi(cfg["rediscover_ms"])
                       : 3000;
  if (rediscover_ms_ > 0 && (!reg_host_.empty() || !reg_dir_.empty())) {
    rediscover_stop_ = false;
    rediscover_thread_ = std::thread([this] {
      try {
        RediscoverLoop();
      } catch (...) {
        // std::terminate barrier (eg-lint: thread-catch): losing
        // re-discovery degrades to the static replica set; quarantine
        // still routes around dead hosts
      }
    });
  }
  return true;
}

void RemoteGraph::TypeWeightSums(int kind, float* out) const {
  const auto& v = kind == 0 ? node_wsum_agg_ : edge_wsum_agg_;
  std::copy(v.begin(), v.end(), out);
}

bool RemoteGraph::Call(int shard, const std::string& req,
                       std::string* reply, uint64_t epoch) const {
  if (!pools_[shard].Call(req, reply, retries_, timeout_ms_, quarantine_ms_,
                          backoff_ms_, deadline_ms_, epoch))
    return false;
  if (reply->empty() || (*reply)[0] != 0) {
    // transport delivered a frame, but the shard refused the request —
    // visible in the ledger as a rejected frame, not a silent default
    Counters::Global().Add(kCtrFrameReject);
    return false;
  }
  return true;
}

void RemoteGraph::ObserveEpoch(int shard, uint64_t epoch) const {
  if (!shard_epoch_ || shard < 0 || shard >= num_shards_) return;
  uint64_t cur = shard_epoch_[shard].load(std::memory_order_relaxed);
  // Monotonic raise: stale announcements (a reply that raced a flip, a
  // lagging registry token) never move the epoch backwards, so the
  // cache generation bumps exactly once per observed flip per shard.
  while (epoch > cur) {
    if (shard_epoch_[shard].compare_exchange_weak(
            cur, epoch, std::memory_order_acq_rel)) {
      cache_gen_.fetch_add(1, std::memory_order_acq_rel);
      return;
    }
  }
}

uint64_t RemoteGraph::Epoch() const {
  uint64_t mx = 0;
  if (shard_epoch_)
    for (int s = 0; s < num_shards_; ++s)
      mx = std::max(mx, shard_epoch_[s].load(std::memory_order_relaxed));
  return mx;
}

bool RemoteGraph::LoadDelta(int shard, const std::string& path,
                            uint64_t* new_epoch, std::string* error) const {
  if (shard < 0 || shard >= num_shards_) {
    *error = "bad shard index " + std::to_string(shard);
    return false;
  }
  WireWriter req;
  req.U8(kLoadDelta);
  req.Str(path);
  std::string reply;
  // raw pool call (not Call): an error status must surface the shard's
  // message, not collapse into a counted frame reject
  if (!pools_[shard].Call(req.buf(), &reply, retries_, timeout_ms_,
                          quarantine_ms_, backoff_ms_, deadline_ms_)) {
    *error = "shard " + std::to_string(shard) +
             " unreachable for load_delta";
    return false;
  }
  WireReader r(reply);
  uint8_t status = r.U8();
  if (status != kStatusOk) {
    std::string msg = r.Str();
    *error = r.ok() && !msg.empty()
                 ? msg
                 : "load_delta failed on shard " + std::to_string(shard);
    return false;
  }
  // the v4 epoch stamp was already stripped (and observed — this
  // client's caches invalidated) by ConnPool; the body is the new epoch
  *new_epoch = r.U64();
  if (!r.ok()) {
    *error = "malformed load_delta reply from shard " +
             std::to_string(shard);
    return false;
  }
  // belt over suspenders for pre-stamp replicas: the reply body itself
  // announces the flip even when the envelope negotiated below v4
  ObserveEpoch(shard, *new_epoch);
  return true;
}

bool RemoteGraph::PingShard(int shard) const {
  if (shard < 0 || shard >= num_shards_) return false;
  WireWriter req;
  req.U8(kPing);
  std::string reply;
  // reply is the bare ok-status byte; Call already validated it
  return Call(shard, req.buf(), &reply);
}

bool RemoteGraph::ScrapeShard(int shard, std::string* json) const {
  if (shard < 0 || shard >= num_shards_) return false;
  WireWriter req;
  req.U8(kStats);
  std::string reply;
  if (!Call(shard, req.buf(), &reply)) return false;
  WireReader r(reply);
  r.U8();  // status already checked in Call
  *json = r.Str();
  return r.ok();
}

bool RemoteGraph::HistoryShard(int shard, std::string* json) const {
  if (shard < 0 || shard >= num_shards_) return false;
  WireWriter req;
  req.U8(kHistory);
  std::string reply;
  if (!Call(shard, req.buf(), &reply)) return false;
  WireReader r(reply);
  r.U8();  // status already checked in Call
  *json = r.Str();
  return r.ok();
}

bool RemoteGraph::HeatShard(int shard, std::string* json) const {
  if (shard < 0 || shard >= num_shards_) return false;
  WireWriter req;
  req.U8(kHeat);
  std::string reply;
  if (!Call(shard, req.buf(), &reply)) return false;
  WireReader r(reply);
  r.U8();  // status already checked in Call
  *json = r.Str();
  return r.ok();
}

std::string RemoteGraph::TakeStrictError() const {
  std::lock_guard<std::mutex> l(strict_mu_);
  std::string out;
  out.swap(strict_error_);
  return out;
}

void RemoteGraph::ShardFailed(int shard, const char* what) const {
  // Pre-dispatcher ForShards threw this bool away: a fully-failed shard
  // silently yielded default rows. Now every op-level shard failure is
  // at least counted, and under strict= it surfaces as an error.
  Counters::Global().Add(kCtrRpcError);
  if (!strict_) return;
  std::lock_guard<std::mutex> l(strict_mu_);
  if (strict_error_.empty())
    strict_error_ = std::string(what) + ": shard " + std::to_string(shard) +
                    " failed after all transport retries (strict=1; see "
                    "rpc_errors/calls_failed counters)";
}

void RemoteGraph::GroupByShard(const uint64_t* ids, int n,
                               std::vector<std::vector<int32_t>>* rows) const {
  rows->assign(num_shards_, {});
  for (int i = 0; i < n; ++i) (*rows)[ShardOf(ids[i])].push_back(i);
}

void RemoteGraph::BuildPlan(const uint64_t* ids, int n,
                            ShardPlan* p) const {
  p->rows.assign(num_shards_, {});
  p->reps.assign(num_shards_, {});
  p->shard_of.assign(n, -1);
  p->pos_of.assign(n, 0);
  p->occ_of.assign(n, 0);
  p->coalesced = 0;
  if (!coalesce_) {
    for (int i = 0; i < n; ++i) {
      int s = ShardOf(ids[i]);
      p->shard_of[i] = s;
      p->pos_of[i] = static_cast<int32_t>(p->rows[s].size());
      p->rows[s].push_back(i);
      p->reps[s].push_back(1);
    }
    return;
  }
  // id -> position within its shard's unique list (the shard itself is a
  // pure function of the id, so it needs no storing)
  std::unordered_map<uint64_t, int32_t> seen;
  seen.reserve(static_cast<size_t>(n) * 2);
  for (int i = 0; i < n; ++i) {
    int s = ShardOf(ids[i]);
    auto [it, fresh] = seen.emplace(ids[i], 0);
    if (fresh) {
      it->second = static_cast<int32_t>(p->rows[s].size());
      p->rows[s].push_back(i);
      p->reps[s].push_back(1);
    } else {
      ++p->reps[s][it->second];
      ++p->coalesced;
    }
    p->shard_of[i] = s;
    p->pos_of[i] = it->second;
    p->occ_of[i] = p->reps[s][it->second] - 1;
  }
  if (p->coalesced)
    Counters::Global().Add(kCtrIdsDeduped,
                           static_cast<uint64_t>(p->coalesced));
}

void RemoteGraph::BuildEdgePlan(const uint64_t* src, int n,
                                ShardPlan* p) const {
  p->rows.assign(num_shards_, {});
  p->reps.assign(num_shards_, {});
  p->shard_of.assign(n, -1);
  p->pos_of.assign(n, 0);
  p->occ_of.assign(n, 0);
  p->coalesced = 0;
  for (int i = 0; i < n; ++i) {
    int s = ShardOf(src[i]);
    p->shard_of[i] = s;
    p->pos_of[i] = static_cast<int32_t>(p->rows[s].size());
    p->rows[s].push_back(i);
    p->reps[s].push_back(1);
  }
}

void RemoteGraph::ForShards(const std::vector<std::vector<int32_t>>& rows,
                            const char* what,
                            const std::function<bool(int)>& fn) const {
  std::vector<std::function<void()>> jobs;
  jobs.reserve(rows.size());
  for (int s = 0; s < static_cast<int>(rows.size()); ++s)
    if (!rows[s].empty())
      jobs.emplace_back([this, &fn, s, what] {
        // flight recorder: timestamp this worker picking up a shard
        // job, so a postmortem shows which shards the dispatcher pool
        // was fanning out to in its final seconds
        Blackbox::Global().Record(kBbDispatch, 0, s, 0, 0, 0);
        bool ok = false;
        try {
          ok = fn(s);
        } catch (...) {
          // a throwing shard call degrades like a failed one — its rows
          // keep their prefilled defaults (and the failure is recorded)
          ok = false;
        }
        if (!ok) ShardFailed(s, what);
      });
  dispatcher_->Run(jobs);
}

void RemoteGraph::RunChunked(
    const std::vector<std::vector<int32_t>>& lists, const char* what,
    const std::function<bool(int, int32_t, int32_t)>& chunk_fn) const {
  std::vector<std::function<void()>> jobs;
  for (int s = 0; s < static_cast<int>(lists.size()); ++s) {
    int32_t m = static_cast<int32_t>(lists[s].size());
    if (m == 0) continue;
    int32_t step = std::min<int32_t>(chunk_ids_, m);
    if (m > step)
      Counters::Global().Add(kCtrRpcChunk,
                             static_cast<uint64_t>((m + step - 1) / step));
    for (int32_t b = 0; b < m; b += step) {
      int32_t e = std::min(m, b + step);
      jobs.emplace_back([this, &chunk_fn, s, b, e, what] {
        Blackbox::Global().Record(kBbDispatch, 0, s, 0,
                                  static_cast<uint64_t>(e - b), 0);
        bool ok = false;
        try {
          ok = chunk_fn(s, b, e);
        } catch (...) {
          ok = false;
        }
        if (!ok) ShardFailed(s, what);
      });
    }
  }
  dispatcher_->Run(jobs);
}

void RemoteGraph::DrawShards(bool edges, int32_t type, int count,
                             int* out) const {
  Rng& rng = ThreadRng();
  const PrefixTable* table;
  if (type < 0)
    table = edges ? &edge_shard_total_ : &node_shard_total_;
  else
    table = edges ? &edge_shard_by_type_[type] : &node_shard_by_type_[type];
  for (int i = 0; i < count; ++i)
    out[i] = static_cast<int>(table->Draw(rng));
}

void RemoteGraph::SampleNode(int count, int32_t type, uint64_t* out) const {
  if (count <= 0) return;
  if (type >= node_type_num_) {
    std::fill(out, out + count, 0);
    return;
  }
  // Per-draw shard assignment proportional to shard weight sums, then one
  // batched SampleNode per shard, results distributed back to draw slots —
  // iid-equivalent to the reference's multinomial split + concat
  // (REMOTE_SAMPLE, remote_graph.cc:195-221).
  std::vector<int> draw_shard(count);
  DrawShards(false, type, count, draw_shard.data());
  std::vector<std::vector<int32_t>> rows(num_shards_);
  for (int i = 0; i < count; ++i) rows[draw_shard[i]].push_back(i);
  std::fill(out, out + count, 0);
  ForShards(rows, "sample_node", [&](int s) {
    WireWriter req;
    req.U8(kSampleNode);
    req.I32(static_cast<int32_t>(rows[s].size()));
    req.I32(type);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    int64_t m;
    const uint64_t* ids = r.Arr<uint64_t>(&m);
    if (!r.ok() || m != static_cast<int64_t>(rows[s].size())) return false;
    for (int64_t j = 0; j < m; ++j) out[rows[s][j]] = ids[j];
    return true;
  });
}

void RemoteGraph::SampleEdge(int count, int32_t type, uint64_t* out_src,
                             uint64_t* out_dst, int32_t* out_type) const {
  if (count <= 0) return;
  std::fill(out_src, out_src + count, 0);
  std::fill(out_dst, out_dst + count, 0);
  std::fill(out_type, out_type + count, -1);
  if (type >= edge_type_num_) return;
  std::vector<int> draw_shard(count);
  DrawShards(true, type, count, draw_shard.data());
  std::vector<std::vector<int32_t>> rows(num_shards_);
  for (int i = 0; i < count; ++i) rows[draw_shard[i]].push_back(i);
  ForShards(rows, "sample_edge", [&](int s) {
    WireWriter req;
    req.U8(kSampleEdge);
    req.I32(static_cast<int32_t>(rows[s].size()));
    req.I32(type);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    int64_t m, m2, m3;
    const uint64_t* src = r.Arr<uint64_t>(&m);
    const uint64_t* dst = r.Arr<uint64_t>(&m2);
    const int32_t* t = r.Arr<int32_t>(&m3);
    if (!r.ok() || m != static_cast<int64_t>(rows[s].size()) || m2 != m ||
        m3 != m)
      return false;
    for (int64_t j = 0; j < m; ++j) {
      out_src[rows[s][j]] = src[j];
      out_dst[rows[s][j]] = dst[j];
      out_type[rows[s][j]] = t[j];
    }
    return true;
  });
}

void RemoteGraph::GetNodeType(const uint64_t* ids, int n,
                              int32_t* out) const {
  std::fill(out, out + n, -1);
  if (n <= 0) return;
  ShardPlan plan;
  BuildPlan(ids, n, &plan);
  // per-shard staging over UNIQUE entries; chunks write disjoint ranges
  std::vector<std::vector<int32_t>> got(num_shards_);
  std::vector<std::vector<char>> ok(num_shards_);
  for (int s = 0; s < num_shards_; ++s) {
    got[s].assign(plan.rows[s].size(), -1);
    ok[s].assign(plan.rows[s].size(), 0);
  }
  RunChunked(plan.rows, "node_type", [&](int s, int32_t b, int32_t e) {
    std::vector<uint64_t> sub(static_cast<size_t>(e - b));
    for (int32_t j = b; j < e; ++j) sub[j - b] = ids[plan.rows[s][j]];
    // heat feed (eg_heat.h): every id that goes on the wire,
    // post-coalesce, tagged by op — this runs ON the dispatcher worker
    Heat::Global().Record(kHeatClient, kNodeType, sub.data(),
                          static_cast<int64_t>(sub.size()));
    WireWriter req;
    req.U8(kNodeType);
    req.Arr(sub);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    int64_t m;
    const int32_t* t = r.Arr<int32_t>(&m);
    if (!r.ok() || m != static_cast<int64_t>(sub.size())) return false;
    for (int64_t j = 0; j < m; ++j) {
      got[s][b + j] = t[j];
      ok[s][b + j] = 1;
    }
    return true;
  });
  for (int i = 0; i < n; ++i) {
    int s = plan.shard_of[i];
    if (s >= 0 && ok[s][plan.pos_of[i]]) out[i] = got[s][plan.pos_of[i]];
  }
}

bool RemoteGraph::GetNodeWeight(const uint64_t* ids, int n,
                                float* out) const {
  std::fill(out, out + n, 0.f);
  if (n <= 0) return true;
  ShardPlan plan;
  BuildPlan(ids, n, &plan);
  std::vector<std::vector<float>> got(num_shards_);
  std::vector<std::vector<char>> ok(num_shards_);
  for (int s = 0; s < num_shards_; ++s) {
    got[s].assign(plan.rows[s].size(), 0.f);
    ok[s].assign(plan.rows[s].size(), 0);
  }
  RunChunked(plan.rows, "node_weight", [&](int s, int32_t b, int32_t e) {
    std::vector<uint64_t> sub(static_cast<size_t>(e - b));
    for (int32_t j = b; j < e; ++j) sub[j - b] = ids[plan.rows[s][j]];
    Heat::Global().Record(kHeatClient, kNodeWeight, sub.data(),
                          static_cast<int64_t>(sub.size()));
    WireWriter req;
    req.U8(kNodeWeight);
    req.Arr(sub);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    int64_t m;
    const float* w = r.Arr<float>(&m);
    if (!r.ok() || m != static_cast<int64_t>(sub.size())) return false;
    for (int64_t j = 0; j < m; ++j) {
      got[s][b + j] = w[j];
      ok[s][b + j] = 1;
    }
    return true;
  });
  // Unlike the query ops (which degrade failed rows to defaults), a
  // weight silently read as 0 would bias the exported device sampler —
  // so any missing unique row fails the whole batch.
  for (int s = 0; s < num_shards_; ++s)
    for (char f : ok[s])
      if (!f) return false;
  for (int i = 0; i < n; ++i) {
    int s = plan.shard_of[i];
    if (s >= 0) out[i] = got[s][plan.pos_of[i]];
  }
  return true;
}

void RemoteGraph::SampleNodeWithSrc(const uint64_t* src, int n, int count,
                                    uint64_t* out) const {
  // Engine semantics (eg_engine.cc SampleNodeWithSrc): each row samples
  // `count` nodes from the global sampler of the src node's type (type -1 —
  // missing src — falls back to the all-types sampler). Remotely: resolve
  // src types, draw a shard per (row, draw) from that type's cross-shard
  // table, batch one SampleNode per (shard, type) on the dispatcher.
  std::vector<int32_t> types(n);
  GetNodeType(src, n, types.data());
  Rng& rng = ThreadRng();
  int64_t total = static_cast<int64_t>(n) * count;
  std::fill(out, out + total, 0);
  // (shard, type) -> slot list into out
  std::map<std::pair<int, int32_t>, std::vector<int64_t>> groups;
  for (int i = 0; i < n; ++i) {
    int32_t t = types[i] >= 0 && types[i] < node_type_num_ ? types[i] : -1;
    const PrefixTable& table =
        t < 0 ? node_shard_total_ : node_shard_by_type_[t];
    for (int j = 0; j < count; ++j) {
      int s = static_cast<int>(table.Draw(rng));
      groups[{s, t}].push_back(static_cast<int64_t>(i) * count + j);
    }
  }
  std::vector<std::function<void()>> jobs;
  jobs.reserve(groups.size());
  for (auto& [key, slots] : groups) {
    jobs.emplace_back([this, &key = key, &slots = slots, out] {
      bool ok = false;
      try {
        WireWriter req;
        req.U8(kSampleNode);
        req.I32(static_cast<int32_t>(slots.size()));
        req.I32(key.second);
        std::string reply;
        if (Call(key.first, req.buf(), &reply)) {
          WireReader r(reply);
          r.U8();
          int64_t m;
          const uint64_t* ids = r.Arr<uint64_t>(&m);
          if (r.ok() && m == static_cast<int64_t>(slots.size())) {
            for (int64_t j = 0; j < m; ++j) out[slots[j]] = ids[j];
            ok = true;
          }
        }
      } catch (...) {
        // this group's slots keep their prefilled zeros, like a failed
        // Call (the failure is recorded below)
        ok = false;
      }
      if (!ok) ShardFailed(key.first, "sample_node_with_src");
    });
  }
  dispatcher_->Run(jobs);
}

void RemoteGraph::NbrPrep(NbrCall* c) const {
  int64_t total = static_cast<int64_t>(c->n) * c->count;
  if (total > 0) {
    std::fill(c->out_ids, c->out_ids + total, c->default_id);
    std::fill(c->out_w, c->out_w + total, 0.f);
    std::fill(c->out_t, c->out_t + total, -1);
  }
  if (c->n <= 0 || c->count <= 0) return;
  BuildPlan(c->ids, c->n, &c->plan);
  // Per-shard staging over the unique entries' draw blocks: unique entry
  // j owns reps[j] * count contiguous draws at rep_off[j] * count; each
  // original row takes the block at (rep_off[pos] + occ) * count, so
  // duplicate rows receive DISTINCT (still iid) draws.
  //
  // Locality split (eg_cache.h NeighborCache): each unique entry takes
  // one of three paths —
  //   * CACHED: its adjacency slice is in the neighbor cache; sample
  //     locally, zero wire bytes (nbr_cache_hits);
  //   * PROMOTE: the heat sketch marks it hot (est >=
  //     kNbrPromoteMinFreq) — fetch its FULL slice once (kFullNeighbor),
  //     cache it, sample locally from the fetched slice;
  //   * FETCH: cold — the plain per-draw wire path, as before.
  Heat& heat = Heat::Global();
  c->heat_on = heat.enabled();
  c->use_ncache = ncache_.enabled();
  // Snapshot-epoch capture (eg_epoch.h): unless the async chain already
  // stamped a whole-op capture into this slice, pin the call to the
  // generation/epochs observed NOW — every cache probe and wire chunk of
  // this call then reads one consistent snapshot even if a flip lands
  // mid-call.
  if (!c->epoch_captured) {
    c->gen = cache_gen_.load(std::memory_order_acquire);
    if (shard_epoch_) {
      c->pin.assign(static_cast<size_t>(num_shards_), 0);
      for (int s = 0; s < num_shards_; ++s)
        c->pin[s] = shard_epoch_[s].load(std::memory_order_relaxed);
    }
    c->epoch_captured = true;
  }
  c->nspec = c->use_ncache ? NeighborCache::SpecHash(c->etypes, c->net) : 0;
  c->rep_off.assign(num_shards_, {});
  c->sid.assign(num_shards_, {});
  c->sw.assign(num_shards_, {});
  c->st.assign(num_shards_, {});
  c->ok.assign(num_shards_, {});
  // unique positions per shard still needing the wire, by path
  c->fetch.assign(num_shards_, {});
  c->promote.assign(num_shards_, {});
  for (int s = 0; s < num_shards_; ++s) {
    size_t m = c->plan.rows[s].size();
    c->rep_off[s].assign(m + 1, 0);
    for (size_t j = 0; j < m; ++j)
      c->rep_off[s][j + 1] = c->rep_off[s][j] + c->plan.reps[s][j];
    size_t draws = static_cast<size_t>(c->rep_off[s][m]) * c->count;
    c->sid[s].assign(draws, c->default_id);
    c->sw[s].assign(draws, 0.f);
    c->st[s].assign(draws, -1);
    c->ok[s].assign(m, 0);
    if (m == 0) continue;
    std::vector<uint64_t> sub(m);
    for (size_t j = 0; j < m; ++j) sub[j] = c->ids[c->plan.rows[s][j]];
    // heat feed: every unique id, post-coalesce but PRE-cache — cache
    // hits are accesses too, and both the promotion gate and the
    // TinyLFU admission read these estimates (this access included)
    if (c->heat_on)
      heat.Record(kHeatClient,
                  coalesce_ ? kSampleNeighborUniq : kSampleNeighbor,
                  sub.data(), static_cast<int64_t>(m));
    Rng& rng = ThreadRng();
    for (size_t j = 0; j < m; ++j) {
      if (c->use_ncache) {
        int64_t draws_j =
            static_cast<int64_t>(c->plan.reps[s][j]) * c->count;
        int64_t dst = c->rep_off[s][j] * c->count;
        if (ncache_.Sample(c->nspec, sub[j], static_cast<int>(draws_j),
                           c->default_id, rng, c->sid[s].data() + dst,
                           c->sw[s].data() + dst, c->st[s].data() + dst,
                           c->gen)) {
          c->ok[s][j] = 1;
          ++c->nbr_hits;
          continue;
        }
        ++c->nbr_misses;
        if (c->heat_on &&
            heat.Estimate(kHeatClient, sub[j]) >= kNbrPromoteMinFreq) {
          c->promote[s].push_back(static_cast<int32_t>(j));
          continue;
        }
      }
      c->fetch[s].push_back(static_cast<int32_t>(j));
    }
  }
  Counters& ctr = Counters::Global();
  if (c->nbr_hits) ctr.Add(kCtrNbrCacheHit, c->nbr_hits);
  if (c->nbr_misses) ctr.Add(kCtrNbrCacheMiss, c->nbr_misses);
}

bool RemoteGraph::NbrFetchChunk(NbrCall* c, int s, int32_t b,
                                int32_t e) const {
  int32_t m = e - b;
  std::vector<uint64_t> sub(static_cast<size_t>(m));
  std::vector<int32_t> subreps(static_cast<size_t>(m));
  for (int32_t x = 0; x < m; ++x) {
    int32_t pos = c->fetch[s][b + x];
    sub[x] = c->ids[c->plan.rows[s][pos]];
    subreps[x] = c->plan.reps[s][pos];
  }
  WireWriter req;
  if (coalesce_) {
    // dedup'd form: each unique id once, with its repeat count
    req.U8(kSampleNeighborUniq);
    req.Arr(sub);
    req.Arr(subreps);
  } else {
    // pre-dedup wire shape (the bench A/B baseline); reps are all 1
    // here, so the reply layout is identical
    req.U8(kSampleNeighbor);
    req.Arr(sub);
  }
  req.Arr(c->etypes, c->net);
  req.I32(c->count);
  req.U64(c->default_id);
  std::string reply;
  if (!Call(s, req.buf(), &reply,
            c->pin.empty() ? 0 : c->pin[static_cast<size_t>(s)]))
    return false;
  Heat::Global().AddShardBytes(s, req.buf().size(), reply.size());
  WireReader r(reply);
  r.U8();
  int64_t mi, mw, mt;
  const uint64_t* rid = r.Arr<uint64_t>(&mi);
  const float* rw = r.Arr<float>(&mw);
  const int32_t* rt = r.Arr<int32_t>(&mt);
  int64_t want = 0;
  for (int32_t x = 0; x < m; ++x)
    want += static_cast<int64_t>(subreps[x]) * c->count;
  if (!r.ok() || mi != want || mw != want || mt != want) return false;
  // the fetched entries are a subset of the unique list, so their
  // reply blocks scatter per entry (no contiguous rep_off range)
  int64_t src = 0;
  for (int32_t x = 0; x < m; ++x) {
    int32_t pos = c->fetch[s][b + x];
    int64_t draws_x = static_cast<int64_t>(subreps[x]) * c->count;
    int64_t dst = c->rep_off[s][pos] * c->count;
    std::copy(rid + src, rid + src + draws_x, c->sid[s].begin() + dst);
    std::copy(rw + src, rw + src + draws_x, c->sw[s].begin() + dst);
    std::copy(rt + src, rt + src + draws_x, c->st[s].begin() + dst);
    c->ok[s][pos] = 1;
    src += draws_x;
  }
  return true;
}

bool RemoteGraph::NbrPromoteChunk(NbrCall* c, int s, int32_t b,
                                  int32_t e) const {
  int32_t m = e - b;
  std::vector<uint64_t> sub(static_cast<size_t>(m));
  for (int32_t x = 0; x < m; ++x)
    sub[x] = c->ids[c->plan.rows[s][c->promote[s][b + x]]];
  WireWriter req;
  req.U8(kFullNeighbor);
  req.Arr(sub);
  req.Arr(c->etypes, c->net);
  req.U8(0);
  std::string reply;
  if (!Call(s, req.buf(), &reply,
            c->pin.empty() ? 0 : c->pin[static_cast<size_t>(s)]))
    return false;
  Heat::Global().AddShardBytes(s, req.buf().size(), reply.size());
  WireReader r(reply);
  r.U8();
  EGResult res;
  if (!ReadResult(&r, &res)) return false;
  if (res.i32.size() != 2 || res.u64.size() != 1 || res.f32.size() != 1 ||
      res.i32[1].size() != static_cast<size_t>(m))
    return false;
  int64_t want = 0;
  for (int32_t x = 0; x < m; ++x) {
    if (res.i32[1][x] < 0) return false;
    want += res.i32[1][x];
  }
  if (res.u64[0].size() != static_cast<size_t>(want) ||
      res.f32[0].size() != static_cast<size_t>(want) ||
      res.i32[0].size() != static_cast<size_t>(want))
    return false;
  Rng& rng = ThreadRng();
  int64_t off = 0;
  for (int32_t x = 0; x < m; ++x) {
    int32_t pos = c->promote[s][b + x];
    int64_t len = res.i32[1][x];
    const uint64_t* nid = res.u64[0].data() + off;
    const float* nw = res.f32[0].data() + off;
    const int32_t* nt = res.i32[0].data() + off;
    // cache the slice for every later call (TinyLFU admission
    // may still refuse it — the draws below don't depend on
    // that verdict, the slice is in hand either way)
    ncache_.Put(c->nspec, sub[x], nid, nw, nt, static_cast<size_t>(len),
                c->gen);
    int64_t draws_x = static_cast<int64_t>(c->plan.reps[s][pos]) * c->count;
    int64_t dst = c->rep_off[s][pos] * c->count;
    DrawFromSlice(nid, nw, nt, len, draws_x, c->default_id, rng,
                  c->sid[s].data() + dst, c->sw[s].data() + dst,
                  c->st[s].data() + dst);
    c->ok[s][pos] = 1;
    off += len;
  }
  return true;
}

void RemoteGraph::NbrBuildJobs(
    NbrCall* c, std::vector<std::function<void()>>* jobs) const {
  // Same chunk splitting + counting + failure wrapping as RunChunked,
  // but emitting into a caller-owned job list: fetch and promote chunks
  // ride ONE dispatcher batch (their staged writes are disjoint —
  // rep_off blocks per unique entry, ok[] entries per path, the caches
  // internally locked), which is what lets the async path treat a whole
  // slice as a single detached batch with one completion continuation.
  Counters& ctr = Counters::Global();
  auto chunked = [&](const std::vector<std::vector<int32_t>>& lists,
                     bool promote_path) {
    for (int s = 0; s < static_cast<int>(lists.size()); ++s) {
      int32_t m = static_cast<int32_t>(lists[s].size());
      if (m == 0) continue;
      int32_t step = std::min<int32_t>(chunk_ids_, m);
      if (m > step)
        ctr.Add(kCtrRpcChunk, static_cast<uint64_t>((m + step - 1) / step));
      for (int32_t b = 0; b < m; b += step) {
        int32_t e = std::min(m, b + step);
        jobs->emplace_back([this, c, s, b, e, promote_path] {
          Blackbox::Global().Record(kBbDispatch, 0, s, 0,
                                    static_cast<uint64_t>(e - b), 0);
          bool ok = false;
          try {
            ok = promote_path ? NbrPromoteChunk(c, s, b, e)
                              : NbrFetchChunk(c, s, b, e);
          } catch (...) {
            // a throwing shard call degrades like a failed one — its
            // entries keep their prefilled defaults
            ok = false;
          }
          if (!ok) ShardFailed(s, "sample_neighbor");
        });
      }
    }
  };
  chunked(c->fetch, false);
  if (c->use_ncache) chunked(c->promote, true);
}

void RemoteGraph::NbrFinish(NbrCall* c) const {
  // fan-out attribution (eg_heat.h): ids_on_wire MEASURED as the sum of
  // the per-shard fetch + promote lists (what was actually encoded), so
  // the heat surface's ledger identity (ids_on_wire == ids_requested -
  // ids_deduped - cache_hits) is a real cross-check of the coalescing
  // plan AND the neighbor cache, not a restatement. cache_hits here are
  // NEIGHBOR-cache hits (locally sampled entries).
  if (c->heat_on) {
    uint64_t on_wire = 0;
    int touched = 0;
    for (int s = 0; s < num_shards_; ++s) {
      uint64_t wire_s = c->fetch[s].size() + c->promote[s].size();
      if (wire_s) {
        ++touched;
        on_wire += wire_s;
      }
    }
    Heat::Global().RecordFanout(kSampleNeighbor,
                                static_cast<uint64_t>(c->n),
                                static_cast<uint64_t>(c->plan.coalesced),
                                c->nbr_hits, on_wire, touched);
  }
  for (int i = 0; i < c->n; ++i) {
    int s = c->plan.shard_of[i];
    int32_t pos = c->plan.pos_of[i];
    if (s < 0 || !c->ok[s][pos]) continue;
    int64_t src_off = (c->rep_off[s][pos] + c->plan.occ_of[i]) * c->count;
    int64_t dst_off = static_cast<int64_t>(i) * c->count;
    std::copy(c->sid[s].begin() + src_off,
              c->sid[s].begin() + src_off + c->count,
              c->out_ids + dst_off);
    std::copy(c->sw[s].begin() + src_off,
              c->sw[s].begin() + src_off + c->count, c->out_w + dst_off);
    std::copy(c->st[s].begin() + src_off,
              c->st[s].begin() + src_off + c->count, c->out_t + dst_off);
  }
}

void RemoteGraph::SampleNeighbor(const uint64_t* ids, int n,
                                 const int32_t* etypes, int net, int count,
                                 uint64_t default_id, uint64_t* out_ids,
                                 float* out_w, int32_t* out_t) const {
  // The sync path over the shared phases: the caller's stack holds the
  // staging and Dispatcher::Run is the completion barrier. Same code
  // the async hop chain runs, so the two are distribution-identical.
  NbrCall c;
  c.ids = ids;
  c.n = n;
  c.etypes = etypes;
  c.net = net;
  c.count = count;
  c.default_id = default_id;
  c.out_ids = out_ids;
  c.out_w = out_w;
  c.out_t = out_t;
  NbrPrep(&c);
  if (c.n <= 0 || c.count <= 0) return;
  std::vector<std::function<void()>> jobs;
  NbrBuildJobs(&c, &jobs);
  dispatcher_->Run(jobs);
  NbrFinish(&c);
}

void RemoteGraph::SampleFanout(const uint64_t* ids, int n,
                               const int32_t* etypes_flat,
                               const int32_t* etype_counts,
                               const int32_t* counts, int nhops,
                               uint64_t default_id, uint64_t** out_ids,
                               float** out_w, int32_t** out_t) const {
  const uint64_t* cur = ids;
  int64_t cur_n = n;
  const int32_t* et = etypes_flat;
  // n * prod(counts) passes 2^31 at deep fanouts; the old
  // static_cast<int>(cur_n) silently truncated there. Issue each hop in
  // INT_MAX-bounded slices instead — the per-row scatter makes slicing
  // invisible to the result.
  const int64_t kSlice = int64_t{1} << 30;
  for (int h = 0; h < nhops; ++h) {
    for (int64_t off = 0; off < cur_n; off += kSlice) {
      int m = static_cast<int>(std::min<int64_t>(kSlice, cur_n - off));
      SampleNeighbor(cur + off, m, et, etype_counts[h], counts[h],
                     default_id, out_ids[h] + off * counts[h],
                     out_w[h] + off * counts[h], out_t[h] + off * counts[h]);
    }
    cur = out_ids[h];
    cur_n *= counts[h];
    et += etype_counts[h];
  }
}

namespace {

// SampleFanout's INT_MAX-bounded hop slicing, shared with the async
// cursor so both paths walk identical (hop, slice) sequences.
constexpr int64_t kFanoutSlice = int64_t{1} << 30;

// Step op's cursor past the slice just completed: next slice of the
// same hop, or the first slice of the next hop (the finished hop's
// output becomes the frontier). Single-writer — see eg_async.h.
void AdvanceFanoutCursor(AsyncSampleOp* op) {
  op->slice_off += kFanoutSlice;
  if (op->slice_off >= op->cur_n) {
    op->cur = op->out_ids[op->hop];
    op->cur_n *= op->counts[op->hop];
    op->et += op->etype_counts[op->hop];
    ++op->hop;
    op->slice_off = 0;
  }
}

}  // namespace

void RemoteGraph::StartSlice(AsyncSampleOp* op) const {
  for (;;) {
    if (op->hop >= op->nhops) {
      // whole fan-out complete: publish kDone under async_mu_ — the
      // lock is the happens-before edge to Poll/Take readers of the
      // output buffers the chain just wrote
      std::lock_guard<std::mutex> l(async_mu_);
      op->state = AsyncSampleOp::kDone;
      --async_inflight_;
      async_cv_.notify_all();
      return;
    }
    int h = op->hop;
    int64_t off = op->slice_off;
    int m = static_cast<int>(
        std::min<int64_t>(kFanoutSlice, op->cur_n - off));
    op->call = std::make_unique<NbrCall>();
    NbrCall* c = op->call.get();
    c->ids = op->cur + off;
    c->n = m;
    c->etypes = op->et;
    c->net = op->etype_counts[h];
    c->count = op->counts[h];
    c->default_id = op->default_id;
    c->out_ids = op->out_ids[h] + off * op->counts[h];
    c->out_w = op->out_w[h] + off * op->counts[h];
    c->out_t = op->out_t[h] + off * op->counts[h];
    // whole-op epoch capture: every slice of this step reads the
    // snapshot stamped at submit, even if a shard flips between hops
    c->gen = op->gen;
    c->pin = op->pin;
    c->epoch_captured = true;
    NbrPrep(c);
    std::vector<std::function<void()>> jobs;
    if (c->n > 0 && c->count > 0) NbrBuildJobs(c, &jobs);
    if (!jobs.empty()) {
      // hop h+1's jobs will be enqueued by THIS batch's completing
      // worker — never by a blocked caller thread
      Counters::Global().Add(kCtrAsyncContinuation);
      dispatcher_->SubmitDetached(std::move(jobs), [this, op] {
        try {
          OnSliceDone(op);
        } catch (...) {
          // eg-lint thread-catch: never kill the worker — mark the op
          // done (completed slices are intact, this one keeps its
          // prefilled defaults) so TakeAsync cannot hang
          std::lock_guard<std::mutex> l(async_mu_);
          if (op->state == AsyncSampleOp::kRunning) {
            op->state = AsyncSampleOp::kDone;
            --async_inflight_;
            async_cv_.notify_all();
          }
        }
      });
      return;
    }
    // zero wire work (empty slice, or every unique entry served from
    // the neighbor cache): finish inline and keep walking the cursor
    // on this thread — a loop, not recursion, so a deep fully-cached
    // fan-out cannot grow the stack
    if (c->n > 0 && c->count > 0) NbrFinish(c);
    op->call.reset();
    AdvanceFanoutCursor(op);
  }
}

void RemoteGraph::OnSliceDone(AsyncSampleOp* op) const {
  NbrFinish(op->call.get());
  op->call.reset();
  AdvanceFanoutCursor(op);
  StartSlice(op);
}

int RemoteGraph::SampleFanoutAsync(const uint64_t* ids, int n,
                                   const int32_t* etypes_flat,
                                   const int32_t* etype_counts,
                                   const int32_t* counts, int nhops,
                                   uint64_t default_id, uint64_t** out_ids,
                                   float** out_w, int32_t** out_t) const {
  if (n < 0 || nhops <= 0 || !dispatcher_) return -1;
  int slot = -1;
  {
    std::lock_guard<std::mutex> l(async_mu_);
    for (int i = 0; i < kMaxAsyncOps; ++i) {
      if (async_ops_[i].state == AsyncSampleOp::kFree) {
        slot = i;
        break;
      }
    }
    if (slot < 0) return -1;  // pool full: the caller degrades to sync
    async_ops_[slot].state = AsyncSampleOp::kRunning;
    ++async_inflight_;
    Counters::Global().Add(kCtrAsyncSubmit);
    Counters::Global().Max(kCtrAsyncInflightPeak,
                           static_cast<uint64_t>(async_inflight_));
  }
  AsyncSampleOp& op = async_ops_[slot];
  // deep-copy the request: the submitting frame (a ctypes call from the
  // Python pipeline driver) unwinds immediately; outputs stay borrowed
  // (the caller pins them until TakeAsync)
  int net_total = 0;
  for (int h = 0; h < nhops; ++h) net_total += etype_counts[h];
  op.ids.assign(ids, ids + n);
  op.etypes_flat.assign(etypes_flat, etypes_flat + net_total);
  op.etype_counts.assign(etype_counts, etype_counts + nhops);
  op.counts.assign(counts, counts + nhops);
  op.n = n;
  op.nhops = nhops;
  op.default_id = default_id;
  op.out_ids.assign(out_ids, out_ids + nhops);
  op.out_w.assign(out_w, out_w + nhops);
  op.out_t.assign(out_t, out_t + nhops);
  op.hop = 0;
  op.slice_off = 0;
  op.cur_n = n;
  op.cur = op.ids.data();
  op.et = op.etypes_flat.data();
  // stamp the whole-op epoch capture once, at submit: a flip that lands
  // while this step's continuation chain is in flight must not tear the
  // step across snapshots (tests/test_epoch.py pins bit-parity here)
  op.gen = cache_gen_.load(std::memory_order_acquire);
  op.pin.clear();
  if (shard_epoch_) {
    op.pin.resize(static_cast<size_t>(num_shards_), 0);
    for (int s = 0; s < num_shards_; ++s)
      op.pin[static_cast<size_t>(s)] =
          shard_epoch_[s].load(std::memory_order_relaxed);
  }
  StartSlice(&op);
  return slot;
}

int RemoteGraph::PollAsync(int slot) const {
  if (slot < 0 || slot >= kMaxAsyncOps) return -1;
  std::lock_guard<std::mutex> l(async_mu_);
  int st = async_ops_[slot].state;
  if (st == AsyncSampleOp::kFree) return -1;
  return st == AsyncSampleOp::kDone ? 1 : 0;
}

int RemoteGraph::TakeAsync(int slot) const {
  if (slot < 0 || slot >= kMaxAsyncOps) return -1;
  std::unique_lock<std::mutex> l(async_mu_);
  AsyncSampleOp& op = async_ops_[slot];
  if (op.state == AsyncSampleOp::kFree) return -1;
  async_cv_.wait(l, [&op] { return op.state == AsyncSampleOp::kDone; });
  op.state = AsyncSampleOp::kFree;
  // drop the owned request copies now, not at the next submit — a
  // paused pipeline should not pin a step's id arrays indefinitely
  op.ids = {};
  op.etypes_flat = {};
  op.out_ids = {};
  op.out_w = {};
  op.out_t = {};
  return 0;
}

namespace {

// Prefix offsets of a counts array.
std::vector<int64_t> Offsets(const std::vector<int32_t>& counts) {
  std::vector<int64_t> off(counts.size() + 1, 0);
  for (size_t j = 0; j < counts.size(); ++j) off[j + 1] = off[j] + counts[j];
  return off;
}

}  // namespace

EGResult* RemoteGraph::MergeFullNeighbor(const ShardPlan& plan,
                                         std::vector<EGResult>& sub,
                                         const std::vector<char>& ok,
                                         int n) const {
  auto* res = new EGResult();
  res->u64.resize(1);
  res->f32.resize(1);
  res->i32.resize(2);
  res->i32[1].assign(n, 0);
  std::vector<std::vector<int64_t>> off(num_shards_);
  for (int s = 0; s < num_shards_; ++s) {
    // Validate reply shape before trusting its counts — a malformed shard
    // reply degrades to defaults, like the fixed-size paths' m != want
    // checks.
    if (!ok[s] || sub[s].i32.size() != 2 || sub[s].u64.size() != 1 ||
        sub[s].f32.size() != 1 ||
        sub[s].i32[1].size() != plan.rows[s].size())
      continue;
    auto o = Offsets(sub[s].i32[1]);
    size_t total = static_cast<size_t>(o.back());
    if (sub[s].u64[0].size() != total || sub[s].f32[0].size() != total ||
        sub[s].i32[0].size() != total)
      continue;
    off[s] = std::move(o);
  }
  for (int i = 0; i < n; ++i) {
    int s = plan.shard_of[i];
    if (s < 0 || !ok[s] || off[s].empty()) continue;  // defaults: count 0
    int32_t j = plan.pos_of[i];  // duplicates share their unique segment
    int64_t b = off[s][j], e = off[s][j + 1];
    res->i32[1][i] = static_cast<int32_t>(e - b);
    res->u64[0].insert(res->u64[0].end(), sub[s].u64[0].begin() + b,
                       sub[s].u64[0].begin() + e);
    res->f32[0].insert(res->f32[0].end(), sub[s].f32[0].begin() + b,
                       sub[s].f32[0].begin() + e);
    res->i32[0].insert(res->i32[0].end(), sub[s].i32[0].begin() + b,
                       sub[s].i32[0].begin() + e);
  }
  return res;
}

EGResult* RemoteGraph::MergeSlotted(const ShardPlan& plan,
                                    std::vector<EGResult>& sub,
                                    const std::vector<char>& ok, int n,
                                    int nf, bool u64_vals,
                                    bool byte_vals) const {
  auto* res = new EGResult();
  res->i32.resize(nf);
  if (u64_vals) res->u64.resize(nf);
  if (byte_vals) res->bytes.resize(nf);
  for (int k = 0; k < nf; ++k) {
    res->i32[k].assign(n, 0);
    std::vector<std::vector<int64_t>> off(num_shards_);
    for (int s = 0; s < num_shards_; ++s) {
      if (!ok[s] || static_cast<int>(sub[s].i32.size()) != nf ||
          sub[s].i32[k].size() != plan.rows[s].size())
        continue;
      if (u64_vals && static_cast<int>(sub[s].u64.size()) != nf) continue;
      if (byte_vals && static_cast<int>(sub[s].bytes.size()) != nf) continue;
      auto o = Offsets(sub[s].i32[k]);
      size_t total = static_cast<size_t>(o.back());
      if (u64_vals && sub[s].u64[k].size() != total) continue;
      if (byte_vals && sub[s].bytes[k].size() != total) continue;
      off[s] = std::move(o);
    }
    for (int i = 0; i < n; ++i) {
      int s = plan.shard_of[i];
      if (s < 0 || !ok[s] || off[s].empty()) continue;
      int32_t j = plan.pos_of[i];
      int64_t b = off[s][j], e = off[s][j + 1];
      res->i32[k][i] = static_cast<int32_t>(e - b);
      if (u64_vals)
        res->u64[k].insert(res->u64[k].end(), sub[s].u64[k].begin() + b,
                           sub[s].u64[k].begin() + e);
      if (byte_vals)
        res->bytes[k].append(sub[s].bytes[k], static_cast<size_t>(b),
                             static_cast<size_t>(e - b));
    }
  }
  return res;
}

EGResult* RemoteGraph::GetFullNeighbor(const uint64_t* ids, int n,
                                       const int32_t* etypes, int net,
                                       bool sorted) const {
  ShardPlan plan;
  BuildPlan(ids, n, &plan);
  std::vector<EGResult> sub(num_shards_);
  std::vector<char> ok(num_shards_, 0);
  // Variable-length replies stay one call per shard (chunking them would
  // need segment stitching for little gain: the dedup above already
  // removed the duplicate rows that dominate power-law batches).
  ForShards(plan.rows, "full_neighbor", [&](int s) {
    std::vector<uint64_t> subids(plan.rows[s].size());
    for (size_t j = 0; j < plan.rows[s].size(); ++j)
      subids[j] = ids[plan.rows[s][j]];
    Heat::Global().Record(kHeatClient, kFullNeighbor, subids.data(),
                          static_cast<int64_t>(subids.size()));
    WireWriter req;
    req.U8(kFullNeighbor);
    req.Arr(subids);
    req.Arr(etypes, net);
    req.U8(sorted ? 1 : 0);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    if (!ReadResult(&r, &sub[s])) return false;
    ok[s] = 1;
    return true;
  });
  // Engine layout: u64[0]=ids, f32[0]=weights, i32[0]=types, i32[1]=counts.
  return MergeFullNeighbor(plan, sub, ok, n);
}

void RemoteGraph::GetTopKNeighbor(const uint64_t* ids, int n,
                                  const int32_t* etypes, int net, int k,
                                  uint64_t default_id, uint64_t* out_ids,
                                  float* out_w, int32_t* out_t) const {
  int64_t total = static_cast<int64_t>(n) * k;
  std::fill(out_ids, out_ids + total, default_id);
  std::fill(out_w, out_w + total, 0.f);
  std::fill(out_t, out_t + total, -1);
  if (n <= 0 || k <= 0) return;
  ShardPlan plan;
  BuildPlan(ids, n, &plan);
  // Deterministic per id, so duplicates simply copy the unique reply row.
  std::vector<std::vector<uint64_t>> sid(num_shards_);
  std::vector<std::vector<float>> sw(num_shards_);
  std::vector<std::vector<int32_t>> st(num_shards_);
  std::vector<std::vector<char>> ok(num_shards_);
  for (int s = 0; s < num_shards_; ++s) {
    size_t m = plan.rows[s].size();
    sid[s].assign(m * k, default_id);
    sw[s].assign(m * k, 0.f);
    st[s].assign(m * k, -1);
    ok[s].assign(m, 0);
  }
  RunChunked(plan.rows, "topk_neighbor", [&](int s, int32_t b, int32_t e) {
    std::vector<uint64_t> sub(static_cast<size_t>(e - b));
    for (int32_t j = b; j < e; ++j) sub[j - b] = ids[plan.rows[s][j]];
    Heat::Global().Record(kHeatClient, kTopKNeighbor, sub.data(),
                          static_cast<int64_t>(sub.size()));
    WireWriter req;
    req.U8(kTopKNeighbor);
    req.Arr(sub);
    req.Arr(etypes, net);
    req.I32(k);
    req.U64(default_id);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    int64_t mi, mw, mt;
    const uint64_t* rid = r.Arr<uint64_t>(&mi);
    const float* rw = r.Arr<float>(&mw);
    const int32_t* rt = r.Arr<int32_t>(&mt);
    int64_t want = static_cast<int64_t>(sub.size()) * k;
    if (!r.ok() || mi != want || mw != want || mt != want) return false;
    std::copy(rid, rid + want, sid[s].begin() + static_cast<int64_t>(b) * k);
    std::copy(rw, rw + want, sw[s].begin() + static_cast<int64_t>(b) * k);
    std::copy(rt, rt + want, st[s].begin() + static_cast<int64_t>(b) * k);
    for (int32_t j = b; j < e; ++j) ok[s][j] = 1;
    return true;
  });
  for (int i = 0; i < n; ++i) {
    int s = plan.shard_of[i];
    int32_t pos = plan.pos_of[i];
    if (s < 0 || !ok[s][pos]) continue;
    int64_t src_off = static_cast<int64_t>(pos) * k;
    int64_t dst_off = static_cast<int64_t>(i) * k;
    std::copy(sid[s].begin() + src_off, sid[s].begin() + src_off + k,
              out_ids + dst_off);
    std::copy(sw[s].begin() + src_off, sw[s].begin() + src_off + k,
              out_w + dst_off);
    std::copy(st[s].begin() + src_off, st[s].begin() + src_off + k,
              out_t + dst_off);
  }
}

void RemoteGraph::RandomWalk(const uint64_t* ids, int n,
                             const int32_t* etypes_flat,
                             const int32_t* etype_counts, int walk_len,
                             float p, float q, uint64_t default_id,
                             uint64_t* out) const {
  int64_t stride = walk_len + 1;
  std::vector<uint64_t> cur(ids, ids + n), parent(n, 0);
  for (int i = 0; i < n; ++i) out[static_cast<int64_t>(i) * stride] = ids[i];
  bool plain = p == 1.f && q == 1.f;
  std::vector<uint64_t> next(n);
  std::vector<float> w1(n);
  std::vector<int32_t> t1(n);
  Rng& rng = ThreadRng();
  const int32_t* et = etypes_flat;
  for (int s = 1; s <= walk_len; ++s) {
    int net = etype_counts[s - 1];
    if (plain || s == 1) {
      SampleNeighbor(cur.data(), n, et, net, 1, default_id, next.data(),
                     w1.data(), t1.data());
    } else {
      // node2vec-biased step: client-side sorted-merge of current and parent
      // neighbor lists, d_tx weights w/p (return), w (distance 1), w/q
      // (distance 2) — semantics of reference euler/client/graph.cc:120-151,
      // which likewise issues two GetSortedFullNeighbor scatters per hop.
      // Walks revisit hubs constantly, so both fetches ride the dedup path.
      EGResult* cn = GetFullNeighbor(cur.data(), n, et, net, true);
      EGResult* pn = GetFullNeighbor(parent.data(), n, et, net, true);
      const auto& c_ids = cn->u64[0];
      const auto& c_w = cn->f32[0];
      const auto& c_cnt = cn->i32[1];
      const auto& p_ids = pn->u64[0];
      const auto& p_cnt = pn->i32[1];
      size_t c_off = 0, p_off = 0;
      std::vector<double> cum;
      for (int i = 0; i < n; ++i) {
        size_t cc = static_cast<size_t>(c_cnt[i]);
        size_t pc = static_cast<size_t>(p_cnt[i]);
        if (cc == 0) {
          next[i] = default_id;
        } else {
          cum.resize(cc);
          double total = 0.0;
          const uint64_t* pb = p_ids.data() + p_off;
          for (size_t j = 0; j < cc; ++j) {
            uint64_t x = c_ids[c_off + j];
            float wx = c_w[c_off + j];
            // parent-adjacency wins even for x == parent (parent with a
            // self-loop is d_tx=1): the reference merge's equality
            // branch runs before its candidate<parent check
            // (euler/client/graph.cc:126-140)
            double scale;
            if (std::binary_search(pb, pb + pc, x))
              scale = 1.0;
            else if (x == parent[i])
              scale = 1.0 / p;
            else
              scale = 1.0 / q;
            total += wx * scale;
            cum[j] = total;
          }
          double r = rng.NextDouble() * total;
          size_t j = std::lower_bound(cum.begin(), cum.end(), r) - cum.begin();
          next[i] = c_ids[c_off + std::min(j, cc - 1)];
        }
        c_off += cc;
        p_off += pc;
      }
      delete cn;
      delete pn;
    }
    for (int i = 0; i < n; ++i) {
      out[static_cast<int64_t>(i) * stride + s] = next[i];
      parent[i] = cur[i];
      cur[i] = next[i];
    }
    et += net;
  }
}

void RemoteGraph::GetDenseFeature(const uint64_t* ids, int n,
                                  const int32_t* fids, const int32_t* dims,
                                  int nf, float* out) const {
  int64_t row_dim = 0;
  for (int k = 0; k < nf; ++k) row_dim += dims[k];
  std::fill(out, out + static_cast<int64_t>(n) * row_dim, 0.f);
  if (n <= 0 || row_dim <= 0) return;
  ShardPlan plan;
  BuildPlan(ids, n, &plan);
  Counters& ctr = Counters::Global();
  const bool use_cache = fcache_.enabled();
  const uint64_t spec =
      use_cache ? FeatureCache::SpecHash(fids, dims, nf) : 0;
  // one generation + epoch-pin capture for the whole gather: every probe
  // and fill below reads a single snapshot (eg_epoch.h)
  const uint64_t gen = cache_gen_.load(std::memory_order_acquire);
  std::vector<uint64_t> pin;
  if (shard_epoch_) {
    pin.resize(static_cast<size_t>(num_shards_), 0);
    for (int s = 0; s < num_shards_; ++s)
      pin[static_cast<size_t>(s)] =
          shard_epoch_[s].load(std::memory_order_relaxed);
  }
  // Staging over unique entries; cache hits fill their rows up front and
  // drop out of the fetch lists entirely (zero wire bytes).
  std::vector<std::vector<float>> sval(num_shards_);
  std::vector<std::vector<char>> ok(num_shards_);
  std::vector<std::vector<int32_t>> fetch(num_shards_);
  // heat feed (eg_heat.h): every unique id, post-coalesce but PRE-cache
  // — cache hits are accesses too, and the frequency the cache-efficacy
  // classes bucket by must count them. The gather form walks the plan's
  // row indices in place (no staging copy), and hands back each id's
  // frequency class from the same sketch walk, so the hit/miss class
  // accounting below costs two array reads per id instead of a second
  // sketch probe.
  Heat& heat = Heat::Global();
  const bool heat_on = heat.enabled();
  std::vector<uint8_t> cls;
  uint32_t cls_hit[kHeatClasses] = {0}, cls_miss[kHeatClasses] = {0};
  uint64_t hits = 0, misses = 0;
  for (int s = 0; s < num_shards_; ++s) {
    size_t m = plan.rows[s].size();
    sval[s].assign(m * static_cast<size_t>(row_dim), 0.f);
    ok[s].assign(m, 0);
    if (heat_on && m) {
      cls.resize(m);
      heat.RecordRows(kHeatClient, kDenseFeature, ids,
                      plan.rows[s].data(), static_cast<int64_t>(m), -1,
                      cls.data());
    }
    for (size_t j = 0; j < m; ++j) {
      uint64_t id = ids[plan.rows[s][j]];
      if (use_cache &&
          fcache_.Get(spec, id, sval[s].data() + j * row_dim,
                      static_cast<size_t>(row_dim), gen)) {
        ok[s][j] = 1;
        ++hits;
        if (heat_on) ++cls_hit[cls[j]];
      } else {
        fetch[s].push_back(static_cast<int32_t>(j));
        if (use_cache) {
          ++misses;
          if (heat_on) ++cls_miss[cls[j]];
        }
      }
    }
  }
  if (heat_on && use_cache) heat.AddCacheClasses(cls_hit, cls_miss);
  if (hits) ctr.Add(kCtrCacheHit, hits);
  if (misses) ctr.Add(kCtrCacheMiss, misses);
  RunChunked(fetch, "dense_feature", [&](int s, int32_t b, int32_t e) {
    int32_t m = e - b;
    std::vector<uint64_t> sub(static_cast<size_t>(m));
    for (int32_t x = 0; x < m; ++x)
      sub[x] = ids[plan.rows[s][fetch[s][b + x]]];
    WireWriter req;
    req.U8(kDenseFeature);
    req.Arr(sub);
    req.Arr(fids, nf);
    req.Arr(dims, nf);
    std::string reply;
    if (!Call(s, req.buf(), &reply,
              pin.empty() ? 0 : pin[static_cast<size_t>(s)]))
      return false;
    Heat::Global().AddShardBytes(s, req.buf().size(), reply.size());
    WireReader r(reply);
    r.U8();
    int64_t mm;
    const float* vals = r.Arr<float>(&mm);
    if (!r.ok() || mm != static_cast<int64_t>(m) * row_dim) return false;
    for (int32_t x = 0; x < m; ++x) {
      int32_t j = fetch[s][b + x];
      std::copy(vals + static_cast<int64_t>(x) * row_dim,
                vals + static_cast<int64_t>(x + 1) * row_dim,
                sval[s].begin() + static_cast<int64_t>(j) * row_dim);
      ok[s][j] = 1;
      if (use_cache)
        fcache_.Put(spec, sub[x], vals + static_cast<int64_t>(x) * row_dim,
                    static_cast<size_t>(row_dim), gen);
    }
    return true;
  });
  // fan-out attribution: ids_on_wire measured as the post-cache fetch
  // list sizes, shards_touched as the shards a fetch actually went to
  if (heat_on) {
    uint64_t on_wire = 0;
    int touched = 0;
    for (int s = 0; s < num_shards_; ++s)
      if (!fetch[s].empty()) {
        ++touched;
        on_wire += fetch[s].size();
      }
    heat.RecordFanout(kDenseFeature, static_cast<uint64_t>(n),
                      static_cast<uint64_t>(plan.coalesced), hits, on_wire,
                      touched);
  }
  for (int i = 0; i < n; ++i) {
    int s = plan.shard_of[i];
    if (s < 0) continue;
    int32_t pos = plan.pos_of[i];
    if (!ok[s][pos]) continue;
    std::copy(sval[s].begin() + static_cast<int64_t>(pos) * row_dim,
              sval[s].begin() + static_cast<int64_t>(pos + 1) * row_dim,
              out + static_cast<int64_t>(i) * row_dim);
  }
}

void RemoteGraph::GetEdgeDenseFeature(const uint64_t* src,
                                      const uint64_t* dst,
                                      const int32_t* types, int n,
                                      const int32_t* fids,
                                      const int32_t* dims, int nf,
                                      float* out) const {
  int64_t row_dim = 0;
  for (int k = 0; k < nf; ++k) row_dim += dims[k];
  std::fill(out, out + static_cast<int64_t>(n) * row_dim, 0.f);
  // Edges live on the shard of their src node (the converter emits edge
  // records inside the src node's block — see convert.py / reference
  // euler/tools/json2dat.py:139). Edge identity is the (src, dst, type)
  // triple, so the node-id dedup/cache does not apply here.
  std::vector<std::vector<int32_t>> rows;
  GroupByShard(src, n, &rows);
  ForShards(rows, "edge_dense_feature", [&](int s) {
    size_t m = rows[s].size();
    std::vector<uint64_t> ssrc(m), sdst(m);
    std::vector<int32_t> st(m);
    for (size_t j = 0; j < m; ++j) {
      ssrc[j] = src[rows[s][j]];
      sdst[j] = dst[rows[s][j]];
      st[j] = types[rows[s][j]];
    }
    // edge ops feed their SRC ids — the routing key hash sharding cuts on
    Heat::Global().Record(kHeatClient, kEdgeDenseFeature, ssrc.data(),
                          static_cast<int64_t>(ssrc.size()));
    WireWriter req;
    req.U8(kEdgeDenseFeature);
    req.Arr(ssrc);
    req.Arr(sdst);
    req.Arr(st);
    req.Arr(fids, nf);
    req.Arr(dims, nf);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    int64_t mm;
    const float* vals = r.Arr<float>(&mm);
    if (!r.ok() || mm != static_cast<int64_t>(m) * row_dim) return false;
    for (size_t j = 0; j < m; ++j)
      std::copy(vals + j * row_dim, vals + (j + 1) * row_dim,
                out + static_cast<int64_t>(rows[s][j]) * row_dim);
    return true;
  });
}

EGResult* RemoteGraph::GetSparseFeature(const uint64_t* ids, int n,
                                        const int32_t* fids, int nf) const {
  ShardPlan plan;
  BuildPlan(ids, n, &plan);
  std::vector<EGResult> sub(num_shards_);
  std::vector<char> ok(num_shards_, 0);
  ForShards(plan.rows, "sparse_feature", [&](int s) {
    std::vector<uint64_t> subids(plan.rows[s].size());
    for (size_t j = 0; j < plan.rows[s].size(); ++j)
      subids[j] = ids[plan.rows[s][j]];
    Heat::Global().Record(kHeatClient, kSparseFeature, subids.data(),
                          static_cast<int64_t>(subids.size()));
    WireWriter req;
    req.U8(kSparseFeature);
    req.Arr(subids);
    req.Arr(fids, nf);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    if (!ReadResult(&r, &sub[s])) return false;
    ok[s] = 1;
    return true;
  });
  // Layout: u64[k]=values of slot k, i32[k]=per-row counts (nf slots each).
  return MergeSlotted(plan, sub, ok, n, nf, /*u64=*/true, /*bytes=*/false);
}

EGResult* RemoteGraph::GetEdgeSparseFeature(const uint64_t* src,
                                            const uint64_t* dst,
                                            const int32_t* types, int n,
                                            const int32_t* fids,
                                            int nf) const {
  ShardPlan plan;
  BuildEdgePlan(src, n, &plan);
  std::vector<EGResult> sub(num_shards_);
  std::vector<char> ok(num_shards_, 0);
  ForShards(plan.rows, "edge_sparse_feature", [&](int s) {
    size_t m = plan.rows[s].size();
    std::vector<uint64_t> ssrc(m), sdst(m);
    std::vector<int32_t> st(m);
    for (size_t j = 0; j < m; ++j) {
      ssrc[j] = src[plan.rows[s][j]];
      sdst[j] = dst[plan.rows[s][j]];
      st[j] = types[plan.rows[s][j]];
    }
    Heat::Global().Record(kHeatClient, kEdgeSparseFeature, ssrc.data(),
                          static_cast<int64_t>(ssrc.size()));
    WireWriter req;
    req.U8(kEdgeSparseFeature);
    req.Arr(ssrc);
    req.Arr(sdst);
    req.Arr(st);
    req.Arr(fids, nf);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    if (!ReadResult(&r, &sub[s])) return false;
    ok[s] = 1;
    return true;
  });
  return MergeSlotted(plan, sub, ok, n, nf, /*u64=*/true, /*bytes=*/false);
}

EGResult* RemoteGraph::GetBinaryFeature(const uint64_t* ids, int n,
                                        const int32_t* fids, int nf) const {
  ShardPlan plan;
  BuildPlan(ids, n, &plan);
  std::vector<EGResult> sub(num_shards_);
  std::vector<char> ok(num_shards_, 0);
  ForShards(plan.rows, "binary_feature", [&](int s) {
    std::vector<uint64_t> subids(plan.rows[s].size());
    for (size_t j = 0; j < plan.rows[s].size(); ++j)
      subids[j] = ids[plan.rows[s][j]];
    Heat::Global().Record(kHeatClient, kBinaryFeature, subids.data(),
                          static_cast<int64_t>(subids.size()));
    WireWriter req;
    req.U8(kBinaryFeature);
    req.Arr(subids);
    req.Arr(fids, nf);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    if (!ReadResult(&r, &sub[s])) return false;
    ok[s] = 1;
    return true;
  });
  return MergeSlotted(plan, sub, ok, n, nf, /*u64=*/false, /*bytes=*/true);
}

EGResult* RemoteGraph::GetEdgeBinaryFeature(const uint64_t* src,
                                            const uint64_t* dst,
                                            const int32_t* types, int n,
                                            const int32_t* fids,
                                            int nf) const {
  ShardPlan plan;
  BuildEdgePlan(src, n, &plan);
  std::vector<EGResult> sub(num_shards_);
  std::vector<char> ok(num_shards_, 0);
  ForShards(plan.rows, "edge_binary_feature", [&](int s) {
    size_t m = plan.rows[s].size();
    std::vector<uint64_t> ssrc(m), sdst(m);
    std::vector<int32_t> st(m);
    for (size_t j = 0; j < m; ++j) {
      ssrc[j] = src[plan.rows[s][j]];
      sdst[j] = dst[plan.rows[s][j]];
      st[j] = types[plan.rows[s][j]];
    }
    Heat::Global().Record(kHeatClient, kEdgeBinaryFeature, ssrc.data(),
                          static_cast<int64_t>(ssrc.size()));
    WireWriter req;
    req.U8(kEdgeBinaryFeature);
    req.Arr(ssrc);
    req.Arr(sdst);
    req.Arr(st);
    req.Arr(fids, nf);
    std::string reply;
    if (!Call(s, req.buf(), &reply)) return false;
    WireReader r(reply);
    r.U8();
    if (!ReadResult(&r, &sub[s])) return false;
    ok[s] = 1;
    return true;
  });
  return MergeSlotted(plan, sub, ok, n, nf, /*u64=*/false, /*bytes=*/true);
}

}  // namespace eg
