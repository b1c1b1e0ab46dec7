#include "eg_service.h"

#include <dirent.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <fstream>

#include "eg_blackbox.h"
#include "eg_fault.h"
#include "eg_heat.h"
#include "eg_placement.h"
#include "eg_registry.h"
#include "eg_stats.h"
#include "eg_telemetry.h"
#include "eg_wire.h"

namespace eg {

namespace {

// Encode an EGResult (all slots of every kind) and free it.
void WriteResult(WireWriter* w, EGResult* res) {
  w->I32(static_cast<int32_t>(res->u64.size()));
  for (auto& v : res->u64) w->Arr(v);
  w->I32(static_cast<int32_t>(res->f32.size()));
  for (auto& v : res->f32) w->Arr(v);
  w->I32(static_cast<int32_t>(res->i32.size()));
  for (auto& v : res->i32) w->Arr(v);
  w->I32(static_cast<int32_t>(res->bytes.size()));
  for (auto& s : res->bytes) w->Str(s);
  delete res;
}

}  // namespace

int CountPartitions(const std::string& dir) {
  DIR* d = opendir(dir.c_str());
  if (!d) return -1;
  int max_p = -1;
  while (dirent* ent = readdir(d)) {
    std::string name = ent->d_name;
    if (name.size() < 4 || name.compare(name.size() - 4, 4, ".dat") != 0)
      continue;
    int p = 0;
    size_t us = name.rfind('_');
    if (us != std::string::npos) {
      size_t start = us + 1, end = name.size() - 4;
      bool digits = start < end;
      for (size_t i = start; i < end && digits; ++i)
        digits = name[i] >= '0' && name[i] <= '9';
      if (digits) p = std::stoi(name.substr(start, end - start));
    }
    max_p = std::max(max_p, p);
  }
  closedir(d);
  return max_p + 1;
}

bool Service::Start(const std::string& data_dir, int shard_idx, int shard_num,
                    const std::string& host, int port,
                    const std::string& registry_dir,
                    const std::string& options) {
  AdmissionOptions opt;
  if (!ParseAdmissionOptions(options, &opt, &error_)) return false;
  opt.shard_idx = shard_idx;  // server-side telemetry spans carry it
  shard_idx_ = shard_idx;
  shard_num_ = shard_num;
  num_partitions_ = CountPartitions(data_dir);
  if (num_partitions_ <= 0) {
    error_ = "no .dat partitions in " + data_dir;
    return false;
  }
  auto base = std::make_shared<Engine>();
  if (!base->Load(data_dir, shard_idx, shard_num)) {
    error_ = base->error();
    return false;
  }
  base_files_ = base->source_files();
  epochs_.Reset(std::move(base), 0);
  announced_epoch_.store(0, std::memory_order_release);
  // Placement artifact (eg_placement.h): read the blob AND parse it —
  // a corrupt artifact must fail the shard start loudly, not surface
  // later as client-side misrouting against whichever shards parsed it.
  if (!ReadPlacementDir(data_dir, &placement_blob_, &error_)) return false;
  if (!placement_blob_.empty()) {
    PlacementMap check;
    if (!check.Parse(placement_blob_, &error_)) return false;
    if (check.num_partitions() != num_partitions_) {
      error_ = "placement artifact declares " +
               std::to_string(check.num_partitions()) +
               " partitions but " + data_dir + " holds " +
               std::to_string(num_partitions_) + " .dat partitions";
      return false;
    }
  }
  host_ = host.empty() ? "127.0.0.1" : host;
  int listen_fd = ListenTcp(host_, port, &port_);
  if (listen_fd < 0) {
    error_ = "cannot bind port " + std::to_string(port);
    return false;
  }
  if (!admission_.Start(
          listen_fd, opt,
          [this](const char* req, size_t len, const Envelope& env,
                 std::string* reply) { Dispatch(req, len, env, reply); },
          &error_)) {
    ::close(listen_fd);
    return false;
  }
  started_ = true;

  if (registry_dir.compare(0, 6, "tcp://") == 0) {
    // TCP registry (eg_registry.h): REG now, then heartbeat re-REG at a
    // third of the registry's TTL (returned in the REG reply) so the
    // entry stays live — the ephemeral-znode session analog
    // (zk_server_register.cc:32-48). The initial registration must
    // succeed (fail fast on a wrong address); later heartbeats tolerate
    // registry restarts by redialing.
    if (!ParseTcpRegistry(registry_dir, &reg_host_, &reg_port_)) {
      error_ = "bad tcp registry url " + registry_dir +
               " (want tcp://host:port)";
      Stop();
      return false;
    }
    // REG lines carry a trailing epoch token ("REG <shard> <addr>
    // <epoch>") — pre-epoch registries parse shard + addr and ignore
    // the extra token, so the announcement is backward compatible. The
    // line is re-composed EVERY beat from announced_epoch_, which is
    // how a flip propagates to discovery within one TTL third.
    const std::string line_base = "REG " + std::to_string(shard_idx_) +
                                  " " + host_ + ":" +
                                  std::to_string(port_);
    int ttl_ms = 10000;
    int fd = DialTcp(reg_host_, reg_port_, 2000);
    if (fd < 0 || !RegistrySend(fd, line_base + " 0", &ttl_ms)) {
      if (fd >= 0) ::close(fd);
      error_ = "cannot register with tcp registry " + registry_dir;
      Stop();
      return false;
    }
    heartbeat_stop_ = false;
    heartbeat_thread_ = std::thread([this, line_base, fd,
                                     ttl_ms]() mutable {
      try {
        while (!heartbeat_stop_.load(std::memory_order_acquire)) {
          // wake every 50 ms so Stop() stays prompt even with short TTLs
          int beat_ms = ttl_ms / 3 > 150 ? ttl_ms / 3 : 150;
          for (int slept = 0; slept < beat_ms && !heartbeat_stop_;
               slept += 50)
            std::this_thread::sleep_for(std::chrono::milliseconds(50));
          if (heartbeat_stop_) break;
          const std::string line =
              line_base + " " +
              std::to_string(
                  announced_epoch_.load(std::memory_order_acquire));
          // kFaultHeartbeat forces this beat to miss: the held connection
          // is dropped and the redial path below must keep the registry
          // entry alive — exactly what a blipped registry link exercises.
          if (FaultHit(kFaultHeartbeat) || fd < 0 ||
              !RegistrySend(fd, line, &ttl_ms)) {
            Counters::Global().Add(kCtrHeartbeatMiss);
            if (fd >= 0) ::close(fd);
            fd = DialTcp(reg_host_, reg_port_, 2000);
            if (fd >= 0) RegistrySend(fd, line, &ttl_ms);
          }
        }
        if (fd >= 0) {
          RegistrySend(fd, "UNREG " + std::to_string(shard_idx_) + " " +
                               host_ + ":" + std::to_string(port_));
          ::close(fd);
        }
      } catch (...) {
        // std::terminate barrier (eg-lint: thread-catch): a dead heartbeat
        // only lets the registry entry expire; rediscovery handles the rest
        if (fd >= 0) ::close(fd);
      }
    });
  } else if (!registry_dir.empty()) {
    // "<shard>#<host>_<port>" file, written via rename for atomicity — the
    // flat-file stand-in for the reference's ephemeral znode
    // (zk_server_register.cc:32-48).
    registry_file_ = registry_dir + "/" + std::to_string(shard_idx) + "#" +
                     host_ + "_" + std::to_string(port_);
    std::string tmp = registry_file_ + ".tmp";
    std::ofstream f(tmp);
    f << host_ << ":" << port_ << "\n";
    f.close();
    if (!f || std::rename(tmp.c_str(), registry_file_.c_str()) != 0) {
      error_ = "cannot write registry file " + registry_file_;
      Stop();
      return false;
    }
  }
  return true;
}

void Service::Deregister() {
  if (!registry_file_.empty()) {
    ::unlink(registry_file_.c_str());
    registry_file_.clear();
  }
  if (heartbeat_thread_.joinable()) {
    heartbeat_stop_.store(true, std::memory_order_release);
    heartbeat_thread_.join();  // sends the UNREG on its way out
  }
}

void Service::Drain(int grace_ms) {
  if (!started_) return;
  // Leave discovery FIRST so clients route new work elsewhere while the
  // in-flight tail finishes — the SIGTERM half of a rolling restart
  // (DEPLOY.md runbook; registry TTL / re-discovery handles the rest).
  Deregister();
  admission_.Drain(grace_ms);
}

void Service::Stop() {
  if (!started_) return;
  Deregister();
  admission_.Stop();
  started_ = false;
}

namespace {

// Result allocations derived from request integers must be bounded by
// what a reply frame can carry anyway (SendFrame caps at kMaxFrame) —
// otherwise a well-framed request with count=INT32_MAX forces a
// multi-GB zero-initialized allocation (OOM kill or bad_alloc) before
// any data is touched.
bool OversizedResult(int64_t elems, std::string* reply) {
  // -64: headroom for the status byte and array-length prefixes, so a
  // boundary-sized result still fits its reply frame
  if (elems >= 0 && elems <= static_cast<int64_t>((kMaxFrame - 64) / 8))
    return false;
  WireWriter e;
  e.U8(1);
  e.Str("oversized request");
  *reply = std::move(e.buf());
  return true;
}

}  // namespace

void Service::Dispatch(const char* req, size_t len, const Envelope& env,
                       std::string* reply) {
  eg::SpanTimer span(eg::kStatServiceRequest);
  WireReader r(req, len);
  uint8_t op = r.U8();
  // Pin the epoch this request runs against: v4 requests may ask for
  // the epoch their op started on (0 = current); anything the table no
  // longer holds falls back to current. The pin holds the snapshot's
  // drain back until this reply is built.
  EpochPin pin =
      epochs_.Pin(env.versioned && env.version >= 4 ? env.epoch : 0);
  if (!pin) {
    *reply = StatusReply(kStatusError, "shard has no snapshot");
    return;
  }
  const Engine& eng = *pin.engine();
  WireWriter w;
  w.U8(0);  // ok status; overwritten on decode error below
  // v4 ok replies carry the shard's CURRENT epoch right after the
  // status byte — the passive flip announcement. Placeholder now,
  // patched after dispatch so a kLoadDelta reply announces the epoch
  // it just flipped to.
  const bool stamp = env.versioned && env.version >= 4;
  if (stamp) w.U64(0);

  // Server-side heat feed (eg_heat.h): the decoded id array,
  // PRE-execute, tagged by op + the requesting conn ServeConn stamped
  // into the thread-local — so a shard's top-K table reflects what it
  // was ASKED for even when the engine call later fails. Edge ops feed
  // their src ids (the routing key hash sharding cuts on).
  Heat& heat = Heat::Global();
  auto feed = [&](const uint64_t* ids, int64_t n) {
    heat.Record(kHeatServer, op, ids, n, HeatConn());
  };

  switch (op) {
    case kPing:
      break;
    case kStats: {
      // Remote telemetry scrape (eg_telemetry.h): the same JSON the
      // local euler_tpu.metrics_text() surface reads, plus this
      // server's live admission gauges — so an operator can ask any
      // shard how it is doing without shelling into its host.
      TelemetryGauges g;
      g.workers = admission_.workers();
      g.active = admission_.active();
      g.queue_depth = admission_.queue_depth();
      g.conns = admission_.conns();
      g.draining = admission_.draining() ? 1 : 0;
      g.epoch = static_cast<int64_t>(epochs_.current());
      w.Str(Telemetry::Global().Json(shard_idx_, &g));
      break;
    }
    case kHistory: {
      // Resource-gauge history scrape (eg_blackbox.h): the live view of
      // exactly what a postmortem freezes — RSS/fds/threads/cache over
      // the last ~minute — so an operator can watch a shard leak before
      // it dies, not only read about it after.
      w.Str(Blackbox::Global().HistoryJson(shard_idx_));
      break;
    }
    case kHeat: {
      // Data-plane heat scrape (eg_heat.h): this shard's full
      // hot-vertex top-K table + sketch totals + per-op/per-conn ids
      // ledger — the targeted reply scripts/heat_dump.py fits its
      // Zipf tail and cache-ceiling projections from.
      w.Str(Heat::Global().Json(shard_idx_));
      break;
    }
    case kPlacement: {
      // Placement-map fetch (eg_placement.h): the raw artifact blob,
      // verbatim. A shard serving hash-sharded data answers the STOCK
      // unknown-op error a pre-placement server would — deliberately
      // byte-identical, so the client's hash-routing fallback covers
      // old servers and map-less data through one path.
      if (placement_blob_.empty()) {
        WireWriter e;
        e.U8(1);
        e.Str("unknown op " + std::to_string(op));
        *reply = std::move(e.buf());
        return;
      }
      w.Str(placement_blob_);
      break;
    }
    case kLoadDelta: {
      // Snapshot-epoch delta load (eg_epoch.h): merge + flip, reply
      // [u64 new_epoch]. Failure answers an error string and leaves the
      // current epoch serving (already counted in delta_loads_failed).
      std::string path = r.Str();
      if (r.ok()) {
        uint64_t new_epoch = 0;
        std::string err;
        if (!LoadDelta(path, &new_epoch, &err)) {
          WireWriter e;
          e.U8(1);
          e.Str(err);
          *reply = std::move(e.buf());
          return;
        }
        w.U64(new_epoch);
      }
      break;
    }
    case kInfo: {
      const GraphStore& s = eng.store();
      w.I64(static_cast<int64_t>(s.num_nodes()));
      w.I64(static_cast<int64_t>(s.num_edges()));
      w.I32(s.node_type_num());
      w.I32(s.edge_type_num());
      w.I32(s.nf_u64_num());
      w.I32(s.nf_f32_num());
      w.I32(s.nf_bin_num());
      w.I32(s.ef_u64_num());
      w.I32(s.ef_f32_num());
      w.I32(s.ef_bin_num());
      w.I32(shard_idx_);
      w.I32(shard_num_);
      w.I32(num_partitions_);
      w.Arr(s.node_type_weight_sums());
      w.Arr(s.edge_type_weight_sums());
      break;
    }
    case kSampleNode: {
      int32_t count = r.I32(), type = r.I32();
      if (OversizedResult(count, reply)) return;
      std::vector<uint64_t> out(std::max<int32_t>(count, 0));
      if (r.ok() && count >= 0) eng.SampleNode(count, type, out.data());
      w.Arr(out);
      break;
    }
    case kSampleEdge: {
      int32_t count = r.I32(), type = r.I32();
      if (OversizedResult(3LL * count, reply)) return;
      size_t n = static_cast<size_t>(std::max<int32_t>(count, 0));
      std::vector<uint64_t> src(n), dst(n);
      std::vector<int32_t> t(n);
      if (r.ok() && count >= 0)
        eng.SampleEdge(count, type, src.data(), dst.data(), t.data());
      w.Arr(src);
      w.Arr(dst);
      w.Arr(t);
      break;
    }
    case kNodeType: {
      int64_t n;
      const uint64_t* ids = r.Arr<uint64_t>(&n);
      if (r.ok()) feed(ids, n);
      std::vector<int32_t> out(static_cast<size_t>(n));
      if (r.ok()) eng.GetNodeType(ids, static_cast<int>(n), out.data());
      w.Arr(out);
      break;
    }
    case kNodeWeight: {
      int64_t n;
      const uint64_t* ids = r.Arr<uint64_t>(&n);
      if (r.ok()) feed(ids, n);
      std::vector<float> out(static_cast<size_t>(n));
      if (r.ok()) eng.GetNodeWeight(ids, static_cast<int>(n), out.data());
      w.Arr(out);
      break;
    }
    case kSampleNeighbor: {
      int64_t n, net;
      const uint64_t* ids = r.Arr<uint64_t>(&n);
      const int32_t* etypes = r.Arr<int32_t>(&net);
      int32_t count = r.I32();
      uint64_t def = r.U64();
      if (r.ok()) feed(ids, n);
      if (OversizedResult(3LL * n * std::max<int32_t>(count, 0), reply))
        return;
      size_t total = static_cast<size_t>(n) * std::max<int32_t>(count, 0);
      std::vector<uint64_t> oid(total);
      std::vector<float> ow(total);
      std::vector<int32_t> ot(total);
      if (r.ok() && count >= 0)
        eng.SampleNeighbor(ids, static_cast<int>(n), etypes,
                               static_cast<int>(net), count, def, oid.data(),
                               ow.data(), ot.data());
      w.Arr(oid);
      w.Arr(ow);
      w.Arr(ot);
      break;
    }
    case kSampleNeighborUniq: {
      // Dedup'd neighbor sampling (see eg_wire.h): ids are unique,
      // reps[i] repeats each; the engine is called once per unique id
      // with reps[i] * count draws, so the node/group lookup happens
      // once per unique id while every draw stays iid.
      int64_t n, nr, net;
      const uint64_t* ids = r.Arr<uint64_t>(&n);
      const int32_t* reps = r.Arr<int32_t>(&nr);
      const int32_t* etypes = r.Arr<int32_t>(&net);
      int32_t count = r.I32();
      uint64_t def = r.U64();
      if (r.ok()) feed(ids, n);
      int64_t total = 0;
      bool shape_ok = r.ok() && nr == n && count >= 0;
      for (int64_t i = 0; shape_ok && i < n; ++i) {
        if (reps[i] < 1) {
          shape_ok = false;
          break;
        }
        total += static_cast<int64_t>(reps[i]) * count;
        if (total > static_cast<int64_t>(kMaxFrame)) break;  // rejected below
      }
      if (!shape_ok) {
        WireWriter e;
        e.U8(1);
        e.Str("malformed request for op " + std::to_string(op));
        *reply = std::move(e.buf());
        return;
      }
      if (OversizedResult(3 * total, reply)) return;
      std::vector<uint64_t> oid(static_cast<size_t>(total));
      std::vector<float> ow(static_cast<size_t>(total));
      std::vector<int32_t> ot(static_cast<size_t>(total));
      int64_t off = 0;
      for (int64_t i = 0; i < n; ++i) {
        int64_t m = static_cast<int64_t>(reps[i]) * count;
        if (m > 0)
          eng.SampleNeighbor(ids + i, 1, etypes, static_cast<int>(net),
                                 static_cast<int>(m), def, oid.data() + off,
                                 ow.data() + off, ot.data() + off);
        off += m;
      }
      w.Arr(oid);
      w.Arr(ow);
      w.Arr(ot);
      break;
    }
    case kFullNeighbor: {
      int64_t n, net;
      const uint64_t* ids = r.Arr<uint64_t>(&n);
      const int32_t* etypes = r.Arr<int32_t>(&net);
      uint8_t sorted = r.U8();
      if (r.ok()) feed(ids, n);
      if (r.ok()) {
        WriteResult(&w, eng.GetFullNeighbor(ids, static_cast<int>(n),
                                                etypes, static_cast<int>(net),
                                                sorted != 0));
      }
      break;
    }
    case kTopKNeighbor: {
      int64_t n, net;
      const uint64_t* ids = r.Arr<uint64_t>(&n);
      const int32_t* etypes = r.Arr<int32_t>(&net);
      int32_t k = r.I32();
      uint64_t def = r.U64();
      if (r.ok()) feed(ids, n);
      if (OversizedResult(3LL * n * std::max<int32_t>(k, 0), reply))
        return;
      size_t total = static_cast<size_t>(n) * std::max<int32_t>(k, 0);
      std::vector<uint64_t> oid(total);
      std::vector<float> ow(total);
      std::vector<int32_t> ot(total);
      if (r.ok() && k >= 0)
        eng.GetTopKNeighbor(ids, static_cast<int>(n), etypes,
                                static_cast<int>(net), k, def, oid.data(),
                                ow.data(), ot.data());
      w.Arr(oid);
      w.Arr(ow);
      w.Arr(ot);
      break;
    }
    case kDenseFeature: {
      int64_t n, nf, nd;
      const uint64_t* ids = r.Arr<uint64_t>(&n);
      const int32_t* fids = r.Arr<int32_t>(&nf);
      const int32_t* dims = r.Arr<int32_t>(&nd);
      if (r.ok()) feed(ids, n);
      int64_t row = 0;
      for (int64_t k = 0; k < nd; ++k) row += dims[k];
      // bound row before multiplying: corrupt dims could overflow n*row
      // (OversizedResult also rejects a negative row)
      if (OversizedResult(row, reply)) return;
      if (OversizedResult(n * row, reply)) return;
      std::vector<float> out(static_cast<size_t>(n * row));
      if (r.ok() && nf == nd)
        eng.GetDenseFeature(ids, static_cast<int>(n), fids, dims,
                                static_cast<int>(nf), out.data());
      w.Arr(out);
      break;
    }
    case kEdgeDenseFeature: {
      int64_t n, n2, n3, nf, nd;
      const uint64_t* src = r.Arr<uint64_t>(&n);
      const uint64_t* dst = r.Arr<uint64_t>(&n2);
      const int32_t* types = r.Arr<int32_t>(&n3);
      const int32_t* fids = r.Arr<int32_t>(&nf);
      const int32_t* dims = r.Arr<int32_t>(&nd);
      if (r.ok()) feed(src, n);
      int64_t row = 0;
      for (int64_t k = 0; k < nd; ++k) row += dims[k];
      if (OversizedResult(row, reply)) return;
      if (OversizedResult(n * row, reply)) return;
      std::vector<float> out(static_cast<size_t>(n * row));
      if (r.ok() && n == n2 && n == n3 && nf == nd)
        eng.GetEdgeDenseFeature(src, dst, types, static_cast<int>(n),
                                    fids, dims, static_cast<int>(nf),
                                    out.data());
      w.Arr(out);
      break;
    }
    case kSparseFeature: {
      int64_t n, nf;
      const uint64_t* ids = r.Arr<uint64_t>(&n);
      const int32_t* fids = r.Arr<int32_t>(&nf);
      if (r.ok()) feed(ids, n);
      if (r.ok())
        WriteResult(&w, eng.GetSparseFeature(ids, static_cast<int>(n),
                                                 fids, static_cast<int>(nf)));
      break;
    }
    case kEdgeSparseFeature: {
      int64_t n, n2, n3, nf;
      const uint64_t* src = r.Arr<uint64_t>(&n);
      const uint64_t* dst = r.Arr<uint64_t>(&n2);
      const int32_t* types = r.Arr<int32_t>(&n3);
      const int32_t* fids = r.Arr<int32_t>(&nf);
      if (r.ok()) feed(src, n);
      if (r.ok() && n == n2 && n == n3)
        WriteResult(&w, eng.GetEdgeSparseFeature(
                            src, dst, types, static_cast<int>(n), fids,
                            static_cast<int>(nf)));
      break;
    }
    case kBinaryFeature: {
      int64_t n, nf;
      const uint64_t* ids = r.Arr<uint64_t>(&n);
      const int32_t* fids = r.Arr<int32_t>(&nf);
      if (r.ok()) feed(ids, n);
      if (r.ok())
        WriteResult(&w, eng.GetBinaryFeature(ids, static_cast<int>(n),
                                                 fids, static_cast<int>(nf)));
      break;
    }
    case kEdgeBinaryFeature: {
      int64_t n, n2, n3, nf;
      const uint64_t* src = r.Arr<uint64_t>(&n);
      const uint64_t* dst = r.Arr<uint64_t>(&n2);
      const int32_t* types = r.Arr<int32_t>(&n3);
      const int32_t* fids = r.Arr<int32_t>(&nf);
      if (r.ok()) feed(src, n);
      if (r.ok() && n == n2 && n == n3)
        WriteResult(&w, eng.GetEdgeBinaryFeature(
                            src, dst, types, static_cast<int>(n), fids,
                            static_cast<int>(nf)));
      break;
    }
    default: {
      WireWriter e;
      e.U8(1);
      e.Str("unknown op " + std::to_string(op));
      *reply = std::move(e.buf());
      return;
    }
  }

  if (!r.ok()) {
    WireWriter e;
    e.U8(1);
    e.Str("malformed request for op " + std::to_string(op));
    *reply = std::move(e.buf());
    return;
  }
  if (stamp) {
    uint64_t cur = epochs_.current();
    std::memcpy(&w.buf()[1], &cur, 8);
  }
  *reply = std::move(w.buf());
}

bool Service::LoadDelta(const std::string& path, uint64_t* new_epoch,
                        std::string* error) {
  // One flip at a time per shard: concurrent kLoadDelta requests queue
  // here. Readers never block — they keep pinning whatever epoch is
  // current while the merge builds off to the side.
  std::lock_guard<std::mutex> l(delta_mu_);
  Counters& ctr = Counters::Global();
  auto fail = [&](const std::string& msg) {
    *error = msg;
    ctr.Add(kCtrDeltaLoadFail);
    return false;
  };
  // kFaultDeltaLoad: the read/parse leg forced to fail or slowed — the
  // window the chaos soak races SIGKILL into.
  if (FaultHit(kFaultDeltaLoad))
    return fail("delta_load failpoint fired for " + path);
  std::string data;
  {
    std::ifstream f(path, std::ios::binary | std::ios::ate);
    if (!f) return fail("cannot read delta " + path);
    std::streamsize size = f.tellg();
    f.seekg(0);
    // eg-lint: allow(wire-count-alloc) sized by tellg of an already-open
    // local file; bad_alloc surfaces as a handler error reply
    data.resize(static_cast<size_t>(size));
    if (!f.read(data.data(), size))
      return fail("cannot read delta " + path);
  }
  DeltaFile d;
  std::string err;
  if (!d.Parse(data.data(), data.size(), &err) || !d.Validate(&err))
    return fail(path + ": " + err);
  ShardOwnership own{shard_idx_, shard_num_, num_partitions_};
  if (!FilterDeltaToShard(&d, own, &err))
    return fail(path + ": " + err);
  if (!deltas_.empty() && d.seq <= deltas_.back().seq)
    return fail(path + ": delta seq " + std::to_string(d.seq) +
                " not above applied seq " +
                std::to_string(deltas_.back().seq));
  deltas_.push_back(std::move(d));
  std::shared_ptr<Engine> merged;
  if (!BuildMergedEngine(base_files_, deltas_, &merged, &err)) {
    deltas_.pop_back();
    return fail(path + ": " + err);
  }
  // kFaultEpochFlip: refuse (err) or stall (delay) the publish itself,
  // AFTER the merged engine was built — the shard keeps serving its
  // current epoch on refusal.
  if (FaultHit(kFaultEpochFlip)) {
    deltas_.pop_back();
    return fail(path + ": epoch_flip failpoint refused the flip");
  }
  merged->set_epoch(epochs_.current() + 1);
  uint64_t e = epochs_.Flip(std::move(merged));
  announced_epoch_.store(e, std::memory_order_release);
  *new_epoch = e;
  return true;
}

}  // namespace eg
