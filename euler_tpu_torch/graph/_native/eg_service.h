// Sharded graph service: serves one shard's Engine over TCP.
//
// Role equivalent of the reference's async gRPC server
// (reference euler/service/graph_service.cc:112-168 — N completion queues ×
// N threads of CallData state machines) re-shaped for the simpler wire
// protocol. Since the survivability rework the transport runs on the
// bounded-admission layer (eg_admission.h): a poller multiplexes idle
// connections, a FIXED handler pool (workers= option, default 2×cores)
// runs read-decode-execute-reply turns, overload answers BUSY instead of
// queueing unboundedly, and v2 requests carry a deadline the handlers
// honor before computing (eg_wire.h envelope). Drain() supports rolling
// restarts: deregister, stop accepting, finish in-flight, close.
//
// Discovery: instead of ZooKeeper ephemeral znodes
// (reference euler/common/zk_server_register.cc:32-48 "<shard>#<ip:port>"
// children), the service drops a registry file "<shard>#<host>_<port>" into
// a shared directory (atomic rename; removed on Drain/Stop), or REGisters
// with a TCP registry (eg_registry.h) and heartbeats to keep its TTL entry
// alive. On a TPU pod the natural registry_dir is on the shared filesystem
// all hosts mount.
#ifndef EG_SERVICE_H_
#define EG_SERVICE_H_

#include <atomic>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "eg_admission.h"
#include "eg_engine.h"
#include "eg_epoch.h"

namespace eg {

// Count partitions in a data dir: max "*_<p>.dat" index + 1 (files without a
// partition suffix count as partition 0). Matches the shard->partition map
// of reference euler/core/graph_engine.cc:90-107.
int CountPartitions(const std::string& dir);

class Service {
 public:
  ~Service() { Stop(); }

  // Loads shard `shard_idx` of `shard_num` from data_dir, binds host:port
  // (port 0 = ephemeral) and starts serving. If registry_dir is non-empty,
  // registers there: either a shared directory (flat file) or
  // "tcp://host:port" of a RegistryServer (heartbeat re-registration keeps
  // the TTL entry alive — the ephemeral-znode analog, eg_registry.h).
  // `options` is a "k=v;k=v" admission spec (workers/pending/max_conns/
  // io_timeout_ms/idle_timeout_ms/linger_ms/drain_ms/wire_version/
  // telemetry/slow_spans/blackbox/postmortem_dir — see
  // eg_admission.h); unknown keys fail loudly. False + error() on
  // failure.
  bool Start(const std::string& data_dir, int shard_idx, int shard_num,
             const std::string& host, int port,
             const std::string& registry_dir,
             const std::string& options = "");

  // Rolling-restart half: deregister from discovery (flat file unlinked /
  // UNREG sent), stop accepting, let in-flight requests finish (condvar,
  // bounded by grace_ms; <0 = the drain_ms option), close every
  // connection. Idempotent; Stop() runs it first.
  void Drain(int grace_ms = -1);
  void Stop();

  int port() const { return port_; }
  int shard_idx() const { return shard_idx_; }
  const std::string& error() const { return error_; }

  // ---- snapshot epochs (eg_epoch.h) ----
  // Merge one `<prefix>.delta.<n>` file over base + every delta applied
  // so far, flip the serving epoch to the fresh snapshot, and announce
  // it (reply stamps + registry heartbeat). Serialized per shard —
  // concurrent loads queue on delta_mu_. False + *error on read/parse/
  // validate/merge failure or a delta_load / epoch_flip failpoint; the
  // current epoch keeps serving and delta_loads_failed counts it.
  bool LoadDelta(const std::string& path, uint64_t* new_epoch,
                 std::string* error);
  uint64_t epoch() const { return epochs_.current(); }

 private:
  // Leave discovery: unlink the flat-file entry and/or stop the
  // heartbeat thread (which UNREGs on its way out). Idempotent.
  void Deregister();
  // Decode one request body (envelope already stripped by the admission
  // worker), run it on the pinned epoch's engine, encode the reply
  // (stamped with the current epoch for v4 requests).
  void Dispatch(const char* req, size_t len, const Envelope& env,
                std::string* reply);

  // Current + previous snapshot; every Dispatch pins one (v4 requests
  // may pin the previous epoch so in-flight multi-hop steps finish on
  // the snapshot they started on).
  EpochTable epochs_;
  std::mutex delta_mu_;  // serializes LoadDelta (one flip at a time)
  // Every delta applied so far, ascending seq — each flip re-merges
  // base_files_ + all of these so the snapshot is bit-identical to a
  // fresh merged load.
  std::vector<DeltaFile> deltas_ EG_GUARDED_BY(delta_mu_);
  std::vector<std::string> base_files_;
  // What the registry heartbeat announces; stored (not read from
  // epochs_) so the beat thread never touches the flip path.
  std::atomic<uint64_t> announced_epoch_{0};
  std::string error_;
  // Raw placement artifact from the data dir (eg_placement.h), served
  // verbatim through kPlacement so clients route by the same map the
  // converter partitioned with. Empty = hash-sharded data — kPlacement
  // then answers the stock unknown-op error, indistinguishable from a
  // pre-placement server (one client fallback path for both).
  std::string placement_blob_;
  std::string host_;
  int port_ = 0;
  int shard_idx_ = 0, shard_num_ = 1, num_partitions_ = 1;
  bool started_ = false;
  std::string registry_file_;
  // tcp:// registry registration (empty host = not in tcp mode)
  std::string reg_host_;
  int reg_port_ = 0;
  std::thread heartbeat_thread_;
  std::atomic<bool> heartbeat_stop_{false};

  AdmissionServer admission_;
};

}  // namespace eg

#endif  // EG_SERVICE_H_
