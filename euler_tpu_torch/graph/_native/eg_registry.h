// TCP shard registry: multi-host service discovery without a shared
// filesystem.
//
// Role equivalent of the reference's ZooKeeper discovery pair
// (reference euler/common/zk_server_register.cc:32-48 creates ephemeral
// znodes "<shard>#<ip:port>"; zk_server_monitor.cc:50-64 watches and parses
// them). The TPU-native reshape: one tiny TCP server — naturally hosted by
// the training coordinator process — holding soft state with TTL expiry.
// Shards REG themselves and heartbeat (re-REG) to stay alive, exactly the
// ephemeral-znode semantics: a dead shard's entry vanishes after ttl_ms with
// no session machinery. Clients LIST to discover live shards. Registry soft
// state survives registry restarts because registrants keep heartbeating.
//
// Wire format: the same [u32 len][payload] frames as the graph service
// (eg_wire.h), with text payloads:
//   "REG <shard> <host>:<port> [<epoch>]"   -> "OK"
//   "UNREG <shard> <host>:<port>"           -> "OK"
//   "LIST"                 -> "<shard> <host>:<port> <epoch>\n" per entry
// A connection may issue any number of requests; registrants typically hold
// one open for heartbeats, clients dial once per LIST.
//
// The trailing epoch token (eg_epoch.h) is the discovery half of the
// flip announcement: shards re-REG their current serving epoch every
// heartbeat, clients see it in LIST. Backward compatible both ways —
// pre-epoch registries and clients parse "<shard> <addr>" and ignore
// the extra token; a missing token reads as epoch 0.
#ifndef EG_REGISTRY_H_
#define EG_REGISTRY_H_

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace eg {

// Registry connections beyond this answer "ERR busy" and close (counted
// in busy_rejects) — the registry is tiny control-plane traffic, so a
// storm of connections here is a bug or an attack, not load to queue.
constexpr int kMaxRegistryConns = 256;

class RegistryServer {
 public:
  ~RegistryServer() { Stop(); }

  // Bind host:port (port 0 = ephemeral) and serve. Entries expire ttl_ms
  // after their last REG. False + error() on failure.
  bool Start(const std::string& host, int port, int ttl_ms);
  void Stop();

  int port() const { return port_; }
  const std::string& error() const { return error_; }

 private:
  void AcceptLoop();
  void HandleConn(int fd);
  std::string Dispatch(const std::string& req);

  std::string error_;
  int port_ = 0;
  int ttl_ms_ = 10000;
  int listen_fd_ = -1;
  std::atomic<bool> stopping_{false};
  std::thread accept_thread_;
  std::mutex mu_;  // guards entries_ and conn_fds_
  struct Entry {
    std::chrono::steady_clock::time_point expiry;
    uint64_t epoch = 0;  // last announced serving epoch (eg_epoch.h)
  };
  // (shard, "host:port") -> soft state
  std::map<std::pair<int, std::string>, Entry> entries_;
  std::set<int> conn_fds_;
  std::atomic<int> active_conns_{0};
  // signaled (under mu_) as each handler exits, so Stop() can wait on a
  // condvar instead of the old 1 ms busy-wait poll
  std::condition_variable conns_cv_;
};

// ---- client side ----

// "tcp://host:port" -> (host, port); false when s is not a tcp:// URL.
bool ParseTcpRegistry(const std::string& s, std::string* host, int* port);

// One REG/UNREG round trip on an existing connection fd (reconnects are the
// caller's job). False on IO error or non-OK reply. When ttl_ms is non-null
// and the reply carries the registry's TTL ("OK <ttl_ms>"), it is written
// there so registrants can pace heartbeats to the actual TTL.
bool RegistrySend(int fd, const std::string& line, int* ttl_ms = nullptr);

// Dial, LIST, parse into shard -> replica addresses. False on IO error
// (empty registry is ok=true with empty *out). When epochs is non-null
// it receives each entry's announced epoch keyed by (shard, addr) —
// entries from pre-epoch registrants read as 0.
bool RegistryList(
    const std::string& host, int port, int timeout_ms,
    std::map<int, std::vector<std::string>>* out,
    std::map<std::pair<int, std::string>, uint64_t>* epochs = nullptr);

}  // namespace eg

#endif  // EG_REGISTRY_H_
