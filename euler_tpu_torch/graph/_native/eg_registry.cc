#include "eg_registry.h"

#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sstream>

#include "eg_fault.h"
#include "eg_stats.h"
#include "eg_wire.h"

namespace eg {

bool RegistryServer::Start(const std::string& host, int port, int ttl_ms) {
  ttl_ms_ = ttl_ms > 0 ? ttl_ms : 10000;
  listen_fd_ = ListenTcp(host.empty() ? "0.0.0.0" : host, port, &port_);
  if (listen_fd_ < 0) {
    error_ = "registry: cannot bind " + host + ":" + std::to_string(port);
    return false;
  }
  stopping_ = false;
  accept_thread_ = std::thread([this] {
    try {
      AcceptLoop();
    } catch (...) {
      // std::terminate barrier (eg-lint: thread-catch): a dead accept
      // loop stops admitting connections; registrants' heartbeats fail
      // loudly instead of the whole process aborting
    }
  });
  return true;
}

void RegistryServer::Stop() {
  if (listen_fd_ < 0) return;
  stopping_ = true;
  ::shutdown(listen_fd_, SHUT_RDWR);
  ::close(listen_fd_);
  if (accept_thread_.joinable()) accept_thread_.join();
  listen_fd_ = -1;
  // Same drain contract as the shard service: shut the live connections
  // down, then wait on the condvar (not a busy poll) until every
  // detached handler has deregistered itself.
  std::unique_lock<std::mutex> l(mu_);
  for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
  conns_cv_.wait(l, [this] {
    return active_conns_.load(std::memory_order_acquire) == 0;
  });
}

void RegistryServer::AcceptLoop() {
  while (!stopping_) {
    int fd = ::accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) {
      if (stopping_) break;
      continue;
    }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // Bounded accept (the service's admission treatment, sized for a
    // control plane): a connection storm gets one "ERR busy" frame and
    // a close instead of an unbounded handler-thread spawn.
    if (active_conns_.load(std::memory_order_acquire) >=
        kMaxRegistryConns) {
      Counters::Global().Add(kCtrBusyReject);
      SendFrame(fd, "ERR busy");
      ::close(fd);
      continue;
    }
    {
      std::lock_guard<std::mutex> l(mu_);
      conn_fds_.insert(fd);
    }
    active_conns_.fetch_add(1, std::memory_order_acq_rel);
    std::thread([this, fd] {
      try {
        HandleConn(fd);
      } catch (...) {
        // one hostile client must not std::terminate the registry
        // (eg-lint: thread-catch); cleanup below still runs
      }
      {
        std::lock_guard<std::mutex> l(mu_);
        conn_fds_.erase(fd);
      }
      ::close(fd);
      active_conns_.fetch_sub(1, std::memory_order_acq_rel);
      {
        // under mu_, so Stop()'s wait cannot miss the last decrement
        std::lock_guard<std::mutex> l(mu_);
        conns_cv_.notify_all();
      }
    }).detach();
  }
}

void RegistryServer::HandleConn(int fd) {
  std::string req;
  while (!stopping_ && RecvFrame(fd, &req)) {
    std::string reply = Dispatch(req);
    // kFaultRegistryReply: the REG/LIST was processed but its reply is
    // lost — registrants must treat it as a missed heartbeat and redial,
    // clients as a failed discovery pass.
    if (FaultHit(kFaultRegistryReply)) break;
    if (!SendFrame(fd, reply)) break;
  }
}

namespace {

// A registration address must look like host:port — hostile bytes that
// happen to parse as "<digits> <garbage>" must not become entries served
// to every LIST client (state poisoning; the reference's ZK quotas play
// this role for znode names).
bool ValidAddr(const std::string& a) {
  if (a.size() > 256) return false;
  auto colon = a.rfind(':');
  if (colon == std::string::npos || colon == 0 || colon + 1 >= a.size())
    return false;
  for (size_t i = colon + 1; i < a.size(); ++i)
    if (!std::isdigit(static_cast<unsigned char>(a[i]))) return false;
  for (size_t i = 0; i < colon; ++i) {
    unsigned char c = static_cast<unsigned char>(a[i]);
    if (!(std::isalnum(c) || c == '.' || c == '-' || c == '_'))
      return false;
  }
  return true;
}

}  // namespace

std::string RegistryServer::Dispatch(const std::string& req) {
  std::istringstream ss(req);
  std::string op;
  ss >> op;
  auto now = std::chrono::steady_clock::now();
  if (op == "REG" || op == "UNREG") {
    int shard = -1;
    std::string addr;
    ss >> shard >> addr;
    if (shard < 0 || shard > (1 << 20) || !ValidAddr(addr))
      return "ERR bad request";
    // optional trailing epoch token (eg_epoch.h); absent (a pre-epoch
    // registrant) or malformed reads as 0
    uint64_t epoch = 0;
    std::string tok;
    if (op == "REG" && ss >> tok) {
      char* end = nullptr;
      unsigned long long v = std::strtoull(tok.c_str(), &end, 10);
      if (end == tok.c_str() + tok.size()) epoch = v;
    }
    std::lock_guard<std::mutex> l(mu_);
    if (op == "REG")
      entries_[{shard, addr}] = {now + std::chrono::milliseconds(ttl_ms_),
                                 epoch};
    else
      entries_.erase({shard, addr});
    // reply carries the TTL so registrants can pace heartbeats to it
    return "OK " + std::to_string(ttl_ms_);
  }
  if (op == "LIST") {
    std::ostringstream out;
    std::lock_guard<std::mutex> l(mu_);
    for (auto it = entries_.begin(); it != entries_.end();) {
      if (it->second.expiry < now) {
        it = entries_.erase(it);  // expired: the ephemeral-znode analog
      } else {
        out << it->first.first << " " << it->first.second << " "
            << it->second.epoch << "\n";
        ++it;
      }
    }
    return out.str();
  }
  return "ERR unknown op";
}

// ---- client side ----

bool ParseTcpRegistry(const std::string& s, std::string* host, int* port) {
  const std::string prefix = "tcp://";
  if (s.compare(0, prefix.size(), prefix) != 0) return false;
  std::string rest = s.substr(prefix.size());
  size_t colon = rest.rfind(':');
  if (colon == std::string::npos || colon == 0) return false;
  *host = rest.substr(0, colon);
  *port = std::atoi(rest.c_str() + colon + 1);
  return *port > 0;
}

bool RegistrySend(int fd, const std::string& line, int* ttl_ms) {
  if (fd < 0 || !SendFrame(fd, line)) return false;
  std::string reply;
  if (!RecvFrame(fd, &reply) || reply.compare(0, 2, "OK") != 0) return false;
  if (ttl_ms && reply.size() > 3) {
    int t = std::atoi(reply.c_str() + 3);
    if (t > 0) *ttl_ms = t;
  }
  return true;
}

bool RegistryList(
    const std::string& host, int port, int timeout_ms,
    std::map<int, std::vector<std::string>>* out,
    std::map<std::pair<int, std::string>, uint64_t>* epochs) {
  int fd = DialTcp(host, port, timeout_ms);
  if (fd < 0) return false;
  std::string reply;
  bool ok = SendFrame(fd, "LIST") && RecvFrame(fd, &reply);
  ::close(fd);
  if (!ok) return false;
  std::istringstream ss(reply);
  std::string line;
  while (std::getline(ss, line)) {
    std::istringstream ls(line);
    int shard = -1;
    std::string addr;
    ls >> shard >> addr;
    if (shard >= 0 && !addr.empty()) {
      (*out)[shard].push_back(addr);
      if (epochs) {
        // trailing epoch token; a pre-epoch registry emits none -> 0
        uint64_t epoch = 0;
        std::string tok;
        if (ls >> tok) {
          char* end = nullptr;
          unsigned long long v = std::strtoull(tok.c_str(), &end, 10);
          if (end == tok.c_str() + tok.size()) epoch = v;
        }
        (*epochs)[{shard, addr}] = epoch;
      }
    }
  }
  return true;
}

}  // namespace eg
