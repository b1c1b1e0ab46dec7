#include "eg_wire.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <cerrno>
#include <cstring>

#include "eg_fault.h"
#include "eg_stats.h"

namespace eg {

namespace {

IoStatus WriteAll(int fd, const char* p, size_t n) {
  while (n) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return IoStatus::kTimeout;
      return IoStatus::kClosed;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return IoStatus::kOk;
}

IoStatus ReadAll(int fd, char* p, size_t n) {
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return IoStatus::kTimeout;
      return IoStatus::kClosed;
    }
    if (r == 0) return IoStatus::kClosed;  // peer closed
    p += r;
    n -= static_cast<size_t>(r);
  }
  return IoStatus::kOk;
}

void SetTimeouts(int fd, int timeout_ms) {
  if (timeout_ms <= 0) return;
  timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

}  // namespace

IoStatus SendFrameEx(int fd, const std::string& payload) {
  if (FaultHit(kFaultSendFrame)) return IoStatus::kClosed;
  uint32_t len = static_cast<uint32_t>(payload.size());
  if (payload.size() > kMaxFrame) return IoStatus::kReject;
  char hdr[4];
  std::memcpy(hdr, &len, 4);
  IoStatus s = WriteAll(fd, hdr, 4);
  if (s != IoStatus::kOk) return s;
  return WriteAll(fd, payload.data(), payload.size());
}

bool SendFrame(int fd, const std::string& payload) {
  return SendFrameEx(fd, payload) == IoStatus::kOk;
}

IoStatus RecvFrameEx(int fd, std::string* payload) {
  char hdr[4];
  IoStatus s = ReadAll(fd, hdr, 4);
  if (s != IoStatus::kOk) return s;
  // Fires after the header — a frame demonstrably began arriving — so an
  // injected fault is a true mid-frame reset (bytes lost, connection
  // must be discarded). Deliberately NOT at entry: a server handler
  // parked between requests would otherwise draw from the stream while
  // idle, making fault accounting depend on scheduler timing.
  if (FaultHit(kFaultRecvFrame)) return IoStatus::kClosed;
  uint32_t len;
  std::memcpy(&len, hdr, 4);
  if (len > kMaxFrame) {
    Counters::Global().Add(kCtrFrameReject);
    return IoStatus::kReject;
  }
  payload->resize(len);
  if (len == 0) return IoStatus::kOk;
  return ReadAll(fd, payload->data(), len);
}

bool RecvFrame(int fd, std::string* payload) {
  return RecvFrameEx(fd, payload) == IoStatus::kOk;
}

// ---- versioned request envelope ----

std::string WrapEnvelope(const std::string& payload, int64_t deadline_ms,
                         uint8_t version, uint64_t trace_id,
                         uint64_t epoch) {
  std::string out;
  out.reserve(payload.size() + 26);
  out.push_back(static_cast<char>(kWireEnvelope));
  out.push_back(static_cast<char>(version));
  char buf[8];
  std::memcpy(buf, &deadline_ms, 8);
  out.append(buf, 8);
  if (version >= 3) {
    std::memcpy(buf, &trace_id, 8);
    out.append(buf, 8);
  }
  if (version >= 4) {
    std::memcpy(buf, &epoch, 8);
    out.append(buf, 8);
  }
  out.append(payload);
  return out;
}

bool PeekEnvelope(const std::string& payload, Envelope* env) {
  *env = Envelope();
  if (payload.empty() ||
      static_cast<uint8_t>(payload[0]) != kWireEnvelope)
    return true;  // plain v1 request
  if (payload.size() < 10) return false;  // truncated envelope header
  env->versioned = true;
  env->version = static_cast<uint8_t>(payload[1]);
  std::memcpy(&env->deadline_ms, payload.data() + 2, 8);
  env->body_off = 10;
  if (env->version == 3 || env->version == 4) {
    // exactly the versions this build KNOWS read past the common header;
    // FUTURE versions keep the 10-byte parse (the server answers
    // kStatusBadVersion before the body offset could matter, so an
    // unknown layout never misparses)
    if (payload.size() < 18) return false;
    std::memcpy(&env->trace_id, payload.data() + 10, 8);
    env->body_off = 18;
    if (env->version == 4) {
      if (payload.size() < 26) return false;
      std::memcpy(&env->epoch, payload.data() + 18, 8);
      env->body_off = 26;
    }
  }
  return true;
}

std::string StatusReply(uint8_t status, const std::string& msg) {
  WireWriter w;
  w.U8(status);
  w.Str(msg);
  return std::move(w.buf());
}

int DialTcp(const std::string& host, int port, int timeout_ms) {
  if (FaultHit(kFaultDial)) return -1;
  addrinfo hints{};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  std::string port_s = std::to_string(port);
  if (::getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0)
    return -1;
  int fd = -1;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    SetTimeouts(fd, timeout_ms);
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  ::freeaddrinfo(res);
  if (fd >= 0) {
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  return fd;
}

int ListenTcp(const std::string& host, int port, int* bound_port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (host.empty() || host == "0.0.0.0") {
    addr.sin_addr.s_addr = INADDR_ANY;
  } else if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 128) < 0) {
    ::close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  if (::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen) == 0)
    *bound_port = ntohs(addr.sin_port);
  else
    *bound_port = port;
  return fd;
}

}  // namespace eg
