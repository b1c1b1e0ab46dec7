// Binary wire protocol for the sharded graph service.
//
// Role equivalent of the reference's protobuf wire layer
// (reference euler/proto/graph_service.proto: 13 RPCs with flat id/weight
// array replies) — redesigned as a zero-dependency length-prefixed binary
// protocol: requests and replies are flat little-endian arrays, so
// marshaling is memcpy-shaped (the reference's §3.5 hot loop #3 is gRPC
// serialize/deserialize of exactly such arrays).
//
// Frame:   [u32 payload_len][payload]
// Request: payload = [u8 op][args...]                              (wire v1)
//          [u8 0xE7][u8 2][i64 deadline_ms][u8 op][args...]        (wire v2)
//          [u8 0xE7][u8 3][i64 deadline_ms][u64 trace_id][u8 op][args...]
//                                                                  (wire v3)
//          [u8 0xE7][u8 4][i64 deadline_ms][u64 trace_id][u64 epoch]
//          [u8 op][args...]                                        (wire v4)
// Reply:   payload = [u8 status][body...]   status 0 = ok, else see
//          WireStatus (1 = error string; 2 BUSY; 3 DEADLINE; 4 BADVERSION).
//          To a v4 request, an OK reply body is prefixed with the shard's
//          CURRENT epoch: [u8 0][u64 epoch][body...] — the passive flip
//          announcement clients learn graph refreshes from (eg_epoch.h).
//          Error/BUSY/DEADLINE/BADVERSION replies are never stamped, so
//          their layout stays identical across all versions.
//
// Version negotiation (backward compatible in every direction, all
// passive — no extra handshake round trip, ever):
//   * current clients wrap every request in the 0xE7 envelope, stamping
//     the call's REMAINING deadline budget (ms) so the server can
//     refuse requests whose answers nobody will read, (v3) the call's
//     trace id so both sides' slow-span journals correlate
//     (eg_telemetry.h), and (v4) the EPOCH the op pinned at start —
//     0 = current; a nonzero epoch asks the shard to serve that
//     snapshot if it still holds it (in-flight multi-hop steps finish
//     against the snapshot they started on, eg_epoch.h).
//   * current servers accept ALL forms: a first byte in the op range is
//     a v1 request (no deadline, no trace); 0xE7 opens an envelope,
//     whose version byte selects the header layout (v2 = 10 bytes,
//     v3 = 18, v4 = 26). An envelope whose version is above the
//     server's speaks back kStatusBadVersion with a plain-text
//     explanation — never a hang or a crash.
//   * a v1 server sees 0xE7 as an unknown op and answers its stock
//     "unknown op 231" error with the connection still healthy; clients
//     recognize exactly that reply on a replica's first exchange, mark
//     the replica v1 (`wire_downgrades` counter), and resend the raw
//     request on the same connection. A v2- or v3-only server instead
//     answers kStatusBadVersion to the v4 envelope; the client steps
//     the replica down one version (4 -> 3 -> 2) and resends — one
//     `wire_downgrades` count per replica pinned below kWireVersion,
//     at most two extra exchanges on its first call ever.
#ifndef EG_WIRE_H_
#define EG_WIRE_H_

#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace eg {

// Op codes — one per GraphService RPC (reference graph_service.proto:13-25;
// sorted-ness is a flag on kFullNeighbor, dense == Float32 feature).
enum WireOp : uint8_t {
  kPing = 1,
  kInfo = 2,
  kSampleNode = 3,
  kSampleEdge = 4,
  kNodeType = 5,
  kSampleNeighbor = 6,
  kFullNeighbor = 7,
  kTopKNeighbor = 8,
  kDenseFeature = 9,
  kEdgeDenseFeature = 10,
  kSparseFeature = 11,
  kEdgeSparseFeature = 12,
  kBinaryFeature = 13,
  kEdgeBinaryFeature = 14,
  // Beyond the reference's 13 RPCs: flat per-node sampling weights, so
  // the device-graph exporter (build_node_sampler) composes with remote
  // mode instead of requiring the whole graph embedded in one process.
  kNodeWeight = 15,
  // Dedup-aware neighbor sampling: the client coalesces duplicate ids
  // before encode and sends each UNIQUE id once with a repeat count; the
  // shard replies reps[i] * count iid draws per unique id, flattened in
  // request order. Independence across duplicate rows is preserved
  // (every draw is a fresh engine sample), while hub ids — repeated
  // thousands of times in a power-law batch — cost one id on the wire
  // and one node/group lookup on the shard.
  // Request: [Arr u64 ids][Arr i32 reps][Arr i32 etypes][i32 count][u64 def]
  // Reply:   [Arr u64 nbr][Arr f32 w][Arr i32 t], each sum(reps)*count long.
  kSampleNeighborUniq = 16,
  // Remote observability scrape (eg_telemetry.h): ask a live shard for
  // its full telemetry dump — counters, span-timer stats, latency
  // histograms, admission gauges, slow-span journal. Request: no args.
  // Reply: [Str json] — the same JSON Telemetry::Json builds for the
  // local surface, so scrape-vs-local parity is one string compare.
  kStats = 17,
  // Resource-gauge history scrape (eg_blackbox.h): the shard's 60-entry
  // background-sampled ring of {RSS, open fds, live threads, cache
  // bytes} plus a fresh sample — the live view of exactly what a
  // postmortem dump freezes. Request: no args. Reply: [Str json].
  kHistory = 18,
  // Data-plane heat scrape (eg_heat.h): the shard's full hot-vertex
  // top-K table, count-min sketch totals, per-op ids ledger, and
  // cache-efficacy classes — the targeted form of the heat section
  // that also rides every kStats reply. Request: no args.
  // Reply: [Str json].
  kHeat = 19,
  // Placement-map fetch (eg_placement.h): the raw id -> partition
  // artifact the degree-aware converter emitted next to this shard's
  // .dat partitions, so clients can route hub neighborhoods to the
  // shard that actually holds them. Request: no args. Reply:
  // [Str blob]. A shard serving hash-sharded data (no artifact)
  // answers the STOCK "unknown op 20" error — byte-identical to a
  // genuine pre-placement server, so one client fallback path (degrade
  // to hash routing) covers old servers and old data alike.
  kPlacement = 20,
  // Snapshot-epoch delta load (eg_epoch.h): merge one delta file into a
  // fresh immutable snapshot and flip the shard's serving epoch to it.
  // Request: [Str path] — a shard-local `<prefix>.delta.<n>` file.
  // Reply: [u64 new_epoch]. Serialized per shard (concurrent loads
  // queue); failure (parse/validate/merge, or the delta_load/epoch_flip
  // failpoints) answers an error string, counts delta_loads_failed,
  // and leaves the current epoch serving.
  kLoadDelta = 21,
};

constexpr uint32_t kMaxFrame = 1u << 30;  // 1 GiB sanity cap

// Highest request-envelope version this build speaks; stamped by clients
// and checked by servers (see the negotiation contract above).
constexpr uint8_t kWireVersion = 4;
// Request-envelope marker. Deliberately far outside the op range so a v1
// server classifies an enveloped request as an unknown op (clean error)
// instead of misparsing it.
constexpr uint8_t kWireEnvelope = 0xE7;

// Reply status byte. v1 peers only know 0/1; every later code reads as a
// generic refused frame there (counted, retried) — degraded, never wrong.
enum WireStatus : uint8_t {
  kStatusOk = 0,
  kStatusError = 1,       // body = error string
  kStatusBusy = 2,        // admission shed the connection; fail over NOW
  kStatusDeadline = 3,    // request's stamped deadline expired server-side
  kStatusBadVersion = 4,  // envelope version above the server's
};

// Parsed view of a request payload's (optional) envelope.
struct Envelope {
  bool versioned = false;   // payload opened with kWireEnvelope
  uint8_t version = 1;      // stamped version (1 when not versioned)
  int64_t deadline_ms = -1; // client's remaining budget; <0 = none stamped
  uint64_t trace_id = 0;    // v3+ trace id; 0 = none propagated
  uint64_t epoch = 0;       // v4 pinned epoch; 0 = serve current
  size_t body_off = 0;      // offset of the v1 [u8 op][args...] body
};

// [kWireEnvelope][u8 version][i64 deadline_ms]([u64 trace_id] for v3+)
// ([u64 epoch] for v4) + payload. `version` must be 2, 3 or 4 (v2 has
// no trace-id field, only v4 carries the epoch pin).
std::string WrapEnvelope(const std::string& payload, int64_t deadline_ms,
                         uint8_t version = kWireVersion,
                         uint64_t trace_id = 0, uint64_t epoch = 0);
// Classify a request payload; false only for a TRUNCATED envelope (marker
// present but header short for its stamped version) — a payload without
// the marker is v1, ok. Versions above kWireVersion parse the common
// 10-byte prefix only (the caller rejects them with kStatusBadVersion
// before the body would matter).
bool PeekEnvelope(const std::string& payload, Envelope* env);
// [u8 status][Str msg] reply payload.
std::string StatusReply(uint8_t status, const std::string& msg);

class WireWriter {
 public:
  std::string& buf() { return buf_; }

  void U8(uint8_t v) { buf_.push_back(static_cast<char>(v)); }
  template <typename T>
  void Pod(T v) {
    buf_.append(reinterpret_cast<const char*>(&v), sizeof(T));
  }
  void I32(int32_t v) { Pod(v); }
  void I64(int64_t v) { Pod(v); }
  void U64(uint64_t v) { Pod(v); }
  void F32(float v) { Pod(v); }

  template <typename T>
  void Arr(const T* p, int64_t n) {
    I64(n);
    if (n) buf_.append(reinterpret_cast<const char*>(p), n * sizeof(T));
  }
  template <typename T>
  void Arr(const std::vector<T>& v) {
    Arr(v.data(), static_cast<int64_t>(v.size()));
  }
  void Str(const std::string& s) {
    I64(static_cast<int64_t>(s.size()));
    buf_.append(s);
  }

 private:
  std::string buf_;
};

class WireReader {
 public:
  WireReader(const char* p, size_t n) : p_(p), n_(n) {}
  explicit WireReader(const std::string& s) : p_(s.data()), n_(s.size()) {}

  bool ok() const { return ok_; }
  // Bytes left unread — the bound for counts decoded from the payload:
  // any honest element/slot count costs at least its encoding's bytes,
  // so callers reject counts beyond remaining()/<min bytes per entry>
  // before allocating (eg-lint rule wire-count-alloc).
  size_t remaining() const { return n_ - off_; }

  uint8_t U8() {
    uint8_t v = 0;
    Copy(&v, 1);
    return v;
  }
  template <typename T>
  T Pod() {
    T v{};
    Copy(&v, sizeof(T));
    return v;
  }
  int32_t I32() { return Pod<int32_t>(); }
  int64_t I64() { return Pod<int64_t>(); }
  uint64_t U64() { return Pod<uint64_t>(); }
  float F32() { return Pod<float>(); }

  // View of a length-prefixed array; nullptr on underrun. Zero-copy when
  // the payload offset happens to be aligned for T; otherwise the data is
  // memcpy'd into an owned 8-byte-aligned scratch block (offsets after the
  // leading status/op byte are usually odd, so replies typically take the
  // copy path — still one copy, same as protobuf parsing).
  template <typename T>
  const T* Arr(int64_t* n) {
    *n = I64();
    // Divide instead of multiplying: n * sizeof(T) can wrap for a hostile
    // length, which would pass the underrun check and then explode in the
    // caller's vector allocation.
    if (!ok_ || *n < 0 ||
        static_cast<uint64_t>(*n) > (n_ - off_) / sizeof(T)) {
      ok_ = false;
      *n = 0;
      return nullptr;
    }
    size_t bytes = static_cast<size_t>(*n) * sizeof(T);
    const char* raw = p_ + off_;
    off_ += bytes;
    if (reinterpret_cast<uintptr_t>(raw) % alignof(T) == 0)
      return reinterpret_cast<const T*>(raw);
    auto buf = std::make_unique<std::vector<uint64_t>>((bytes + 7) / 8);
    std::memcpy(buf->data(), raw, bytes);
    const T* p = reinterpret_cast<const T*>(buf->data());
    scratch_.push_back(std::move(buf));
    return p;
  }
  template <typename T>
  void Vec(std::vector<T>* out) {
    int64_t n;
    const T* p = Arr<T>(&n);
    out->assign(p, p + n);
  }
  std::string Str() {
    int64_t n;
    const char* p = Arr<char>(&n);
    return std::string(p ? p : "", static_cast<size_t>(n));
  }

 private:
  void Copy(void* out, size_t sz) {
    if (sz > n_ - off_) {
      ok_ = false;
      std::memset(out, 0, sz);
      return;
    }
    std::memcpy(out, p_ + off_, sz);
    off_ += sz;
  }

  const char* p_;
  size_t n_;
  size_t off_ = 0;
  bool ok_ = true;
  std::vector<std::unique_ptr<std::vector<uint64_t>>> scratch_;
};

// ---- framed socket IO (implemented in eg_wire.cc) ----

// Outcome of one framed IO op, for callers that must distinguish a
// wedged peer (socket timeout — the handler-slot-freeing case) from a
// clean close or a protocol rejection.
enum class IoStatus {
  kOk,
  kClosed,   // peer closed / reset / write error
  kTimeout,  // SO_RCVTIMEO / SO_SNDTIMEO expired mid-op
  kReject,   // oversize declared length (counted in frames_rejected)
};

// Write [u32 len][payload]; false on error.
bool SendFrame(int fd, const std::string& payload);
// SendFrame distinguishing a send-buffer timeout (client stopped
// reading) from a plain broken pipe.
IoStatus SendFrameEx(int fd, const std::string& payload);
// Read one frame into *payload; false on error/close/oversize.
bool RecvFrame(int fd, std::string* payload);
// RecvFrame distinguishing timeout/close/oversize (see IoStatus).
IoStatus RecvFrameEx(int fd, std::string* payload);
// Blocking TCP connect with send/recv timeouts + TCP_NODELAY; -1 on failure.
int DialTcp(const std::string& host, int port, int timeout_ms);
// Listen socket on host:port (port 0 = ephemeral); *bound_port receives the
// actual port. -1 on failure.
int ListenTcp(const std::string& host, int port, int* bound_port);

}  // namespace eg

#endif  // EG_WIRE_H_
