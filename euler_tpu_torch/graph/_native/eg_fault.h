// Deterministic fault injection ("failpoints") for the transport stack.
//
// Production-scale remote serving treats shard death, slow links, and
// mid-frame resets as routine (ROADMAP north star; FastSample and the
// pipelined-sampling line assume the sampling tier keeps feeding the
// accelerator through exactly these hiccups). Until now every failure
// path in eg_remote/eg_service was exercised only by real process kills;
// this layer makes the same failures injectable, seeded, and countable:
//
//   fault=recv_frame:err@0.5,dial:delay@200     (see FAULTS.md)
//
// Named failpoints sit at the transport choke points (dial, send_frame,
// recv_frame, service_reply, registry_reply, heartbeat). Each point owns
// its own splitmix64 stream derived from the configured seed, so the
// decision SEQUENCE at a point is a pure function of (seed, hit index) —
// a given seed replays the exact failure pattern regardless of which
// thread hits the point (thread interleaving only changes which caller
// draws which decision, not the pattern itself).
//
// Compiled in always; the unconfigured cost is one relaxed atomic load
// per hook (FaultHit below) — nothing is registered, no lock is taken.
#ifndef EG_FAULT_H_
#define EG_FAULT_H_

#include <atomic>
#include <cstdint>
#include <mutex>
#include <string>

#include "eg_common.h"

namespace eg {

enum FaultId : int {
  kFaultDial = 0,      // DialTcp: connect fails (-1) or is delayed
  kFaultSendFrame,     // SendFrame: write fails (connection is discarded)
  kFaultRecvFrame,     // RecvFrame: read fails (mid-frame reset analog)
  kFaultServiceReply,  // service worker: reply dropped, conn closed
  kFaultRegistryReply, // RegistryServer::HandleConn: ditto for LIST/REG
  kFaultHeartbeat,     // Service heartbeat: one beat forced to miss
  // Server-side survivability failpoints (eg_admission.cc):
  kFaultAccept,        // admission: the accepted connection is dropped
                       // on the floor (err) or accept is slowed (delay)
  kFaultHandlerStall,  // worker, post-recv pre-dispatch: the handler
                       // stalls (delay — drives deadline replies) or
                       // wedges and abandons the connection (err)
  kFaultBusyForce,     // admission: the capacity check is forced to
                       // report overload — a deterministic BUSY reply
  // Postmortem-path failpoint (eg_blackbox.h): a seeded FATAL SIGNAL at
  // the dial (client) and handler (server) hook points, so the
  // flight-recorder + crash-dump path is deterministically testable.
  // Grammar reuses the action params as the signal choice:
  //   crash:err@p[#limit]          raise(SIGSEGV)
  //   crash:delay@SIG[@p][#limit]  raise(SIG) (e.g. 6 = SIGABRT)
  // The `crashes` counter is bumped BEFORE the raise, so the signal
  // handler's postmortem ledger accounts for the fire that killed it.
  kFaultCrash,
  // Snapshot-epoch failpoints (eg_epoch.h / eg_service.cc LoadDelta):
  kFaultDeltaLoad,     // delta file read/parse forced to fail (err) or
                       // slowed (delay — widens the pre-flip window the
                       // chaos soak races SIGKILL into)
  kFaultEpochFlip,     // the flip publish itself: err refuses the flip
                       // after the merged engine was built (the shard
                       // keeps serving its current epoch; counted in
                       // delta_loads_failed), delay stalls between
                       // build and publish
  kFaultIdCount,
};

// Fixed-order names; both the config grammar and Python read them.
const char* const kFaultNames[kFaultIdCount] = {
    "dial",           "send_frame", "recv_frame",
    "service_reply",  "registry_reply", "heartbeat",
    "accept",         "handler_stall",  "busy_force",
    "crash",          "delta_load",     "epoch_flip",
};

class FaultInjector {
 public:
  static FaultInjector& Global() {
    static FaultInjector f;
    return f;
  }

  // Parse and install a spec: comma-separated failpoints
  //   <point>:err@<prob>[#<limit>]
  //   <point>:delay@<ms>[@<prob>][#<limit>]
  // Replaces the whole previous configuration (per-point streams restart
  // from `seed`). Empty spec == Clear(). False + error() on a malformed
  // spec (unknown point, bad number, duplicate point) — nothing is
  // installed in that case.
  bool Configure(const std::string& spec, uint64_t seed);
  void Clear();
  const std::string& error() const { return error_; }

  bool enabled() const { return enabled_.load(std::memory_order_relaxed); }

  // Decide whether the fault at `id` fires on this hit. Applies the
  // configured delay (sleeping in the caller's thread), counts the fire,
  // and returns true when the caller must fail the operation (err
  // faults; delay-only faults return false after sleeping).
  bool Fire(FaultId id);

  // Injected-fault ledger: how many times each point has fired since it
  // was (re)configured.
  uint64_t injected(FaultId id) const;
  void SnapshotInjected(uint64_t* out) const;

 private:
  struct Point {
    bool configured = false;
    bool err = false;   // true: fail the op; false: delay only
    double prob = 1.0;  // fire probability per hit
    int delay_ms = 0;   // sleep before (possibly) failing
    int64_t limit = -1; // max fires, -1 = unlimited
    int64_t fired = 0;
    Rng rng{0};
  };

  std::atomic<bool> enabled_{false};
  mutable std::mutex mu_;  // guards points_ (config, streams, ledger)
  Point points_[kFaultIdCount];
  std::string error_;
};

// The hook every transport choke point calls: one relaxed load when no
// fault is configured, the full decision path otherwise.
inline bool FaultHit(FaultId id) {
  FaultInjector& f = FaultInjector::Global();
  if (!f.enabled()) return false;
  return f.Fire(id);
}

}  // namespace eg

#endif  // EG_FAULT_H_
