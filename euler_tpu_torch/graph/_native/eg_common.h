// euler_tpu native graph engine — common types and utilities.
//
// TPU-native rebuild of the reference Euler graph engine
// (cf. the reference's euler/common/data_types.h, random.h, bytes_reader.h).
// Design departs from the reference: the store is a flat SoA arena (see
// eg_graph.h) rather than per-node heap objects, so batch sampling is
// cache-friendly and trivially parallel across a host CPU feeding TPU chips.
#ifndef EG_COMMON_H_
#define EG_COMMON_H_

#include <pthread.h>
#include <time.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

// Lock-discipline annotation, machine-checked by scripts/check_contracts.py
// (pass `lock`, rule `guarded-by`): a member declared
//
//     std::deque<Conn> ready_ EG_GUARDED_BY(mu_);
//
// may only be touched inside a scope holding an RAII guard on `mu_`
// (std::lock_guard / std::unique_lock / std::scoped_lock), including
// wait-predicate lambdas whose enclosing unique_lock holds it.
// Deliberately-unlocked accesses (constructors/destructors are exempt
// automatically; documented lock-free reads are not) need a reasoned
// `allow(guarded-by)` escape — check_native.py's eg-lint grammar — on
// or above the line. Expands to nothing — gcc 10 has no
// -Wthread-safety — so the checker, not the compiler, enforces it.
#define EG_GUARDED_BY(mu)

// Companion annotation for helper functions that are only ever called
// with `mu` already held (the caller locks, the helper touches guarded
// state freely). The checker exempts the helper's body and instead
// verifies every CALL SITE holds the guard — same enforcement story as
// EG_GUARDED_BY: checker, not compiler.
#define EG_REQUIRES(mu)

namespace eg {

using NodeID = uint64_t;

// Edge identity: (src, dst, type). Mirrors the reference wire semantics
// (reference euler/common/data_types.h:29-41) with our own hash mix.
struct EdgeKey {
  uint64_t src;
  uint64_t dst;
  int32_t type;
  bool operator==(const EdgeKey& o) const {
    return src == o.src && dst == o.dst && type == o.type;
  }
};

struct EdgeKeyHash {
  size_t operator()(const EdgeKey& k) const {
    // splitmix64-style mixing of the three fields.
    uint64_t h = k.src * 0x9E3779B97F4A7C15ULL;
    h ^= (k.dst + 0x9E3779B97F4A7C15ULL + (h << 6) + (h >> 2));
    h *= 0xBF58476D1CE4E5B9ULL;
    h ^= static_cast<uint64_t>(k.type) + (h >> 31);
    return static_cast<size_t>(h * 0x94D049BB133111EBULL);
  }
};

// Fast per-thread RNG (xorshift-based splitmix64). The reference uses
// thread_local std::default_random_engine (reference euler/common/random.cc:22);
// we need something cheaper because sampling draws dominate the host profile.
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed = 0x853C49E6748FEA9BULL) : state(seed) {}
  inline uint64_t Next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  // Uniform in [0, 1).
  inline double NextDouble() {
    return static_cast<double>(Next() >> 11) * (1.0 / 9007199254740992.0);
  }
  inline float NextFloat() { return static_cast<float>(NextDouble()); }
  // Uniform integer in [0, n).
  inline uint64_t NextLess(uint64_t n) {
    return n ? static_cast<uint64_t>(NextDouble() * static_cast<double>(n)) % n
             : 0;
  }
};

Rng& ThreadRng();
void SeedThreadRng(uint64_t seed);

// Mutex with a TSAN-visible lifecycle. std::mutex on Linux is
// trivially constructed AND trivially destroyed (PTHREAD_MUTEX_
// INITIALIZER, no init/destroy calls), so when an object holding one
// is deleted and the allocator hands its block to a NEW object of the
// same class, TSAN's shadow state for the old mutex survives at that
// address and the new object's first lock reports a false "double
// lock of a destroyed mutex" (reproduced on sequential Service
// create/stop churn under `make tsan`; an address-size pad on the
// PRE-telemetry tree reproduces it identically, pinning it as an
// allocator-layout artifact, SANITIZERS.md round 9). Explicit
// pthread_mutex_init/destroy are intercepted by TSAN and reset the
// shadow state, so heap-recycled servers start clean. Satisfies
// BasicLockable: use through std::lock_guard/std::unique_lock like
// any std::mutex (the raw-lock lint rule applies to callers as usual).
class PosixMutex {
 public:
  PosixMutex() { pthread_mutex_init(&m_, nullptr); }
  ~PosixMutex() { pthread_mutex_destroy(&m_); }
  PosixMutex(const PosixMutex&) = delete;
  PosixMutex& operator=(const PosixMutex&) = delete;
  void lock() { pthread_mutex_lock(&m_); }
  void unlock() { pthread_mutex_unlock(&m_); }
  bool try_lock() { return pthread_mutex_trylock(&m_) == 0; }
  pthread_mutex_t* native() { return &m_; }

 private:
  pthread_mutex_t m_;
};

// Companion condition variable with the same TSAN-visible lifecycle.
// NOT std::condition_variable (whose mutex type is fixed to
// std::mutex) and NOT std::condition_variable_any (which allocates an
// INTERNAL std::shared_ptr<std::mutex> — trivially initialized, so the
// heap-recycling false positive above just moves inside it). Runs on a
// CLOCK_MONOTONIC pthread_cond_t, so timed waits ignore wall-clock
// jumps.
class PosixCondVar {
 public:
  PosixCondVar() {
    pthread_condattr_t attr;
    pthread_condattr_init(&attr);
    pthread_condattr_setclock(&attr, CLOCK_MONOTONIC);
    pthread_cond_init(&c_, &attr);
    pthread_condattr_destroy(&attr);
  }
  ~PosixCondVar() { pthread_cond_destroy(&c_); }
  PosixCondVar(const PosixCondVar&) = delete;
  PosixCondVar& operator=(const PosixCondVar&) = delete;

  void notify_one() { pthread_cond_signal(&c_); }
  void notify_all() { pthread_cond_broadcast(&c_); }

  template <typename Pred>
  void wait(std::unique_lock<PosixMutex>& l, Pred pred) {
    while (!pred()) pthread_cond_wait(&c_, l.mutex()->native());
  }

  // Wait up to timeout_ms for pred; returns pred()'s final verdict.
  template <typename Pred>
  bool wait_for_ms(std::unique_lock<PosixMutex>& l, int64_t timeout_ms,
                   Pred pred) {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    ts.tv_sec += timeout_ms / 1000;
    ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (ts.tv_nsec >= 1000000000L) {
      ts.tv_sec += 1;
      ts.tv_nsec -= 1000000000L;
    }
    while (!pred()) {
      if (pthread_cond_timedwait(&c_, l.mutex()->native(), &ts) != 0)
        return pred();  // timeout (or error): report the final state
    }
    return true;
  }

 private:
  pthread_cond_t c_;
};

// Little-endian cursor over a byte buffer; unaligned-safe via memcpy.
// (Equivalent role to reference euler/common/bytes_reader.h:27.)
class ByteCursor {
 public:
  ByteCursor(const char* data, size_t size) : p_(data), end_(data + size) {}

  template <typename T>
  bool Read(T* out) {
    if (p_ + sizeof(T) > end_) return false;
    std::memcpy(out, p_, sizeof(T));
    p_ += sizeof(T);
    return true;
  }

  template <typename T>
  bool ReadVec(size_t n, std::vector<T>* out) {
    // compare against remaining(): `p_ + n * sizeof(T)` overflows for
    // corrupt huge n, slipping past the bound into resize()/memcpy
    if (n > remaining() / sizeof(T)) return false;
    out->resize(n);
    if (n) std::memcpy(out->data(), p_, n * sizeof(T));
    p_ += n * sizeof(T);
    return true;
  }

  bool ReadStr(size_t n, std::string* out) {
    if (n > remaining()) return false;
    out->assign(p_, n);
    p_ += n;
    return true;
  }

  bool Skip(size_t n) {
    if (n > remaining()) return false;
    p_ += n;
    return true;
  }

  size_t remaining() const { return static_cast<size_t>(end_ - p_); }
  const char* ptr() const { return p_; }

 private:
  const char* p_;
  const char* end_;
};

}  // namespace eg

#endif  // EG_COMMON_H_
