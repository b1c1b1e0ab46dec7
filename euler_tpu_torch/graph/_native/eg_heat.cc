#include "eg_heat.h"

#include <algorithm>

namespace eg {

namespace {

thread_local int g_heat_conn = -1;

// splitmix64 finalizer — the same mix eg_telemetry/eg_cache use; one
// finalized hash per id drives both the sketch cells and the top-K
// index probe (see CmsCell below).
uint64_t Mix(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// Blocked sketch addressing from ONE splitmix64 hash per id (the same
// hash the top-K index probes): bits 0..9 pick the 64-byte block,
// disjoint higher windows pick two cells inside it. One cache line
// touched per id; the two in-block cells may coincide (1-in-8), which
// just degrades that id to a depth-1 estimate.
inline uint64_t CmsCell(uint64_t h, int d) {
  uint64_t block = h & (kHeatCmsBlocks - 1);
  uint64_t sub = (h >> (20 + d * 16)) & (kHeatCmsBlockCells - 1);
  return block * kHeatCmsBlockCells + sub;
}

void AppendU64(std::string* out, uint64_t v) {
  char buf[24];
  int n = 0;
  do {
    buf[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) out->push_back(buf[--n]);
}

void AppendI64(std::string* out, int64_t v) {
  if (v < 0) {
    out->push_back('-');
    AppendU64(out, static_cast<uint64_t>(-v));
  } else {
    AppendU64(out, static_cast<uint64_t>(v));
  }
}

void AppendKey(std::string* out, const char* k) {
  out->push_back('"');
  out->append(k);
  out->append("\":");
}

}  // namespace

void HeatSetConn(int conn) { g_heat_conn = conn; }
int HeatConn() { return g_heat_conn; }

Heat& Heat::Global() {
  static Heat h;
  return h;
}

Heat::Heat() {
  for (auto& t : top_)
    for (auto& c : t.index) c = -1;
  for (auto& c : conn_fd_) c.store(-1, std::memory_order_relaxed);
}

void Heat::SetTopK(int k) {
  if (k < 1) k = 1;
  if (k > kHeatMaxTopK) k = kHeatMaxTopK;
  cap_.store(k, std::memory_order_relaxed);
  for (auto& t : top_) {
    std::lock_guard<std::mutex> l(t.mu);
    t.size = 0;
    t.tombstones = 0;
    t.min_count = 0;
    t.scan_pos = 0;
    for (auto& c : t.index) c = -1;
  }
}

int Heat::topk_capacity() const {
  return cap_.load(std::memory_order_relaxed);
}

int Heat::FindSlot(const TopTable& t, uint64_t id, uint64_t h)
    EG_REQUIRES(mu) {
  for (int probe = 0; probe < kHeatIndexSlots; ++probe) {
    int i = static_cast<int>((h + probe) & (kHeatIndexSlots - 1));
    int32_t v = t.index[i];
    if (v == -1) return -1;
    if (v >= 0 && t.ids[v] == id) return v;
  }
  return -1;  // unreachable: the table is never full (load <= 25%)
}

void Heat::InsertSlot(TopTable* t, uint64_t h, int slot) EG_REQUIRES(mu) {
  for (int probe = 0; probe < kHeatIndexSlots; ++probe) {
    int i = static_cast<int>((h + probe) & (kHeatIndexSlots - 1));
    int32_t v = t->index[i];
    if (v == -1 || v == -2) {
      if (v == -2) --t->tombstones;
      t->index[i] = slot;
      return;
    }
  }
}

void Heat::EraseSlot(TopTable* t, uint64_t id) EG_REQUIRES(mu) {
  uint64_t h = Mix(id);
  for (int probe = 0; probe < kHeatIndexSlots; ++probe) {
    int i = static_cast<int>((h + probe) & (kHeatIndexSlots - 1));
    int32_t v = t->index[i];
    if (v == -1) return;
    if (v >= 0 && t->ids[v] == id) {
      t->index[i] = -2;
      if (++t->tombstones > kHeatIndexSlots / 4) RebuildIndex(t);
      return;
    }
  }
}

void Heat::RebuildIndex(TopTable* t) EG_REQUIRES(mu) {
  for (auto& c : t->index) c = -1;
  t->tombstones = 0;
  for (int s = 0; s < t->size; ++s) InsertSlot(t, Mix(t->ids[s]), s);
}

void Heat::UpdateTop(TopTable* t, uint64_t id, uint64_t h, int cap)
    EG_REQUIRES(mu) {
  int slot = FindSlot(*t, id, h);
  if (slot >= 0) {
    ++t->counts[slot];
    return;
  }
  if (t->size < cap) {
    slot = t->size++;
    t->ids[slot] = id;
    t->counts[slot] = 1;
    t->errs[slot] = 0;
    InsertSlot(t, h, slot);
    if (t->size == cap) {
      // table just filled: every slot was inserted at count >= 1 and
      // only grew, so the smallest count is the true min level
      int m = 0;
      for (int s = 1; s < cap; ++s)
        if (t->counts[s] < t->counts[m]) m = s;
      t->min_count = t->counts[m];
      t->scan_pos = m;
    }
    return;
  }
  // space-saving replacement: evict A minimum slot (any slot at the
  // cached min level is a true minimum, see TopTable::min_count); the
  // newcomer inherits its count as the overestimate err
  int m = -1;
  for (int k = 0; k < cap; ++k) {
    int i = t->scan_pos + k;
    if (i >= cap) i -= cap;
    if (t->counts[i] == t->min_count) {
      m = i;
      t->scan_pos = i;
      break;
    }
  }
  if (m < 0) {
    // level exhausted (every min slot replaced or incremented away):
    // recompute — counts only grow, so this raises min_count
    m = 0;
    for (int s = 1; s < cap; ++s)
      if (t->counts[s] < t->counts[m]) m = s;
    t->min_count = t->counts[m];
    t->scan_pos = m;
  }
  EraseSlot(t, t->ids[m]);
  t->ids[m] = id;
  t->errs[m] = t->counts[m];
  t->counts[m] += 1;
  InsertSlot(t, h, m);
}

void Heat::Record(int side, int op, const uint64_t* keys, int64_t n,
                  int conn) {
  RecordRows(side, op, keys, nullptr, n, conn);
}

void Heat::RecordRows(int side, int op, const uint64_t* base,
                      const int32_t* rows, int64_t n, int conn,
                      uint8_t* out_classes) {
  if (!enabled() || n <= 0) return;
  if (side < 0 || side >= kHeatSideCount) return;
  if (op < 0 || op >= kHistOpSlots) op = 0;
  total_[side].fetch_add(static_cast<uint64_t>(n),
                         std::memory_order_relaxed);
  ids_by_op_[side][op].fetch_add(static_cast<uint64_t>(n),
                                 std::memory_order_relaxed);
  if (side == kHeatServer && conn >= 0) {
    // fd-labeled fixed pool: claim a slot by CAS on first sight; a
    // full pool counts into the overflow bucket instead of allocating
    bool placed = false;
    for (int c = 0; c < kHeatMaxConns; ++c) {
      int cur = conn_fd_[c].load(std::memory_order_relaxed);
      if (cur == conn) {
        conn_ids_[c].fetch_add(static_cast<uint64_t>(n),
                               std::memory_order_relaxed);
        placed = true;
        break;
      }
      if (cur == -1) {
        int expect = -1;
        if (conn_fd_[c].compare_exchange_strong(
                expect, conn, std::memory_order_relaxed)) {
          conn_ids_[c].fetch_add(static_cast<uint64_t>(n),
                                 std::memory_order_relaxed);
          placed = true;
          break;
        }
        if (expect == conn) {
          conn_ids_[c].fetch_add(static_cast<uint64_t>(n),
                                 std::memory_order_relaxed);
          placed = true;
          break;
        }
      }
    }
    if (!placed)
      conn_overflow_.fetch_add(static_cast<uint64_t>(n),
                               std::memory_order_relaxed);
  }
  // one fused pass: sketch updates + top-K update share a single Mix
  // per id; the top-K mutex is held once per BATCH. Because THIS mutex
  // serializes every writer of this side's sketch (feeds are the only
  // writers and all come through here), the cells increment with plain
  // relaxed load+store pairs instead of locked fetch_adds — an
  // uncontended `lock xadd` still costs tens of cycles per id, and two
  // per id was the measured majority of the feed's ns/id. Concurrent
  // READERS (Estimate, the scrape JSON) see relaxed atomic loads: never
  // torn, at worst one increment stale. The pre-increment row counts
  // give the frequency class (estimate = min + 1) for free.
  TopTable& t = top_[side];
  int cap = cap_.load(std::memory_order_relaxed);
  std::lock_guard<std::mutex> l(t.mu);
  // chunked two-phase walk: hash a small run of ids first, prefetching
  // each id's sketch line (one 64-byte block) while the hashes of its
  // neighbors compute — the blocked layout makes the whole sketch
  // access one prefetchable line per id
  constexpr int kChunk = 32;
  uint64_t hid[kChunk], hh[kChunk];
  for (int64_t i0 = 0; i0 < n; i0 += kChunk) {
    int m = static_cast<int>(std::min<int64_t>(kChunk, n - i0));
    for (int j = 0; j < m; ++j) {
      uint64_t id = rows ? base[rows[i0 + j]] : base[i0 + j];
      uint64_t h = Mix(id);
      hid[j] = id;
      hh[j] = h;
      __builtin_prefetch(&cms_[side][CmsCell(h, 0)], 1, 1);
    }
    for (int j = 0; j < m; ++j) {
      uint64_t h = hh[j];
      uint64_t c0 = CmsCell(h, 0), c1 = CmsCell(h, 1);
      auto bump = [&](uint64_t c) {
        auto& cell = cms_[side][c];
        uint64_t prev = cell.load(std::memory_order_relaxed);
        cell.store(prev + 1, std::memory_order_relaxed);
        return prev;
      };
      uint64_t prev_min = bump(c0);
      // coinciding in-block cells (1-in-8): count once, depth-1 est
      if (c1 != c0) prev_min = std::min(prev_min, bump(c1));
      if (out_classes) out_classes[i0 + j] = HeatClassOf(prev_min + 1);
      UpdateTop(&t, hid[j], h, cap);
    }
  }
}

uint64_t Heat::Estimate(int side, uint64_t id) const {
  if (side < 0 || side >= kHeatSideCount) return 0;
  uint64_t h = Mix(id);
  uint64_t est = UINT64_MAX;
  for (int d = 0; d < kHeatCmsDepth; ++d)
    est = std::min(est, cms_[side][CmsCell(h, d)].load(
                            std::memory_order_relaxed));
  return est == UINT64_MAX ? 0 : est;
}

void Heat::RecordFanout(int op, uint64_t ids_requested,
                        uint64_t ids_deduped, uint64_t cache_hits,
                        uint64_t ids_on_wire, int shards_touched) {
  if (!enabled()) return;
  if (op < 0 || op >= kHistOpSlots) op = 0;
  fan_calls_[op].fetch_add(1, std::memory_order_relaxed);
  fan_requested_[op].fetch_add(ids_requested, std::memory_order_relaxed);
  fan_deduped_[op].fetch_add(ids_deduped, std::memory_order_relaxed);
  fan_cache_hits_[op].fetch_add(cache_hits, std::memory_order_relaxed);
  fan_on_wire_[op].fetch_add(ids_on_wire, std::memory_order_relaxed);
  uint64_t st = shards_touched < 0 ? 0
                                   : static_cast<uint64_t>(shards_touched);
  SpreadCell& c = spread_[op];
  c.buckets[HistBucketOf(st)].fetch_add(1, std::memory_order_relaxed);
  c.total.fetch_add(st, std::memory_order_relaxed);
}

void Heat::AddShardBytes(int shard, uint64_t req_bytes,
                         uint64_t reply_bytes) {
  if (!enabled()) return;
  if (shard < 0) return;
  if (shard >= kHeatMaxShards) shard = kHeatMaxShards - 1;
  shard_req_bytes_[shard].fetch_add(req_bytes, std::memory_order_relaxed);
  shard_reply_bytes_[shard].fetch_add(reply_bytes,
                                      std::memory_order_relaxed);
}

void Heat::RecordCacheEvent(int event, uint64_t id) {
  if (!enabled()) return;
  if (event < 0 || event >= kHeatCacheEventCount) return;
  int cls = HeatClassOf(Estimate(kHeatClient, id));
  cache_class_[event][cls].fetch_add(1, std::memory_order_relaxed);
}

void Heat::AddCacheClasses(const uint32_t* hits, const uint32_t* misses) {
  if (!enabled()) return;
  for (int cls = 0; cls < kHeatClasses; ++cls) {
    if (hits[cls])
      cache_class_[kHeatCacheHit][cls].fetch_add(
          hits[cls], std::memory_order_relaxed);
    if (misses[cls])
      cache_class_[kHeatCacheMiss][cls].fetch_add(
          misses[cls], std::memory_order_relaxed);
  }
}

std::vector<Heat::TopEntry> Heat::TopK(int side) const {
  std::vector<TopEntry> out;
  if (side < 0 || side >= kHeatSideCount) return out;
  const TopTable& t = top_[side];
  {
    std::lock_guard<std::mutex> l(t.mu);
    out.reserve(t.size);
    for (int s = 0; s < t.size; ++s)
      out.push_back({t.ids[s], t.counts[s], t.errs[s]});
  }
  std::sort(out.begin(), out.end(), [](const TopEntry& a,
                                       const TopEntry& b) {
    return a.count != b.count ? a.count > b.count : a.id < b.id;
  });
  return out;
}

void Heat::Reset() {
  // hold both top-K mutexes while zeroing the sketches: the tables'
  // mutexes are what make the feed's load+store cell increments safe,
  // so the reset must exclude in-flight feeds the same way
  for (int side = 0; side < kHeatSideCount; ++side) {
    std::lock_guard<std::mutex> l(top_[side].mu);
    for (auto& c : cms_[side]) c.store(0, std::memory_order_relaxed);
  }
  for (auto& t : total_) t.store(0, std::memory_order_relaxed);
  for (auto& side : ids_by_op_)
    for (auto& c : side) c.store(0, std::memory_order_relaxed);
  for (int op = 0; op < kHistOpSlots; ++op) {
    fan_calls_[op].store(0, std::memory_order_relaxed);
    fan_requested_[op].store(0, std::memory_order_relaxed);
    fan_deduped_[op].store(0, std::memory_order_relaxed);
    fan_cache_hits_[op].store(0, std::memory_order_relaxed);
    fan_on_wire_[op].store(0, std::memory_order_relaxed);
    for (auto& b : spread_[op].buckets) b.store(0, std::memory_order_relaxed);
    spread_[op].total.store(0, std::memory_order_relaxed);
  }
  for (int s = 0; s < kHeatMaxShards; ++s) {
    shard_req_bytes_[s].store(0, std::memory_order_relaxed);
    shard_reply_bytes_[s].store(0, std::memory_order_relaxed);
  }
  for (int c = 0; c < kHeatMaxConns; ++c) {
    conn_fd_[c].store(-1, std::memory_order_relaxed);
    conn_ids_[c].store(0, std::memory_order_relaxed);
  }
  conn_overflow_.store(0, std::memory_order_relaxed);
  for (auto& ev : cache_class_)
    for (auto& c : ev) c.store(0, std::memory_order_relaxed);
  for (auto& t : top_) {
    std::lock_guard<std::mutex> l(t.mu);
    t.size = 0;
    t.tombstones = 0;
    t.min_count = 0;
    t.scan_pos = 0;
    for (auto& c : t.index) c = -1;
  }
}

void Heat::SpreadJsonInto(std::string* out, bool* first) const {
  for (int op = 1; op < kHistOpSlots; ++op) {
    const SpreadCell& c = spread_[op];
    uint64_t count = 0;
    uint64_t bvals[kHistBuckets];
    for (int b = 0; b < kHistBuckets; ++b) {
      bvals[b] = c.buckets[b].load(std::memory_order_relaxed);
      count += bvals[b];
    }
    if (count == 0) continue;  // only ops with fan-out records emit
    if (!*first) out->push_back(',');
    *first = false;
    out->append("\"heat_spread:");
    out->append(kWireOpNames[op]);
    out->append("\":{\"b\":[");
    for (int b = 0; b < kHistBuckets; ++b) {
      if (b) out->push_back(',');
      AppendU64(out, bvals[b]);
    }
    out->append("],\"count\":");
    AppendU64(out, count);
    out->append(",\"sum_us\":");
    AppendU64(out, c.total.load(std::memory_order_relaxed));
    out->push_back('}');
  }
}

void Heat::JsonInto(std::string* out) const {
  out->append(",\"heat\":");
  out->append(Json(-1));
}

std::string Heat::Json(int shard) const {
  std::string o;
  o.reserve(4096);
  o.push_back('{');
  AppendKey(&o, "shard");
  AppendI64(&o, shard);
  o.push_back(',');
  AppendKey(&o, "enabled");
  AppendI64(&o, flag() ? 1 : 0);
  o.push_back(',');
  AppendKey(&o, "topk_capacity");
  AppendI64(&o, topk_capacity());

  // sketch geometry + stream lengths (N in the eps bound per side)
  o.push_back(',');
  AppendKey(&o, "sketch");
  o.append("{\"depth\":");
  AppendI64(&o, kHeatCmsDepth);
  o.append(",\"width\":");
  AppendI64(&o, kHeatCmsWidth);
  o.append(",\"total\":{");
  for (int side = 0; side < kHeatSideCount; ++side) {
    if (side) o.push_back(',');
    AppendKey(&o, kHeatSideNames[side]);
    AppendU64(&o, Total(side));
  }
  o.append("}}");

  // top-K tables, hottest first; ids as decimal STRINGS (u64-safe,
  // same convention as trace ids)
  o.push_back(',');
  AppendKey(&o, "topk");
  o.push_back('{');
  for (int side = 0; side < kHeatSideCount; ++side) {
    if (side) o.push_back(',');
    AppendKey(&o, kHeatSideNames[side]);
    o.push_back('[');
    std::vector<TopEntry> top = TopK(side);
    for (size_t i = 0; i < top.size(); ++i) {
      if (i) o.push_back(',');
      o.append("{\"id\":\"");
      AppendU64(&o, top[i].id);
      o.append("\",\"count\":");
      AppendU64(&o, top[i].count);
      o.append(",\"err\":");
      AppendU64(&o, top[i].err);
      o.push_back('}');
    }
    o.push_back(']');
  }
  o.push_back('}');

  // ids fed per (side, op) — nonzero only
  o.push_back(',');
  AppendKey(&o, "ids");
  o.push_back('{');
  bool first = true;
  for (int side = 0; side < kHeatSideCount; ++side)
    for (int op = 0; op < kHistOpSlots; ++op) {
      uint64_t v = ids_by_op_[side][op].load(std::memory_order_relaxed);
      if (v == 0) continue;
      if (!first) o.push_back(',');
      first = false;
      o.push_back('"');
      o.append(kHeatSideNames[side]);
      o.push_back(':');
      o.append(kWireOpNames[op]);
      o.append("\":");
      AppendU64(&o, v);
    }
  o.push_back('}');

  // client fan-out attribution per op — nonzero only
  o.push_back(',');
  AppendKey(&o, "fanout");
  o.push_back('{');
  first = true;
  for (int op = 0; op < kHistOpSlots; ++op) {
    uint64_t calls = fan_calls_[op].load(std::memory_order_relaxed);
    if (calls == 0) continue;
    if (!first) o.push_back(',');
    first = false;
    o.push_back('"');
    o.append(kWireOpNames[op]);
    o.append("\":{\"calls\":");
    AppendU64(&o, calls);
    o.append(",\"ids_requested\":");
    AppendU64(&o, fan_requested_[op].load(std::memory_order_relaxed));
    o.append(",\"ids_deduped\":");
    AppendU64(&o, fan_deduped_[op].load(std::memory_order_relaxed));
    o.append(",\"cache_hits\":");
    AppendU64(&o, fan_cache_hits_[op].load(std::memory_order_relaxed));
    o.append(",\"ids_on_wire\":");
    AppendU64(&o, fan_on_wire_[op].load(std::memory_order_relaxed));
    o.append(",\"shards_touched\":");
    AppendU64(&o, spread_[op].total.load(std::memory_order_relaxed));
    o.push_back('}');
  }
  o.push_back('}');

  // per-shard wire bytes — nonzero only
  o.push_back(',');
  AppendKey(&o, "shard_bytes");
  o.push_back('[');
  first = true;
  for (int s = 0; s < kHeatMaxShards; ++s) {
    uint64_t req = shard_req_bytes_[s].load(std::memory_order_relaxed);
    uint64_t rep = shard_reply_bytes_[s].load(std::memory_order_relaxed);
    if (req == 0 && rep == 0) continue;
    if (!first) o.push_back(',');
    first = false;
    o.append("{\"shard\":");
    AppendI64(&o, s);
    o.append(",\"req_bytes\":");
    AppendU64(&o, req);
    o.append(",\"reply_bytes\":");
    AppendU64(&o, rep);
    o.push_back('}');
  }
  o.push_back(']');

  // server-side requesting-conn ledger — nonzero only
  o.push_back(',');
  AppendKey(&o, "conns");
  o.push_back('[');
  first = true;
  for (int c = 0; c < kHeatMaxConns; ++c) {
    int fd = conn_fd_[c].load(std::memory_order_relaxed);
    uint64_t n = conn_ids_[c].load(std::memory_order_relaxed);
    if (fd < 0 || n == 0) continue;
    if (!first) o.push_back(',');
    first = false;
    o.append("{\"conn\":");
    AppendI64(&o, fd);
    o.append(",\"ids\":");
    AppendU64(&o, n);
    o.push_back('}');
  }
  o.push_back(']');
  o.push_back(',');
  AppendKey(&o, "conn_overflow");
  AppendU64(&o, conn_overflow_.load(std::memory_order_relaxed));

  // cache-efficacy classes: event -> per-class counts (class c covers
  // sketch estimates in [2^(c-1), 2^c); class 0 = never estimated)
  o.push_back(',');
  AppendKey(&o, "cache_class");
  o.push_back('{');
  for (int ev = 0; ev < kHeatCacheEventCount; ++ev) {
    if (ev) o.push_back(',');
    AppendKey(&o, kHeatCacheEventNames[ev]);
    o.push_back('[');
    for (int cls = 0; cls < kHeatClasses; ++cls) {
      if (cls) o.push_back(',');
      AppendU64(&o, cache_class_[ev][cls].load(std::memory_order_relaxed));
    }
    o.push_back(']');
  }
  o.push_back('}');

  o.push_back('}');
  return o;
}

}  // namespace eg
