#include "eg_epoch.h"

#include <algorithm>
#include <cstring>
#include <fstream>
#include <functional>
#include <thread>

#include "eg_stats.h"
#include "eg_wire.h"

namespace eg {

namespace {

bool ReadWholeFile(const std::string& path, std::string* out) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return false;
  std::streamsize size = f.tellg();
  f.seekg(0);
  // eg-lint: allow(wire-count-alloc) sized by tellg of an already-open
  // local file — the bytes exist on disk; bad_alloc surfaces to the
  // caller as a load error
  out->resize(static_cast<size_t>(size));
  return static_cast<bool>(f.read(out->data(), size));
}

// Count the drain for a superseded snapshot exactly once. Flip (when it
// observes pins == 0) and the last pin release race to the exchange;
// whichever wins does the counting.
void MaybeCountDrain(EpochSnapshot* snap) {
  if (snap->superseded.load(std::memory_order_acquire) &&
      snap->pins.load(std::memory_order_acquire) == 0 &&
      !snap->drain_counted.exchange(true, std::memory_order_acq_rel))
    Counters::Global().Add(kCtrEpochDrain);
}

// The shared cursor walk: rebuild a staging keeping only records the
// predicates accept. Staging arrays are slice-concatenated with counts
// living in *_cnt / grp_counts — a drop must skip the record AND its
// slices in every parallel array, so the walk mirrors
// GraphStore::Build's cursor arithmetic exactly. Every slice is
// bounds-checked against its value array before it is read (ptr-arith
// discipline: counts come from parsed input, never trust them to add
// up).
bool FilterStagingImpl(
    Staging* s, const std::function<bool(uint64_t)>& drop_node,
    const std::function<bool(uint64_t, uint64_t, int32_t)>& drop_adj,
    const std::function<bool(uint64_t, uint64_t, int32_t)>& drop_edge,
    std::string* error) {
  const int32_t T = std::max(s->edge_type_num, 0);
  const int32_t NU = std::max(s->nf_u64_num, 0);
  const int32_t NF = std::max(s->nf_f32_num, 0);
  const int32_t NB = std::max(s->nf_bin_num, 0);
  const int32_t EU = std::max(s->ef_u64_num, 0);
  const int32_t EF = std::max(s->ef_f32_num, 0);
  const int32_t EB = std::max(s->ef_bin_num, 0);
  const size_t nn = s->node_ids.size();
  const size_t ne = s->e_src.size();

  if (s->node_types.size() != nn || s->node_weights.size() != nn ||
      s->grp_counts.size() != nn * static_cast<size_t>(T) ||
      s->nf_u64_cnt.size() != nn * static_cast<size_t>(NU) ||
      s->nf_f32_cnt.size() != nn * static_cast<size_t>(NF) ||
      s->nf_bin_cnt.size() != nn * static_cast<size_t>(NB) ||
      s->e_dst.size() != ne || s->e_type.size() != ne ||
      s->e_w.size() != ne ||
      s->ef_u64_cnt.size() != ne * static_cast<size_t>(EU) ||
      s->ef_f32_cnt.size() != ne * static_cast<size_t>(EF) ||
      s->ef_bin_cnt.size() != ne * static_cast<size_t>(EB)) {
    *error = "inconsistent staging shapes";
    return false;
  }

  Staging out;
  out.edge_type_num = s->edge_type_num;
  out.nf_u64_num = s->nf_u64_num;
  out.nf_f32_num = s->nf_f32_num;
  out.nf_bin_num = s->nf_bin_num;
  out.ef_u64_num = s->ef_u64_num;
  out.ef_f32_num = s->ef_f32_num;
  out.ef_bin_num = s->ef_bin_num;

  size_t nbr_cur = 0, u64_cur = 0, f32_cur = 0, bin_cur = 0;
  for (size_t i = 0; i < nn; ++i) {
    size_t nbr_n = 0, u64_n = 0, f32_n = 0, bin_n = 0;
    for (int32_t t = 0; t < T; ++t) {
      int32_t c = s->grp_counts[i * T + t];
      if (c < 0) {
        *error = "negative group count in staging";
        return false;
      }
      nbr_n += static_cast<size_t>(c);
    }
    for (int32_t k = 0; k < NU; ++k)
      u64_n += static_cast<size_t>(s->nf_u64_cnt[i * NU + k]);
    for (int32_t k = 0; k < NF; ++k)
      f32_n += static_cast<size_t>(s->nf_f32_cnt[i * NF + k]);
    for (int32_t k = 0; k < NB; ++k)
      bin_n += static_cast<size_t>(s->nf_bin_cnt[i * NB + k]);
    if (nbr_cur + nbr_n > s->nbr_ids.size() ||
        nbr_cur + nbr_n > s->nbr_w.size() ||
        u64_cur + u64_n > s->nf_u64_val.size() ||
        f32_cur + f32_n > s->nf_f32_val.size() ||
        bin_cur + bin_n > s->nf_bin_val.size()) {
      *error = "node slice counts overrun staging arrays";
      return false;
    }

    uint64_t id = s->node_ids[i];
    if (!drop_node(id)) {
      out.node_ids.push_back(id);
      out.node_types.push_back(s->node_types[i]);
      out.node_weights.push_back(s->node_weights[i]);
      size_t cur = nbr_cur;
      for (int32_t t = 0; t < T; ++t) {
        int32_t c = s->grp_counts[i * T + t];
        int32_t kept = 0;
        float wsum = 0.f;
        for (int32_t j = 0; j < c; ++j) {
          uint64_t nbr = s->nbr_ids[cur + static_cast<size_t>(j)];
          float w = s->nbr_w[cur + static_cast<size_t>(j)];
          if (drop_adj(id, nbr, t)) continue;
          out.nbr_ids.push_back(nbr);
          out.nbr_w.push_back(w);
          ++kept;
          wsum += w;
        }
        cur += static_cast<size_t>(c);
        out.grp_counts.push_back(kept);
        out.grp_weights.push_back(wsum);
      }
      size_t c = u64_cur;
      for (int32_t k = 0; k < NU; ++k) {
        size_t n = static_cast<size_t>(s->nf_u64_cnt[i * NU + k]);
        out.nf_u64_cnt.push_back(s->nf_u64_cnt[i * NU + k]);
        out.nf_u64_val.insert(out.nf_u64_val.end(),
                              s->nf_u64_val.begin() + c,
                              s->nf_u64_val.begin() + c + n);
        c += n;
      }
      c = f32_cur;
      for (int32_t k = 0; k < NF; ++k) {
        size_t n = static_cast<size_t>(s->nf_f32_cnt[i * NF + k]);
        out.nf_f32_cnt.push_back(s->nf_f32_cnt[i * NF + k]);
        out.nf_f32_val.insert(out.nf_f32_val.end(),
                              s->nf_f32_val.begin() + c,
                              s->nf_f32_val.begin() + c + n);
        c += n;
      }
      c = bin_cur;
      for (int32_t k = 0; k < NB; ++k) {
        size_t n = static_cast<size_t>(s->nf_bin_cnt[i * NB + k]);
        out.nf_bin_cnt.push_back(s->nf_bin_cnt[i * NB + k]);
        out.nf_bin_val.append(s->nf_bin_val, c, n);
        c += n;
      }
    }
    nbr_cur += nbr_n;
    u64_cur += u64_n;
    f32_cur += f32_n;
    bin_cur += bin_n;
  }

  size_t eu_cur = 0, ef_cur = 0, eb_cur = 0;
  for (size_t i = 0; i < ne; ++i) {
    size_t u64_n = 0, f32_n = 0, bin_n = 0;
    for (int32_t k = 0; k < EU; ++k)
      u64_n += static_cast<size_t>(s->ef_u64_cnt[i * EU + k]);
    for (int32_t k = 0; k < EF; ++k)
      f32_n += static_cast<size_t>(s->ef_f32_cnt[i * EF + k]);
    for (int32_t k = 0; k < EB; ++k)
      bin_n += static_cast<size_t>(s->ef_bin_cnt[i * EB + k]);
    if (eu_cur + u64_n > s->ef_u64_val.size() ||
        ef_cur + f32_n > s->ef_f32_val.size() ||
        eb_cur + bin_n > s->ef_bin_val.size()) {
      *error = "edge slice counts overrun staging arrays";
      return false;
    }

    if (!drop_edge(s->e_src[i], s->e_dst[i], s->e_type[i])) {
      out.e_src.push_back(s->e_src[i]);
      out.e_dst.push_back(s->e_dst[i]);
      out.e_type.push_back(s->e_type[i]);
      out.e_w.push_back(s->e_w[i]);
      size_t c = eu_cur;
      for (int32_t k = 0; k < EU; ++k) {
        size_t n = static_cast<size_t>(s->ef_u64_cnt[i * EU + k]);
        out.ef_u64_cnt.push_back(s->ef_u64_cnt[i * EU + k]);
        out.ef_u64_val.insert(out.ef_u64_val.end(),
                              s->ef_u64_val.begin() + c,
                              s->ef_u64_val.begin() + c + n);
        c += n;
      }
      c = ef_cur;
      for (int32_t k = 0; k < EF; ++k) {
        size_t n = static_cast<size_t>(s->ef_f32_cnt[i * EF + k]);
        out.ef_f32_cnt.push_back(s->ef_f32_cnt[i * EF + k]);
        out.ef_f32_val.insert(out.ef_f32_val.end(),
                              s->ef_f32_val.begin() + c,
                              s->ef_f32_val.begin() + c + n);
        c += n;
      }
      c = eb_cur;
      for (int32_t k = 0; k < EB; ++k) {
        size_t n = static_cast<size_t>(s->ef_bin_cnt[i * EB + k]);
        out.ef_bin_cnt.push_back(s->ef_bin_cnt[i * EB + k]);
        out.ef_bin_val.append(s->ef_bin_val, c, n);
        c += n;
      }
    }
    eu_cur += u64_n;
    ef_cur += f32_n;
    eb_cur += bin_n;
  }

  *s = std::move(out);
  return true;
}

}  // namespace

// ---- EpochPin / EpochTable ----

void EpochPin::Release() {
  if (!snap_) return;
  if (snap_->pins.fetch_sub(1, std::memory_order_acq_rel) == 1)
    MaybeCountDrain(snap_.get());
  snap_.reset();
}

void EpochTable::Reset(std::shared_ptr<Engine> engine, uint64_t epoch) {
  auto snap = std::make_shared<EpochSnapshot>();
  snap->epoch = epoch;
  snap->engine = std::move(engine);
  std::lock_guard<std::mutex> l(mu_);
  held_.clear();
  held_.push_back(std::move(snap));
  current_.store(epoch, std::memory_order_release);
}

EpochPin EpochTable::Pin(uint64_t requested) const {
  std::lock_guard<std::mutex> l(mu_);
  if (held_.empty()) return EpochPin();
  std::shared_ptr<EpochSnapshot> snap;
  if (requested != 0) {
    for (const auto& h : held_)
      if (h->epoch == requested) {
        snap = h;
        break;
      }
  }
  if (!snap) snap = held_.back();
  // Under mu_ the snapshot cannot be superseded-and-drain-checked
  // concurrently with this increment (Flip also takes mu_), so a pin
  // never resurrects a snapshot whose drain was already counted — it
  // simply rides the still-held window.
  snap->pins.fetch_add(1, std::memory_order_acq_rel);
  return EpochPin(std::move(snap));
}

uint64_t EpochTable::Flip(std::shared_ptr<Engine> next) {
  std::lock_guard<std::mutex> l(mu_);
  uint64_t e = current_.load(std::memory_order_relaxed) + 1;
  auto snap = std::make_shared<EpochSnapshot>();
  snap->epoch = e;
  snap->engine = std::move(next);
  if (!held_.empty()) {
    EpochSnapshot* prev = held_.back().get();
    prev->superseded.store(true, std::memory_order_release);
    MaybeCountDrain(prev);
  }
  held_.push_back(std::move(snap));
  // Drop epoch N-2: pinned readers (if any) still hold it alive via
  // their shared_ptr; its drain is counted by the last release.
  while (held_.size() > static_cast<size_t>(kEpochKeep))
    held_.erase(held_.begin());
  current_.store(e, std::memory_order_release);
  Counters::Global().Add(kCtrEpochFlip);
  return e;
}

// ---- delta files ----

bool DeltaFile::Parse(const char* data, size_t size, std::string* error) {
  if (size < 8 || std::memcmp(data, "EGD1", 4) != 0) {
    *error = "bad delta magic (want EGD1)";
    return false;
  }
  WireReader r(data + 4, size - 4);
  uint32_t version = r.Pod<uint32_t>();
  if (version != 1) {
    *error = "unsupported delta version " + std::to_string(version);
    return false;
  }
  seq = r.U64();
  r.Vec(&removed_nodes);
  r.Vec(&rme_src);
  r.Vec(&rme_dst);
  r.Vec(&rme_type);
  dat_blob = r.Str();
  if (!r.ok()) {
    *error = "truncated delta file";
    return false;
  }
  if (r.remaining() != 0) {
    *error = "trailing bytes after delta payload";
    return false;
  }
  if (rme_src.size() != rme_dst.size() ||
      rme_src.size() != rme_type.size()) {
    *error = "removed-edge columns disagree in length";
    return false;
  }
  staged = Staging();
  if (!dat_blob.empty() &&
      !staged.ParseFile(dat_blob.data(), dat_blob.size())) {
    *error = staged.error.empty() ? "delta dat blob parse failure"
                                  : staged.error;
    return false;
  }
  return true;
}

bool DeltaFile::Validate(std::string* error) const {
  std::unordered_set<uint64_t> rm_nodes;
  for (uint64_t id : removed_nodes)
    if (!rm_nodes.insert(id).second) {
      *error = "duplicate removed node " + std::to_string(id);
      return false;
    }
  std::unordered_set<EdgeKey, EdgeKeyHash> rm_edges;
  for (size_t i = 0; i < rme_src.size(); ++i)
    if (!rm_edges.insert(EdgeKey{rme_src[i], rme_dst[i], rme_type[i]})
             .second) {
      *error = "duplicate removed edge (" + std::to_string(rme_src[i]) +
               ", " + std::to_string(rme_dst[i]) + ", " +
               std::to_string(rme_type[i]) + ")";
      return false;
    }
  std::unordered_set<uint64_t> seen_nodes;
  for (uint64_t id : staged.node_ids) {
    if (!seen_nodes.insert(id).second) {
      *error = "duplicate node record " + std::to_string(id) +
               " within one delta";
      return false;
    }
    if (rm_nodes.count(id)) {
      *error = "node " + std::to_string(id) +
               " both removed and present in one delta";
      return false;
    }
  }
  std::unordered_set<EdgeKey, EdgeKeyHash> seen_edges;
  for (size_t i = 0; i < staged.e_src.size(); ++i) {
    EdgeKey k{staged.e_src[i], staged.e_dst[i], staged.e_type[i]};
    if (!seen_edges.insert(k).second) {
      *error = "duplicate edge record (" + std::to_string(k.src) + ", " +
               std::to_string(k.dst) + ", " + std::to_string(k.type) +
               ") within one delta";
      return false;
    }
    if (rm_edges.count(k)) {
      *error = "edge (" + std::to_string(k.src) + ", " +
               std::to_string(k.dst) + ", " + std::to_string(k.type) +
               ") both removed and re-emitted in one delta";
      return false;
    }
  }
  return true;
}

bool FilterDeltaToShard(DeltaFile* d, const ShardOwnership& own,
                        std::string* error) {
  if (own.shard_num <= 1) return true;
  return FilterStagingImpl(
      &d->staged, [&own](uint64_t id) { return !own.OwnsNode(id); },
      [](uint64_t, uint64_t, int32_t) { return false; },
      [&own](uint64_t src, uint64_t, int32_t) {
        return !own.OwnsNode(src);
      },
      error);
}

bool FilterStaging(
    Staging* s, const std::unordered_set<uint64_t>& rm_nodes,
    const std::unordered_set<EdgeKey, EdgeKeyHash>& rm_edges,
    std::string* error) {
  if (rm_nodes.empty() && rm_edges.empty()) return true;
  return FilterStagingImpl(
      s, [&](uint64_t id) { return rm_nodes.count(id) != 0; },
      [&](uint64_t src, uint64_t dst, int32_t t) {
        return !rm_edges.empty() &&
               rm_edges.count(EdgeKey{src, dst, t}) != 0;
      },
      [&](uint64_t src, uint64_t dst, int32_t t) {
        return rm_nodes.count(src) != 0 || rm_nodes.count(dst) != 0 ||
               (!rm_edges.empty() &&
                rm_edges.count(EdgeKey{src, dst, t}) != 0);
      },
      error);
}

bool BuildMergedEngine(std::vector<std::string> base_files,
                       const std::vector<DeltaFile>& deltas,
                       std::shared_ptr<Engine>* out, std::string* error) {
  std::sort(base_files.begin(), base_files.end());
  const size_t nd = deltas.size();
  const size_t nb = base_files.size();
  for (size_t i = 1; i < nd; ++i)
    if (deltas[i].seq <= deltas[i - 1].seq) {
      *error = "delta seqs not strictly ascending";
      return false;
    }

  // parts order: newest delta first, then older deltas, then base —
  // Build's first-occurrence-wins dedup makes the newest record
  // authoritative. Each level is filtered by the removal sets of
  // strictly NEWER deltas (absorbed as we walk downward), so a record
  // removed in delta k never resurfaces from delta k-1 or base.
  std::vector<Staging> parts(nd + nb);
  std::unordered_set<uint64_t> rm_nodes;
  std::unordered_set<EdgeKey, EdgeKeyHash> rm_edges;
  for (size_t k = nd; k-- > 0;) {
    Staging s = deltas[k].staged;  // copy: the DeltaFile outlives flips
    if (!FilterStaging(&s, rm_nodes, rm_edges, error)) return false;
    parts[nd - 1 - k] = std::move(s);
    rm_nodes.insert(deltas[k].removed_nodes.begin(),
                    deltas[k].removed_nodes.end());
    for (size_t j = 0; j < deltas[k].rme_src.size(); ++j)
      rm_edges.insert(EdgeKey{deltas[k].rme_src[j], deltas[k].rme_dst[j],
                              deltas[k].rme_type[j]});
  }

  // Base partitions parse in a strided worker pool (the flip path must
  // not be slower than a cold load of the same data); rm sets are
  // read-only from here, so the post-parse filter runs in-thread too.
  std::vector<std::string> errs(nb);
  unsigned nthreads = std::min<unsigned>(
      std::thread::hardware_concurrency(), static_cast<unsigned>(nb));
  nthreads = std::max(1u, nthreads);
  std::vector<std::thread> threads;
  for (unsigned w = 0; w < nthreads && nb; ++w) {
    threads.emplace_back([&, w]() {
      for (size_t i = w; i < nb; i += nthreads) {
        try {
          std::string data;
          if (!ReadWholeFile(base_files[i], &data)) {
            errs[i] = "cannot read " + base_files[i];
            continue;
          }
          Staging* part = &parts[nd + i];
          if (!part->ParseFile(data.data(), data.size())) {
            errs[i] = part->error.empty()
                          ? "parse failure in " + base_files[i]
                          : part->error;
            continue;
          }
          if (!FilterStaging(part, rm_nodes, rm_edges, &errs[i]))
            continue;
        } catch (const std::exception& ex) {
          // an exception escaping a worker thread is std::terminate —
          // surface it like any other per-file error instead
          errs[i] = base_files[i] + " threw: " + ex.what();
        }
      }
    });
  }
  for (auto& t : threads) t.join();
  for (const auto& e : errs)
    if (!e.empty()) {
      *error = e;
      return false;
    }

  auto eng = std::make_shared<Engine>();
  if (!eng->BuildFromStagings(&parts)) {
    *error = eng->error();
    return false;
  }
  eng->set_source_files(std::move(base_files));
  *out = std::move(eng);
  return true;
}

bool LoadEngineWithDeltas(Engine* eng,
                          std::vector<std::string> base_files,
                          const std::vector<std::string>& delta_paths,
                          std::string* error) {
  std::vector<DeltaFile> deltas(delta_paths.size());
  for (size_t i = 0; i < delta_paths.size(); ++i) {
    std::string data;
    if (!ReadWholeFile(delta_paths[i], &data)) {
      *error = "cannot read delta " + delta_paths[i];
      return false;
    }
    if (!deltas[i].Parse(data.data(), data.size(), error) ||
        !deltas[i].Validate(error)) {
      *error = delta_paths[i] + ": " + *error;
      return false;
    }
  }
  // Deltas apply in seq order regardless of the path order given.
  std::sort(deltas.begin(), deltas.end(),
            [](const DeltaFile& a, const DeltaFile& b) {
              return a.seq < b.seq;
            });
  std::shared_ptr<Engine> merged;
  if (!BuildMergedEngine(std::move(base_files), deltas, &merged, error))
    return false;
  merged->set_epoch(static_cast<uint64_t>(deltas.size()));
  eng->Adopt(std::move(*merged));
  return true;
}

}  // namespace eg
