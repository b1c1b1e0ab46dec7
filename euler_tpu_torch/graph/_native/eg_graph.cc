#include "eg_graph.h"

#include <algorithm>
#include <cstddef>
#include <numeric>

namespace eg {

namespace {

// Checks a slot-count field is uniform across records.
bool FixCount(int32_t* slot, int32_t seen, const char* what,
              std::string* error) {
  if (*slot == -1) {
    *slot = seen;
    return true;
  }
  if (*slot != seen) {
    *error = std::string("non-uniform ") + what + " across records";
    return false;
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// Parsing (.dat block format; spec from reference euler/tools/json2dat.py)
// ---------------------------------------------------------------------------

bool Staging::ParseFile(const char* data, size_t size) {
  ByteCursor cur(data, size);
  while (cur.remaining() > 0) {
    if (!ParseBlock(&cur)) {
      if (error.empty()) error = "truncated or malformed block";
      return false;
    }
  }
  return true;
}

bool Staging::ParseBlock(ByteCursor* cur) {
  int32_t block_bytes = 0, node_bytes = 0;
  if (!cur->Read(&block_bytes)) return false;
  if (!cur->Read(&node_bytes)) return false;
  if (node_bytes < 0 ||
      static_cast<size_t>(node_bytes) > cur->remaining()) {
    error = "bad node_info_bytes";
    return false;
  }

  // --- node record ---
  ByteCursor nc(cur->ptr(), static_cast<size_t>(node_bytes));
  if (!cur->Skip(static_cast<size_t>(node_bytes))) return false;

  uint64_t id;
  int32_t type, T;
  float weight;
  if (!nc.Read(&id) || !nc.Read(&type) || !nc.Read(&weight) || !nc.Read(&T))
    return false;
  // Corrupted types index the per-type sampler tables downstream
  // (negative -> size_t wrap, huge -> unbounded resize) — reject here.
  if (type < 0 || type > 1 << 20) {
    error = "bad node type";
    return false;
  }
  if (T < 0 || T > 1 << 20) {
    error = "bad edge_type_num";
    return false;
  }
  if (!FixCount(&edge_type_num, T, "edge_type_num", &error)) return false;

  std::vector<int32_t> gsize;
  std::vector<float> gweight;
  if (!nc.ReadVec(static_cast<size_t>(T), &gsize)) return false;
  if (!nc.ReadVec(static_cast<size_t>(T), &gweight)) return false;
  size_t total_nbr = 0;
  for (int32_t s : gsize) {
    if (s < 0) return false;
    total_nbr += static_cast<size_t>(s);
  }
  std::vector<uint64_t> nids;
  std::vector<float> nw;
  if (!nc.ReadVec(total_nbr, &nids)) return false;
  if (!nc.ReadVec(total_nbr, &nw)) return false;

  node_ids.push_back(id);
  node_types.push_back(type);
  node_weights.push_back(weight);
  grp_counts.insert(grp_counts.end(), gsize.begin(), gsize.end());
  grp_weights.insert(grp_weights.end(), gweight.begin(), gweight.end());
  // Sort each group's neighbors ascending by id (needed for the sorted-merge
  // paths: sorted full neighbor and biased-walk intersection).
  {
    size_t off = 0;
    std::vector<size_t> order;
    for (int32_t s : gsize) {
      size_t n = static_cast<size_t>(s);
      order.resize(n);
      std::iota(order.begin(), order.end(), size_t{0});
      std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
        return nids[off + a] < nids[off + b];
      });
      for (size_t j : order) {
        nbr_ids.push_back(nids[off + j]);
        nbr_w.push_back(nw[off + j]);
      }
      off += n;
    }
  }

  // --- node features: u64, f32, binary ---
  int32_t nu;
  if (!nc.Read(&nu)) return false;
  if (!FixCount(&nf_u64_num, nu, "node u64 feature num", &error)) return false;
  std::vector<int32_t> sizes;
  if (!nc.ReadVec(static_cast<size_t>(nu), &sizes)) return false;
  size_t tot = 0;
  for (int32_t s : sizes) {
    if (s < 0) return false;  // negative count -> wild iterator in Build
    tot += static_cast<size_t>(s);
  }
  nf_u64_cnt.insert(nf_u64_cnt.end(), sizes.begin(), sizes.end());
  {
    std::vector<uint64_t> vals;
    if (!nc.ReadVec(tot, &vals)) return false;
    nf_u64_val.insert(nf_u64_val.end(), vals.begin(), vals.end());
  }

  int32_t nf;
  if (!nc.Read(&nf)) return false;
  if (!FixCount(&nf_f32_num, nf, "node f32 feature num", &error)) return false;
  if (!nc.ReadVec(static_cast<size_t>(nf), &sizes)) return false;
  tot = 0;
  for (int32_t s : sizes) {
    if (s < 0) return false;
    tot += static_cast<size_t>(s);
  }
  nf_f32_cnt.insert(nf_f32_cnt.end(), sizes.begin(), sizes.end());
  {
    std::vector<float> vals;
    if (!nc.ReadVec(tot, &vals)) return false;
    nf_f32_val.insert(nf_f32_val.end(), vals.begin(), vals.end());
  }

  int32_t nb;
  if (!nc.Read(&nb)) return false;
  if (!FixCount(&nf_bin_num, nb, "node binary feature num", &error))
    return false;
  if (!nc.ReadVec(static_cast<size_t>(nb), &sizes)) return false;
  nf_bin_cnt.insert(nf_bin_cnt.end(), sizes.begin(), sizes.end());
  for (int32_t s : sizes) {
    std::string b;
    if (!nc.ReadStr(static_cast<size_t>(s), &b)) return false;
    nf_bin_val += b;
  }

  // --- edge records ---
  int32_t edge_num = 0;
  if (!cur->Read(&edge_num)) return false;
  if (edge_num < 0) return false;
  std::vector<int32_t> ebytes;
  if (!cur->ReadVec(static_cast<size_t>(edge_num), &ebytes)) return false;
  for (int32_t eb : ebytes) {
    if (eb < 0 || static_cast<size_t>(eb) > cur->remaining()) return false;
    if (!ParseEdgeRecord(cur->ptr(), static_cast<size_t>(eb))) return false;
    cur->Skip(static_cast<size_t>(eb));
  }

  // Framing check, mirroring the reference loader's "checksum"
  // (reference euler/core/graph_builder.cc:211-222).
  int64_t expect = 8 + 4LL * edge_num + node_bytes;
  for (int32_t eb : ebytes) expect += eb;
  if (expect != block_bytes) {
    error = "block framing mismatch";
    return false;
  }
  return true;
}

bool Staging::ParseEdgeRecord(const char* data, size_t size) {
  ByteCursor ec(data, size);
  uint64_t src, dst;
  int32_t type;
  float weight;
  if (!ec.Read(&src) || !ec.Read(&dst) || !ec.Read(&type) || !ec.Read(&weight))
    return false;
  if (type < 0 || type > 1 << 20) {  // see node-type check above
    error = "bad edge type";
    return false;
  }
  e_src.push_back(src);
  e_dst.push_back(dst);
  e_type.push_back(type);
  e_w.push_back(weight);

  int32_t nu;
  std::vector<int32_t> sizes;
  if (!ec.Read(&nu)) return false;
  if (!FixCount(&ef_u64_num, nu, "edge u64 feature num", &error)) return false;
  if (!ec.ReadVec(static_cast<size_t>(nu), &sizes)) return false;
  size_t tot = 0;
  for (int32_t s : sizes) {
    if (s < 0) return false;  // negative count -> wild iterator in Build
    tot += static_cast<size_t>(s);
  }
  ef_u64_cnt.insert(ef_u64_cnt.end(), sizes.begin(), sizes.end());
  {
    std::vector<uint64_t> vals;
    if (!ec.ReadVec(tot, &vals)) return false;
    ef_u64_val.insert(ef_u64_val.end(), vals.begin(), vals.end());
  }

  int32_t nf;
  if (!ec.Read(&nf)) return false;
  if (!FixCount(&ef_f32_num, nf, "edge f32 feature num", &error)) return false;
  if (!ec.ReadVec(static_cast<size_t>(nf), &sizes)) return false;
  tot = 0;
  for (int32_t s : sizes) {
    if (s < 0) return false;
    tot += static_cast<size_t>(s);
  }
  ef_f32_cnt.insert(ef_f32_cnt.end(), sizes.begin(), sizes.end());
  {
    std::vector<float> vals;
    if (!ec.ReadVec(tot, &vals)) return false;
    ef_f32_val.insert(ef_f32_val.end(), vals.begin(), vals.end());
  }

  int32_t nb;
  if (!ec.Read(&nb)) return false;
  if (!FixCount(&ef_bin_num, nb, "edge binary feature num", &error))
    return false;
  if (!ec.ReadVec(static_cast<size_t>(nb), &sizes)) return false;
  ef_bin_cnt.insert(ef_bin_cnt.end(), sizes.begin(), sizes.end());
  for (int32_t s : sizes) {
    std::string b;
    if (!ec.ReadStr(static_cast<size_t>(s), &b)) return false;
    ef_bin_val += b;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Build
// ---------------------------------------------------------------------------

bool GraphStore::Build(std::vector<Staging>* parts, std::string* error) {
  // Resolve uniform slot counts across partitions.
  int32_t T = -1, nu = -1, nf = -1, nb = -1, eu = -1, ef = -1, eb = -1;
  auto unify = [&](int32_t* acc, int32_t v, const char* what) {
    if (v == -1) return true;  // partition had no records of this kind
    if (*acc == -1) *acc = v;
    if (*acc != v) {
      *error = std::string("partitions disagree on ") + what;
      return false;
    }
    return true;
  };
  for (auto& s : *parts) {
    if (!s.error.empty()) {
      *error = s.error;
      return false;
    }
    if (!unify(&T, s.edge_type_num, "edge_type_num") ||
        !unify(&nu, s.nf_u64_num, "node u64 slots") ||
        !unify(&nf, s.nf_f32_num, "node f32 slots") ||
        !unify(&nb, s.nf_bin_num, "node binary slots") ||
        !unify(&eu, s.ef_u64_num, "edge u64 slots") ||
        !unify(&ef, s.ef_f32_num, "edge f32 slots") ||
        !unify(&eb, s.ef_bin_num, "edge binary slots"))
      return false;
  }
  edge_type_num_ = std::max(T, 0);
  nf_u64_num_ = std::max(nu, 0);
  nf_f32_num_ = std::max(nf, 0);
  nf_bin_num_ = std::max(nb, 0);
  ef_u64_num_ = std::max(eu, 0);
  ef_f32_num_ = std::max(ef, 0);
  ef_bin_num_ = std::max(eb, 0);

  size_t node_cap = 0, edge_cap = 0;
  for (auto& s : *parts) {
    node_cap += s.node_ids.size();
    edge_cap += s.e_src.size();
  }
  node_ids_.reserve(node_cap);
  node_idx_.reserve(node_cap * 2);
  edge_idx_.reserve(edge_cap * 2);
  adj_off_.push_back(0);
  nf_u64_off_.push_back(0);
  nf_f32_off_.push_back(0);
  nf_bin_off_.push_back(0);
  ef_u64_off_.push_back(0);
  ef_f32_off_.push_back(0);
  ef_bin_off_.push_back(0);

  for (auto& s : *parts) {
    // Per-partition running cursors into the concatenated staging arrays.
    size_t nbr_cur = 0, u64_cur = 0, f32_cur = 0, bin_cur = 0;
    for (size_t i = 0; i < s.node_ids.size(); ++i) {
      // Stage sizes for this node.
      size_t nbr_n = 0;
      for (int32_t t = 0; t < edge_type_num_; ++t)
        nbr_n += static_cast<size_t>(s.grp_counts[i * edge_type_num_ + t]);
      size_t u64_n = 0, f32_n = 0, bin_n = 0;
      for (int32_t k = 0; k < nf_u64_num_; ++k)
        u64_n += static_cast<size_t>(s.nf_u64_cnt[i * nf_u64_num_ + k]);
      for (int32_t k = 0; k < nf_f32_num_; ++k)
        f32_n += static_cast<size_t>(s.nf_f32_cnt[i * nf_f32_num_ + k]);
      for (int32_t k = 0; k < nf_bin_num_; ++k)
        bin_n += static_cast<size_t>(s.nf_bin_cnt[i * nf_bin_num_ + k]);

      uint64_t id = s.node_ids[i];
      bool dup = !node_idx_
                      .emplace(id, static_cast<int64_t>(node_ids_.size()))
                      .second;
      if (!dup) {
        node_ids_.push_back(id);
        node_types_.push_back(s.node_types[i]);
        node_weights_.push_back(s.node_weights[i]);
        // adjacency groups
        size_t cur = nbr_cur;
        for (int32_t t = 0; t < edge_type_num_; ++t) {
          size_t n = static_cast<size_t>(s.grp_counts[i * edge_type_num_ + t]);
          float acc = 0.f;
          for (size_t j = 0; j < n; ++j) {
            adj_nbr_.push_back(s.nbr_ids[cur + j]);
            float w = s.nbr_w[cur + j];
            adj_w_.push_back(w);
            acc += w;
            adj_cumw_.push_back(acc);
          }
          cur += n;
          adj_off_.push_back(static_cast<int64_t>(adj_nbr_.size()));
          grp_w_.push_back(acc);
        }
        // features
        size_t c = u64_cur;
        for (int32_t k = 0; k < nf_u64_num_; ++k) {
          size_t n = static_cast<size_t>(s.nf_u64_cnt[i * nf_u64_num_ + k]);
          nf_u64_val_.insert(nf_u64_val_.end(), s.nf_u64_val.begin() + c,
                             s.nf_u64_val.begin() + c + n);
          c += n;
          nf_u64_off_.push_back(static_cast<int64_t>(nf_u64_val_.size()));
        }
        c = f32_cur;
        for (int32_t k = 0; k < nf_f32_num_; ++k) {
          size_t n = static_cast<size_t>(s.nf_f32_cnt[i * nf_f32_num_ + k]);
          nf_f32_val_.insert(nf_f32_val_.end(), s.nf_f32_val.begin() + c,
                             s.nf_f32_val.begin() + c + n);
          c += n;
          nf_f32_off_.push_back(static_cast<int64_t>(nf_f32_val_.size()));
        }
        c = bin_cur;
        for (int32_t k = 0; k < nf_bin_num_; ++k) {
          size_t n = static_cast<size_t>(s.nf_bin_cnt[i * nf_bin_num_ + k]);
          nf_bin_val_.append(s.nf_bin_val, c, n);
          c += n;
          nf_bin_off_.push_back(static_cast<int64_t>(nf_bin_val_.size()));
        }
      }
      nbr_cur += nbr_n;
      u64_cur += u64_n;
      f32_cur += f32_n;
      bin_cur += bin_n;
    }

    size_t eu_cur = 0, ef_cur = 0, eb_cur = 0;
    for (size_t i = 0; i < s.e_src.size(); ++i) {
      size_t u64_n = 0, f32_n = 0, bin_n = 0;
      for (int32_t k = 0; k < ef_u64_num_; ++k)
        u64_n += static_cast<size_t>(s.ef_u64_cnt[i * ef_u64_num_ + k]);
      for (int32_t k = 0; k < ef_f32_num_; ++k)
        f32_n += static_cast<size_t>(s.ef_f32_cnt[i * ef_f32_num_ + k]);
      for (int32_t k = 0; k < ef_bin_num_; ++k)
        bin_n += static_cast<size_t>(s.ef_bin_cnt[i * ef_bin_num_ + k]);

      EdgeKey key{s.e_src[i], s.e_dst[i], s.e_type[i]};
      bool dup =
          !edge_idx_.emplace(key, static_cast<int64_t>(e_src_.size())).second;
      if (!dup) {
        e_src_.push_back(s.e_src[i]);
        e_dst_.push_back(s.e_dst[i]);
        e_type_.push_back(s.e_type[i]);
        e_w_.push_back(s.e_w[i]);
        size_t c = eu_cur;
        for (int32_t k = 0; k < ef_u64_num_; ++k) {
          size_t n = static_cast<size_t>(s.ef_u64_cnt[i * ef_u64_num_ + k]);
          ef_u64_val_.insert(ef_u64_val_.end(), s.ef_u64_val.begin() + c,
                             s.ef_u64_val.begin() + c + n);
          c += n;
          ef_u64_off_.push_back(static_cast<int64_t>(ef_u64_val_.size()));
        }
        c = ef_cur;
        for (int32_t k = 0; k < ef_f32_num_; ++k) {
          size_t n = static_cast<size_t>(s.ef_f32_cnt[i * ef_f32_num_ + k]);
          ef_f32_val_.insert(ef_f32_val_.end(), s.ef_f32_val.begin() + c,
                             s.ef_f32_val.begin() + c + n);
          c += n;
          ef_f32_off_.push_back(static_cast<int64_t>(ef_f32_val_.size()));
        }
        c = eb_cur;
        for (int32_t k = 0; k < ef_bin_num_; ++k) {
          size_t n = static_cast<size_t>(s.ef_bin_cnt[i * ef_bin_num_ + k]);
          ef_bin_val_.append(s.ef_bin_val, c, n);
          c += n;
          ef_bin_off_.push_back(static_cast<int64_t>(ef_bin_val_.size()));
        }
      }
      eu_cur += u64_n;
      ef_cur += f32_n;
      eb_cur += bin_n;
    }
    s = Staging();  // free staging memory as we go
  }

  // Node/edge type counts from the data.
  node_type_num_ = 0;
  for (int32_t t : node_types_) node_type_num_ = std::max(node_type_num_, t + 1);
  for (int32_t t : e_type_) edge_type_num_ = std::max(edge_type_num_, t + 1);

  // Global per-type samplers (weight-proportional, alias method).
  nodes_by_type_.assign(static_cast<size_t>(node_type_num_), {});
  for (size_t i = 0; i < node_ids_.size(); ++i)
    nodes_by_type_[static_cast<size_t>(node_types_[i])].push_back(
        static_cast<int64_t>(i));
  node_samplers_.resize(nodes_by_type_.size());
  node_type_wsum_.resize(nodes_by_type_.size());
  std::vector<float> w;
  for (size_t t = 0; t < nodes_by_type_.size(); ++t) {
    w.clear();
    double sum = 0.0;
    for (int64_t i : nodes_by_type_[t]) {
      w.push_back(node_weights_[i]);
      sum += node_weights_[i];
    }
    node_samplers_[t].Build(w);
    node_type_wsum_[t] = static_cast<float>(sum);
  }
  node_type_sampler_.Build(node_type_wsum_);

  edges_by_type_.assign(static_cast<size_t>(edge_type_num_), {});
  for (size_t i = 0; i < e_src_.size(); ++i)
    edges_by_type_[static_cast<size_t>(e_type_[i])].push_back(
        static_cast<int64_t>(i));
  edge_samplers_.resize(edges_by_type_.size());
  edge_type_wsum_.resize(edges_by_type_.size());
  for (size_t t = 0; t < edges_by_type_.size(); ++t) {
    w.clear();
    double sum = 0.0;
    for (int64_t i : edges_by_type_[t]) {
      w.push_back(e_w_[i]);
      sum += e_w_[i];
    }
    edge_samplers_[t].Build(w);
    edge_type_wsum_[t] = static_cast<float>(sum);
  }
  edge_type_sampler_.Build(edge_type_wsum_);
  return true;
}

// ---------------------------------------------------------------------------
// Sampling & queries
// ---------------------------------------------------------------------------

uint64_t GraphStore::SampleNode(int32_t type, Rng& rng) const {
  if (node_ids_.empty()) return 0;
  size_t t;
  if (type < 0) {
    t = node_type_sampler_.Draw(rng);
  } else if (static_cast<size_t>(type) < nodes_by_type_.size()) {
    t = static_cast<size_t>(type);
  } else {
    return 0;
  }
  const auto& idxs = nodes_by_type_[t];
  if (idxs.empty()) return 0;
  return node_ids_[idxs[node_samplers_[t].Draw(rng)]];
}

int64_t GraphStore::SampleEdgeIdx(int32_t type, Rng& rng) const {
  if (e_src_.empty()) return -1;
  size_t t;
  if (type < 0) {
    t = edge_type_sampler_.Draw(rng);
  } else if (static_cast<size_t>(type) < edges_by_type_.size()) {
    t = static_cast<size_t>(type);
  } else {
    return -1;
  }
  const auto& idxs = edges_by_type_[t];
  if (idxs.empty()) return -1;
  return idxs[edge_samplers_[t].Draw(rng)];
}

void GraphStore::SampleNeighbors(int64_t nidx, const int32_t* etypes, int net,
                                 int count, uint64_t default_id, Rng& rng,
                                 uint64_t* out_ids, float* out_w,
                                 int32_t* out_t) const {
  double total = 0.0;
  if (nidx >= 0) {
    for (int e = 0; e < net; ++e) {
      int32_t t = etypes[e];
      if (t < 0 || t >= edge_type_num_) continue;
      int64_t n;
      const float* cum = GroupCum(nidx, t, &n);
      if (n > 0) total += cum[n - 1];
    }
  }
  if (total <= 0.0) {
    for (int j = 0; j < count; ++j) {
      out_ids[j] = default_id;
      out_w[j] = 0.f;
      out_t[j] = -1;
    }
    return;
  }
  for (int j = 0; j < count; ++j) {
    double r = rng.NextDouble() * total;
    // Pick the group by weight prefix, then binary-search its cumulative
    // array. Falls back to the last non-empty group on float rounding spill.
    int32_t pick_group = -1;
    double r_in_group = 0.0;
    for (int e = 0; e < net; ++e) {
      int32_t t = etypes[e];
      if (t < 0 || t >= edge_type_num_) continue;
      int64_t n;
      const float* cum = GroupCum(nidx, t, &n);
      if (n == 0) continue;
      double gt = cum[n - 1];
      pick_group = t;
      r_in_group = r;
      if (r < gt) break;
      r -= gt;
    }
    int64_t n;
    const float* cum = GroupCum(nidx, pick_group, &n);
    size_t k = SearchCumulative(cum, static_cast<size_t>(n),
                                static_cast<float>(r_in_group));
    int64_t off = adj_off_[nidx * edge_type_num_ + pick_group];
    out_ids[j] = adj_nbr_[off + static_cast<int64_t>(k)];
    out_w[j] = adj_w_[off + static_cast<int64_t>(k)];
    out_t[j] = pick_group;
  }
}

void GraphStore::FullNeighbors(int64_t nidx, const int32_t* etypes, int net,
                               bool sorted, std::vector<uint64_t>* ids,
                               std::vector<float>* w,
                               std::vector<int32_t>* t) const {
  if (nidx < 0) return;
  if (!sorted) {
    for (int e = 0; e < net; ++e) {
      int32_t et = etypes[e];
      if (et < 0 || et >= edge_type_num_) continue;
      int64_t g = nidx * edge_type_num_ + et;
      for (int64_t j = adj_off_[g]; j < adj_off_[g + 1]; ++j) {
        ids->push_back(adj_nbr_[j]);
        w->push_back(adj_w_[j]);
        t->push_back(et);
      }
    }
    return;
  }
  // k-way merge of id-sorted groups.
  struct Head {
    int64_t pos, end;
    int32_t et;
  };
  std::vector<Head> heads;
  for (int e = 0; e < net; ++e) {
    int32_t et = etypes[e];
    if (et < 0 || et >= edge_type_num_) continue;
    int64_t g = nidx * edge_type_num_ + et;
    if (adj_off_[g] < adj_off_[g + 1])
      heads.push_back(Head{adj_off_[g], adj_off_[g + 1], et});
  }
  while (!heads.empty()) {
    size_t best = 0;
    for (size_t h = 1; h < heads.size(); ++h)
      if (adj_nbr_[heads[h].pos] < adj_nbr_[heads[best].pos]) best = h;
    ids->push_back(adj_nbr_[heads[best].pos]);
    w->push_back(adj_w_[heads[best].pos]);
    t->push_back(heads[best].et);
    if (++heads[best].pos == heads[best].end)
      heads.erase(heads.begin() + static_cast<ptrdiff_t>(best));
  }
}

void GraphStore::TopKNeighbors(int64_t nidx, const int32_t* etypes, int net,
                               int k, uint64_t default_id, uint64_t* out_ids,
                               float* out_w, int32_t* out_t) const {
  std::vector<uint64_t> ids;
  std::vector<float> w;
  std::vector<int32_t> t;
  FullNeighbors(nidx, etypes, net, false, &ids, &w, &t);
  std::vector<size_t> order(ids.size());
  std::iota(order.begin(), order.end(), size_t{0});
  size_t take = std::min(static_cast<size_t>(k), ids.size());
  std::partial_sort(order.begin(), order.begin() + static_cast<ptrdiff_t>(take),
                    order.end(),
                    [&](size_t a, size_t b) { return w[a] > w[b]; });
  for (int j = 0; j < k; ++j) {
    if (static_cast<size_t>(j) < take) {
      out_ids[j] = ids[order[static_cast<size_t>(j)]];
      out_w[j] = w[order[static_cast<size_t>(j)]];
      out_t[j] = t[order[static_cast<size_t>(j)]];
    } else {
      out_ids[j] = default_id;
      out_w[j] = 0.f;
      out_t[j] = -1;
    }
  }
}

uint64_t GraphStore::BiasedNeighbor(int64_t nidx, bool has_parent,
                                    uint64_t parent_id, const int32_t* etypes,
                                    int net, float p, float q,
                                    uint64_t default_id, Rng& rng) const {
  if (nidx < 0) return default_id;
  if (!has_parent || (p == 1.f && q == 1.f)) {
    // No parent yet (first hop) or unbiased: plain weighted draw.
    uint64_t id;
    float w;
    int32_t t;
    SampleNeighbors(nidx, etypes, net, 1, default_id, rng, &id, &w, &t);
    return id;
  }
  std::vector<uint64_t> ids;
  std::vector<float> w;
  std::vector<int32_t> t;
  FullNeighbors(nidx, etypes, net, true, &ids, &w, &t);
  if (ids.empty()) return default_id;

  std::vector<uint64_t> pids;
  std::vector<float> pw;
  std::vector<int32_t> pt;
  int64_t parent_idx = NodeIndex(parent_id);
  if (parent_idx >= 0)
    FullNeighbors(parent_idx, etypes, net, true, &pids, &pw, &pt);
  // d_tx weighting (reference euler/client/graph.cc:120-151): x adjacent
  // to parent → w (this wins even for x == parent when the parent has a
  // self-loop — the reference merge's equality branch runs first);
  // x == parent → w/p; else w/q. Sorted two-pointer intersect.
  std::vector<float> cum(ids.size());
  double acc = 0.0;
  size_t pi = 0;
  for (size_t j = 0; j < ids.size(); ++j) {
    while (pi < pids.size() && pids[pi] < ids[j]) ++pi;
    float wj = w[j];
    if (pi < pids.size() && pids[pi] == ids[j]) {
      // distance 1: keep wj
    } else if (ids[j] == parent_id) {
      wj /= p;
    } else {
      wj /= q;
    }
    acc += wj;
    cum[j] = static_cast<float>(acc);
  }
  if (acc <= 0.0) return default_id;
  float r = static_cast<float>(rng.NextDouble() * acc);
  size_t k = SearchCumulative(cum.data(), cum.size(), r);
  return ids[k];
}

void GraphStore::DenseFeature(int64_t nidx, int32_t fid, int32_t dim,
                              float* out) const {
  std::fill(out, out + dim, 0.f);
  if (nidx < 0 || fid < 0 || fid >= nf_f32_num_) return;
  int64_t g = nidx * nf_f32_num_ + fid;
  int64_t n = std::min<int64_t>(nf_f32_off_[g + 1] - nf_f32_off_[g], dim);
  const float* src = nf_f32_val_.data() + nf_f32_off_[g];
  std::copy(src, src + n, out);
}

void GraphStore::EdgeDenseFeature(int64_t eidx, int32_t fid, int32_t dim,
                                  float* out) const {
  std::fill(out, out + dim, 0.f);
  if (eidx < 0 || fid < 0 || fid >= ef_f32_num_) return;
  int64_t g = eidx * ef_f32_num_ + fid;
  int64_t n = std::min<int64_t>(ef_f32_off_[g + 1] - ef_f32_off_[g], dim);
  const float* src = ef_f32_val_.data() + ef_f32_off_[g];
  std::copy(src, src + n, out);
}

void GraphStore::U64Feature(int64_t nidx, int32_t fid, const uint64_t** vals,
                            int64_t* count) const {
  *vals = nullptr;
  *count = 0;
  if (nidx < 0 || fid < 0 || fid >= nf_u64_num_) return;
  int64_t g = nidx * nf_u64_num_ + fid;
  *vals = nf_u64_val_.data() + nf_u64_off_[g];
  *count = nf_u64_off_[g + 1] - nf_u64_off_[g];
}

void GraphStore::EdgeU64Feature(int64_t eidx, int32_t fid,
                                const uint64_t** vals, int64_t* count) const {
  *vals = nullptr;
  *count = 0;
  if (eidx < 0 || fid < 0 || fid >= ef_u64_num_) return;
  int64_t g = eidx * ef_u64_num_ + fid;
  *vals = ef_u64_val_.data() + ef_u64_off_[g];
  *count = ef_u64_off_[g + 1] - ef_u64_off_[g];
}

void GraphStore::F32Feature(int64_t nidx, int32_t fid, const float** vals,
                            int64_t* count) const {
  *vals = nullptr;
  *count = 0;
  if (nidx < 0 || fid < 0 || fid >= nf_f32_num_) return;
  int64_t g = nidx * nf_f32_num_ + fid;
  *vals = nf_f32_val_.data() + nf_f32_off_[g];
  *count = nf_f32_off_[g + 1] - nf_f32_off_[g];
}

void GraphStore::EdgeF32Feature(int64_t eidx, int32_t fid, const float** vals,
                                int64_t* count) const {
  *vals = nullptr;
  *count = 0;
  if (eidx < 0 || fid < 0 || fid >= ef_f32_num_) return;
  int64_t g = eidx * ef_f32_num_ + fid;
  *vals = ef_f32_val_.data() + ef_f32_off_[g];
  *count = ef_f32_off_[g + 1] - ef_f32_off_[g];
}

void GraphStore::BinFeature(int64_t nidx, int32_t fid, const char** data,
                            int64_t* size) const {
  *data = nullptr;
  *size = 0;
  if (nidx < 0 || fid < 0 || fid >= nf_bin_num_) return;
  int64_t g = nidx * nf_bin_num_ + fid;
  *data = nf_bin_val_.data() + nf_bin_off_[g];
  *size = nf_bin_off_[g + 1] - nf_bin_off_[g];
}

void GraphStore::EdgeBinFeature(int64_t eidx, int32_t fid, const char** data,
                                int64_t* size) const {
  *data = nullptr;
  *size = 0;
  if (eidx < 0 || fid < 0 || fid >= ef_bin_num_) return;
  int64_t g = eidx * ef_bin_num_ + fid;
  *data = ef_bin_val_.data() + ef_bin_off_[g];
  *size = ef_bin_off_[g + 1] - ef_bin_off_[g];
}

}  // namespace eg
