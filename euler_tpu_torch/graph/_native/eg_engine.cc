#include "eg_engine.h"

#include <dirent.h>

#include <algorithm>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <thread>

namespace eg {

namespace {

// Parse a trailing "_<p>.dat" partition index; -1 when absent.
int PartitionIndex(const std::string& name) {
  if (name.size() < 5 || name.compare(name.size() - 4, 4, ".dat") != 0)
    return -1;
  size_t us = name.rfind('_');
  if (us == std::string::npos) return -1;
  size_t start = us + 1, end = name.size() - 4;
  if (start >= end) return -1;
  int p = 0;
  for (size_t i = start; i < end; ++i) {
    if (name[i] < '0' || name[i] > '9') return -1;
    p = p * 10 + (name[i] - '0');
  }
  return p;
}

bool ReadWholeFile(const std::string& path, std::string* out) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return false;
  std::streamsize size = f.tellg();
  f.seekg(0);
  // eg-lint: allow(wire-count-alloc) sized by tellg of an already-open
  // local file — the bytes exist on disk; bad_alloc surfaces via eg_load
  out->resize(static_cast<size_t>(size));
  return static_cast<bool>(f.read(out->data(), size));
}

}  // namespace

bool Engine::Load(const std::string& dir, int shard_idx, int shard_num) {
  DIR* d = opendir(dir.c_str());
  if (!d) {
    error_ = "cannot open directory: " + dir;
    return false;
  }
  std::vector<std::string> files;
  while (dirent* ent = readdir(d)) {
    std::string name = ent->d_name;
    if (name.size() < 4 || name.compare(name.size() - 4, 4, ".dat") != 0)
      continue;
    int p = PartitionIndex(name);
    if (p < 0) p = 0;
    if (shard_num > 1 && p % shard_num != shard_idx) continue;
    files.push_back(dir + "/" + name);
  }
  closedir(d);
  if (files.empty()) {
    error_ = "no .dat partitions for shard in " + dir;
    return false;
  }
  return LoadFiles(std::move(files));
}

bool Engine::ParseStagings(
    const std::vector<std::string>& labels,
    const std::function<void(int, Staging*, std::string*)>& parse_one) {
  // One staging per item so the merged order is deterministic regardless
  // of thread scheduling (reference loads files across threads too,
  // euler/core/graph_builder.cc:91-120).
  int n = static_cast<int>(labels.size());
  std::vector<Staging> parts(n);
  std::vector<std::string> errors(n);
  unsigned nthreads = std::min<unsigned>(
      std::thread::hardware_concurrency(), static_cast<unsigned>(n));
  nthreads = std::max(1u, nthreads);
  std::vector<std::thread> threads;
  for (unsigned w = 0; w < nthreads; ++w) {
    threads.emplace_back([&, w]() {
      for (int i = w; i < n; i += static_cast<int>(nthreads)) {
        try {
          parse_one(i, &parts[i], &errors[i]);
        } catch (const std::exception& ex) {
          // an exception escaping a worker thread is std::terminate —
          // surface it like any other per-item error instead
          errors[i] = labels[i] + " threw: " + ex.what();
        }
      }
    });
  }
  for (auto& t : threads) t.join();
  for (auto& e : errors)
    if (!e.empty()) {
      error_ = e;
      return false;
    }
  return store_.Build(&parts, &error_);
}

bool Engine::LoadFiles(std::vector<std::string> files) {
  std::sort(files.begin(), files.end());
  source_files_ = files;  // what a later delta merge rebuilds from
  // Bytes live only inside one worker iteration — only ~nthreads raw
  // files are in memory at once (the property the streamed path trades
  // away; see remote_fs.read_directory's RAM note).
  return ParseStagings(
      files, [&](int i, Staging* part, std::string* err) {
        std::string data;
        if (!ReadWholeFile(files[i], &data)) {
          *err = "cannot read " + files[i];
          return;
        }
        if (!part->ParseFile(data.data(), data.size()) &&
            part->error.empty())
          part->error = "parse failure in " + files[i];
      });
}

bool Engine::LoadBuffers(const char* const* bufs, const size_t* lens,
                         const char* const* names, int n) {
  if (n <= 0) {
    error_ = "no partition buffers";
    return false;
  }
  // name-sorted merge order, like LoadFiles' sort of paths — the built
  // store must not depend on the order the fetches completed in
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return std::strcmp(names[a], names[b]) < 0;
  });
  std::vector<std::string> labels(n);
  for (int i = 0; i < n; ++i) labels[i] = names[order[i]];
  return ParseStagings(
      labels, [&](int i, Staging* part, std::string* err) {
        int src = order[i];
        if (!part->ParseFile(bufs[src], lens[src]))
          // streamed buffers have no path in the Staging error —
          // attribute the partition name here
          *err = labels[i] + ": " +
                 (part->error.empty() ? "parse failure" : part->error);
      });
}

void Engine::SampleNode(int count, int32_t type, uint64_t* out) const {
  Rng& rng = ThreadRng();
  for (int i = 0; i < count; ++i) out[i] = store_.SampleNode(type, rng);
}

void Engine::SampleEdge(int count, int32_t type, uint64_t* out_src,
                        uint64_t* out_dst, int32_t* out_type) const {
  Rng& rng = ThreadRng();
  for (int i = 0; i < count; ++i) {
    int64_t e = store_.SampleEdgeIdx(type, rng);
    if (e < 0) {
      out_src[i] = 0;
      out_dst[i] = 0;
      out_type[i] = -1;
    } else {
      out_src[i] = store_.EdgeSrcAt(e);
      out_dst[i] = store_.EdgeDstAt(e);
      out_type[i] = store_.EdgeTypeAt(e);
    }
  }
}

void Engine::SampleNodeWithSrc(const uint64_t* src, int n, int count,
                               uint64_t* out) const {
#pragma omp parallel for schedule(static) if (n > 64)
  for (int i = 0; i < n; ++i) {
    Rng& rng = ThreadRng();
    int64_t idx = store_.NodeIndex(src[i]);
    int32_t type = idx >= 0 ? store_.NodeTypeAt(idx) : -1;
    for (int j = 0; j < count; ++j)
      out[static_cast<int64_t>(i) * count + j] = store_.SampleNode(type, rng);
  }
}

void Engine::GetNodeType(const uint64_t* ids, int n, int32_t* out) const {
#pragma omp parallel for schedule(static) if (n > 1024)
  for (int i = 0; i < n; ++i) {
    int64_t idx = store_.NodeIndex(ids[i]);
    out[i] = idx >= 0 ? store_.NodeTypeAt(idx) : -1;
  }
}

bool Engine::GetNodeWeight(const uint64_t* ids, int n, float* out) const {
#pragma omp parallel for schedule(static) if (n > 1024)
  for (int i = 0; i < n; ++i) {
    int64_t idx = store_.NodeIndex(ids[i]);
    out[i] = idx >= 0 ? store_.NodeWeightAt(idx) : 0.0f;
  }
  return true;
}

void Engine::SampleNeighbor(const uint64_t* ids, int n, const int32_t* etypes,
                            int net, int count, uint64_t default_id,
                            uint64_t* out_ids, float* out_w,
                            int32_t* out_t) const {
#pragma omp parallel for schedule(dynamic, 64) if (n * count > 2048)
  for (int i = 0; i < n; ++i) {
    Rng& rng = ThreadRng();
    int64_t off = static_cast<int64_t>(i) * count;
    store_.SampleNeighbors(store_.NodeIndex(ids[i]), etypes, net, count,
                           default_id, rng, out_ids + off, out_w + off,
                           out_t + off);
  }
}

void Engine::SampleFanout(const uint64_t* ids, int n,
                          const int32_t* etypes_flat,
                          const int32_t* etype_counts, const int32_t* counts,
                          int nhops, uint64_t default_id, uint64_t** out_ids,
                          float** out_w, int32_t** out_t) const {
  const uint64_t* cur = ids;
  int64_t cur_n = n;
  const int32_t* et = etypes_flat;
  // n * prod(counts) past 2^31 would truncate in the per-hop int cast
  // (same overflow class fixed in RemoteGraph::SampleFanout): issue each
  // hop in bounded slices instead — per-row sampling makes the slicing
  // invisible to the result.
  const int64_t kSlice = int64_t{1} << 30;
  for (int h = 0; h < nhops; ++h) {
    for (int64_t off = 0; off < cur_n; off += kSlice) {
      int m = static_cast<int>(std::min<int64_t>(kSlice, cur_n - off));
      SampleNeighbor(cur + off, m, et, etype_counts[h], counts[h],
                     default_id, out_ids[h] + off * counts[h],
                     out_w[h] + off * counts[h], out_t[h] + off * counts[h]);
    }
    cur = out_ids[h];
    cur_n *= counts[h];
    et += etype_counts[h];
  }
}

EGResult* Engine::GetFullNeighbor(const uint64_t* ids, int n,
                                  const int32_t* etypes, int net,
                                  bool sorted) const {
  auto* res = new EGResult();
  res->u64.resize(1);
  res->f32.resize(1);
  res->i32.resize(2);
  res->i32[1].resize(static_cast<size_t>(n));
  std::vector<std::vector<uint64_t>> row_ids(static_cast<size_t>(n));
  std::vector<std::vector<float>> row_w(static_cast<size_t>(n));
  std::vector<std::vector<int32_t>> row_t(static_cast<size_t>(n));
#pragma omp parallel for schedule(dynamic, 64) if (n > 256)
  for (int i = 0; i < n; ++i) {
    store_.FullNeighbors(store_.NodeIndex(ids[i]), etypes, net, sorted,
                         &row_ids[i], &row_w[i], &row_t[i]);
    res->i32[1][static_cast<size_t>(i)] =
        static_cast<int32_t>(row_ids[static_cast<size_t>(i)].size());
  }
  for (int i = 0; i < n; ++i) {
    auto& ri = row_ids[static_cast<size_t>(i)];
    res->u64[0].insert(res->u64[0].end(), ri.begin(), ri.end());
    auto& rw = row_w[static_cast<size_t>(i)];
    res->f32[0].insert(res->f32[0].end(), rw.begin(), rw.end());
    auto& rt = row_t[static_cast<size_t>(i)];
    res->i32[0].insert(res->i32[0].end(), rt.begin(), rt.end());
  }
  return res;
}

void Engine::GetTopKNeighbor(const uint64_t* ids, int n, const int32_t* etypes,
                             int net, int k, uint64_t default_id,
                             uint64_t* out_ids, float* out_w,
                             int32_t* out_t) const {
#pragma omp parallel for schedule(dynamic, 64) if (n * k > 2048)
  for (int i = 0; i < n; ++i) {
    int64_t off = static_cast<int64_t>(i) * k;
    store_.TopKNeighbors(store_.NodeIndex(ids[i]), etypes, net, k, default_id,
                         out_ids + off, out_w + off, out_t + off);
  }
}

void Engine::RandomWalk(const uint64_t* ids, int n,
                        const int32_t* etypes_flat,
                        const int32_t* etype_counts, int walk_len, float p,
                        float q, uint64_t default_id, uint64_t* out) const {
  // Per-step edge-type segment offsets.
  std::vector<int64_t> seg(static_cast<size_t>(walk_len) + 1, 0);
  for (int s = 0; s < walk_len; ++s) seg[s + 1] = seg[s] + etype_counts[s];
  int64_t stride = walk_len + 1;
#pragma omp parallel for schedule(dynamic, 16) if (n * walk_len > 512)
  for (int i = 0; i < n; ++i) {
    Rng& rng = ThreadRng();
    uint64_t* row = out + static_cast<int64_t>(i) * stride;
    row[0] = ids[i];
    uint64_t cur = ids[i];
    uint64_t parent = 0;
    bool has_parent = false;
    for (int s = 1; s <= walk_len; ++s) {
      int64_t idx = store_.NodeIndex(cur);
      uint64_t next = store_.BiasedNeighbor(
          idx, has_parent, parent, etypes_flat + seg[s - 1],
          static_cast<int>(seg[s] - seg[s - 1]), p, q, default_id, rng);
      row[s] = next;
      parent = cur;
      has_parent = true;
      cur = next;
    }
  }
}

void Engine::GetDenseFeature(const uint64_t* ids, int n, const int32_t* fids,
                             const int32_t* dims, int nf, float* out) const {
  int64_t row_dim = 0;
  for (int k = 0; k < nf; ++k) row_dim += dims[k];
#pragma omp parallel for schedule(static) if (n * row_dim > 8192)
  for (int i = 0; i < n; ++i) {
    int64_t idx = store_.NodeIndex(ids[i]);
    float* row = out + static_cast<int64_t>(i) * row_dim;
    for (int k = 0; k < nf; ++k) {
      store_.DenseFeature(idx, fids[k], dims[k], row);
      row += dims[k];
    }
  }
}

void Engine::GetEdgeDenseFeature(const uint64_t* src, const uint64_t* dst,
                                 const int32_t* types, int n,
                                 const int32_t* fids, const int32_t* dims,
                                 int nf, float* out) const {
  int64_t row_dim = 0;
  for (int k = 0; k < nf; ++k) row_dim += dims[k];
#pragma omp parallel for schedule(static) if (n * row_dim > 8192)
  for (int i = 0; i < n; ++i) {
    int64_t idx = store_.EdgeIndex(src[i], dst[i], types[i]);
    float* row = out + static_cast<int64_t>(i) * row_dim;
    for (int k = 0; k < nf; ++k) {
      store_.EdgeDenseFeature(idx, fids[k], dims[k], row);
      row += dims[k];
    }
  }
}

EGResult* Engine::GetSparseFeature(const uint64_t* ids, int n,
                                   const int32_t* fids, int nf) const {
  auto* res = new EGResult();
  res->u64.resize(static_cast<size_t>(nf));
  res->i32.resize(static_cast<size_t>(nf));
  for (int k = 0; k < nf; ++k) {
    res->i32[k].resize(static_cast<size_t>(n));
    for (int i = 0; i < n; ++i) {
      const uint64_t* vals;
      int64_t cnt;
      store_.U64Feature(store_.NodeIndex(ids[i]), fids[k], &vals, &cnt);
      res->i32[k][static_cast<size_t>(i)] = static_cast<int32_t>(cnt);
      if (cnt) res->u64[k].insert(res->u64[k].end(), vals, vals + cnt);
    }
  }
  return res;
}

EGResult* Engine::GetEdgeSparseFeature(const uint64_t* src,
                                       const uint64_t* dst,
                                       const int32_t* types, int n,
                                       const int32_t* fids, int nf) const {
  auto* res = new EGResult();
  res->u64.resize(static_cast<size_t>(nf));
  res->i32.resize(static_cast<size_t>(nf));
  for (int k = 0; k < nf; ++k) {
    res->i32[k].resize(static_cast<size_t>(n));
    for (int i = 0; i < n; ++i) {
      const uint64_t* vals;
      int64_t cnt;
      store_.EdgeU64Feature(store_.EdgeIndex(src[i], dst[i], types[i]),
                            fids[k], &vals, &cnt);
      res->i32[k][static_cast<size_t>(i)] = static_cast<int32_t>(cnt);
      if (cnt) res->u64[k].insert(res->u64[k].end(), vals, vals + cnt);
    }
  }
  return res;
}

EGResult* Engine::GetBinaryFeature(const uint64_t* ids, int n,
                                   const int32_t* fids, int nf) const {
  auto* res = new EGResult();
  res->bytes.resize(static_cast<size_t>(nf));
  res->i32.resize(static_cast<size_t>(nf));
  for (int k = 0; k < nf; ++k) {
    res->i32[k].resize(static_cast<size_t>(n));
    for (int i = 0; i < n; ++i) {
      const char* data;
      int64_t size;
      store_.BinFeature(store_.NodeIndex(ids[i]), fids[k], &data, &size);
      res->i32[k][static_cast<size_t>(i)] = static_cast<int32_t>(size);
      if (size) res->bytes[k].append(data, static_cast<size_t>(size));
    }
  }
  return res;
}

EGResult* Engine::GetEdgeBinaryFeature(const uint64_t* src,
                                       const uint64_t* dst,
                                       const int32_t* types, int n,
                                       const int32_t* fids, int nf) const {
  auto* res = new EGResult();
  res->bytes.resize(static_cast<size_t>(nf));
  res->i32.resize(static_cast<size_t>(nf));
  for (int k = 0; k < nf; ++k) {
    res->i32[k].resize(static_cast<size_t>(n));
    for (int i = 0; i < n; ++i) {
      const char* data;
      int64_t size;
      store_.EdgeBinFeature(store_.EdgeIndex(src[i], dst[i], types[i]),
                            fids[k], &data, &size);
      res->i32[k][static_cast<size_t>(i)] = static_cast<int32_t>(size);
      if (size) res->bytes[k].append(data, static_cast<size_t>(size));
    }
  }
  return res;
}

}  // namespace eg
