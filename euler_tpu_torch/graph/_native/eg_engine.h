// Batch engine over the graph store: the host-side query surface that feeds
// the TPU input pipeline.
//
// Functional equivalent of the reference GraphEngine
// (reference euler/core/graph_engine.h:33) plus parts of the local client
// (reference euler/client/local_graph.cc) — but batch-synchronous instead of
// callback-async: the Python side drives it from a prefetch thread pool that
// overlaps sampling with TPU compute, so the async completion machinery of
// the reference (AsyncOpKernel + callbacks) is unnecessary. Batch ops are
// parallelized with OpenMP over rows.
#ifndef EG_ENGINE_H_
#define EG_ENGINE_H_

#include <algorithm>
#include <cstdint>
#include <functional>
#include <memory>
#include <string>
#include <vector>

#include "eg_api.h"
#include "eg_graph.h"

namespace eg {

// Variable-shaped result container crossing the C ABI (fixed-shape calls
// write straight into caller-allocated numpy buffers instead).
struct EGResult {
  std::vector<std::vector<uint64_t>> u64;
  std::vector<std::vector<float>> f32;
  std::vector<std::vector<int32_t>> i32;
  std::vector<std::string> bytes;
};

class Engine : public GraphAPI {
 public:
  // Load shard `shard_idx` of `shard_num` from a directory of partition
  // files named *_<p>.dat: the shard owns partitions p ≡ shard_idx (mod
  // shard_num) (reference euler/core/graph_engine.cc:90-107). Files without
  // a partition suffix belong to partition 0.
  bool Load(const std::string& dir, int shard_idx, int shard_num);
  bool LoadFiles(std::vector<std::string> files);
  // Parse partition bytes already in memory — the streaming ingest path
  // (remote bytes go fetch -> parse -> store with no local staging; the
  // reference reads partitions straight off HDFS instead,
  // euler/common/hdfs_file_io.cc:79-80). names[i] attributes parse
  // errors; buffers are merged in name-sorted order so the store is
  // byte-identical to LoadFiles on the same partitions.
  bool LoadBuffers(const char* const* bufs, const size_t* lens,
                   const char* const* names, int n);
  // Build directly from pre-parsed stagings — the snapshot-epoch merge
  // path (eg_epoch.cc) orders and filters stagings itself before the
  // store build.
  bool BuildFromStagings(std::vector<Staging>* parts) {
    return store_.Build(parts, &error_);
  }
  const std::string& error() const { return error_; }

  const GraphStore& store() const { return store_; }

  // ---- snapshot epochs (eg_epoch.h) ----
  // Which refresh generation this store represents: 0 for a plain base
  // load, the applied-delta count for a merged load.
  uint64_t Epoch() const override { return epoch_; }
  void set_epoch(uint64_t e) { epoch_ = e; }
  // The base partition files this store was built from — what a delta
  // flip re-merges. Empty for buffer-streamed loads (those cannot
  // delta-flip; the remote tier serves that case).
  const std::vector<std::string>& source_files() const {
    return source_files_;
  }
  void set_source_files(std::vector<std::string> files) {
    source_files_ = std::move(files);
  }
  // Move another engine's built store into this one (the in-place merge
  // path, eg_epoch.cc LoadEngineWithDeltas) — the handle identity the
  // C ABI handed out stays stable.
  void Adopt(Engine&& other) {
    store_ = std::move(other.store_);
    epoch_ = other.epoch_;
    source_files_ = std::move(other.source_files_);
  }

  // ---- introspection (GraphAPI) ----
  int64_t NumNodes() const override {
    return static_cast<int64_t>(store_.num_nodes());
  }
  int64_t NumEdges() const override {
    return static_cast<int64_t>(store_.num_edges());
  }
  int32_t NodeTypeNum() const override { return store_.node_type_num(); }
  int32_t EdgeTypeNum() const override { return store_.edge_type_num(); }
  int32_t FeatureNum(int kind) const override {
    switch (kind) {
      case 0: return store_.nf_u64_num();
      case 1: return store_.nf_f32_num();
      case 2: return store_.nf_bin_num();
      case 3: return store_.ef_u64_num();
      case 4: return store_.ef_f32_num();
      case 5: return store_.ef_bin_num();
      default: return -1;
    }
  }
  void TypeWeightSums(int kind, float* out) const override {
    const auto& v = kind == 0 ? store_.node_type_weight_sums()
                              : store_.edge_type_weight_sums();
    std::copy(v.begin(), v.end(), out);
  }

  // ---- global sampling ----
  void SampleNode(int count, int32_t type, uint64_t* out) const;
  void SampleEdge(int count, int32_t type, uint64_t* out_src,
                  uint64_t* out_dst, int32_t* out_type) const;
  // Typed negative sampling: for each src row, `count` nodes drawn from the
  // global sampler of that src's node type. Replaces the reference's
  // unique/while_loop/inflate_idx pipeline
  // (reference tf_euler/python/euler_ops/sample_ops.py:39-67) with one
  // host-side batch call producing a fixed [n, count] block.
  void SampleNodeWithSrc(const uint64_t* src, int n, int count,
                         uint64_t* out) const;

  void GetNodeType(const uint64_t* ids, int n, int32_t* out) const;
  // Per-node sampling weights, 0 for unknown ids. Used by the
  // device-graph exporter to build the HBM-resident weighted root
  // sampler; also served remotely via kNodeWeight so the exporter
  // composes with sharded graphs. Always true locally (unknown ids are
  // a resolved answer: weight 0).
  bool GetNodeWeight(const uint64_t* ids, int n, float* out) const override;

  // ---- neighbor ops ----
  void SampleNeighbor(const uint64_t* ids, int n, const int32_t* etypes,
                      int net, int count, uint64_t default_id,
                      uint64_t* out_ids, float* out_w, int32_t* out_t) const;
  // Fused multi-hop fanout: one call produces every hop, avoiding the
  // per-hop op round trips of the reference
  // (reference tf_euler/python/euler_ops/neighbor_ops.py:86-92).
  // hop h input size n_h = n * prod(counts[:h]); outputs are caller
  // buffers of size n_{h+1} per hop.
  void SampleFanout(const uint64_t* ids, int n, const int32_t* etypes_flat,
                    const int32_t* etype_counts, const int32_t* counts,
                    int nhops, uint64_t default_id, uint64_t** out_ids,
                    float** out_w, int32_t** out_t) const;

  EGResult* GetFullNeighbor(const uint64_t* ids, int n, const int32_t* etypes,
                            int net, bool sorted) const;
  void GetTopKNeighbor(const uint64_t* ids, int n, const int32_t* etypes,
                       int net, int k, uint64_t default_id, uint64_t* out_ids,
                       float* out_w, int32_t* out_t) const;

  // ---- walks ----
  // out: [n, walk_len+1], column 0 = start ids. Walks through missing nodes
  // emit default_id for the rest of the walk. Each step s uses its own
  // edge-type set (etypes_flat segmented by etype_counts, one segment per
  // step) — heterogeneous metapath walks, matching the reference RandomWalk
  // op's per-step edge_types inputs (tf_euler/ops/walk_ops.cc:71-100).
  void RandomWalk(const uint64_t* ids, int n, const int32_t* etypes_flat,
                  const int32_t* etype_counts, int walk_len, float p, float q,
                  uint64_t default_id, uint64_t* out) const;

  // ---- features ----
  void GetDenseFeature(const uint64_t* ids, int n, const int32_t* fids,
                       const int32_t* dims, int nf, float* out) const;
  void GetEdgeDenseFeature(const uint64_t* src, const uint64_t* dst,
                           const int32_t* types, int n, const int32_t* fids,
                           const int32_t* dims, int nf, float* out) const;
  EGResult* GetSparseFeature(const uint64_t* ids, int n, const int32_t* fids,
                             int nf) const;
  EGResult* GetEdgeSparseFeature(const uint64_t* src, const uint64_t* dst,
                                 const int32_t* types, int n,
                                 const int32_t* fids, int nf) const;
  EGResult* GetBinaryFeature(const uint64_t* ids, int n, const int32_t* fids,
                             int nf) const;
  EGResult* GetEdgeBinaryFeature(const uint64_t* src, const uint64_t* dst,
                                 const int32_t* types, int n,
                                 const int32_t* fids, int nf) const;

 private:
  // One staging-parse fan-out shared by the file and buffer loaders
  // (strided worker pool, per-slot error attribution, merged Build) —
  // the two ingest modes must never diverge in threading or error
  // semantics. labels[i] attributes exceptions; parse_one fills
  // parts[i]/errors[i].
  bool ParseStagings(
      const std::vector<std::string>& labels,
      const std::function<void(int, Staging*, std::string*)>& parse_one);

  GraphStore store_;
  std::string error_;
  uint64_t epoch_ = 0;
  std::vector<std::string> source_files_;
};

}  // namespace eg

#endif  // EG_ENGINE_H_
