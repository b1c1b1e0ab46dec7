// Immutable in-memory heterogeneous graph store, flat SoA layout.
//
// Functional equivalent of the reference's graph core
// (reference euler/core/graph.h, compact_graph.cc, compact_node.cc,
// graph_builder.cc) with a different architecture: instead of a hash map of
// per-node heap objects each owning little vectors, everything lives in a
// handful of flat arrays (global CSR over [node x edge_type] groups, feature
// CSRs, edge SoA). The store is immutable after Build(), so all reads are
// lock-free, cache-friendly, and trivially parallel — which is what matters
// when one host CPU must keep TPU chips fed.
//
// On-disk format: the reference's length-prefixed block .dat format
// (spec derived from the reference's euler/tools/json2dat.py:40-175 and the
// framing check in the reference's euler/core/graph_builder.cc:166-224), so
// existing converters and fixtures interoperate.
#ifndef EG_GRAPH_H_
#define EG_GRAPH_H_

#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

#include "eg_common.h"
#include "eg_sampling.h"

namespace eg {

// Mutable staging area one loader thread fills while parsing blocks.
// Concatenated into the final store by GraphStore::Build.
struct Staging {
  // Slot/type counts discovered from records (must be uniform).
  int32_t edge_type_num = -1;
  int32_t nf_u64_num = -1, nf_f32_num = -1, nf_bin_num = -1;
  int32_t ef_u64_num = -1, ef_f32_num = -1, ef_bin_num = -1;

  std::vector<uint64_t> node_ids;
  std::vector<int32_t> node_types;
  std::vector<float> node_weights;
  std::vector<int32_t> grp_counts;   // [nodes * edge_type_num]
  std::vector<float> grp_weights;    // [nodes * edge_type_num]
  std::vector<uint64_t> nbr_ids;     // per group, sorted by id
  std::vector<float> nbr_w;

  std::vector<int32_t> nf_u64_cnt;   // [nodes * nf_u64_num]
  std::vector<uint64_t> nf_u64_val;
  std::vector<int32_t> nf_f32_cnt;
  std::vector<float> nf_f32_val;
  std::vector<int32_t> nf_bin_cnt;
  std::string nf_bin_val;

  std::vector<uint64_t> e_src, e_dst;
  std::vector<int32_t> e_type;
  std::vector<float> e_w;
  std::vector<int32_t> ef_u64_cnt;
  std::vector<uint64_t> ef_u64_val;
  std::vector<int32_t> ef_f32_cnt;
  std::vector<float> ef_f32_val;
  std::vector<int32_t> ef_bin_cnt;
  std::string ef_bin_val;

  std::string error;  // non-empty on parse failure

  // Parse every block in `data` (the full contents of one .dat partition).
  bool ParseFile(const char* data, size_t size);

 private:
  bool ParseBlock(ByteCursor* cur);
  bool ParseEdgeRecord(const char* data, size_t size);
};

class GraphStore {
 public:
  // Merge staging partitions (in deterministic order) and build samplers,
  // hash indexes, and cumulative weights. Returns false + error on mismatch.
  bool Build(std::vector<Staging>* parts, std::string* error);

  // ---- introspection ----
  size_t num_nodes() const { return node_ids_.size(); }
  size_t num_edges() const { return e_src_.size(); }
  int32_t node_type_num() const { return node_type_num_; }
  int32_t edge_type_num() const { return edge_type_num_; }
  int32_t nf_u64_num() const { return nf_u64_num_; }
  int32_t nf_f32_num() const { return nf_f32_num_; }
  int32_t nf_bin_num() const { return nf_bin_num_; }
  int32_t ef_u64_num() const { return ef_u64_num_; }
  int32_t ef_f32_num() const { return ef_f32_num_; }
  int32_t ef_bin_num() const { return ef_bin_num_; }
  // Per-type weight sums (used for cross-shard weighted global sampling,
  // cf. reference euler/core/graph_engine.h:136-164).
  const std::vector<float>& node_type_weight_sums() const {
    return node_type_wsum_;
  }
  const std::vector<float>& edge_type_weight_sums() const {
    return edge_type_wsum_;
  }

  // ---- lookup ----
  // Returns -1 if the id is not present.
  inline int64_t NodeIndex(uint64_t id) const {
    auto it = node_idx_.find(id);
    return it == node_idx_.end() ? -1 : it->second;
  }
  inline int64_t EdgeIndex(uint64_t src, uint64_t dst, int32_t type) const {
    auto it = edge_idx_.find(EdgeKey{src, dst, type});
    return it == edge_idx_.end() ? -1 : it->second;
  }
  inline int32_t NodeTypeAt(int64_t idx) const { return node_types_[idx]; }
  inline float NodeWeightAt(int64_t idx) const { return node_weights_[idx]; }
  uint64_t NodeIdAt(int64_t idx) const { return node_ids_[idx]; }

  // ---- global sampling (weight-proportional) ----
  // type == -1: sample the type first by weight sum, then a node within it
  // (semantics of reference euler/core/compact_graph.cc:32-56).
  uint64_t SampleNode(int32_t type, Rng& rng) const;
  // Returns edge index, -1 when no edge matches.
  int64_t SampleEdgeIdx(int32_t type, Rng& rng) const;
  uint64_t EdgeSrcAt(int64_t idx) const { return e_src_[idx]; }
  uint64_t EdgeDstAt(int64_t idx) const { return e_dst_[idx]; }
  int32_t EdgeTypeAt(int64_t idx) const { return e_type_[idx]; }

  // ---- per-node adjacency ----
  // Weighted draw of `count` neighbors (with replacement) restricted to the
  // given edge types. Fills default_id/weight 0/type -1 when the node has no
  // matching neighbors (semantics of reference
  // tf_euler/kernels/sample_neighbor_op.cc:43-82 + compact_node.cc:42-101).
  void SampleNeighbors(int64_t nidx, const int32_t* etypes, int net, int count,
                       uint64_t default_id, Rng& rng, uint64_t* out_ids,
                       float* out_w, int32_t* out_t) const;

  // Append all neighbors in the given edge types. If `sorted`, merge groups
  // ascending by neighbor id (groups are already id-sorted).
  void FullNeighbors(int64_t nidx, const int32_t* etypes, int net, bool sorted,
                     std::vector<uint64_t>* ids, std::vector<float>* w,
                     std::vector<int32_t>* t) const;

  // Top-k by weight (descending), padded with default_id/0/-1.
  void TopKNeighbors(int64_t nidx, const int32_t* etypes, int net, int k,
                     uint64_t default_id, uint64_t* out_ids, float* out_w,
                     int32_t* out_t) const;

  // node2vec-biased single draw given the previous walk node (parent).
  // Weight scaling w/p for return, w for distance-1, w/q for distance-2
  // (semantics of reference euler/client/graph.cc:120-151). has_parent=false
  // on the first hop degrades to a plain weighted draw.
  uint64_t BiasedNeighbor(int64_t nidx, bool has_parent, uint64_t parent_id,
                          const int32_t* etypes, int net, float p, float q,
                          uint64_t default_id, Rng& rng) const;

  // ---- features ----
  // Copy up to `dim` float values of feature slot `fid`; zero-pad the rest.
  void DenseFeature(int64_t nidx, int32_t fid, int32_t dim, float* out) const;
  void EdgeDenseFeature(int64_t eidx, int32_t fid, int32_t dim,
                        float* out) const;
  // Raw spans for variable-length gathers.
  void U64Feature(int64_t nidx, int32_t fid, const uint64_t** vals,
                  int64_t* count) const;
  void EdgeU64Feature(int64_t eidx, int32_t fid, const uint64_t** vals,
                      int64_t* count) const;
  void F32Feature(int64_t nidx, int32_t fid, const float** vals,
                  int64_t* count) const;
  void EdgeF32Feature(int64_t eidx, int32_t fid, const float** vals,
                      int64_t* count) const;
  void BinFeature(int64_t nidx, int32_t fid, const char** data,
                  int64_t* size) const;
  void EdgeBinFeature(int64_t eidx, int32_t fid, const char** data,
                      int64_t* size) const;

 private:
  friend class Engine;

  inline const float* GroupCum(int64_t nidx, int32_t t, int64_t* n) const {
    int64_t g = nidx * edge_type_num_ + t;
    *n = adj_off_[g + 1] - adj_off_[g];
    return adj_cumw_.data() + adj_off_[g];
  }

  int32_t node_type_num_ = 0, edge_type_num_ = 0;
  int32_t nf_u64_num_ = 0, nf_f32_num_ = 0, nf_bin_num_ = 0;
  int32_t ef_u64_num_ = 0, ef_f32_num_ = 0, ef_bin_num_ = 0;

  std::vector<uint64_t> node_ids_;
  std::vector<int32_t> node_types_;
  std::vector<float> node_weights_;

  std::vector<int64_t> adj_off_;   // [nodes * edge_type_num + 1]
  std::vector<uint64_t> adj_nbr_;  // id-sorted within each group
  std::vector<float> adj_w_;
  std::vector<float> adj_cumw_;    // cumulative within group
  std::vector<float> grp_w_;       // [nodes * edge_type_num]

  std::vector<int64_t> nf_u64_off_;  // [nodes * nf_u64_num + 1]
  std::vector<uint64_t> nf_u64_val_;
  std::vector<int64_t> nf_f32_off_;
  std::vector<float> nf_f32_val_;
  std::vector<int64_t> nf_bin_off_;
  std::string nf_bin_val_;

  std::vector<uint64_t> e_src_, e_dst_;
  std::vector<int32_t> e_type_;
  std::vector<float> e_w_;
  std::vector<int64_t> ef_u64_off_;
  std::vector<uint64_t> ef_u64_val_;
  std::vector<int64_t> ef_f32_off_;
  std::vector<float> ef_f32_val_;
  std::vector<int64_t> ef_bin_off_;
  std::string ef_bin_val_;

  std::unordered_map<uint64_t, int64_t> node_idx_;
  std::unordered_map<EdgeKey, int64_t, EdgeKeyHash> edge_idx_;

  // Global weight-proportional samplers, one alias table per type plus a
  // type-level prefix table (cf. reference compact_graph.cc:74-104).
  std::vector<std::vector<int64_t>> nodes_by_type_;
  std::vector<AliasTable> node_samplers_;
  PrefixTable node_type_sampler_;
  std::vector<float> node_type_wsum_;

  std::vector<std::vector<int64_t>> edges_by_type_;
  std::vector<AliasTable> edge_samplers_;
  PrefixTable edge_type_sampler_;
  std::vector<float> edge_type_wsum_;
};

}  // namespace eg

#endif  // EG_GRAPH_H_
