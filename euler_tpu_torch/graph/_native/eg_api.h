// Abstract graph query interface shared by the embedded engine (Local mode)
// and the remote sharded client (Remote mode).
//
// Role equivalent of the reference's abstract async client
// (reference euler/client/graph.h:47 with Local/Remote impls picked by
// Graph::NewGraph, graph.cc:157-185) — but batch-synchronous: the TPU input
// pipeline drives these from prefetch threads, so results return in place of
// flowing through completion callbacks.
#ifndef EG_API_H_
#define EG_API_H_

#include <cstdint>

namespace eg {

struct EGResult;

class GraphAPI {
 public:
  virtual ~GraphAPI() = default;

  // ---- introspection ----
  virtual int64_t NumNodes() const = 0;
  virtual int64_t NumEdges() const = 0;
  virtual int32_t NodeTypeNum() const = 0;
  virtual int32_t EdgeTypeNum() const = 0;
  // kind: 0=node u64, 1=node f32, 2=node binary, 3..5 same for edges.
  virtual int32_t FeatureNum(int kind) const = 0;
  // kind 0 = node, 1 = edge; out sized {node,edge}_type_num.
  virtual void TypeWeightSums(int kind, float* out) const = 0;
  // Snapshot epoch this view serves (eg_epoch.h); 0 = base load, never
  // refreshed. Remote graphs answer the max across shards.
  virtual uint64_t Epoch() const { return 0; }

  // ---- global sampling ----
  virtual void SampleNode(int count, int32_t type, uint64_t* out) const = 0;
  virtual void SampleEdge(int count, int32_t type, uint64_t* out_src,
                          uint64_t* out_dst, int32_t* out_type) const = 0;
  virtual void SampleNodeWithSrc(const uint64_t* src, int n, int count,
                                 uint64_t* out) const = 0;
  virtual void GetNodeType(const uint64_t* ids, int n,
                           int32_t* out) const = 0;
  // Per-node sampling weights (0 for unknown ids) — the device-graph
  // exporter's feed (euler_tpu/graph/device.py build_node_sampler).
  // Returns false when any row could not be resolved (remote shard
  // unreachable): unlike the query ops, which degrade to defaults, a
  // silently-zero weight would bias the exported sampler — callers must
  // surface the failure.
  virtual bool GetNodeWeight(const uint64_t* ids, int n,
                             float* out) const = 0;

  // ---- neighbor ops ----
  virtual void SampleNeighbor(const uint64_t* ids, int n,
                              const int32_t* etypes, int net, int count,
                              uint64_t default_id, uint64_t* out_ids,
                              float* out_w, int32_t* out_t) const = 0;
  virtual void SampleFanout(const uint64_t* ids, int n,
                            const int32_t* etypes_flat,
                            const int32_t* etype_counts, const int32_t* counts,
                            int nhops, uint64_t default_id, uint64_t** out_ids,
                            float** out_w, int32_t** out_t) const = 0;
  virtual EGResult* GetFullNeighbor(const uint64_t* ids, int n,
                                    const int32_t* etypes, int net,
                                    bool sorted) const = 0;
  virtual void GetTopKNeighbor(const uint64_t* ids, int n,
                               const int32_t* etypes, int net, int k,
                               uint64_t default_id, uint64_t* out_ids,
                               float* out_w, int32_t* out_t) const = 0;

  // ---- walks ----
  virtual void RandomWalk(const uint64_t* ids, int n,
                          const int32_t* etypes_flat,
                          const int32_t* etype_counts, int walk_len, float p,
                          float q, uint64_t default_id,
                          uint64_t* out) const = 0;

  // ---- features ----
  virtual void GetDenseFeature(const uint64_t* ids, int n, const int32_t* fids,
                               const int32_t* dims, int nf,
                               float* out) const = 0;
  virtual void GetEdgeDenseFeature(const uint64_t* src, const uint64_t* dst,
                                   const int32_t* types, int n,
                                   const int32_t* fids, const int32_t* dims,
                                   int nf, float* out) const = 0;
  virtual EGResult* GetSparseFeature(const uint64_t* ids, int n,
                                     const int32_t* fids, int nf) const = 0;
  virtual EGResult* GetEdgeSparseFeature(const uint64_t* src,
                                         const uint64_t* dst,
                                         const int32_t* types, int n,
                                         const int32_t* fids,
                                         int nf) const = 0;
  virtual EGResult* GetBinaryFeature(const uint64_t* ids, int n,
                                     const int32_t* fids, int nf) const = 0;
  virtual EGResult* GetEdgeBinaryFeature(const uint64_t* src,
                                         const uint64_t* dst,
                                         const int32_t* types, int n,
                                         const int32_t* fids,
                                         int nf) const = 0;
};

}  // namespace eg

#endif  // EG_API_H_
