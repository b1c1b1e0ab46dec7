// Weighted sampling tables.
//
// Two structures, matching the reference's two strategies
// (reference euler/common/compact_weighted_collection.h — prefix-sum + binary
// search, and euler/common/fast_weighted_collection.h + alias_method.cc —
// Walker alias, O(1) per draw). We use the alias table for the big global
// per-type node/edge samplers and inline prefix-sum binary search over the
// adjacency CSR for neighbor draws (no per-node table objects).
#ifndef EG_SAMPLING_H_
#define EG_SAMPLING_H_

#include <cstdint>
#include <vector>

#include "eg_common.h"

namespace eg {

// Walker alias table: O(n) build, O(1) draw.
class AliasTable {
 public:
  void Build(const float* weights, size_t n);
  void Build(const std::vector<float>& w) { Build(w.data(), w.size()); }

  inline size_t Draw(Rng& rng) const {
    if (prob_.empty()) return 0;
    size_t i = static_cast<size_t>(rng.NextLess(prob_.size()));
    return rng.NextDouble() < prob_[i] ? i : alias_[i];
  }

  size_t size() const { return prob_.size(); }
  double total_weight() const { return total_; }

 private:
  std::vector<double> prob_;
  std::vector<uint32_t> alias_;
  double total_ = 0.0;
};

// Prefix-sum table: O(n) build, O(log n) draw. Used where we also need the
// cumulative array itself (e.g. biased random-walk merge weights).
class PrefixTable {
 public:
  void Build(const float* weights, size_t n);
  void Build(const std::vector<float>& w) { Build(w.data(), w.size()); }

  size_t Draw(Rng& rng) const;

  size_t size() const { return cum_.size(); }
  double total_weight() const { return cum_.empty() ? 0.0 : cum_.back(); }

 private:
  std::vector<double> cum_;
};

// Binary search a cumulative float array segment [begin, end) for value r
// in [0, end[-1]); returns the index offset within the segment.
size_t SearchCumulative(const float* cum, size_t n, float r);

// Flat-CSR Walker/Vose build for the device-side EXACT sampler: row r's
// entries live at [offsets[r], offsets[r+1]); fill prob[slot] (chance of
// keeping the slot's own entry) and alias[slot] (ROW-LOCAL index of the
// alternative) for every slot. Zero/negative-total rows fall back to
// uniform (prob 1, alias self) — callers mask them with the engine's
// unsampleable contract, exactly like the padded-slab path. Parallel
// over rows (the device exporter calls it on multi-million-row CSRs).
void BuildAliasRows(const int64_t* offsets, int64_t num_rows,
                    const float* weights, float* prob, int32_t* alias);

}  // namespace eg

#endif  // EG_SAMPLING_H_
