#include "eg_sampling.h"

#include <algorithm>

namespace eg {

namespace {
thread_local Rng tls_rng(0xC0FFEE123456789ULL ^
                         reinterpret_cast<uint64_t>(&tls_rng));
}  // namespace

Rng& ThreadRng() { return tls_rng; }
void SeedThreadRng(uint64_t seed) { tls_rng = Rng(seed); }

void AliasTable::Build(const float* weights, size_t n) {
  prob_.assign(n, 1.0);
  alias_.assign(n, 0);
  total_ = 0.0;
  if (n == 0) return;
  for (size_t i = 0; i < n; ++i) total_ += weights[i];
  if (total_ <= 0.0) {
    // Degenerate: uniform.
    for (size_t i = 0; i < n; ++i) {
      prob_[i] = 1.0;
      alias_[i] = static_cast<uint32_t>(i);
    }
    total_ = 0.0;
    return;
  }
  const double scale = static_cast<double>(n) / total_;
  std::vector<double> scaled(n);
  std::vector<uint32_t> small, large;
  small.reserve(n);
  large.reserve(n);
  for (size_t i = 0; i < n; ++i) {
    scaled[i] = weights[i] * scale;
    (scaled[i] < 1.0 ? small : large).push_back(static_cast<uint32_t>(i));
  }
  while (!small.empty() && !large.empty()) {
    uint32_t s = small.back();
    small.pop_back();
    uint32_t l = large.back();
    large.pop_back();
    prob_[s] = scaled[s];
    alias_[s] = l;
    scaled[l] = scaled[l] - (1.0 - scaled[s]);
    (scaled[l] < 1.0 ? small : large).push_back(l);
  }
  for (uint32_t i : large) prob_[i] = 1.0;
  for (uint32_t i : small) prob_[i] = 1.0;
}

void PrefixTable::Build(const float* weights, size_t n) {
  cum_.resize(n);
  double acc = 0.0;
  for (size_t i = 0; i < n; ++i) {
    acc += weights[i];
    cum_[i] = acc;
  }
}

size_t PrefixTable::Draw(Rng& rng) const {
  if (cum_.empty()) return 0;
  double r = rng.NextDouble() * cum_.back();
  auto it = std::upper_bound(cum_.begin(), cum_.end(), r);
  if (it == cum_.end()) --it;
  return static_cast<size_t>(it - cum_.begin());
}

size_t SearchCumulative(const float* cum, size_t n, float r) {
  const float* it = std::upper_bound(cum, cum + n, r);
  if (it == cum + n) --it;
  return static_cast<size_t>(it - cum);
}

void BuildAliasRows(const int64_t* offsets, int64_t num_rows,
                    const float* weights, float* prob, int32_t* alias) {
#pragma omp parallel
  {
    // per-thread scratch reused across rows (heavy-tail rows reach
    // tens of thousands of entries; reallocating per row would thrash)
    std::vector<double> scaled;
    std::vector<int32_t> small, large;
#pragma omp for schedule(dynamic, 256)
    for (int64_t r = 0; r < num_rows; ++r) {
      const int64_t base = offsets[r];
      const int64_t n = offsets[r + 1] - base;
      if (n <= 0) continue;
      double total = 0.0;
      for (int64_t i = 0; i < n; ++i) total += weights[base + i];
      if (total <= 0.0) {  // degenerate: uniform, like AliasTable
        for (int64_t i = 0; i < n; ++i) {
          prob[base + i] = 1.0f;
          alias[base + i] = static_cast<int32_t>(i);
        }
        continue;
      }
      const double scale = static_cast<double>(n) / total;
      scaled.resize(n);
      small.clear();
      large.clear();
      for (int64_t i = 0; i < n; ++i) {
        scaled[i] = weights[base + i] * scale;
        (scaled[i] < 1.0 ? small : large)
            .push_back(static_cast<int32_t>(i));
      }
      // defaults cover entries the loop leaves untouched
      for (int64_t i = 0; i < n; ++i) {
        prob[base + i] = 1.0f;
        alias[base + i] = static_cast<int32_t>(i);
      }
      while (!small.empty() && !large.empty()) {
        int32_t s = small.back();
        small.pop_back();
        int32_t l = large.back();
        large.pop_back();
        prob[base + s] = static_cast<float>(scaled[s]);
        alias[base + s] = l;
        scaled[l] -= 1.0 - scaled[s];
        (scaled[l] < 1.0 ? small : large).push_back(l);
      }
    }
  }
}

}  // namespace eg
