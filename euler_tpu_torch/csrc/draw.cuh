// The weighted slab draw shared by the port's sampling kernels
// (sample_fanout2.cu, sample_neighbor.cu), as the TPU kernels share
// euler_tpu/graph/pallas_sampling.py _stage_draw: both kernels include
// this routine, so their pick rule and their uniforms cannot drift apart.
//
// Pick rule: nbr[row, min(#(u >= cum[row, :W]), W - 1)], or the default
// id R-1 when the row is not sampleable; negative and past-the-slab ids
// are clamped to the default row. Same function as
// euler_tpu_torch/graph/device.py sample_neighbor.
//
// Layout: one warp holds one row in registers, lane j slots j, j+32, ...
// (T slots a lane), so a draw is T ballots and popcounts and the pick a
// register select plus one shuffle: no memory access per draw.
//
// Uniforms: Philox4x32-10 keyed by the two seed words, counter (row,
// column, hop, 0), first output word, top 24 bits times 2^-24: u < 1,
// exact in float32, independent of the launch geometry. The plain
// version computes the same numbers (graph/device.py philox_uniform).
// Build without --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace etpu {

constexpr unsigned kFull = 0xffffffffu;
// Widest slab the register layout holds: 32 slots per lane.
constexpr int kMaxWidth = 32 * 32;

__device__ __forceinline__ float philox_uniform(uint32_t k0, uint32_t k1,
                                                uint32_t row, uint32_t col,
                                                uint32_t hop) {
  uint32_t c0 = row, c1 = col, c2 = hop, c3 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return static_cast<float>(c0 >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ int clamp_row(int id, int R) {
  return id < 0 ? R - 1 : min(id, R - 1);
}

// Row `row` of a [R, W] slab into lane registers: slot lane + 32t.
template <int T>
__device__ __forceinline__ void load_row(const int* __restrict__ nbr,
                                         const float* __restrict__ cum,
                                         int row, int W, int R, int lane,
                                         float (&c)[T], int (&n)[T]) {
  const size_t base = static_cast<size_t>(row) * W;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = lane + 32 * t;
    c[t] = col < W ? cum[base + col] : 2.0f;
    n[t] = col < W ? nbr[base + col] : R - 1;
  }
}

// One draw from the row in registers; u is warp-uniform, so is the pick.
template <int T>
__device__ __forceinline__ int draw(float u, const float (&c)[T],
                                    const int (&n)[T], int W, int lane) {
  int idx = 0;
#pragma unroll
  for (int t = 0; t < T; ++t)
    idx += __popc(__ballot_sync(kFull, lane + 32 * t < W && u >= c[t]));
  idx = min(idx, W - 1);
  const int src_t = idx >> 5;
  int v = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) v = t == src_t ? n[t] : v;
  return __shfl_sync(kFull, v, idx & 31);
}

// `count` draws from the row in registers for global row `grow` of hop
// `hop`, written to out[grow * count + c]: lane j computes the uniform of
// draw c0+j of each chunk of 32 (or reads it from the injected u), and
// stores that draw's pick.
template <int T>
__device__ __forceinline__ void draw_row_out(
    const float (&c)[T], const int (&n)[T], bool ok, int W, int R,
    int lane, long long grow, int count, int hop, uint32_t k0, uint32_t k1,
    const float* __restrict__ u, int* __restrict__ out) {
  for (int c0 = 0; c0 < count; c0 += 32) {
    const int cnt = min(32, count - c0);
    float my_u = 0.0f;
    if (lane < cnt)
      my_u = u ? u[grow * count + c0 + lane]
               : philox_uniform(k0, k1, static_cast<uint32_t>(grow),
                                static_cast<uint32_t>(c0 + lane),
                                static_cast<uint32_t>(hop));
    int mine = R - 1;
    for (int j = 0; j < cnt; ++j) {
      const int p = draw<T>(__shfl_sync(kFull, my_u, j), c, n, W, lane);
      if (lane == j) mine = ok ? p : R - 1;
    }
    if (lane < cnt) out[grow * count + c0 + lane] = mine;
  }
}

// Calls launch(std::integral_constant<int, T>{}) with the fewest slots a
// lane T in {1, 2, 4, 8, 16, 32} that hold a row of width w <= kMaxWidth.
template <class Launch>
cudaError_t with_slots(int w, Launch&& launch) {
  const int t = (w + 31) / 32;
  if (t <= 1) return launch(std::integral_constant<int, 1>{});
  if (t <= 2) return launch(std::integral_constant<int, 2>{});
  if (t <= 4) return launch(std::integral_constant<int, 4>{});
  if (t <= 8) return launch(std::integral_constant<int, 8>{});
  if (t <= 16) return launch(std::integral_constant<int, 16>{});
  return launch(std::integral_constant<int, 32>{});
}

}  // namespace etpu
