// Chained two-hop weighted neighbor draw for Hopper (sm_90a).
//
// Replaces the TPU kernel euler_tpu/graph/pallas_sampling.py
// _fanout2_kernel (entry sample_fanout2): for m roots, f1 hop-1 picks per
// root from adjacency 1, then f2 hop-2 picks per hop-1 pick from
// adjacency 2, in one launch. Each pick is
//     nbr[row, min(#(u >= cum[row, :W]), W - 1)]
// or the default id R-1 when the row is not sampleable; negative and
// past-the-slab ids are clamped to the default row. Same function as
// euler_tpu_torch/graph/sampling_kernels.py sample_fanout2_reference.
//
// Design. One warp per root, several roots per block. Lane j holds
// slots j, j+32, ... of the current row's cum and nbr in registers, so a
// draw is T ballots and popcounts (idx = number of slots with u >= cum),
// and the pick is a register select plus one shuffle from lane idx % 32:
// no memory access per draw. The hop-1 picks stay in registers (lane c
// holds pick c of its chunk of 32) and feed hop 2 through shuffles, so
// nothing but the outputs goes through device memory. The TPU kernel's
// packed [2K(N+2), 128] slab, its double-buffered row DMAs and its
// VMEM->SMEM pick copy exist for the TPU's (8, 128) tiling and scalar
// memory; here the unpacked nbr/cum/sampleable slabs are read directly,
// each row with coalesced loads.
//
// Draw routine and uniforms: draw.cuh, shared with sample_neighbor.cu.
// Philox counters: (r, c, 0, 0) for hop-1 draw c of root r, and
// (r * f1 + c, c2, 1, 0) for hop-2 draw c2 of that pick, so this launch
// draws exactly what two chained sample_neighbor launches draw at hops 0
// and 1. Optional injected u1 [m, f1] and u2 [m*f1, f2] replace
// the Philox uniforms, so the kernel can be held bit-exactly against the
// plain version. Build without --use_fast_math.
//
// Bound. At the ppi shape (m=512, f1=f2=10, W<=60) the draw reads about
// 5,632 slab rows x W x 8 B ~ 2.7 MB, about 0.8 us at 3.35 TB/s, and does
// trivial arithmetic: it is bound by the latency of its dependent row
// loads (hop-2 rows are known only after hop 1) and by launch cost, not
// by bytes. Each warp walks its f1 hop-2 rows in turn; spreading those
// rows over more warps is the first step to make it faster.
//
// Launch discipline: runs on the caller's stream, allocates nothing,
// does not synchronise; the C entry returns cudaGetLastError().

#include "draw.cuh"

namespace {

using etpu::clamp_row;
using etpu::draw;
using etpu::draw_row_out;
using etpu::kFull;
using etpu::load_row;
using etpu::philox_uniform;

constexpr int kWarpsPerBlock = 4;

template <int T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
fanout2_kernel(const int* __restrict__ roots, int m,
               const int* __restrict__ nbr1, const float* __restrict__ cum1,
               const uint8_t* __restrict__ ok1,
               const int* __restrict__ nbr2, const float* __restrict__ cum2,
               const uint8_t* __restrict__ ok2, int R, int W1, int W2,
               int f1, int f2, uint32_t k0, uint32_t k1,
               const float* __restrict__ u1, const float* __restrict__ u2,
               int* __restrict__ out1, int* __restrict__ out2) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= m) return;  // warp-uniform: whole warps leave together

  const int row1 = clamp_row(roots[r], R);
  const bool s1 = ok1[row1] != 0;
  float c1[T];
  int n1[T];
  load_row<T>(nbr1, cum1, row1, W1, R, lane, c1, n1);

  float c2[T];
  int n2[T];
  for (int c0 = 0; c0 < f1; c0 += 32) {
    const int cnt = min(32, f1 - c0);
    const long long g1 = static_cast<long long>(r) * f1 + c0;
    float my_u = 0.0f;
    if (lane < cnt)
      my_u = u1 ? u1[g1 + lane]
                : philox_uniform(k0, k1, static_cast<uint32_t>(r),
                                 static_cast<uint32_t>(c0 + lane), 0u);
    // hop 1: lane j keeps pick c0+j of this chunk
    int pick = R - 1;
    for (int j = 0; j < cnt; ++j) {
      const int p = draw<T>(__shfl_sync(kFull, my_u, j), c1, n1, W1, lane);
      if (lane == j) pick = s1 ? p : R - 1;
    }
    if (lane < cnt) out1[g1 + lane] = pick;
    // hop 2: the f2 draws of each hop-1 pick of the chunk
    for (int j = 0; j < cnt; ++j) {
      const int row2 = clamp_row(__shfl_sync(kFull, pick, j), R);
      load_row<T>(nbr2, cum2, row2, W2, R, lane, c2, n2);
      draw_row_out<T>(c2, n2, ok2[row2] != 0, W2, R, lane, g1 + j, f2, 1,
                      k0, k1, u2, out2);
    }
  }
}

}  // namespace

extern "C" int etpu_draw_max_width() { return etpu::kMaxWidth; }

extern "C" int etpu_sample_fanout2(const int* roots, int m, const int* nbr1,
                                   const float* cum1, const uint8_t* ok1,
                                   const int* nbr2, const float* cum2,
                                   const uint8_t* ok2, int R, int W1, int W2,
                                   int f1, int f2, uint32_t k0, uint32_t k1,
                                   const float* u1, const float* u2,
                                   int* out1, int* out2, void* stream) {
  const int w = W1 > W2 ? W1 : W2;
  if (m <= 0 || R <= 0 || W1 <= 0 || W2 <= 0 || f1 <= 0 || f2 <= 0 ||
      w > etpu::kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(etpu::with_slots(w, [&](auto slots) {
    fanout2_kernel<decltype(slots)::value>
        <<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
            roots, m, nbr1, cum1, ok1, nbr2, cum2, ok2, R, W1, W2, f1, f2,
            k0, k1, u1, u2, out1, out2);
    return cudaGetLastError();
  }));
}
