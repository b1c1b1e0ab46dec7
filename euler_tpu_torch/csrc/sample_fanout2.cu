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
// Uniforms. Philox4x32-10 keyed by the two seed words, counter (row,
// column, hop, 0) with row the global row index of the hop, first output
// word, top 24 bits times 2^-24: u < 1, exact in float32, and independent
// of the launch geometry. The plain version computes the same numbers
// (graph/device.py philox_uniform). Optional injected u1 [m, f1] and
// u2 [m*f1, f2] replace them, so the kernel can be held bit-exactly
// against the plain version. Build without --use_fast_math.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

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
// draw c0+j of each chunk of 32, and stores that draw's pick.
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

template <int T>
cudaError_t launch(const int* roots, int m, const int* nbr1,
                   const float* cum1, const uint8_t* ok1, const int* nbr2,
                   const float* cum2, const uint8_t* ok2, int R, int W1,
                   int W2, int f1, int f2, uint32_t k0, uint32_t k1,
                   const float* u1, const float* u2, int* out1, int* out2,
                   cudaStream_t stream) {
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fanout2_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      roots, m, nbr1, cum1, ok1, nbr2, cum2, ok2, R, W1, W2, f1, f2, k0, k1,
      u1, u2, out1, out2);
  return cudaGetLastError();
}

}  // namespace

// Widest slab the register layout holds: 32 slots per lane.
extern "C" int etpu_fanout2_max_width() { return 32 * 32; }

extern "C" int etpu_sample_fanout2(const int* roots, int m, const int* nbr1,
                                   const float* cum1, const uint8_t* ok1,
                                   const int* nbr2, const float* cum2,
                                   const uint8_t* ok2, int R, int W1, int W2,
                                   int f1, int f2, uint32_t k0, uint32_t k1,
                                   const float* u1, const float* u2,
                                   int* out1, int* out2, void* stream) {
  const int w = W1 > W2 ? W1 : W2;
  if (m <= 0 || R <= 0 || W1 <= 0 || W2 <= 0 || f1 <= 0 || f2 <= 0 ||
      w > etpu_fanout2_max_width())
    return static_cast<int>(cudaErrorInvalidValue);
  const int t = (w + 31) / 32;
  auto s = static_cast<cudaStream_t>(stream);
#define ETPU_LAUNCH(TT)                                                      \
  return static_cast<int>(launch<TT>(roots, m, nbr1, cum1, ok1, nbr2, cum2, \
                                     ok2, R, W1, W2, f1, f2, k0, k1, u1, u2, \
                                     out1, out2, s))
  if (t <= 1) ETPU_LAUNCH(1);
  if (t <= 2) ETPU_LAUNCH(2);
  if (t <= 4) ETPU_LAUNCH(4);
  if (t <= 8) ETPU_LAUNCH(8);
  if (t <= 16) ETPU_LAUNCH(16);
  ETPU_LAUNCH(32);
#undef ETPU_LAUNCH
}
