// Single-hop weighted neighbor draw for Hopper (sm_90a).
//
// Replaces the TPU kernel euler_tpu/graph/pallas_sampling.py _kernel
// (entry sample_neighbor): `count` draws with replacement for each of m
// nodes, out [m, count]. Each pick is
//     nbr[row, min(#(u >= cum[row, :W]), W - 1)]
// or the default id R-1 when the row is not sampleable; negative and
// past-the-slab ids are clamped to the default row. Same function as
// euler_tpu_torch/graph/device.py sample_neighbor, its plain version.
//
// Design. One warp per node, eight nodes a block: the warp loads its row
// with coalesced loads and makes the row's draws through the shared
// routine draw_row_out (draw.cuh, the same one sample_fanout2.cu runs for
// its hop-2 draws), which stages the row in the warp's slice of shared
// memory and makes a chunk's draws at once, a group of lanes a draw. The
// TPU kernel's packed [2K(N+2), 128] slab and its double-buffered row
// DMAs follow the TPU's tiling; here the unpacked nbr/cum/sampleable
// slabs are read directly.
//
// Wide slabs. A slab wider than kMaxWidth (1,024) takes the wide path,
// which stands for the JAX package's XLA chain beyond the TPU kernel's
// MAX_W = 512 (euler_tpu/graph/device.py sample_neighbor, :454-500): one
// block of 256 threads per node makes the node's `count` draws from one
// pass over its row (32 draws a pass; more take more passes), the row's
// cum streamed through a cp.async ring and counted over deg[row] slots
// (draw.cuh wide_draws, its precondition and
// its bound: the bytes of the rows read). Slabs up to kMaxWidth keep the
// warp-per-node path above unchanged.
//
// Uniforms: Philox counter (r, c, hop, 0) for draw c of node r, with the
// hop given by the caller, so a launch at hop h draws what
// graph/device.py philox_uniform(seed_words, h, m, count) gives. Optional
// injected u [m, count] replaces them.
//
// Bound. At the unsupervised GraphSAGE positives ([512, 1], W = 32) the
// draw reads 512 rows of W x 8 B + 1 B, about 135 KB (0.04 us at
// 3.35 TB/s), and at a hop-2 shape ([5120, 10]) about 1.2 MB (0.35 us).
// No launch reaches the first: the node id, its row and one draw make a
// chain of two dependent loads behind the launch itself, and the small
// shape is set by the launch. The large one is set by the same chain
// plus its draws. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3
// (700 W): 5.4 us at [512, 1] against 4.8 us for an empty kernel at the
// same grid under the same event timer, 7.1 us at [5120, 10] against
// 5.1 us.
//
// Launch discipline: runs on the caller's stream, allocates nothing,
// does not synchronise; the C entry returns the launch's error.

#include "draw.cuh"

namespace {

using etpu::kWarpsPerBlock;

template <int T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sample_neighbor_kernel(const int* __restrict__ nodes, int m,
                       const int* __restrict__ nbr,
                       const float* __restrict__ cum,
                       const uint8_t* __restrict__ ok, int R, int W,
                       int count, int hop, uint32_t k0, uint32_t k1,
                       const float* __restrict__ u, int* __restrict__ out) {
  extern __shared__ float4 stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= m) return;  // warp-uniform: whole warps leave together

  const int row = etpu::clamp_row(nodes[r], R);
  const float u0 = etpu::chunk_uniform(u, k0, k1, r, count, 0, hop, lane);
  float c[T];
  int n[T];
  etpu::load_row<T>(nbr, cum, row, W, R, lane, c, n);
  etpu::draw_row_out<T>(c, n, ok[row] != 0, W, R, lane, r, count, hop, k0,
                        k1, u, u0, out, etpu::warp_stage<T>(stage, warp));
}

// The wide path (W > kMaxWidth): one block per node, D draws a pass.
template <int D>
__global__ void __launch_bounds__(etpu::kWideThreads)
sample_neighbor_wide(const int* __restrict__ nodes,
                     const int* __restrict__ nbr,
                     const float* __restrict__ cum,
                     const uint8_t* __restrict__ ok,
                     const int* __restrict__ deg, int R, int W, int count,
                     int hop, uint32_t k0, uint32_t k1,
                     const float* __restrict__ u, int* __restrict__ out) {
  __shared__ etpu::WideSmem sm;
  const int r = blockIdx.x;
  const int row = etpu::clamp_row(nodes[r], R);
  for (int c0 = 0; c0 < count; c0 += D)
    etpu::wide_draws<D>(nbr, cum, ok, deg, row, W, R, r, count, c0, hop, k0,
                        k1, u, out, sm);
}

}  // namespace

extern "C" int etpu_sample_neighbor(const int* nodes, int m, const int* nbr,
                                    const float* cum, const uint8_t* ok,
                                    const int* deg, int R, int W, int count,
                                    int hop, uint32_t k0, uint32_t k1,
                                    const float* u, int* out, void* stream) {
  if (m <= 0 || R <= 0 || W <= 0 || count <= 0 || hop < 0 || !deg)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (W > etpu::kMaxWidth)
    return static_cast<int>(etpu::with_draws(count, [&](auto draws) {
      constexpr int D = decltype(draws)::value;
      return etpu::launch_wide(sample_neighbor_wide<D>, m, s, nodes, nbr,
                               cum, ok, deg, R, W, count, hop, k0, k1, u,
                               out);
    }));
  return static_cast<int>(etpu::with_slots(W, [&](auto slots) {
    constexpr int T = decltype(slots)::value;
    return etpu::launch_warps<T>(sample_neighbor_kernel<T>, m, s, nodes, m,
                                 nbr, cum, ok, R, W, count, hop, k0, k1, u,
                                 out);
  }));
}
