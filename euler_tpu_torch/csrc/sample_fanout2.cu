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
// Bound. At the ppi shape (m=512, f1=f2=10, W=32) the draw reads the
// distinct rows it touches once, some 1.3 MB, 0.385 us at 3.35 TB/s, and
// does trivial arithmetic. What sets its time is latency: every hop-2 row
// is known only after its hop-1 draw, so the least a launch can take is
// the launch itself plus two dependent row loads. Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W): an empty kernel at
// this grid takes 5.1 us under its event timer, this kernel 7.8 us (8.6
// us with a cold L2). At 2,560 roots (25,600 warps) it takes 16.6 us
// against an empty launch's 6.7 us: there the ~330 instructions a pick
// of its hot path (from the SASS) keep the schedulers busy, and fewer
// instructions, not fewer bytes, would make it faster.
//
// Design. The TPU kernel issues all hop-2 row DMAs of a stage at once and
// draws hop 2 one stage behind hop 1, so the dependent loads overlap. The
// same here: one warp per (root, hop-1 pick) pair p = r * f1 + c, all
// m * f1 of them launched together, eight a block. Each warp loads
// roots[r] and row 1 into lane registers (the f1 warps of a root sit in
// one or two blocks, so the repeated loads hit L1), makes its one hop-1
// draw with the ballot draw (lane 0 writes out1[p]), loads row 2 and
// makes its f2 hop-2 draws through draw_row_out, which stages the row in
// shared memory and makes the draws at once. A warp's longest dependent
// chain is two row loads and two rounds of draws; every hop-2 row of the
// launch is requested together. (A warp per root would walk its f1 hop-2
// rows one after another, 11 row loads and 110 draws in a chain, with
// 512 warps at ppi for 132 SMs: nothing would hide the loads.) The TPU
// kernel's packed [2K(N+2), 128] slab and VMEM->SMEM pick copy exist for
// its (8, 128) tiling and scalar memory; here the unpacked
// nbr/cum/sampleable slabs are read directly.
//
// Philox counters: (r, c, 0, 0) for hop-1 draw c of root r, and
// (r * f1 + c, c2, 1, 0) for hop-2 draw c2 of that pick, so this launch
// draws exactly what two chained sample_neighbor launches draw at hops 0
// and 1. Optional injected u1 [m, f1] and u2 [m*f1, f2] replace the
// Philox uniforms, so the kernel can be held bit-exactly against the
// plain version. Draw routine and uniforms: draw.cuh, shared with
// sample_neighbor.cu. Build without --use_fast_math.
//
// Wide slabs. When either slab is wider than kMaxWidth (1,024) the
// launch takes the wide path, which stands for the JAX package's XLA
// chain beyond the TPU kernel's MAX_W = 512 (_sample_fanout2_route
// returns None there, euler_tpu/graph/device.py:959-1001, and the per-hop
// loop runs): one block of 256 threads per root makes the root's f1
// hop-1 draws from one pass over its row, then the f2 hop-2 draws of each
// hop-1 pick from one pass over that pick's row, in turn, both hops in
// one launch as the TPU kernel chains them, with the counters above
// (draw.cuh wide_draws: the row's cum streamed through a cp.async ring,
// counted over deg[row] slots). Slabs of mixed width take it whole.
// What bounds it is the bytes of the rows read;
// a root's chain is 1 + f1 row passes, and the card runs every root's
// chain at once (a block a root, several blocks an SM).
//
// Launch discipline: runs on the caller's stream, allocates nothing,
// does not synchronise; the C entry returns the launch's error.

#include "draw.cuh"

namespace {

using etpu::clamp_row;
using etpu::kWarpsPerBlock;

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
  extern __shared__ float4 stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long picks = static_cast<long long>(m) * f1;
  const long long p =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (p >= picks) return;  // warp-uniform: whole warps leave together
  int r, c;  // 32-bit division where it fits: a 64-bit one is a long loop
  if (picks <= INT_MAX) {
    r = static_cast<int>(p) / f1;
    c = static_cast<int>(p) - r * f1;
  } else {
    r = static_cast<int>(p / f1);
    c = static_cast<int>(p - static_cast<long long>(r) * f1);
  }

  // One Philox pass serves both hops: lane j < f2 takes hop-2 draw j of
  // pick p (draw_row_out's first chunk, chunk_uniform's layout) and, when
  // f2 < 32, lane 31 takes hop-1 draw c of root r. The rounds overlap
  // the row loads.
  const bool h1 = lane == 31 && f2 < 32;
  float u_lane = 0.0f;
  if (h1 || lane < f2)
    u_lane = etpu::uniform_at(h1 ? u1 : u2, h1 ? p : p * f2 + lane, k0, k1,
                              static_cast<uint32_t>(h1 ? r : p),
                              static_cast<uint32_t>(h1 ? c : lane),
                              h1 ? 0u : 1u);
  const float u_hop1 =
      f2 < 32 ? __shfl_sync(etpu::kFull, u_lane, 31)
              : etpu::uniform_at(u1, p, k0, k1, static_cast<uint32_t>(r),
                                 static_cast<uint32_t>(c), 0u);

  const int row1 = clamp_row(roots[r], R);
  float cr[T];
  int nr[T];
  etpu::load_row<T>(nbr1, cum1, row1, W1, R, lane, cr, nr);
  const int p1 = etpu::draw<T>(u_hop1, cr, nr, W1, lane);
  const int pick = ok1[row1] != 0 ? p1 : R - 1;
  if (lane == 0) out1[p] = pick;

  const int row2 = clamp_row(pick, R);
  etpu::load_row<T>(nbr2, cum2, row2, W2, R, lane, cr, nr);
  etpu::draw_row_out<T>(cr, nr, ok2[row2] != 0, W2, R, lane, p, f2, 1, k0,
                        k1, u2, u_lane, out2,
                        etpu::warp_stage<T>(stage, warp));
}

// The wide path (either slab wider than kMaxWidth): one block per root
// makes the root's f1 hop-1 draws from one pass over its row, then the
// f2 hop-2 draws of each hop-1 pick from one pass over that pick's row,
// in turn, D draws a pass.
template <int D>
__global__ void __launch_bounds__(etpu::kWideThreads)
fanout2_wide(const int* __restrict__ roots, const int* __restrict__ nbr1,
             const float* __restrict__ cum1, const uint8_t* __restrict__ ok1,
             const int* __restrict__ deg1, const int* __restrict__ nbr2,
             const float* __restrict__ cum2, const uint8_t* __restrict__ ok2,
             const int* __restrict__ deg2, int R, int W1, int W2, int f1,
             int f2, uint32_t k0, uint32_t k1, const float* __restrict__ u1,
             const float* __restrict__ u2, int* out1, int* __restrict__ out2) {
  __shared__ etpu::WideSmem sm;
  const int r = blockIdx.x;
  const int row1 = clamp_row(roots[r], R);
  for (int c0 = 0; c0 < f1; c0 += D)
    etpu::wide_draws<D>(nbr1, cum1, ok1, deg1, row1, W1, R, r, f1, c0, 0, k0,
                        k1, u1, out1, sm);
  // wide_draws ends on a barrier: the block's hop-1 picks are visible
  for (int c = 0; c < f1; ++c) {
    const long long p = static_cast<long long>(r) * f1 + c;
    const int row2 = clamp_row(out1[p], R);
    for (int c0 = 0; c0 < f2; c0 += D)
      etpu::wide_draws<D>(nbr2, cum2, ok2, deg2, row2, W2, R, p, f2, c0, 1,
                          k0, k1, u2, out2, sm);
  }
}

}  // namespace

// The widest slab of the register path; wider slabs take the wide path.
extern "C" int etpu_draw_max_width() { return etpu::kMaxWidth; }

extern "C" int etpu_sample_fanout2(const int* roots, int m, const int* nbr1,
                                   const float* cum1, const uint8_t* ok1,
                                   const int* deg1, const int* nbr2,
                                   const float* cum2, const uint8_t* ok2,
                                   const int* deg2, int R, int W1, int W2,
                                   int f1, int f2, uint32_t k0, uint32_t k1,
                                   const float* u1, const float* u2,
                                   int* out1, int* out2, void* stream) {
  if (m <= 0 || R <= 0 || W1 <= 0 || W2 <= 0 || f1 <= 0 || f2 <= 0 ||
      !deg1 || !deg2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int w = W1 > W2 ? W1 : W2;
  if (w > etpu::kMaxWidth)
    return static_cast<int>(
        etpu::with_draws(f1 > f2 ? f1 : f2, [&](auto draws) {
          constexpr int D = decltype(draws)::value;
          return etpu::launch_wide(fanout2_wide<D>, m, s, roots, nbr1, cum1,
                                   ok1, deg1, nbr2, cum2, ok2, deg2, R, W1,
                                   W2, f1, f2, k0, k1, u1, u2, out1, out2);
        }));
  return static_cast<int>(etpu::with_slots(w, [&](auto slots) {
    constexpr int T = decltype(slots)::value;
    return etpu::launch_warps<T>(
        fanout2_kernel<T>, static_cast<long long>(m) * f1, s, roots, m, nbr1,
        cum1, ok1, nbr2, cum2, ok2, R, W1, W2, f1, f2, k0, k1, u1, u2, out1,
        out2);
  }));
}
