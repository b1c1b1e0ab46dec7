// The weighted slab draw shared by the port's sampling kernels
// (sample_fanout2.cu, sample_neighbor.cu), as the TPU kernels share
// euler_tpu/graph/pallas_sampling.py _stage_draw: both kernels include
// this header and make their rows' draws with draw_row_out, so their pick
// rule and their uniforms cannot drift apart.
//
// Pick rule: nbr[row, min(#(u >= cum[row, :W]), W - 1)], or the default
// id R-1 when the row is not sampleable; negative and past-the-slab ids
// are clamped to the default row. Same function as
// euler_tpu_torch/graph/device.py sample_neighbor.
//
// Rows: one warp loads one row into lane registers, lane j slots j,
// j+32, ... (T slots a lane), with coalesced loads (load_row).
//
// Two draws, one rule.
// - draw: one warp-uniform u against the row in registers: T ballots and
//   popcounts give the count, a register select plus one shuffle the
//   pick. It serves a warp that makes one draw (sample_fanout2's hop 1).
// - draw_row_out: the `count` draws of one row. The row goes to the
//   warp's slice of shared memory and the draws of a chunk of up to 32
//   run at once: each draw gets a group of g lanes (g = 32 / cnt rounded
//   down to a power of two), lane s of the group counts the slots with
//   u >= cum in the float4s s, s+g, ... of the row, and log2(g) xor
//   shuffles sum the group's counts. Slots past W hold NaN, which no u
//   reaches. The reads are broadcasts or g neighbouring float4s, so no
//   bank conflicts. A single draw (count 1) takes `draw` instead:
//   staging would only lengthen its chain. Either way the index is a
//   count, not a search, so the pick is the same for any row,
//   non-decreasing or not, and the same as the plain version's.
//
// Uniforms: Philox4x32-10 keyed by the two seed words, counter (row,
// column, hop, 0), first output word, top 24 bits times 2^-24: u < 1,
// exact in float32, independent of the launch geometry. The plain
// version computes the same numbers (graph/device.py philox_uniform).
// Build without --use_fast_math.
//
// The wide path: a slab wider than kMaxWidth (1,024 slots) has no room
// in the register layout. The TPU kernels stop at MAX_W = 512 and the
// JAX package draws wider slabs through its XLA chain
// (euler_tpu/graph/device.py sample_neighbor :454-500 and
// _sample_fanout2_route returning None, :959-1001); here wide_draws
// stands for that chain. A block of kWideThreads threads takes one row
// at a time: each thread streams its float4s t, t + 256, ... of the
// row's cum through its own slots of a kWideStages-deep shared-memory
// ring with cp.async (kWideStages - 1 copies in flight, so the loads of
// later tiles overlap the counting of earlier ones; a thread reads back
// only what it copied, so the stream needs no barrier), counts u >= cum
// for up to kWideDraws draws at once with their uniforms in registers,
// and the counts are summed by a warp reduction and across the block's
// warps in shared memory. Draw j's pick is then one read of
// nbr[row, min(count_j, W - 1)]: a count, not a search, as above.
// A row's float4s are read at 16-byte-aligned addresses; the first and
// last may hold slots of the next or previous row, which are masked to
// NaN (no u reaches it) and never leave the 16-byte block, so never the
// page, of an in-bounds slot.
//
// Bound of the wide path: the bytes of the rows it reads. Its work is
// one compare per (slot, draw) and a row's slots are read once for up to
// kWideDraws draws, so at the main paths' counts (<= 10) a row is read
// at HBM rate and compared in registers. Its design answers the bytes
// in two ways. (1) A row is counted over its first deg[row] slots only
// (deg is the slab's "deg" column, which every slab carries).
// Precondition: every slot at or past deg[row] holds a cum that no
// uniform reaches (cum >= 1 or NaN, and u < 1), so the count over deg
// slots equals the count over W; build_adjacency pins padding cum to
// 1.0 and each row's last real slot to exactly 1.0, so every slab it
// makes, and the sharded routes' replicated slabs, meet it. On the
// heavy-tailed graphs a wide slab is for, that reads a median row of
// tens of slots instead of W.
// (2) The ring keeps three tiles of a row in flight per thread, 12 KB a
// block, so a few blocks an SM hold the card's memory pipe full.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace etpu {

constexpr unsigned kFull = 0xffffffffu;
// Widest slab the register layout holds: 32 slots per lane. Wider slabs
// take the wide path (wide_draws).
constexpr int kMaxWidth = 32 * 32;
// Warps in a block of either kernel (256 threads).
constexpr int kWarpsPerBlock = 8;
// The wide path: threads of the block that draws from one row, depth of
// each thread's cp.async ring, and the most draws one pass over a row
// counts (more draws take more passes).
constexpr int kWideThreads = 32 * kWarpsPerBlock;
constexpr int kWideStages = 4;
constexpr int kWideDraws = 32;

// Dynamic shared memory of a block at T slots a lane: each warp's staged
// row, 32T cum then 32T nbr (64 KB at T = 32).
template <int T>
constexpr int stage_bytes() {
  return kWarpsPerBlock * 32 * T * 8;
}

// Warp `warp`'s slice of the block's dynamic shared memory.
template <int T>
__device__ __forceinline__ void* warp_stage(void* smem, int warp) {
  return static_cast<char*>(smem) + static_cast<size_t>(warp) * 32 * T * 8;
}

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

// The uniform at injected u[at], or Philox (row, col, hop, 0).
__device__ __forceinline__ float uniform_at(const float* __restrict__ u,
                                            long long at, uint32_t k0,
                                            uint32_t k1, uint32_t row,
                                            uint32_t col, uint32_t hop) {
  return u ? u[at] : philox_uniform(k0, k1, row, col, hop);
}

// Lane j < min(32, count - c0): the uniform of draw c0 + j of global row
// grow at hop `hop`, u[grow * count + c0 + j] or Philox (grow, c0 + j,
// hop, 0); other lanes 0.
__device__ __forceinline__ float chunk_uniform(const float* __restrict__ u,
                                               uint32_t k0, uint32_t k1,
                                               long long grow, int count,
                                               int c0, int hop, int lane) {
  return lane < min(32, count - c0)
             ? uniform_at(u, grow * count + c0 + lane, k0, k1,
                          static_cast<uint32_t>(grow),
                          static_cast<uint32_t>(c0 + lane),
                          static_cast<uint32_t>(hop))
             : 0.0f;
}

// `count` draws from the row in registers for global row `grow` of hop
// `hop`, written to out[grow * count + c]. Draw c's uniform is the
// injected u[grow * count + c] or Philox (grow, c, hop, 0); u0 holds the
// first chunk's, chunk_uniform(u, k0, k1, grow, count, 0, hop, lane),
// which a caller computes ahead so that its Philox rounds overlap the
// row's load. `stage` is the warp's slice of shared memory (warp_stage).
// A single draw takes the ballot: staging would only lengthen its chain.
template <int T>
__device__ __forceinline__ void draw_row_out(
    const float (&c)[T], const int (&n)[T], bool ok, int W, int R,
    int lane, long long grow, int count, int hop, uint32_t k0, uint32_t k1,
    const float* __restrict__ u, float u0, int* __restrict__ out,
    void* stage) {
  if (count == 1) {
    const int p = draw<T>(__shfl_sync(kFull, u0, 0), c, n, W, lane);
    if (lane == 0) out[grow] = ok ? p : R - 1;
    return;
  }
  float* sc = static_cast<float*>(stage);
  int* sn = reinterpret_cast<int*>(sc + 32 * T);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = lane + 32 * t;
    sc[col] = col < W ? c[t] : __int_as_float(0x7fc00000);  // NaN
    sn[col] = n[t];
  }
  __syncwarp();
  for (int c0 = 0; c0 < count; c0 += 32) {
    const int cnt = min(32, count - c0);
    const float my_u =
        c0 == 0 ? u0 : chunk_uniform(u, k0, k1, grow, count, c0, hop, lane);
    // g = 2^lg lanes a draw, g * cnt <= 32; lane = j * g + s
    const int lg = 5 - (32 - __clz(cnt - 1));
    const int j = lane >> lg, s = lane & ((1 << lg) - 1);
    const float uj = __shfl_sync(kFull, my_u, j);
    int idx = 0;
    if (j < cnt) {
      for (int k = 4 * s; k < W; k += 4 << lg) {
        const float4 q = *reinterpret_cast<const float4*>(sc + k);
        idx += (uj >= q.x) + (uj >= q.y) + (uj >= q.z) + (uj >= q.w);
      }
    }
    for (int o = 1; o < (1 << lg); o <<= 1)
      idx += __shfl_xor_sync(kFull, idx, o);
    if (j < cnt && s == 0)
      out[grow * count + c0 + j] = ok ? sn[min(idx, W - 1)] : R - 1;
  }
  __syncwarp();  // the slice may be staged again
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

// Launches `kernel` (instantiated at T) with one warp per work item,
// kWarpsPerBlock warps a block and stage_bytes<T>() of dynamic shared
// memory, first allowing the kernel that much where it passes the
// default 48 KB. Returns the first error: a refused launch never runs.
template <int T, class Kernel, class... Args>
cudaError_t launch_warps(Kernel* kernel, long long warps, cudaStream_t s,
                         Args... args) {
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr int bytes = stage_bytes<T>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, bytes, s>>>(
      args...);
  return cudaGetLastError();
}

// ---- the wide path ----

// A block's shared memory on the wide path: each thread's ring slots
// (ring[s][thread]), a pass's uniforms and each warp's partial counts.
struct WideSmem {
  float4 ring[kWideStages][kWideThreads];
  float u[kWideDraws];
  int part[kWarpsPerBlock][kWideDraws];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's counts c[j] = #(u[j] >= cum[k]) over its slots k < len of
// the row at row_cum: float4s t, t + kWideThreads, ... of the row,
// streamed through ring[.][t] kWideStages - 1 copies ahead. Slots outside
// [0, len) read as NaN.
template <int D>
__device__ __forceinline__ void wide_count(const float* row_cum, int len,
                                           const float (&u)[D],
                                           int (&c)[D],
                                           float4 (*ring)[kWideThreads]) {
  const int t = threadIdx.x;
  const uintptr_t a = reinterpret_cast<uintptr_t>(row_cum);
  const float4* q = reinterpret_cast<const float4*>(a & ~uintptr_t(15));
  const int lead = static_cast<int>((a & 15) >> 2);  // slots before the row
  const long long nq = (static_cast<long long>(lead) + len + 3) >> 2;
  const int mine =
      t < nq ? static_cast<int>((nq - 1 - t) / kWideThreads) + 1 : 0;
#pragma unroll
  for (int j = 0; j < D; ++j) c[j] = 0;
#pragma unroll
  for (int s = 0; s < kWideStages - 1; ++s) {
    if (s < mine)
      cp_async16(&ring[s][t], q + t + static_cast<long long>(s) * kWideThreads);
    cp_async_commit();
  }
  const float nan = __int_as_float(0x7fc00000);
  for (int k = 0; k < mine; ++k) {
    const int nk = k + kWideStages - 1;
    if (nk < mine)
      cp_async16(&ring[nk % kWideStages][t],
                 q + t + static_cast<long long>(nk) * kWideThreads);
    cp_async_commit();
    cp_async_wait<kWideStages - 1>();  // copy k has landed
    float4 x = ring[k % kWideStages][t];
    const long long s0 =
        4 * (t + static_cast<long long>(k) * kWideThreads) - lead;
    const auto in = [&](int e) {
      return static_cast<unsigned long long>(s0 + e) <
             static_cast<unsigned long long>(len);
    };
    x.x = in(0) ? x.x : nan;
    x.y = in(1) ? x.y : nan;
    x.z = in(2) ? x.z : nan;
    x.w = in(3) ? x.w : nan;
#pragma unroll
    for (int j = 0; j < D; ++j)
      c[j] += (u[j] >= x.x) + (u[j] >= x.y) + (u[j] >= x.z) + (u[j] >= x.w);
  }
  cp_async_wait<0>();  // the ring is free for the next pass
}

// Draws c0 .. c0 + min(D, count - c0) - 1 of global row grow at hop `hop`
// from slab row `row`, by the whole block: out[grow * count + c] =
// ok[row] ? nbr[row, min(#(u >= cum[row, :len]), W - 1)] : R - 1, with
// len = deg[row] clamped to [0, W]. Draw c's
// uniform is u[grow * count + c] or Philox (grow, c, hop, 0). Every thread
// of the block must call it; it ends on a barrier, so a caller may read
// the picks it wrote.
template <int D>
__device__ __forceinline__ void wide_draws(
    const int* __restrict__ nbr, const float* __restrict__ cum,
    const uint8_t* __restrict__ ok, const int* __restrict__ deg, int row,
    int W, int R, long long grow, int count, int c0, int hop, uint32_t k0,
    uint32_t k1, const float* __restrict__ u, int* __restrict__ out,
    WideSmem& sm) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cnt = min(D, count - c0);
  if (t < cnt)
    sm.u[t] = uniform_at(u, grow * count + c0 + t, k0, k1,
                         static_cast<uint32_t>(grow),
                         static_cast<uint32_t>(c0 + t),
                         static_cast<uint32_t>(hop));
  const size_t base = static_cast<size_t>(row) * W;
  const int len = min(max(deg[row], 0), W);
  __syncthreads();
  float uj[D];
  int c[D];
#pragma unroll
  for (int j = 0; j < D; ++j)
    uj[j] = j < cnt ? sm.u[j] : __int_as_float(0x7fc00000);
  wide_count<D>(cum + base, len, uj, c, sm.ring);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int s = __reduce_add_sync(kFull, c[j]);
    if (lane == 0) sm.part[warp][j] = s;
  }
  __syncthreads();
  if (t < cnt) {
    int idx = 0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) idx += sm.part[w][t];
    out[grow * count + c0 + t] =
        ok[row] != 0 ? nbr[base + min(idx, W - 1)] : R - 1;
  }
  __syncthreads();  // sm is free, and the picks are visible to the block
}

// Calls launch(std::integral_constant<int, D>{}) with the fewest draws a
// pass D in {1, 2, 4, 8, 16, 32} that cover `count` draws in one pass
// (32 when count is larger: more passes).
template <class Launch>
cudaError_t with_draws(int count, Launch&& launch) {
  if (count <= 1) return launch(std::integral_constant<int, 1>{});
  if (count <= 2) return launch(std::integral_constant<int, 2>{});
  if (count <= 4) return launch(std::integral_constant<int, 4>{});
  if (count <= 8) return launch(std::integral_constant<int, 8>{});
  if (count <= 16) return launch(std::integral_constant<int, 16>{});
  return launch(std::integral_constant<int, kWideDraws>{});
}

// Launches `kernel` with one block of kWideThreads threads per work item
// (the wide path). Returns the first error: a refused launch never runs.
template <class Kernel, class... Args>
cudaError_t launch_wide(Kernel* kernel, long long blocks, cudaStream_t s,
                        Args... args) {
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kWideThreads, 0, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace etpu
