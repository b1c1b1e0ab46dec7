// An empty kernel, for measuring only: no path of the port calls it.
//
// Its event-timed duration at a kernel's grid is the least that any
// launch at that grid takes under the same timer (chip_smoke.py cuda_ms:
// the device time between two events, launch gap included), so a draw
// kernel's time is read against it beside its byte bound. The grid comes
// from the warp count and draw.cuh's kWarpsPerBlock, as the draw
// kernels' own (launch_warps) does.

#include "draw.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int etpu_launch_floor(int warps, void* stream) {
  const int per_block = etpu::kWarpsPerBlock;
  if (warps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<(warps + per_block - 1) / per_block, 32 * per_block, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
