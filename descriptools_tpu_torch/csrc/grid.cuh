// Launch geometry shared by the walk kernels (walk.cu, flow_fold.cu) and the
// accumulation's rounds (accumulation.cu).
#pragma once

#include <cuda_runtime.h>

// Blocks of a persistent grid of `kernel` at `threads` a block: as many as
// the card's SMs hold at once.  `cached` (one slot per device, 0 until
// known) keeps the answer for the caller's next launch.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int threads, int (&cached)[64], int& blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 64 && cached[device] > 0) {
    blocks = cached[device];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (device < 64) cached[device] = blocks;
  return 0;
}
