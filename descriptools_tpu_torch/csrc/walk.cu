// The two D8 walks of the descriptor suite, one serial walk per thread.
//
// downslope_walk_kernel replaces
//   descriptools_tpu/ops/pallas/walk_vmem.py::_downslope_kernel
// flow_walk_kernel replaces
//   descriptools_tpu/ops/pallas/walk_vmem.py::_walk2_kernel
//
// The TPU kernels advance every cell's walk one step per whole-grid sweep
// (vector selects over VMEM-resident bands), because the TPU has no cheap
// per-lane gather.  A Hopper thread can follow a pointer, so each thread
// here takes one start cell and follows its D8 path to its stop, which is
// the reference toolbox's own design.  The result is the same fixed point:
// the downslope walk stops at the first cell whose encoded elevation Zt is
// at or below the start's z - ed (the Jacobi lookahead's first hit, for any
// fdr, monotone or not); the flow walk stops at the first absorbing cell.
//
// Bound: dependent loads.  Each step reads the current cell's direction
// and its successor's state (8 B, scattered), and the next step waits on
// them; a warp runs as long as its longest walk.  Neighbouring start cells
// share most of their path, so the reads mostly hit L1/L2.  No shared
// memory, no atomics; the walks are independent.
//
// Inputs are the walk operands built by the PyTorch wrappers
// (descriptools_tpu_torch/ops/cuda/walk.py): fdr_eff is 0 at every cell
// that stops a walk (terminal / absorbing), and every non-zero fdr_eff is
// a valid D8 code whose step stays inside the grid.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kIncDiag = 1 << 16;  // packed count: diagonal steps in bits 16-31
constexpr int kUnres = INT_MIN;    // flow code of a walk that found no absorber

// ESRI D8 code -> (dy, dx, diagonal?); false for 0 / invalid codes.
__device__ __forceinline__ bool d8_step(int code, int& dy, int& dx, bool& diag) {
  switch (code) {
    case 1: dy = 0; dx = 1; diag = false; return true;     // E
    case 2: dy = 1; dx = 1; diag = true; return true;      // SE
    case 4: dy = 1; dx = 0; diag = false; return true;     // S
    case 8: dy = 1; dx = -1; diag = true; return true;     // SW
    case 16: dy = 0; dx = -1; diag = false; return true;   // W
    case 32: dy = -1; dx = -1; diag = true; return true;   // NW
    case 64: dy = -1; dx = 0; diag = false; return true;   // N
    case 128: dy = -1; dx = 1; diag = true; return true;   // NE
    default: return false;
  }
}

__device__ __forceinline__ bool cell_of_thread(int rows, int cols, int& idx) {
  const long long cell = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  idx = static_cast<int>(cell);
  return cell < static_cast<long long>(rows) * cols;
}

// Downslope: walk until zt0[cur] <= z0 - ed, or max_steps steps.  Writes the
// stop state (pk = packed cardinal/diagonal counts, Zt = zt0 at the stop).
__global__ void downslope_walk_kernel(const int* __restrict__ fdr_eff,
                                      const float* __restrict__ z,
                                      const float* __restrict__ zt0,
                                      int* __restrict__ pk_out,
                                      float* __restrict__ zt_out, int rows,
                                      int cols, float ed, int max_steps) {
  int idx;
  if (!cell_of_thread(rows, cols, idx)) return;
  const float thresh = z[idx] - ed;
  float zt = zt0[idx];
  int pk = 0;
  if (!(zt <= thresh)) {  // a terminal start cell stops at once, pk = 0
    int cur = idx;
    for (int s = 0; s < max_steps; ++s) {
      int dy, dx;
      bool diag;
      // A terminal that did not stop the walk holds still for good: the
      // lookahead's state would stay (pk, Zt) to the cap.
      if (!d8_step(fdr_eff[cur], dy, dx, diag)) break;
      pk += diag ? kIncDiag : 1;
      cur += dy * cols + dx;
      zt = zt0[cur];
      if (zt <= thresh) break;
    }
  }
  pk_out[idx] = pk;
  zt_out[idx] = zt;
}

// Flow: walk until an absorbing cell (code0 != UNRES), or give up after
// max_steps steps.  Writes the absorber's code and the cardinal (a) and
// diagonal (b) step counts, or (UNRES, 0, 0) where no absorber was reached
// within max_steps (cycles, over-long paths).  a and b are separate 32-bit
// counts: no path length can overflow them.
__global__ void flow_walk_kernel(const int* __restrict__ fdr_eff,
                                 const int* __restrict__ code0,
                                 int* __restrict__ code_out,
                                 int* __restrict__ a_out,
                                 int* __restrict__ b_out, int rows, int cols,
                                 int max_steps) {
  int idx;
  if (!cell_of_thread(rows, cols, idx)) return;
  int cur = idx;
  int code = code0[idx];
  int a = 0, b = 0;
  for (int s = 0; code == kUnres && s < max_steps; ++s) {
    int dy, dx;
    bool diag;
    if (!d8_step(fdr_eff[cur], dy, dx, diag)) break;
    a += diag ? 0 : 1;
    b += diag ? 1 : 0;
    cur += dy * cols + dx;
    code = code0[cur];
  }
  if (code == kUnres) a = b = 0;
  code_out[idx] = code;
  a_out[idx] = a;
  b_out[idx] = b;
}

unsigned blocks_for(int rows, int cols, int threads) {
  const long long n = static_cast<long long>(rows) * cols;
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

extern "C" int launch_downslope_walk(const int* fdr_eff, const float* z,
                                     const float* zt0, int* pk, float* zt,
                                     int rows, int cols, float ed, int max_steps,
                                     void* stream) {
  const int threads = 256;
  const unsigned blocks = blocks_for(rows, cols, threads);
  if (blocks == 0) return 0;
  downslope_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      fdr_eff, z, zt0, pk, zt, rows, cols, ed, max_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_flow_walk(const int* fdr_eff, const int* code0, int* code,
                                int* a, int* b, int rows, int cols, int max_steps,
                                void* stream) {
  const int threads = 256;
  const unsigned blocks = blocks_for(rows, cols, threads);
  if (blocks == 0) return 0;
  flow_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      fdr_eff, code0, code, a, b, rows, cols, max_steps);
  return static_cast<int>(cudaGetLastError());
}
