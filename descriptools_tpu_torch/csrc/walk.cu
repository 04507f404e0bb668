// The D8 walks of the descriptor suite.
//
// downslope_walk_kernel<false> replaces
//   descriptools_tpu/ops/pallas/walk_vmem.py::_downslope_kernel
// downslope_walk_kernel<true> (truncation tracking) replaces
//   descriptools_tpu/ops/pallas/walk.py::_downslope_kernel and the trunc0
//   mode of walk_vmem.py::_downslope_kernel
// The jump walk (jump_start_kernel, then jump_round_kernel), launched as
// the flow walk, replaces
//   descriptools_tpu/ops/pallas/walk_vmem.py:264 _walk2_kernel
// and, launched as the absorbing walk, replaces
//   descriptools_tpu/ops/pallas/walk_vmem.py:704 _walk3_kernel and
//   descriptools_tpu/ops/pallas/walk.py:461 _walk3_kernel
//
// The TPU kernels advance every cell's walk one step per whole-grid sweep
// (vector selects over VMEM-resident bands), because the TPU has no cheap
// per-lane gather.  A Hopper thread can follow a pointer.  The downslope
// walks take one start cell per thread and follow its D8 path to its stop,
// the reference toolbox's own design: the first cell whose encoded
// elevation Zt is at or below the start's z - ed (the Jacobi lookahead's
// first hit, for any fdr, monotone or not).  Their stops depend on the
// start's own threshold, so a walk cannot reuse another's result.  One
// kernel serves every grid size: there is no VMEM tier, so the TPU's
// VMEM-resident and HBM-blocked kernels of one walk have one counterpart.
//
// Downslope bound: dependent loads.  Each step reads the current cell's
// direction and its successor's state (8 B, scattered), and the next step
// waits on them; a warp runs as long as its longest walk.  Neighbouring
// start cells share most of their path, so the reads mostly hit L1/L2.
//
// The jump walk (flow and absorbing walks): every cell's absorber (the
// first absorbing cell on its path) and its cardinal and diagonal step
// counts, or (UNRES, 0, 0) where none lies within max_steps steps.
//   Bound: 20 B per cell (fdr_eff and code0 read, code, a and b written).
//   What held the serial walk back: one thread per start cell walked its
//   whole path, O(N*L) dependent steps for N cells and paths of L steps
//   (6.2e9 on a 2178x1534 lateral channel with paths of up to 3710 steps),
//   neighbouring threads walking the same downstream cells again, each warp
//   as long as its longest walk.
//   The design: O(N log L) work, all on the device, no host read.
//   - Phase 1 (one launch, one thread per cell) walks at most
//     min(B, max_steps) steps.  A walk that lands, or that cannot go
//     on, is final: done[c] = -1.  Otherwise the cell is pending: its state
//     (the cell reached, its cardinal count) goes to buffer X, done[c] =
//     INT_MAX, and c is appended to a pending list through a
//     warp-aggregated atomicAdd, so a warp's cells stay contiguous there.
//   - R = ceil(log2(ceil(max_steps / B))) jump rounds, launched back
//     to back.  Each is a persistent grid that reads its list's length from
//     device memory, returns at once when it is 0, and walks the list with
//     a grid-stride loop.  Round k trusts only finals of earlier launches
//     (done[q] < k), so no read can see half a triple; a pending cell whose
//     target q is final lands or gives up; one whose target is still
//     pending jumps to q's target, doubling the steps it covers, and is
//     appended to the next list.  Every pending cell of round k covers
//     exactly B << k steps, so the diagonal count is that less the
//     cardinal one and X holds 8 B per cell.  The round whose jumps reach
//     max_steps (the last) gives up on every cell still walking.
//   - Counts are integers: any order of jumping gives the serial walk's
//     sums.  Nothing overflows for max_steps < 2^30 (the wrapper refuses
//     more).
//   B = kJumpB = 64.  On the H100, 32 and 64 were within the run-to-run
//   spread over the basin and the lateral channel, and 16 and 128 slower
//   (PERF.md); a sweep rebuilds with another value.
//
// Inputs are the walk operands built by the PyTorch wrappers
// (descriptools_tpu_torch/ops/cuda/walk.py): fdr_eff is 0 at every cell
// that stops a walk (terminal / absorbing), and every non-zero fdr_eff is
// a valid D8 code whose step stays inside the grid.

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "d8.cuh"
#include "grid.cuh"

namespace {

constexpr int kIncDiag = 1 << 16;  // packed count: diagonal steps in bits 16-31
// Terminals are encoded as Zt = z - 2^20, so Zt < -2^19 marks a terminal.
constexpr float kHalf = 524288.0f;

__device__ __forceinline__ bool cell_of_thread(int rows, int cols, int& idx) {
  const long long cell = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  idx = static_cast<int>(cell);
  return cell < static_cast<long long>(rows) * cols;
}

// Downslope: walk until zt0[cur] <= z0 - ed, or max_steps steps.  Writes the
// stop state (pk = packed cardinal/diagonal counts, Zt = zt0 at the stop).
// kTrack: also writes trunc = 1 where the walk stopped at a terminal that
// trunc0 marks (a block edge cut it).  The serial walk knows its stop cell,
// so the flag is read there directly: exact for fractional elevations too,
// where the TPU tiers' second Zt offset is exact only for integers.  A
// start that is itself a terminal stops at once and carries its own flag;
// a walk cut by the cap is exact and is not flagged.
template <bool kTrack>
__global__ void downslope_walk_kernel(const int* __restrict__ fdr_eff,
                                      const float* __restrict__ z,
                                      const float* __restrict__ zt0,
                                      const unsigned char* __restrict__ trunc0,
                                      int* __restrict__ pk_out,
                                      float* __restrict__ zt_out,
                                      unsigned char* __restrict__ trunc_out,
                                      int rows, int cols, float ed, int max_steps) {
  int idx;
  if (!cell_of_thread(rows, cols, idx)) return;
  const float thresh = z[idx] - ed;
  float zt = zt0[idx];
  int pk = 0;
  int cur = idx;
  if (!(zt <= thresh)) {  // a terminal start cell stops at once, pk = 0
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
  if constexpr (kTrack) {
    trunc_out[idx] = (zt <= thresh && zt < -kHalf && trunc0[cur] != 0) ? 1 : 0;
  }
}

// The jump walk's result for each cell: the absorber's code and the
// cardinal (a) and diagonal (b) step counts, or (UNRES, 0, 0) where no
// absorber lies within max_steps steps (cycles, over-long paths).  The flow
// walk and the absorbing walk differ only in their code0: the flow walk's
// is a river cell's flat index, -idx-1 at a NaN absorber; the local phase
// of a tile or shard (parallel/boundary.py) gives the absorber's local
// index at every absorbing cell (river, NaN and exit roles alike), the role
// riding a payload gathered afterwards.
//
// done[c]: -1 for a cell final after phase 1, k for one final in round k,
// INT_MAX while it is pending.  state[c] = (the cell reached, cardinal
// steps so far) of a pending cell.

constexpr int kDonePending = INT_MAX;
constexpr int kJumpB = 64;  // phase 1's steps (B)

// Append a slot to a list: one atomicAdd per warp for the lanes that call
// it together, the lanes taking consecutive slots.
__device__ __forceinline__ int append_slot(int* count) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(count, static_cast<int>(g.size()));
  return g.shfl(base, 0) + static_cast<int>(g.thread_rank());
}

// Phase 1: the serial walk, cut after kJumpB steps.
__global__ void jump_start_kernel(const int* __restrict__ fdr_eff,
                                  const int* __restrict__ code0,
                                  int* __restrict__ code_out, int* __restrict__ a_out,
                                  int* __restrict__ b_out, int* __restrict__ done,
                                  int2* __restrict__ state, int* __restrict__ list,
                                  int* __restrict__ count, int rows, int cols,
                                  int max_steps) {
  int idx;
  if (!cell_of_thread(rows, cols, idx)) return;
  const int limit = min(kJumpB, max_steps);
  int cur = idx;
  int code = code0[idx];
  int a = 0, b = 0, s = 0;
  for (; code == kUnres && s < limit; ++s) {
    int dy, dx;
    bool diag;
    if (!d8_step(fdr_eff[cur], dy, dx, diag)) break;  // stuck: never lands
    a += diag ? 0 : 1;
    b += diag ? 1 : 0;
    cur += dy * cols + dx;
    code = code0[cur];
  }
  // A stuck walk breaks with s < limit; one cut at max_steps has limit ==
  // max_steps.  Only a walk cut at kJumpB < max_steps goes on.
  if (code == kUnres && s == kJumpB && kJumpB < max_steps) {
    state[idx] = make_int2(cur, a);
    done[idx] = kDonePending;
    list[append_slot(count)] = idx;
    return;
  }
  if (code == kUnres) a = b = 0;
  code_out[idx] = code;
  a_out[idx] = a;
  b_out[idx] = b;
  done[idx] = -1;
}

// Jump round `round`: every cell of list_in covers `steps` = kJumpB << round
// steps, from state x.  Writes y, list_out, the outputs and done; reads the
// outputs only of cells final before this launch.  code_out, a_out, b_out
// and done are written in this launch, so they are read through plain
// (coherent) loads.
__global__ void jump_round_kernel(int* code_out, int* a_out, int* b_out, int* done,
                                  const int2* __restrict__ x, int2* __restrict__ y,
                                  const int* __restrict__ list_in,
                                  const int* __restrict__ count_in,
                                  int* __restrict__ list_out, int* __restrict__ count_out,
                                  int round, int steps, int max_steps) {
  const int n = *count_in;
  // The jump would cover 2 * steps >= max_steps: a cell whose target is
  // still walking has its absorber past the cap.  True in the last round
  // only (R is the least with kJumpB << R >= max_steps).
  const bool give_up = 2 * steps >= max_steps;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = list_in[i];
    const int2 sc = x[c];
    const int q = sc.x;
    const int a = sc.y, b = steps - sc.y;
    if (done[q] < round) {  // q was final before this launch
      const int code_q = code_out[q];
      const int a_q = a_out[q], b_q = b_out[q];
      const bool land = code_q != kUnres && steps + a_q + b_q <= max_steps;
      code_out[c] = land ? code_q : kUnres;
      a_out[c] = land ? a + a_q : 0;
      b_out[c] = land ? b + b_q : 0;
      done[c] = round;
    } else if (give_up) {
      code_out[c] = kUnres;
      a_out[c] = 0;
      b_out[c] = 0;
      done[c] = round;
    } else {  // q was pending at the start of this round: x[q] is its state
      const int2 sq = x[q];
      y[c] = make_int2(sq.x, a + sq.y);
      list_out[append_slot(count_out)] = c;
    }
  }
}

unsigned blocks_for(int rows, int cols, int threads) {
  const long long n = static_cast<long long>(rows) * cols;
  return static_cast<unsigned>((n + threads - 1) / threads);
}

constexpr int kThreads = 256;

// The least R with kJumpB << R >= max_steps.
int jump_rounds(int max_steps) {
  int r = 0;
  while ((static_cast<long long>(kJumpB) << r) < max_steps) ++r;
  return r;
}

// Blocks of a persistent round grid, computed once per device.
int round_blocks(int& blocks) {
  static int cached[64] = {};
  return persistent_blocks(jump_round_kernel, kThreads, cached, blocks);
}

}  // namespace

extern "C" int launch_downslope_walk(const int* fdr_eff, const float* z,
                                     const float* zt0, int* pk, float* zt,
                                     int rows, int cols, float ed, int max_steps,
                                     void* stream) {
  const unsigned blocks = blocks_for(rows, cols, kThreads);
  if (blocks == 0) return 0;
  downslope_walk_kernel<false><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fdr_eff, z, zt0, nullptr, pk, zt, nullptr, rows, cols, ed, max_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_downslope_walk_tracked(const int* fdr_eff, const float* z,
                                             const float* zt0,
                                             const unsigned char* trunc0, int* pk,
                                             float* zt, unsigned char* trunc,
                                             int rows, int cols, float ed,
                                             int max_steps, void* stream) {
  const unsigned blocks = blocks_for(rows, cols, kThreads);
  if (blocks == 0) return 0;
  downslope_walk_kernel<true><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fdr_eff, z, zt0, trunc0, pk, zt, trunc, rows, cols, ed, max_steps);
  return static_cast<int>(cudaGetLastError());
}

// Phase 1's steps (B), for the wrapper and the tests.
extern "C" int jump_walk_bound() { return kJumpB; }

// The whole jump walk on the stream, no host read: counts zeroed, phase 1,
// then R rounds, round k reading (state, list) k % 2 and writing the other
// pair.  Writes R to *rounds (host memory).  The in-core flow walk (K4) and
// the local phase of the tiled and sharded paths (K5/K8) both call it, each
// counted by its own wrapper.
//
// From the wrapper: counts, n_counts ints (counts[k] is the length of round
// k's list; R + 1 of them are used); scratch, 7n ints: state_x[2n],
// state_y[2n] (int2 each), done[n], list_x[n], list_y[n].
extern "C" int launch_jump_walk(const int* fdr_eff, const int* code0, int* code, int* a,
                                int* b, int* counts, int n_counts, int* scratch, int rows,
                                int cols, int max_steps, int* rounds, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int r = jump_rounds(max_steps);
  *rounds = r;
  if (r + 1 > n_counts) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(rows) * cols;
  if (n == 0) return 0;
  int2* state[2] = {reinterpret_cast<int2*>(scratch), reinterpret_cast<int2*>(scratch + 2 * n)};
  int* done = scratch + 4 * n;
  int* list[2] = {done + n, done + 2 * n};
  int blocks = 0;
  int err = round_blocks(blocks);
  if (err != 0) return err;
  cudaError_t e = cudaMemsetAsync(counts, 0, (r + 1) * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  jump_start_kernel<<<blocks_for(rows, cols, kThreads), kThreads, 0, stream>>>(
      fdr_eff, code0, code, a, b, done, state[0], list[0], counts, rows, cols, max_steps);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  for (int k = 0; k < r; ++k) {
    jump_round_kernel<<<blocks, kThreads, 0, stream>>>(
        code, a, b, done, state[k % 2], state[(k + 1) % 2], list[k % 2], counts + k,
        list[(k + 1) % 2], counts + k + 1, k, kJumpB << k, max_steps);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
