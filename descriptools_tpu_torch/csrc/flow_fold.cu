// The blocked flow walk: frontier sweeps in shared-memory tiles.
//
// flow_fold_kernel replaces
//   descriptools_tpu/ops/pallas/walk.py::_flow_kernel (via _flow_sweeps and
//   flow_pallas), the JAX package's flow walk for grids above the VMEM
//   budget.
//
// What it computes.  Every cell's (code, dist): the code of the absorber its
// D8 path reaches, and dist, the RIGHT FOLD of the f32 step lengths along
// that path, stepd[c0] + (stepd[c1] + (... + (stepd[c_last] + 0))).  Sweep s
// (from 0, gated by s < max_steps) resolves every UNRES cell whose
// successor is resolved: it takes the successor's code and stepd + the
// successor's dist.  A cell at depth d resolves at sweep d - 1.  The
// per-thread serial walk of walk.cu cannot form this fold without the path's
// step kinds in reverse order, and successor doubling sums in another tree,
// so neither gives the JAX blocked tier's fdist bit for bit.
//
// Design (a): shared-memory frontier tiles, the Hopper analogue of the TPU
// kernel's VMEM windows.  Each block owns a kTile x kTile interior and loads
// it with a kHalo-cell halo (a kWin x kWin window) of step targets, codes
// and distances into shared memory.  It then runs up to kHalo synchronous
// sweeps there: values move one cell per sweep, so after kHalo sweeps the
// interior is exactly what kHalo sweeps of the whole grid give, and the
// interior goes back to device memory.  A window cell whose successor lies
// outside the window never resolves inside the window (the TPU kernel reads
// wrapped garbage there instead); either way the halo keeps it from the
// interior.  The host launches again until a launch resolves nothing, or
// until max_steps sweeps are done, reading one device counter per launch,
// so there is no limit on max_steps.  The result is exactly the plain
// engine's (descriptools_tpu_torch/ops/flow.py::fold_walk).
//
// Each launch reads one state buffer and writes the other (ping-pong), so a
// launch is exactly kHalo global sweeps whatever order the blocks run in.
// Skips, both exact:
// - a sweep that resolves nothing in the window ends the block's sweeps:
//   the window is isolated during a launch, so it is at its fixed point;
// - a block is active in a launch only if some block of its 3x3
//   neighbourhood resolved a cell in the previous launch (every block is
//   active in the first).  A cell can only resolve once its successor has,
//   and a successor resolved two or more launches ago has already resolved
//   its predecessors (they are in its own block or a neighbour, which was
//   active then); so an inactive block has no resolvable cell within its
//   window and its interior stays as it is.  It writes nothing: its own
//   interior did not change in the previous launch either, so the buffer it
//   would write, which holds the state from two launches back, is current.
//
// Bound: on short walks, the one or two full-grid launches (each reads
// about 12 B per window cell and writes 8 B per interior cell); on long
// walks, one launch per kHalo steps of the longest walk, each costing a
// launch, a 4-byte read-back and a stream synchronisation, with only the
// blocks near the frontier doing sweeps.  Each sweep is two shared-memory
// passes split by barriers: the first marks the cells that resolve, the
// second writes them (a cell that resolves reads a successor resolved before
// the sweep, which no thread writes in that sweep, so there is no race).
//
// The fold is additions only (dist = stepd + p_dist), so no contraction can
// arise; the library builds with -fmad=false all the same.  c_card and
// c_diag come from the host, formed as f32(step) * f32(px) exactly as the
// plain engine forms them.

#include <cuda_runtime.h>

#include <cstdint>

#include "d8.cuh"

namespace {

constexpr int kTile = 64;        // interior side of a block
constexpr int kHalo = 16;        // halo width = sweeps per launch (< kTile)
constexpr int kWin = kTile + 2 * kHalo;
constexpr int kWinCells = kWin * kWin;
constexpr int kThreads = 512;
constexpr int kCellsPerThread = kWinCells / kThreads;
constexpr uint16_t kNoPull = 0xFFFF;  // no successor inside the window
constexpr uint16_t kDiagBit = 0x8000;
constexpr size_t kSmemBytes =
    static_cast<size_t>(kWinCells) * (sizeof(int) + sizeof(float) + sizeof(uint16_t));

static_assert(kWinCells % kThreads == 0, "every thread owns the same number of window cells");
static_assert(kCellsPerThread <= 32, "the per-thread hit mask is 32 bits");
static_assert(kWinCells < kDiagBit, "window indices fit below the diagonal bit");
static_assert(kHalo < kTile, "a resolved successor stays within the 3x3 block neighbourhood");

// One launch: up to kHalo sweeps (global sweeps t0 .. t0 + kHalo - 1) from
// (code_in, dist_in) into (code_out, dist_out).  changed_prev / changed_cur:
// one flag per block, "its interior resolved a cell" in the previous / this
// launch; n_changed counts the blocks that set theirs.
__global__ void __launch_bounds__(kThreads, 2)
flow_fold_kernel(const int* __restrict__ fdr_eff, const int* __restrict__ code_in,
                 const float* __restrict__ dist_in, int* __restrict__ code_out,
                 float* __restrict__ dist_out, const int* __restrict__ changed_prev,
                 int* __restrict__ changed_cur, int* __restrict__ n_changed, int rows,
                 int cols, float c_card, float c_diag, int t0, int max_steps, int first) {
  extern __shared__ unsigned char smem[];
  int* s_code = reinterpret_cast<int*>(smem);
  float* s_dist = reinterpret_cast<float*>(s_code + kWinCells);
  uint16_t* s_next = reinterpret_cast<uint16_t*>(s_dist + kWinCells);

  const int tid = threadIdx.x;
  const int bx = blockIdx.x, by = blockIdx.y;
  const int nbx = gridDim.x, nby = gridDim.y;
  const int block = by * nbx + bx;
  const int row0 = by * kTile, col0 = bx * kTile;  // interior origin

  bool active = first != 0;
  if (!active) {
    for (int y = max(by - 1, 0); y <= min(by + 1, nby - 1); ++y)
      for (int x = max(bx - 1, 0); x <= min(bx + 1, nbx - 1); ++x)
        active = active || changed_prev[y * nbx + x] != 0;
  }
  if (!active) {  // uniform across the block: no barrier is skipped unevenly
    if (tid == 0) changed_cur[block] = 0;
    return;
  }

  // Load the window.  Cells off the grid are inert: resolved, no successor.
  for (int w = tid; w < kWinCells; w += kThreads) {
    const int wr = w / kWin, wc = w % kWin;
    const int r = row0 - kHalo + wr, c = col0 - kHalo + wc;
    int code = -1;
    float dist = 0.0f;
    uint16_t next = kNoPull;
    if (r >= 0 && r < rows && c >= 0 && c < cols) {
      const long long g = static_cast<long long>(r) * cols + c;
      code = code_in[g];
      dist = dist_in[g];
      int dy, dx;
      bool diag;
      if (d8_step(fdr_eff[g], dy, dx, diag)) {
        const int nr = wr + dy, nc = wc + dx;
        if (nr >= 0 && nr < kWin && nc >= 0 && nc < kWin) {
          next = static_cast<uint16_t>((nr * kWin + nc) | (diag ? kDiagBit : 0));
        }
      }
    }
    s_code[w] = code;
    s_dist[w] = dist;
    s_next[w] = next;
  }
  __syncthreads();

  bool interior_hit = false;
  for (int k = 0; k < kHalo && t0 + k < max_steps; ++k) {
    // Pass 1: which of my cells resolve in this sweep.
    unsigned hits = 0;
#pragma unroll
    for (int j = 0; j < kCellsPerThread; ++j) {
      const int w = tid + j * kThreads;
      const uint16_t next = s_next[w];
      if (s_code[w] == kUnres && next != kNoPull && s_code[next & ~kDiagBit] != kUnres) {
        hits |= 1u << j;
      }
    }
    __syncthreads();
    // Pass 2: write them.  Their successors were resolved before this sweep,
    // so no thread writes what another reads here.
#pragma unroll
    for (int j = 0; j < kCellsPerThread; ++j) {
      if (hits & (1u << j)) {
        const int w = tid + j * kThreads;
        const uint16_t next = s_next[w];
        const int p = next & ~kDiagBit;
        const float stepd = (next & kDiagBit) ? c_diag : c_card;
        s_dist[w] = stepd + s_dist[p];
        s_code[w] = s_code[p];
        const int wr = w / kWin, wc = w % kWin;
        interior_hit = interior_hit || (wr >= kHalo && wr < kHalo + kTile &&
                                        wc >= kHalo && wc < kHalo + kTile);
      }
    }
    if (!__syncthreads_or(hits != 0)) break;  // window at its fixed point
  }

  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int ir = i / kTile, ic = i % kTile;
    const int r = row0 + ir, c = col0 + ic;
    if (r < rows && c < cols) {
      const long long g = static_cast<long long>(r) * cols + c;
      const int w = (kHalo + ir) * kWin + kHalo + ic;
      code_out[g] = s_code[w];
      dist_out[g] = s_dist[w];
    }
  }
  const bool changed = __syncthreads_or(interior_hit);
  if (tid == 0) {
    changed_cur[block] = changed ? 1 : 0;
    if (changed) atomicAdd(n_changed, 1);
  }
}

}  // namespace

// The whole blocked walk: code <- code0, dist <- 0, then launches until one
// resolves nothing or max_steps sweeps are done; the result lands in
// (code, dist).  Scratch from the caller: (code_b, dist_b) of the grid's
// shape, and flags of at least 2 * blocks + 1 ints.  *launches gets the
// number of kernel launches.  Synchronises the stream once per launch.
extern "C" int launch_flow_walk_blocked(const int* fdr_eff, const int* code0, int* code,
                                        float* dist, int* code_b, float* dist_b, int* flags,
                                        int n_flags, int rows, int cols, float c_card,
                                        float c_diag, int max_steps, int* launches,
                                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  const long long n = static_cast<long long>(rows) * cols;
  if (n == 0) return 0;
  const int nbx = (cols + kTile - 1) / kTile, nby = (rows + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(nbx) * nby;
  if (static_cast<long long>(n_flags) < 2 * blocks + 1 || nby > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      flow_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyAsync(code, code0, n * sizeof(int), cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(dist, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  int* codes[2] = {code, code_b};
  float* dists[2] = {dist, dist_b};
  int* changed[2] = {flags, flags + blocks};
  int* n_changed = flags + 2 * blocks;
  int count = 0;  // launches made; launch l reads buffer l % 2, writes (l + 1) % 2
  for (int t0 = 0; t0 < max_steps; t0 += kHalo) {
    const int src = count % 2, dst = 1 - src;
    err = cudaMemsetAsync(n_changed, 0, sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    flow_fold_kernel<<<dim3(nbx, nby), kThreads, kSmemBytes, stream>>>(
        fdr_eff, codes[src], dists[src], codes[dst], dists[dst], changed[src], changed[dst],
        n_changed, rows, cols, c_card, c_diag, t0, max_steps, count == 0 ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++count;
    int resolved = 0;
    err = cudaMemcpyAsync(&resolved, n_changed, sizeof(int), cudaMemcpyDeviceToHost, stream);
    if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resolved == 0) break;
  }
  *launches = count;
  if (count % 2 == 1) {  // the last launch wrote (code_b, dist_b)
    err = cudaMemcpyAsync(code, code_b, n * sizeof(int), cudaMemcpyDeviceToDevice, stream);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(dist, dist_b, n * sizeof(float), cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
