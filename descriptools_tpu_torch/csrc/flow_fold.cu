// The blocked flow walk as an anchored fold.
//
// The anchored fold (fold_start_kernel, band_histogram_kernel,
// band_scan_kernel, band_scatter_kernel, fold_round_kernel, after the jump
// walk of walk.cu) replaces
//   descriptools_tpu/ops/pallas/walk.py:375 _flow_kernel (via _flow_sweeps
//   and flow_pallas), the JAX package's flow walk for grids above the VMEM
//   budget.
//
// What it computes.  Every cell's (code, dist): the code of the absorber its
// D8 path reaches, and dist, the RIGHT FOLD of the f32 step lengths along
// that path, s_0 + (s_1 + (... + (s_{t-1} + 0))) for a path of t steps;
// (UNRES, 0) where no absorber lies within max_steps steps.  This is what
// the TPU kernel's frontier sweeps form (a cell takes stepd + its
// successor's dist when the successor resolves), and the plain engine
// descriptools_tpu_torch/ops/flow.py::fold_walk.  Float addition does not
// reassociate, so the counts of the jump walk (a * c_card + b * c_diag) and
// its pointer jumping (sums in another tree) cannot give it bit for bit.
//
// The fold can be cut at any cell q of the path: with q m steps
// downstream of c, d_c = s_0 + (s_1 + (... + (s_{m-1} + d_q))), d_q being
// q's own right fold.  So a cell needs only the kinds of its first m steps
// (one bit each: diagonal or not) and d_q, once d_q is final.  With W =
// kFoldW = 64 the kinds of up to W steps fit one uint64.
//
// Design, all queued on the caller's stream by one C call, with one host
// read:
//   1. The jump walk (walk.cu, launch_jump_walk) gives every cell's code and
//      depth t = a + b, bitwise the serial walk, with no host read.  It
//      lands exactly the cells with t <= max_steps, as fold_walk does.
//   2. Fold start, one thread a cell.  An absorber keeps (code0, 0), a cell
//      the jump walk left UNRES gets (UNRES, 0); the jump walk wrote both
//      codes, so only dist is written here.  Any other cell walks m =
//      ((t - 1) mod W) + 1 steps, recording their kinds, to its anchor q at
//      depth t - m, a multiple of W.  If t <= W, q is the absorber and dist
//      is written now; otherwise the cell is pending in band k = (t - 1) /
//      W: its (q, kinds) are kept and it joins a list through a
//      warp-aggregated slot, and K, the largest band, rises by atomicMax.
//   3. One host read: the pending count P and K (8 B).  P = 0 ends the call.
//   4. A counting sort of the list by band: a histogram over K bins
//      (warp-aggregated with __match_any_sync: a warp's cells are
//      consecutive on a row and mostly share one or two bands), an
//      exclusive scan in one block, a scatter into band segments.
//   5. Rounds k = 1 .. K, queued with no further host read.  Round k folds
//      band k's segment (bounds read on the device): dist[c] = fold(kinds,
//      m, dist[q]).  q lies at depth W * k, in band k - 1, written by round
//      k - 1 (or by the fold start when k = 1): always by an earlier
//      launch, so no cell reads a value written in its own launch.
//
// Bound: 16 B a cell (fdr_eff and code0 read, code and dist written).  The
// jump walk moves 20 B a cell and more on long walks (walk.cu); the fold
// start reads code, a, b and fdr_eff and writes dist (20 B a cell), all
// issued at once, then walks at most W dependent steps a cell (t steps for
// a cell of depth t <= W, about W / 2 on average beyond), reading fdr_eff
// along the path, mostly from L1/L2 since neighbouring cells share their
// paths.  The sort and the rounds cost O(P); each round is one launch, so K
// launches of a few microseconds bound the deep cases (a path of L steps
// gives K = (L - 1) / W rounds).  Scratch: the jump walk's 28 B a cell, reused by the fold
// (20 B a cell) once the jump walk is done, and its a and b (8 B).
//
// The fold is additions only, in fold_walk's order, so no contraction can
// arise; the library builds with -fmad=false all the same.  c_card and
// c_diag come from the host, formed as f32(step) * f32(px) exactly as the
// plain engine forms them.

#include <cuda_runtime.h>

#include <cstdint>

#include "d8.cuh"
#include "grid.cuh"

// The jump walk (walk.cu), linked into the same library.
extern "C" int launch_jump_walk(const int* fdr_eff, const int* code0, int* code, int* a,
                                int* b, int* counts, int n_counts, int* scratch, int rows,
                                int cols, int max_steps, int* rounds, void* stream_ptr);

namespace {

constexpr int kFoldW = 64;  // steps of one band: their kinds fill one uint64
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kFoldW <= 64, "a band's step kinds fit one uint64");
static_assert(kThreads % 32 == 0 && kScanThreads % 32 == 0, "whole warps");

// The right fold of the m steps whose kinds are in bits (bit j: step j is
// diagonal) onto acc: for j = m - 1 down to 0, acc = stepd_j + acc.
__device__ __forceinline__ float fold(uint64_t bits, int m, float acc, float c_card,
                                     float c_diag) {
  for (int j = m - 1; j >= 0; --j) acc = (((bits >> j) & 1u) ? c_diag : c_card) + acc;
  return acc;
}

// A cell's band: (t - 1) / kFoldW for its depth t = a + b >= 1.
__device__ __forceinline__ int band_of(const int* a, const int* b, int c) {
  return (a[c] + b[c] - 1) / kFoldW;
}

// Step 2.  The jump walk gave an absorber its code0 and depth 0, and a
// cell that lands only after a step, so (code, t) alone tell the three
// kinds of cell apart; the cell's four words are loaded together, the walk's
// first step among them.  Every thread of every warp reaches the warp-wide
// calls at the end (no early return), so they may name all 32 lanes.
// header[0] counts the pending list, header[1] holds K.
__global__ void fold_start_kernel(const int* __restrict__ fdr_eff, const int* __restrict__ code,
                                  const int* __restrict__ a, const int* __restrict__ b,
                                  float* __restrict__ dist, int* __restrict__ anchor,
                                  uint64_t* __restrict__ kinds, int* __restrict__ list,
                                  int* __restrict__ header, int rows, int cols, float c_card,
                                  float c_diag) {
  const long long cell = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int c = static_cast<int>(cell);
  bool pending = false;
  int band = 0;
  if (cell < static_cast<long long>(rows) * cols) {
    const int t = a[c] + b[c];
    const bool landed = code[c] != kUnres;
    int dir = fdr_eff[c];
    if (!landed || t == 0) {
      dist[c] = 0.0f;  // a walk that never lands, or an absorber
    } else {
      const int m = (t - 1) % kFoldW + 1;
      uint64_t bits = 0;
      int q = c;
      for (int j = 0; j < m; ++j) {
        int dy = 0, dx = 0;
        bool diag = false;
        d8_step(dir, dy, dx, diag);  // valid: q walks on to its absorber
        bits |= static_cast<uint64_t>(diag) << j;
        q += dy * cols + dx;
        if (j + 1 < m) dir = fdr_eff[q];
      }
      if (t <= kFoldW) {
        dist[c] = fold(bits, m, 0.0f, c_card, c_diag);  // q is the absorber
      } else {
        anchor[c] = q;
        kinds[c] = bits;
        pending = true;
        band = (t - 1) / kFoldW;
      }
    }
  }
  const unsigned lanes = __ballot_sync(kFull, pending);
  const int kmax = __reduce_max_sync(kFull, band);
  if (lanes == 0) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(lanes) - 1;
  int base = 0;
  if (lane == leader) {
    base = atomicAdd(&header[0], __popc(lanes));
    atomicMax(&header[1], kmax);
  }
  base = __shfl_sync(kFull, base, leader);
  if (pending) list[base + __popc(lanes & ((1u << lane) - 1u))] = c;
}

// Step 4a: hist[k - 1] += the cells of band k, one atomicAdd per band per
// warp.
__global__ void band_histogram_kernel(const int* __restrict__ list, int n_list,
                                      const int* __restrict__ a, const int* __restrict__ b,
                                      int* __restrict__ hist) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned active = __ballot_sync(kFull, i < n_list);
  if (i >= n_list) return;
  const int band = band_of(a, b, list[i]);
  const unsigned peers = __match_any_sync(active, band);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[band - 1], __popc(peers));
}

// Step 4b, one block: offsets[j] = hist[0] + ... + hist[j - 1] for j = 0 ..
// K, and hist[j] becomes the scatter's cursor, offsets[j].
__global__ void band_scan_kernel(int* __restrict__ hist, int* __restrict__ offsets, int k) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < k; base += kScanThreads) {
    const int j = base + tid;
    const int v = j < k ? hist[j] : 0;
    int incl = v;  // inclusive scan within the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // scan of the warp totals
      int w = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += up;
      }
      if (lane < kScanThreads / 32) warp_sums[lane] = w;
    }
    __syncthreads();
    const int excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + incl - v;
    if (j < k) {
      offsets[j] = excl;
      hist[j] = excl;
    }
    __syncthreads();  // every thread has read carry and warp_sums
    if (tid == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (tid == 0) offsets[k] = carry;
}

// Step 4c: each listed cell to its band's segment; a warp's cells of one
// band take consecutive slots.
__global__ void band_scatter_kernel(const int* __restrict__ list, int n_list,
                                    const int* __restrict__ a, const int* __restrict__ b,
                                    int* __restrict__ cursor, int* __restrict__ sorted) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned active = __ballot_sync(kFull, i < n_list);
  if (i >= n_list) return;
  const int c = list[i];
  const int band = band_of(a, b, c);
  const unsigned peers = __match_any_sync(active, band);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&cursor[band - 1], __popc(peers));
  base = __shfl_sync(peers, base, leader);
  sorted[base + __popc(peers & ((1u << lane) - 1u))] = c;
}

// Step 5, round k: fold band k's cells onto their anchors (band k - 1,
// final since an earlier launch).  dist is written in this launch, so it is
// read through plain loads.
__global__ void fold_round_kernel(float* dist, const int* __restrict__ sorted,
                                  const int* __restrict__ offsets, const int* __restrict__ anchor,
                                  const uint64_t* __restrict__ kinds, const int* __restrict__ a,
                                  const int* __restrict__ b, float c_card, float c_diag, int k) {
  const int lo = offsets[k - 1], hi = offsets[k];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = lo + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < hi;
       i += stride) {
    const int c = sorted[i];
    const int m = (a[c] + b[c] - 1) % kFoldW + 1;
    dist[c] = fold(kinds[c], m, dist[anchor[c]], c_card, c_diag);
  }
}

// Blocks of a persistent round grid, computed once per device.
int round_blocks(int& blocks) {
  static int cached[64] = {};
  return persistent_blocks(fold_round_kernel, kThreads, cached, blocks);
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// W, the steps of one band, for the wrapper and the tests.
extern "C" int fold_band_width() { return kFoldW; }

// The whole blocked walk: the jump walk, the fold start, one host read
// (P and K), the counting sort and K rounds; the result lands in (code,
// dist).  From the wrapper: a and b (the jump walk's step counts, scratch
// here); jump_counts (n_jump_counts ints) and scratch (7n ints) as
// launch_jump_walk takes them; bands, n_bands >= 2 + 2 * K_cap + 1 ints
// with K_cap = (min(max_steps, n) - 1) / W, the largest band any cell can
// reach.  info (host) gets {R, P, K}.  Synchronises the stream once.
extern "C" int launch_flow_walk_blocked(const int* fdr_eff, const int* code0, int* code,
                                        float* dist, int* a, int* b, int* jump_counts,
                                        int n_jump_counts, int* scratch, int* bands,
                                        int n_bands, int rows, int cols, float c_card,
                                        float c_diag, int max_steps, int* info,
                                        void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  info[0] = info[1] = info[2] = 0;
  const long long n = static_cast<long long>(rows) * cols;
  const long long reach = max_steps < n ? max_steps : n;
  const long long k_cap = reach > 0 ? (reach - 1) / kFoldW : 0;
  if (static_cast<long long>(n_bands) < 2 + 2 * k_cap + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = launch_jump_walk(fdr_eff, code0, code, a, b, jump_counts, n_jump_counts, scratch,
                             rows, cols, max_steps, &info[0], stream_ptr);
  if (err != 0 || n == 0) return err;
  // The fold's scratch takes the jump walk's, which is done with it by the
  // time the fold start runs (stream order): kinds (2n ints, 8-byte
  // aligned at the start), anchor, list and sorted (n each).
  uint64_t* kinds = reinterpret_cast<uint64_t*>(scratch);
  int* anchor = scratch + 2 * n;
  int* list = scratch + 3 * n;
  int* sorted = scratch + 4 * n;
  int* header = bands;               // [P, K]
  int* hist = bands + 2;             // K_cap bins, then the scatter's cursors
  int* offsets = hist + k_cap;       // K_cap + 1
  cudaError_t e = cudaMemsetAsync(header, 0, (2 + k_cap) * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  fold_start_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      fdr_eff, code, a, b, dist, anchor, kinds, list, header, rows, cols, c_card, c_diag);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  int read[2] = {0, 0};
  e = cudaMemcpyAsync(read, header, sizeof(read), cudaMemcpyDeviceToHost, stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pending = read[0], k = read[1];
  info[1] = pending;
  info[2] = k;
  if (pending == 0) return 0;
  if (k < 1 || k > k_cap) return static_cast<int>(cudaErrorInvalidValue);
  band_histogram_kernel<<<blocks_for(pending), kThreads, 0, stream>>>(list, pending, a, b, hist);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  band_scan_kernel<<<1, kScanThreads, 0, stream>>>(hist, offsets, k);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  band_scatter_kernel<<<blocks_for(pending), kThreads, 0, stream>>>(list, pending, a, b, hist,
                                                                     sorted);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  if ((err = round_blocks(blocks)) != 0) return err;
  const unsigned need = blocks_for(pending);
  const unsigned grid = need < static_cast<unsigned>(blocks) ? need : blocks;
  for (int r = 1; r <= k; ++r) {
    fold_round_kernel<<<grid, kThreads, 0, stream>>>(dist, sorted, offsets, anchor, kinds, a, b,
                                                     c_card, c_diag, r);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
