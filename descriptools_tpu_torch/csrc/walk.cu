// The D8 walks of the descriptor suite.
//
// downslope_kernel<false, Fdr> (entry launch_downslope) replaces
//   descriptools_tpu/ops/pallas/walk_vmem.py::_downslope_kernel
// downslope_kernel<true, Fdr> (truncation tracking, entry
// launch_downslope_tracked) replaces
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
// kernel takes one start cell per thread and follows its D8 path to its
// stop, the reference toolbox's own design: the first cell that is a
// terminal or whose elevation is at or below the start's z - ed (the Jacobi
// lookahead's first hit, for any fdr, monotone or not).  Its stops depend on the
// start's own threshold, so a walk cannot reuse another's result.  One
// kernel serves every grid size: there is no VMEM tier, so the TPU's
// VMEM-resident and HBM-blocked kernels of one walk have one counterpart.
//
// The downslope kernel: the whole downslope stage in one launch, from the
// raw rasters (dem as float32, fdr as uint8 or int32, read in its own type)
// to the downslope raster and, tracked, the truncation flag.
//   Bound: 9 B a cell (dem 4, fdr 1, downslope 4), 10 B a tracked interior
//   cell with the flag, each read or written once.
//   What held the operand-level kernel back: the stage built three operands
//   (fdr_eff, z, zt0; 12 B a cell) in some 40 torch launches and formed the
//   ratio in a torch post-pass, about 20x the walk's own time; and each step
//   waited on two loads, one after the other (fdr_eff at the cell, then zt0
//   at its successor).
//   The design:
//   - the terminal test formed on the fly (ops/downslope.py::
//     _terminal_and_step): p is terminal where its code is not one of the
//     8, its target lies outside the grid (tracked: the window), or z is
//     -100 at p or at its target; the walk stops there, and its result
//     reads z(p) as it is (a flag apart from the elevation, so fractional
//     elevations stay exact: the TPU kernels' terminal offset z - 2^20
//     rounds them to 1/16 m);
//   - one dependent load round a step: at p, with p's code decoded, the
//     thread loads z and fdr of p's successor together; that completes p's
//     terminal test and is the next step's operand;
//   - a branch-free decode (d8_decode): a table indexed by the code's bit,
//     with a test that the code is one of the 8;
//   - the post-pass in ops/downslope.py::downslope_from_state's order,
//     separate multiplies and an add (built with -fmad=false) and an IEEE
//     division, so the raster is bitwise the plain version's;
//   - a 2-D thread map, 32 columns x 8 rows a block: a warp starts on 32
//     neighbouring cells of a row and its successors fall in the block's
//     own rows +-1;
//   - tracked, only the window's interior is launched (the walk may read
//     the whole window) and the outputs are tile-sized; the flag is read at
//     the stop cell (ops/downslope.py::trunc_cells there, and "stopped at a
//     terminal").
//   Its work still follows the walks' lengths: a warp runs as long as its
//   longest walk.  Where every start walks far, instruction issue bounds
//   it, not the loads' latency (a 100-step ramp at 2178 x 1534 on an H100:
//   43 SASS instructions a step, issued at about 86 % of the card's rate),
//   so the loop is kept short: the row is tracked for the flag alone, a
//   cell reached by a step is never NoData (its predecessor was not
//   terminal), and the walk counts its steps and its diagonal steps and
//   packs them once, at the end.  Staging a block's tile in shared memory
//   and a step table in the kernel's parameters (indexed per lane, so
//   divergent on real terrain) were slower on the basin.
//
// The jump walk (flow and absorbing walks): every cell's absorber (the
// first absorbing cell on its path) and its cardinal and diagonal step
// counts, or (UNRES, 0, 0) where none lies within max_steps steps.
//   Bound: 20 B per cell (fdr_eff and code0 read, code, a and b written);
//   launched from the rasters (launch_flow_walk, below), 5 B read (fdr
//   int32 and river; 2 B with uint8 fdr) and the 12 B of (code, a, b)
//   written, which the finish reads again to write fdist and indices (8 B).
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
// Phase 1 reads its cells in one of two forms (the Cells parameter of
// jump_start_kernel; the rounds read neither):
// - OperandCells, launched by launch_jump_walk: the walk operands fdr_eff
//   and code0 that the caller built (descriptools_tpu_torch/ops/flow.py::
//   walk_inputs, or a block's local phase, parallel/boundary.py): code0 is
//   the absorber's code at every absorbing cell, and fdr_eff is 0 there
//   and a D8 code whose step stays inside the grid elsewhere;
// - RawCells, launched by launch_flow_walk (the in-core flow walk, K4):
//   fdr as given (uint8 or int32) and the river mask (one byte a cell).
//   The thread forms each cell's role itself, at its start cell and at
//   every cell it enters, by ops/flow.py::flow_states' truth table: fdr 0
//   is a NaN absorber (code -idx-1); a river cell (river == 1) with any
//   other fdr is a river absorber (code idx), whatever its code; a code
//   outside the D8 set, or a step off the grid, is a NaN absorber; every
//   other cell steps.  The walk keeps its row and column for the edge.
//   walk_inputs' operands are never formed: phase 1 reads 5 B a cell (2 B
//   with uint8 fdr) where the operands are 8.
// launch_flow_walk then forms fdist and indices in one more launch
// (flow_finish_kernel, ops/flow.py::flow_from_state in its order), so the
// in-core flow stage is one C entry: a memset, phase 1, R rounds and the
// finish, with no torch op between them.

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "d8.cuh"
#include "grid.cuh"

namespace {

constexpr int kIncDiag = 1 << 16;  // packed count: diagonal steps in bits 16-31
constexpr float kNoData = -100.0f;
constexpr int kBlockX = 32;  // a downslope block's columns: one warp along a row
constexpr int kBlockY = 8;   // a downslope block's rows

__device__ __forceinline__ bool cell_of_thread(int rows, int cols, int& idx) {
  const long long cell = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  idx = static_cast<int>(cell);
  return cell < static_cast<long long>(rows) * cols;
}

// The raster a downslope launch walks and the start cells it takes.
struct DownslopeGeometry {
  int win_rows, win_cols;    // the raster read: the grid, or a tile's window
  int rows, cols;            // the start cells: [halo, halo + rows) x [halo, halo + cols)
  int halo;
  int row0, col0;            // tracked: the raster's origin in the global grid
  int grid_rows, grid_cols;  // tracked: the global grid's shape
};

// Downslope: from each start, walk until z <= z0 - ed at the cell reached,
// or to a terminal, or max_steps steps; then the ratio (z0 - z at the
// stop) / path length, 0 for a walk of no step, -100 where z0 is NoData.
// kTrack: also the flag of a walk that stopped at a terminal that only the
// window's edge made.  The serial walk knows its stop cell, so the flag is
// read there directly.  A start that is itself such a terminal stops at
// once and carries its own flag; a walk cut by the cap is exact and is not
// flagged.
template <bool kTrack, typename Fdr>
__global__ void __launch_bounds__(kBlockX * kBlockY)
downslope_kernel(const float* __restrict__ z, const Fdr* __restrict__ fdr,
                 float* __restrict__ out, unsigned char* __restrict__ trunc,
                 DownslopeGeometry g, float ed, int max_steps, float c_card,
                 float c_diag) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= g.rows || j >= g.cols) return;
  const unsigned cols = static_cast<unsigned>(g.win_cols);
  const unsigned n = static_cast<unsigned>(g.win_rows) * cols;
  int r = i + g.halo, c = j + g.halo;
  int cur = r * g.win_cols + c;
  const float z0 = z[cur];
  const float thresh = z0 - ed;
  float zc = z0;
  // The cell's step: its target lies inside the raster where the code is
  // valid and the target's column and flat index are inside (then its row
  // is too).  z and fdr of the target are loaded together.
  int dy, dx;
  bool diag;
  bool valid = d8_decode(static_cast<int>(fdr[cur]), dy, dx, diag);
  int next = cur + dy * g.win_cols + dx;
  bool inside = valid && static_cast<unsigned>(c + dx) < cols && static_cast<unsigned>(next) < n;
  float zn = 0.0f;
  int fn = 0;
  if (inside) {
    zn = z[next];
    fn = static_cast<int>(fdr[next]);
  }
  bool terminal = !inside || zn == kNoData || zc == kNoData;
  int steps = 0, diags = 0;
  if (!terminal && !(zc <= thresh)) {  // a terminal start cell stops at once, pk = 0
    while (steps < max_steps) {
      ++steps;
      diags += diag;
      r += dy;  // the row serves the flag alone
      c += dx;
      cur = next;
      zc = zn;  // never NoData: the cell left was not terminal
      valid = d8_decode(fn, dy, dx, diag);
      next = cur + dy * g.win_cols + dx;
      inside = valid && static_cast<unsigned>(c + dx) < cols && static_cast<unsigned>(next) < n;
      if (inside) {
        zn = z[next];
        fn = static_cast<int>(fdr[next]);
      }
      terminal = !inside || zn == kNoData;
      if (terminal || zc <= thresh) break;
    }
  }
  // The packed counts (the diagonal count in bits 16-31, as repeated
  // additions of 2^16 would leave it).
  const int pk = static_cast<int>(static_cast<unsigned>(steps - diags) +
                                  static_cast<unsigned>(diags) * kIncDiag);
  // ops/downslope.py::downslope_from_state, in its order.
  const float dist = __fadd_rn(__fmul_rn(static_cast<float>(pk & 0xFFFF), c_card),
                               __fmul_rn(static_cast<float>(pk >> 16), c_diag));
  const float down = pk == 0 ? 0.0f : __fdiv_rn(__fsub_rn(z0, zc), dist);
  const int o = i * g.cols + j;
  out[o] = z0 == kNoData ? kNoData : down;
  if constexpr (kTrack) {
    // trunc_cells at the stop cell: a valid step that leaves the window
    // and stays inside the grid, from a cell that is not NoData.
    const bool in_grid =
        static_cast<unsigned>(r + dy + g.row0) < static_cast<unsigned>(g.grid_rows) &&
        static_cast<unsigned>(c + dx + g.col0) < static_cast<unsigned>(g.grid_cols);
    const bool cut = valid && !inside && in_grid && zc != kNoData;
    trunc[o] = (terminal && cut) ? 1 : 0;
  }
}

template <bool kTrack>
int launch_downslope_kernel(const float* z, const void* fdr, int fdr_is_int32, float* out,
                            unsigned char* trunc, const DownslopeGeometry& g, float ed,
                            int max_steps, float c_card, float c_diag, void* stream) {
  if (g.rows <= 0 || g.cols <= 0) return 0;
  // Offsets are int: the raster and the row a step may leave it by must
  // hold fewer than 2^31 cells.
  if (static_cast<long long>(g.win_rows + 1) * g.win_cols >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((g.cols + kBlockX - 1) / kBlockX, (g.rows + kBlockY - 1) / kBlockY);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  const auto s = static_cast<cudaStream_t>(stream);
  if (fdr_is_int32) {
    downslope_kernel<kTrack, int><<<grid, block, 0, s>>>(
        z, static_cast<const int*>(fdr), out, trunc, g, ed, max_steps, c_card, c_diag);
  } else {
    downslope_kernel<kTrack, unsigned char><<<grid, block, 0, s>>>(
        z, static_cast<const unsigned char*>(fdr), out, trunc, g, ed, max_steps, c_card, c_diag);
  }
  return static_cast<int>(cudaGetLastError());
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

// Phase 1's cells as walk operands: code0 gives a cell's code, fdr_eff the
// step of a cell that walks on (a code that does not decode: stuck, the
// walk never lands).  fdr_eff is read at unresolved cells alone: it is 0
// at every absorbing cell.
struct OperandCells {
  const int* __restrict__ fdr_eff;
  const int* __restrict__ code0;

  __device__ __forceinline__ int visit(int cur, int, int, int, int, int& dy, int& dx,
                                       bool& diag, bool& moves) const {
    const int code = code0[cur];
    moves = code == kUnres && d8_step(fdr_eff[cur], dy, dx, diag);
    return code;
  }
};

// Phase 1's cells as raw rasters: the role of cell cur at (r, c) by
// flow_states' truth table.  kUnres and moves where the cell steps.
template <typename Fdr>
struct RawCells {
  const Fdr* __restrict__ fdr;
  const unsigned char* __restrict__ river;

  __device__ __forceinline__ int visit(int cur, int r, int c, int rows, int cols, int& dy,
                                       int& dx, bool& diag, bool& moves) const {
    const int f = static_cast<int>(fdr[cur]);
    const bool is_river = river[cur] == 1;
    const bool inside = d8_decode(f, dy, dx, diag) &&
                        static_cast<unsigned>(r + dy) < static_cast<unsigned>(rows) &&
                        static_cast<unsigned>(c + dx) < static_cast<unsigned>(cols);
    moves = f != 0 && !is_river && inside;
    if (moves) return kUnres;
    return f != 0 && is_river ? cur : -cur - 1;
  }
};

// Phase 1: the serial walk, cut after kJumpB steps.
template <typename Cells>
__global__ void jump_start_kernel(Cells cells, int* __restrict__ code_out,
                                  int* __restrict__ a_out, int* __restrict__ b_out,
                                  int* __restrict__ done, int2* __restrict__ state,
                                  int* __restrict__ list, int* __restrict__ count, int rows,
                                  int cols, int max_steps) {
  int idx;
  if (!cell_of_thread(rows, cols, idx)) return;
  const int limit = min(kJumpB, max_steps);
  int cur = idx;
  int r = idx / cols, c = idx - r * cols;  // read by RawCells alone
  int dy, dx;
  bool diag, moves;
  int code = cells.visit(cur, r, c, rows, cols, dy, dx, diag, moves);
  int a = 0, b = 0, s = 0;
  for (; code == kUnres && s < limit; ++s) {
    if (!moves) break;  // stuck: never lands
    a += diag ? 0 : 1;
    b += diag ? 1 : 0;
    cur += dy * cols + dx;
    r += dy;
    c += dx;
    code = cells.visit(cur, r, c, rows, cols, dy, dx, diag, moves);
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

// After the rounds: fdist and indices from the walk's (code, a, b), as
// ops/flow.py::flow_from_state forms them: where the walk landed on a river
// within max_steps, a * c_card + b * c_diag in that order (separate
// roundings, as -fmad=false keeps them too) and the river's index; -100 in
// both elsewhere.
__global__ void flow_finish_kernel(const int* __restrict__ code, const int* __restrict__ a,
                                   const int* __restrict__ b, float* __restrict__ fdist,
                                   int* __restrict__ indices, int rows, int cols,
                                   int max_steps, float c_card, float c_diag) {
  int idx;
  if (!cell_of_thread(rows, cols, idx)) return;
  const int k = code[idx], na = a[idx], nb = b[idx];
  const bool landed = k >= 0 && na + nb <= max_steps;
  fdist[idx] = landed ? __fadd_rn(__fmul_rn(__int2float_rn(na), c_card),
                                  __fmul_rn(__int2float_rn(nb), c_diag))
                      : kNoData;
  indices[idx] = landed ? k : static_cast<int>(kNoData);
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

// The whole jump walk on the stream, no host read: counts zeroed, phase 1
// over `cells`, then R rounds, round k reading (state, list) k % 2 and
// writing the other pair.  Writes R to *rounds (host memory).  counts,
// n_counts ints (counts[k] is the length of round k's list; R + 1 of them
// are used); scratch, 7n ints: state_x[2n], state_y[2n] (int2 each),
// done[n], list_x[n], list_y[n].
template <typename Cells>
int jump_walk(Cells cells, int* code, int* a, int* b, int* counts, int n_counts, int* scratch,
              int rows, int cols, int max_steps, int* rounds, cudaStream_t stream) {
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
      cells, code, a, b, done, state[0], list[0], counts, rows, cols, max_steps);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  for (int k = 0; k < r; ++k) {
    jump_round_kernel<<<blocks, kThreads, 0, stream>>>(
        code, a, b, done, state[k % 2], state[(k + 1) % 2], list[k % 2], counts + k,
        list[(k + 1) % 2], counts + k + 1, k, kJumpB << k, max_steps);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// dem: float32; fdr: int32 (fdr_is_int32 != 0) or uint8; downslope: the
// same shape.  c_card, c_diag: the step lengths f32(step) * f32(px).
extern "C" int launch_downslope(const float* dem, const void* fdr, int fdr_is_int32,
                                float* downslope, int rows, int cols, float ed,
                                int max_steps, float c_card, float c_diag, void* stream) {
  const DownslopeGeometry g{rows, cols, rows, cols, 0, 0, 0, rows, cols};
  return launch_downslope_kernel<false>(dem, fdr, fdr_is_int32, downslope, nullptr, g, ed,
                                        max_steps, c_card, c_diag, stream);
}

// dem and fdr: a tile's window, win_rows x win_cols, with a ring of halo
// cells around the tile; its origin in the global grid (grid_rows x
// grid_cols) is (row0, col0).  downslope and trunc: the tile's interior,
// (win_rows - 2 halo) x (win_cols - 2 halo).
extern "C" int launch_downslope_tracked(const float* dem, const void* fdr, int fdr_is_int32,
                                        float* downslope, unsigned char* trunc, int win_rows,
                                        int win_cols, int halo, int row0, int col0,
                                        int grid_rows, int grid_cols, float ed,
                                        int max_steps, float c_card, float c_diag,
                                        void* stream) {
  const DownslopeGeometry g{win_rows, win_cols, win_rows - 2 * halo, win_cols - 2 * halo,
                            halo, row0, col0, grid_rows, grid_cols};
  return launch_downslope_kernel<true>(dem, fdr, fdr_is_int32, downslope, trunc, g, ed,
                                       max_steps, c_card, c_diag, stream);
}

// Phase 1's steps (B), for the wrapper and the tests.
extern "C" int jump_walk_bound() { return kJumpB; }

// The jump walk over walk operands (fdr_eff, code0): code, a and b out.
// The local phase of the tiled and sharded paths (K5/K8) and the fold
// walk (flow_fold.cu) call it.  counts and scratch as jump_walk takes them.
extern "C" int launch_jump_walk(const int* fdr_eff, const int* code0, int* code, int* a,
                                int* b, int* counts, int n_counts, int* scratch, int rows,
                                int cols, int max_steps, int* rounds, void* stream_ptr) {
  return jump_walk(OperandCells{fdr_eff, code0}, code, a, b, counts, n_counts, scratch, rows,
                   cols, max_steps, rounds, static_cast<cudaStream_t>(stream_ptr));
}

// The in-core flow walk (K4), from the rasters to the outputs, no host
// read: the jump walk over fdr (int32 where fdr_is_int32 != 0, else
// uint8) and river (one byte a cell, 1 = river), then flow_finish_kernel
// writes fdist (float32) and indices (int32).  Writes R to *rounds (host
// memory).  counts as jump_walk takes it; scratch, 10n ints: the jump
// walk's 7n (its int2 states first, 8-byte aligned), then code, a and b.
extern "C" int launch_flow_walk(const void* fdr, int fdr_is_int32, const unsigned char* river,
                                float* fdist, int* indices, int* counts, int n_counts,
                                int* scratch, int rows, int cols, int max_steps, float c_card,
                                float c_diag, int* rounds, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n = static_cast<long long>(rows) * cols;
  int* walk_scratch = scratch;
  int* code = scratch + 7 * n;
  int* a = code + n;
  int* b = a + n;
  const int err =
      fdr_is_int32
          ? jump_walk(RawCells<int>{static_cast<const int*>(fdr), river}, code, a, b, counts,
                      n_counts, walk_scratch, rows, cols, max_steps, rounds, stream)
          : jump_walk(RawCells<unsigned char>{static_cast<const unsigned char*>(fdr), river},
                      code, a, b, counts, n_counts, walk_scratch, rows, cols, max_steps, rounds,
                      stream);
  if (err != 0 || n == 0) return err;
  flow_finish_kernel<<<blocks_for(rows, cols, kThreads), kThreads, 0, stream>>>(
      code, a, b, fdist, indices, rows, cols, max_steps, c_card, c_diag);
  return static_cast<int>(cudaGetLastError());
}
