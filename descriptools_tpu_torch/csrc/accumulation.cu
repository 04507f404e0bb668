// Terrain's flow accumulation: each cell's strict upstream-cell count, by
// level doubling over the cells still live, in one C entry
// (ops/terrain.py::flow_accumulation, stage terrain.accumulation).
//
// The rounds (entry launch_accumulation) replace no Pallas kernel: the JAX
// package's accumulation is jnp, a while_loop of scatter-adds over n + 1
// slots (descriptools_tpu/ops/terrain.py:37, flow_accumulation).  The
// port's plain version is that loop over a live list in torch
// (ops/cuda/terrain.py::accumulation_plain):
//
//   F_0 = the donors;  F_{j+1} = F_j + scatter_add(F_j, by=succ_j);  succ_{j+1} = succ_j[succ_j]
//
// over the live cells, those whose successor is not the sink n, for
// `levels` = d8.doubling_rounds(max_path) rounds at most, ending once no
// cell is live.  The adds are int32, exact (and wrapping) in any order, so
// every count, truncated and lap-multiplied ones included, is bitwise the
// plain version's, and so are the live cells' numbers a round and the
// successor jumped in place.
//
//   Bound: 8 B a cell (succ read once, fac written once): 0.239 ms at
//   10000 x 10000 at 3.35 TB/s.  Each round adds its live cells' traffic:
//   on 1 m drainage 10-11 rounds over 6.3e8 live cells in all, 7 of them
//   with more than 60 % of the cells live.
//   What held the torch loop back: about ten launches a round (two
//   gathers, index_add_, the successor's scatter, a compare, nonzero and
//   the gathers of its int64 indices), some 200 B moved a live cell a
//   round, and nonzero's length read on the host every round, the card
//   idle meanwhile.
//   The design:
//   - init_kernel, after a memset of fac: a cell whose successor t is not
//     the sink adds 1 to fac[t] (F_0), and the live cells are counted;
//   - then exactly `levels` rounds are queued back to back, two persistent
//     grid-stride kernels each, which read the round's live count from
//     device memory: a round with none returns at once (the plain loop has
//     exited by then), and no launch needs a count on the host.  Two,
//     because a round reads the old F at every live cell and the old succ
//     at every live cell's successor, and writes both: in one kernel the
//     reads would race the writes.  gather_kernel only reads F and the
//     round's successor, apply_kernel adds to F (atomicAdd) and, in a
//     listed round, writes the successor;
//   - a round runs in one of two forms, chosen on the device from its live
//     count, the same for all its blocks:
//     - dense, while more than half the cells are live (1 m drainage keeps
//       60-90 % live for 7 rounds): over every cell in order, so every
//       access of a cell's own F, succ and scratch is coalesced.  gather
//       writes v[c] = F[c] at each live cell c and every cell's next
//       successor, succ[succ[c]] or the sink, into the successor's twin
//       buffer; apply adds v[c] to F[succ[c]], and the buffers swap.  The
//       first round at or under half (or round 0, if it is) also lists its
//       survivors (c, succ[succ[c]]) for the next round.  After the rounds
//       the successor is copied back into the caller's buffer if an odd
//       number of swaps left it in the twin (finish_kernel);
//     - listed, afterwards: over a list of (i, t) pairs, t = succ[i], for
//       the live cells alone, the successor updated in its buffer.  gather
//       reads v = F[i] and nt = succ[t], rewrites its entry as (v, t), and
//       appends (i, nt) to the next list where nt is not the sink, else
//       (i, n) at the next list's back end; apply adds v to F[t], and sets
//       succ[i] = nt from the next list's entry k (front first, then back);
//     A listed round moves 40 B of list a live cell besides its four
//     scattered accesses, a dense one 8 B of v and 4 B of the twin a cell:
//     on an H100 at 1e8 cells, 90 % of them live, a listed round took 2.3
//     ms and a dense one 1.3, so the list pays only under about half;
//   - appends are aggregated per block over a tile of kItems entries a
//     thread: one atomicAdd a tile on the list's counter, the slots in the
//     tile's order, so the lists keep the cells' order within a tile.  An
//     append a warp on one counter queued 3e6 same-address atomics at
//     1e8 cells (7 ms on an H100);
//   - the adds to F are aggregated per warp: lanes of one target add their
//     sum once (__match_any_sync, then a tree over the peers).  Neighbouring
//     cells share targets, more so as paths converge: on an H100 at 10000 x
//     10000 the applies took 8.4 and 3.6 ms without it, 7.1 and 3.2 with
//     it (the LiDAR and SRTM tile mixes);
//   - the scratch is v and the successor's twin (4 B a cell each) and two
//     lists of half the cells (8 B an entry): 16 B a cell.  The live
//     counts of each round, and each listed round's back-end count, land
//     in a small device array, which the caller reads once, after the last
//     round.

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // entries a thread, per tile
constexpr int kTile = kThreads * kItems;

enum RoundForm { kIdle, kDense, kDenseListing, kListed };

// The accumulation's buffers.  succ[0] is the caller's successor, succ[1]
// its twin in the scratch; counts: [levels + 1] live counts, then [levels]
// back-end counts; list[j % 2] is round j's list, cap entries.
struct Rounds {
  int* fac;
  int* succ[2];
  int* v;
  int2* list[2];
  int* counts;
  int* sunk;
  int n;
  int cap;
};

__device__ __forceinline__ int round_form(const Rounds& r, int j) {
  const int live = r.counts[j];
  if (live == 0) return kIdle;
  if (live > r.cap) return kDense;
  return (j == 0 || r.counts[j - 1] > r.cap) ? kDenseListing : kListed;
}

// The dense rounds among rounds 0 .. j - 1, the listing one included: each
// swapped the successor's buffers, so round j reads succ[swaps % 2].  The
// dense rounds come first, then the listing one.
__device__ __forceinline__ int swaps_before(const Rounds& r, int j) {
  int i = 0;
  while (i < j && r.counts[i] > r.cap) ++i;
  return (i < j && r.counts[i] > 0) ? i + 1 : i;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Slots for the kept items of the block's tile, in the tile's order (item
// r of thread x is entry r * kThreads + x), after one atomicAdd of their
// number to *counter.  Every thread of the block calls it.
__device__ __forceinline__ void tile_slots(const bool (&keep)[kItems], int (&slot)[kItems],
                                           int* counter) {
  __shared__ int offset[kItems * kWarps];
  constexpr int kPer = (kItems * kWarps + 31) / 32;  // scan entries a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ballot[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    ballot[r] = __ballot_sync(0xffffffffu, keep[r]);
    if (lane == 0) offset[r * kWarps + warp] = __popc(ballot[r]);
  }
  __syncthreads();
  if (warp == 0) {  // an exclusive scan of the kItems * kWarps counts
    int own[kPer];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      own[q] = offset[lane * kPer + q];
      sum += own[q];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int base = 0;
    if (lane == 0 && total > 0) base = atomicAdd(counter, total);
    int run = __shfl_sync(0xffffffffu, base, 0) + incl - sum;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      offset[lane * kPer + q] = run;
      run += own[q];
    }
  }
  __syncthreads();
  const unsigned below = lanemask_lt();
#pragma unroll
  for (int r = 0; r < kItems; ++r) slot[r] = offset[r * kWarps + warp] + __popc(ballot[r] & below);
  __syncthreads();  // offset is free for the next tile
}

static_assert((kItems * kWarps) % 32 == 0, "the scan takes whole lanes");

// F[t] += v for each lane's (t, v), t = n adding nothing: the lanes of one
// t add their sum once (a tree over the peers, Westphal's reduce_peers).
// Every lane of the warp calls it.
__device__ __forceinline__ void add_to(int* fac, int t, int v, int n) {
  unsigned peers = __match_any_sync(0xffffffffu, t);
  const int lane = threadIdx.x & 31;
  const bool leader = (peers & lanemask_lt()) == 0;
  int rank = __popc(peers & lanemask_lt());
  peers &= 0xfffffffeu << lane;  // the peers above this lane
  while (__any_sync(0xffffffffu, peers != 0)) {
    const int next = __ffs(peers);
    const int y = __shfl_sync(0xffffffffu, v, (next - 1) & 31);
    if (next) v += y;
    peers &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
  if (leader && t != n) atomicAdd(fac + t, v);
}

// F_0 (fac zeroed before) and round 0's live count.
__global__ void __launch_bounds__(kThreads) init_kernel(Rounds r) {
  for (long long base = static_cast<long long>(blockIdx.x) * kTile; base < r.n;
       base += static_cast<long long>(gridDim.x) * kTile) {
    int t[kItems], slot[kItems];
    bool live[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long c = base + q * kThreads + threadIdx.x;
      t[q] = c < r.n ? r.succ[0][c] : r.n;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      live[q] = t[q] != r.n;
      add_to(r.fac, t[q], 1, r.n);
    }
    tile_slots(live, slot, r.counts);
  }
}

// A round's reads, dense: v at every live cell, and every cell's next
// successor in the other buffer (the sink at the dead ones); listing, the
// survivors appended to the next list too.
__device__ __forceinline__ void gather_dense(const Rounds& r, int j, bool listing) {
  const int swaps = swaps_before(r, j);
  const int* succ = r.succ[swaps % 2];
  int* next_succ = r.succ[(swaps + 1) % 2];
  int2* next = r.list[(j + 1) % 2];
  for (long long base = static_cast<long long>(blockIdx.x) * kTile; base < r.n;
       base += static_cast<long long>(gridDim.x) * kTile) {
    int s[kItems], f[kItems], nt[kItems], slot[kItems];
    bool keep[kItems];
    // Loads first, then stores: the buffers may alias as far as the
    // compiler knows, and the loads of all items should be in flight at once.
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long c = base + q * kThreads + threadIdx.x;
      s[q] = c < r.n ? succ[c] : r.n;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long c = base + q * kThreads + threadIdx.x;
      nt[q] = s[q] != r.n ? succ[s[q]] : r.n;
      f[q] = s[q] != r.n ? r.fac[c] : 0;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long c = base + q * kThreads + threadIdx.x;
      if (s[q] != r.n) r.v[c] = f[q];
      if (c < r.n) next_succ[c] = nt[q];
      keep[q] = nt[q] != r.n;
    }
    tile_slots(keep, slot, r.counts + j + 1);
    if (listing) {
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        if (keep[q]) next[slot[q]] = make_int2(static_cast<int>(base + q * kThreads + threadIdx.x), nt[q]);
      }
    }
  }
}

// A round's reads, listed: entry (i, t) becomes (F[i], t); (i, succ[t])
// goes to the next list's front, or (i, n) to its back.
__device__ __forceinline__ void gather_listed(const Rounds& r, int j) {
  const int* succ = r.succ[swaps_before(r, j) % 2];
  int2* list = r.list[j % 2];
  int2* next = r.list[(j + 1) % 2];
  const int live = r.counts[j];
  for (long long base = static_cast<long long>(blockIdx.x) * kTile; base < live;
       base += static_cast<long long>(gridDim.x) * kTile) {
    int2 e[kItems];
    int f[kItems], nt[kItems], slot[kItems];
    bool in[kItems], keep[kItems], sunk[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long k = base + q * kThreads + threadIdx.x;
      in[q] = k < live;
      e[q] = in[q] ? list[k] : make_int2(0, 0);
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      nt[q] = in[q] ? succ[e[q].y] : r.n;
      f[q] = in[q] ? r.fac[e[q].x] : 0;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (in[q]) list[base + q * kThreads + threadIdx.x] = make_int2(f[q], e[q].y);
      keep[q] = in[q] && nt[q] != r.n;
      sunk[q] = in[q] && nt[q] == r.n;
    }
    tile_slots(keep, slot, r.counts + j + 1);
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (keep[q]) next[slot[q]] = make_int2(e[q].x, nt[q]);
    }
    tile_slots(sunk, slot, r.sunk + j);
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (sunk[q]) next[r.cap - 1 - slot[q]] = make_int2(e[q].x, r.n);
    }
  }
}

__global__ void __launch_bounds__(kThreads) gather_kernel(Rounds r, int j) {
  const int form = round_form(r, j);
  if (form == kListed) {
    gather_listed(r, j);
  } else if (form != kIdle) {
    gather_dense(r, j, form == kDenseListing);
  }
}

// A round's writes, dense: F[succ[c]] += v[c] at every live cell, succ
// the round's (its gather wrote the next one apart).
__device__ __forceinline__ void apply_dense(const Rounds& r, int j) {
  const int* succ = r.succ[swaps_before(r, j) % 2];
  for (long long base = static_cast<long long>(blockIdx.x) * kTile; base < r.n;
       base += static_cast<long long>(gridDim.x) * kTile) {
    int s[kItems], v[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long c = base + q * kThreads + threadIdx.x;
      s[q] = c < r.n ? succ[c] : r.n;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long c = base + q * kThreads + threadIdx.x;
      v[q] = s[q] != r.n ? r.v[c] : 0;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) add_to(r.fac, s[q], v[q], r.n);
  }
}

// A round's writes, listed: F[t] += v for each entry (v, t), and each
// entry of the next list, front then back, sets its cell's successor.
__device__ __forceinline__ void apply_listed(const Rounds& r, int j) {
  int* succ = r.succ[swaps_before(r, j) % 2];
  const int2* list = r.list[j % 2];
  const int2* next = r.list[(j + 1) % 2];
  const int live = r.counts[j];
  const int kept = r.counts[j + 1];
  for (long long base = static_cast<long long>(blockIdx.x) * kTile; base < live;
       base += static_cast<long long>(gridDim.x) * kTile) {
    int2 e[kItems], s[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long k = base + q * kThreads + threadIdx.x;
      if (k < live) {
        e[q] = list[k];
        s[q] = next[k < kept ? k : r.cap - 1 - (k - kept)];
      }
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const bool in = base + q * kThreads + threadIdx.x < live;
      add_to(r.fac, in ? e[q].y : r.n, in ? e[q].x : 0, r.n);
      if (in) succ[s[q].x] = s[q].y;
    }
  }
}

// At most 64 registers, four blocks an SM: the listed path's arrays would
// take 94 and halve the dense path's occupancy, which its atomics need (on
// an H100 the LiDAR tile mix's applies took 6.1 ms at 94 registers and 5.2
// at 64, with a few bytes spilled on the listed path).
__global__ void __launch_bounds__(kThreads, 4) apply_kernel(Rounds r, int j) {
  const int form = round_form(r, j);
  if (form == kListed) {
    apply_listed(r, j);
  } else if (form != kIdle) {
    apply_dense(r, j);
  }
}

// After the last round: the successor back in the caller's buffer, where
// an odd number of dense rounds left it in the twin.
__global__ void __launch_bounds__(kThreads) finish_kernel(Rounds r, int levels) {
  if (swaps_before(r, levels) % 2 == 0) return;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; c < r.n;
       c += stride) {
    r.succ[0][c] = r.succ[1][c];
  }
}

// Blocks of each persistent grid, computed once per device.
int init_blocks(int& blocks) {
  static int cached[64] = {};
  return persistent_blocks(init_kernel, kThreads, cached, blocks);
}

int gather_blocks(int& blocks) {
  static int cached[64] = {};
  return persistent_blocks(gather_kernel, kThreads, cached, blocks);
}

int apply_blocks(int& blocks) {
  static int cached[64] = {};
  return persistent_blocks(apply_kernel, kThreads, cached, blocks);
}

int finish_blocks(int& blocks) {
  static int cached[64] = {};
  return persistent_blocks(finish_kernel, kThreads, cached, blocks);
}

}  // namespace

// succ: n = rows * cols int32, each cell's flat successor or n (the sink),
// jumped in place; fac: n int32 out, the counts.  counts: n_counts >=
// 2 * levels + 1 ints, written: counts[j] is the number of cells live
// entering round j (counts[levels] after the last round); counts[levels + 1
// + j] how many of a listed round j's cells reached the sink.  scratch:
// 2n + 4 ceil(n / 2) ints: v and the successor's twin, then two lists of
// ceil(n / 2) int2 entries.  Queues a memset of counts and of fac, the
// init pass, `levels` rounds and the finish on the stream, with no host
// read.  Grids of
// 2^31 cells or more are refused (flat int32 indices, and the sink n).
extern "C" int launch_accumulation(int* succ, int* fac, int* counts, int n_counts, int* scratch,
                                   int rows, int cols, int levels, void* stream) {
  if (rows < 0 || cols < 0 || levels < 0 || n_counts < 2 * levels + 1) {
    return cudaErrorInvalidValue;
  }
  if (static_cast<long long>(rows) * cols >= (1LL << 31)) return cudaErrorInvalidValue;
  const int n = rows * cols;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counts, 0, (2 * levels + 1) * sizeof(int), s);
  if (e != cudaSuccess || n == 0) return static_cast<int>(e);
  if ((e = cudaMemsetAsync(fac, 0, static_cast<size_t>(n) * sizeof(int), s)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  const int cap = static_cast<int>((n + 1LL) / 2);
  int2* lists = reinterpret_cast<int2*>(scratch + 2LL * n);
  const Rounds r{fac, {succ, scratch + n}, scratch, {lists, lists + cap}, counts, counts + levels + 1,
                 n, cap};
  int i_blocks = 0, g_blocks = 0, a_blocks = 0, f_blocks = 0;
  int err = init_blocks(i_blocks);
  if (err == 0) err = gather_blocks(g_blocks);
  if (err == 0) err = apply_blocks(a_blocks);
  if (err == 0) err = finish_blocks(f_blocks);
  if (err != 0) return err;
  init_kernel<<<i_blocks, kThreads, 0, s>>>(r);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  for (int j = 0; j < levels; ++j) {
    gather_kernel<<<g_blocks, kThreads, 0, s>>>(r, j);
    apply_kernel<<<a_blocks, kThreads, 0, s>>>(r, j);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  finish_kernel<<<f_blocks, kThreads, 0, s>>>(r, levels);
  return static_cast<int>(cudaGetLastError());
}
