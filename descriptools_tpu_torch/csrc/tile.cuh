// A grid's 32-column x 32-row tile and its one-cell halo, staged as float32
// in shared memory, shared by the stencil kernels (stencil.cu's
// stencil_tile_kernel, terrain.cu's d8_kernel).
//
// A block of 32 x 8 threads stages it: warp y reads halo rows y, y + 8, ...
// (rows 34-39 are read and not used), one lane a column, coalesced; threads
// 0-67 then read columns 32 and 33 of the 34 rows.  A block whose halo lies
// wholly in the source reads without a test; a block at the source's edge
// calls stage_edge, which stages the source's fill where it holds no cell.
// Each thread then takes kCells cells down its column, so a warp stores
// along a row, coalesced.
//
// A source Src (a kernel's view of its input) has:
//   src, pitch:  the cells, and the offset from one row to the next;
//   at(i, j):    the offset of grid cell (i, j);
//   holds(i, j): whether the source holds grid cell (i, j);
//   value(v):    a cell's value as staged (float32);
//   fill():      what a cell the source does not hold stages as.
#pragma once

#include <cuda_runtime.h>

constexpr int kTileW = 32;                     // a tile's columns: one warp
constexpr int kThreadRows = 8;                 // rows of threads in a block
constexpr int kCells = 4;                      // cells a thread computes
constexpr int kTileH = kThreadRows * kCells;   // a tile's rows
constexpr int kHaloW = kTileW + 2;
constexpr int kLoadRows = (kTileH + 2 + kThreadRows - 1) / kThreadRows;  // halo rows a warp reads
constexpr int kTileFloats = kLoadRows * kThreadRows * kHaloW;           // the staged tile
constexpr int kThreads = kTileW * kThreadRows;

// Stage the halo of a tile at the source's edge, reading only the cells the
// source holds.  Out of line: most blocks take stage_tile's test-free path.
template <typename Src>
__device__ __noinline__ void stage_edge(Src g, float* tile, int i0, int j0) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int jh = j0 - 1 + tx;
#pragma unroll
  for (int s = 0; s < kLoadRows; ++s) {
    const int i = i0 - 1 + ty + s * kThreadRows;
    tile[(ty + s * kThreadRows) * kHaloW + tx] =
        g.holds(i, jh) ? g.value(g.src[g.at(i, jh)]) : g.fill();
  }
  const int tid = ty * kTileW + tx;
  if (tid < 2 * (kTileH + 2)) {
    const int i = i0 - 1 + (tid >> 1);
    const int j = j0 - 1 + kTileW + (tid & 1);
    tile[(tid >> 1) * kHaloW + kTileW + (tid & 1)] =
        g.holds(i, j) ? g.value(g.src[g.at(i, j)]) : g.fill();
  }
}

// Stage the tile whose first cell is grid cell (i0, j0), and its halo, into
// tile (kTileFloats floats of shared memory); the caller synchronizes.
template <typename Src>
__device__ __forceinline__ void stage_tile(Src g, float* tile, int i0, int j0) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  if (g.holds(i0 - 1, j0 - 1) && g.holds(i0 - 2 + kLoadRows * kThreadRows, j0 + kTileW)) {
    const auto* p = g.src + g.at(i0 - 1 + ty, j0 - 1 + tx);
#pragma unroll
    for (int s = 0; s < kLoadRows; ++s) {
      tile[(ty + s * kThreadRows) * kHaloW + tx] = g.value(p[s * kThreadRows * g.pitch]);
    }
    const int tid = ty * kTileW + tx;
    if (tid < 2 * (kTileH + 2)) {
      tile[(tid >> 1) * kHaloW + kTileW + (tid & 1)] =
          g.value(g.src[g.at(i0 - 1 + (tid >> 1), j0 - 1 + kTileW + (tid & 1))]);
    }
  } else {
    stage_edge(g, tile, i0, j0);
  }
}
