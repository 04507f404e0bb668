// Terrain from a DEM: each cell's D8 flow direction and its successor, in
// one pass (ops/terrain.py::derive_terrain, stage terrain.d8).
//
// d8_kernel (entry launch_d8) replaces no Pallas kernel: the JAX package's
// D8 is jnp (descriptools_tpu/d8.py:75, d8_flow_direction), and the port's
// plain version is d8.d8_flow_direction, then d8.successor in the sink form
// (ops/cuda/terrain.py::d8_successor_plain).  It writes the successor as a
// second output because the stencil already picks it: flow_accumulation
// takes it instead of decoding fdr again.
//
// The rule, bitwise d8_flow_direction's: the eight drops in ESRI order (E,
// SE, S, SW, W, NW, N, NE), each fl(fl(z - nbr) / step) with step float32 1
// or float32 sqrt(2) (D8_STEP); best starts at 0.0f and a drop wins only if
// it is strictly greater, so the first of equal drops wins; a neighbour equal
// to NoData, or off the grid, never wins; a NoData centre gets code 0.  The
// DEM is read in its own type: int16 exactly, int32 by __int2float_rn
// (PyTorch's cast), float32 as it is.  succ is the winner's flat index
// ty * cols + tx, or rows * cols (the accumulation's sink) where the code is
// 0.
//
//   Bound: 12 B a cell (dem 4 read; fdr 4 and succ 4 written) for the 4-byte
//   DEMs, 10 B for int16: 0.358 ms at 10000 x 10000 at 3.35 TB/s.
//   The design, to spend few instructions beside the bytes:
//   - a block of 32 x 8 threads stages a 32-column x 32-row tile and its
//     one-cell halo in shared memory, converting to float32 as it stages
//     (tile.cuh's stage_tile, as stencil.cu's stencil_tile_kernel does).
//     Each thread then takes 4 cells down its column, and a warp stores fdr
//     and succ along a row, coalesced;
//   - staging writes NaN for a NoData cell and for a cell off the grid.  A
//     NaN drop is never > best, so such a neighbour never wins and such a
//     centre (every drop NaN) gets code 0, as the rule asks of NoData; a
//     NaN or an infinite elevation in the DEM behaves as in the rule, whose
//     drops are NaN or -inf there.  No neighbour needs a NoData test;
//   - a cardinal drop is the subtraction alone: an IEEE division by 1 is
//     exact.  A diagonal drop is one __fdiv_rn (no fast math, built with
//     -fmad=false); the divisor is a kernel argument, so its reciprocal is
//     formed once a thread.  A drop d can win only where d > best (best is
//     at least 0, and fl(d / sqrt 2) <= d for d >= 0), so the division
//     takes d there and 1 elsewhere: the zero drops of plateaus and the
//     NaN of NoData neighbours, which can send __fdiv_rn down its slow
//     path, never reach it (on an H100 at 700 W, on a 10000 x 10000 int32 DEM
//     of many plateaus, 0.86 ms with them and 0.58 without);
//   - the winner is kept as its code; succ follows from it through
//     d8.cuh's d8_decode;
//   - grids of more than 65535 tile rows loop over them (a grid's y
//     dimension holds 65535 blocks), so 1 x N and N x 1 grids of any
//     length below 2^31 cells run.

#include <cuda_runtime.h>

#include "d8.cuh"
#include "tile.cuh"

namespace {

constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float elevation(float z) { return z; }
__device__ __forceinline__ float elevation(int z) { return __int2float_rn(z); }
__device__ __forceinline__ float elevation(short z) { return __int2float_rn(z); }  // exact

// The DEM as tile.cuh's stage_tile reads it: the grid alone, an elevation
// staged as float32, NaN where it is NoData or off the grid.
template <typename Dem>
struct DemSource {
  const Dem* src;
  int rows, cols, pitch;
  float nodata;
  __device__ int at(int i, int j) const { return i * pitch + j; }
  __device__ bool holds(int i, int j) const { return i >= 0 && i < rows && j >= 0 && j < cols; }
  __device__ float value(Dem v) const {
    const float z = elevation(v);
    return z == nodata ? fill() : z;
  }
  __device__ float fill() const { return __int_as_float(0x7fc00000); }
};

// dem, fdr and succ: rows x cols; step_diag: the diagonal step in pixels
// (float32 sqrt(2)).
template <typename Dem>
__global__ void __launch_bounds__(kThreads)
    d8_kernel(const Dem* __restrict__ dem, int* __restrict__ fdr, int* __restrict__ succ,
              int rows, int cols, int tile_rows, float nodata, float step_diag) {
  __shared__ float tile[kTileFloats];
  const DemSource<Dem> g{dem, rows, cols, cols, nodata};
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int j0 = blockIdx.x * kTileW;
  const int j = j0 + tx;
  const int sink = rows * cols;
  for (int by = blockIdx.y; by < tile_rows; by += gridDim.y) {
    const int i0 = by * kTileH;
    if (by != blockIdx.y) __syncthreads();  // the last tile's reads are done
    stage_tile(g, tile, i0, j0);
    __syncthreads();
    if (j < cols) {
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        const int r = ty + c * kThreadRows;  // the cell's row in the tile
        const int i = i0 + r;
        if (i < rows) {
          const float* w = tile + (r + 1) * kHaloW + tx + 1;  // the cell
          const float z = w[0];
          float best = 0.0f;
          int code = 0;
          // Drop to a neighbour in ESRI order; the first strictly steepest
          // wins.  A cardinal drop is undivided, and a diagonal one divides
          // 1 where it cannot win (see above).
          auto take = [&](float nbr, bool diag, int k) {
            const float d = __fsub_rn(z, nbr);
            const bool up = d > best;
            const float g = diag ? __fdiv_rn(up ? d : 1.0f, step_diag) : d;
            if (up && g > best) {
              best = g;
              code = k;
            }
          };
          take(w[1], false, 1);             // E
          take(w[kHaloW + 1], true, 2);     // SE
          take(w[kHaloW], false, 4);        // S
          take(w[kHaloW - 1], true, 8);     // SW
          take(w[-1], false, 16);           // W
          take(w[-kHaloW - 1], true, 32);   // NW
          take(w[-kHaloW], false, 64);      // N
          take(w[-kHaloW + 1], true, 128);  // NE
          int dy = 0, dx = 0;
          bool diagonal = false;
          d8_decode(code, dy, dx, diagonal);
          const int idx = i * cols + j;
          fdr[idx] = code;
          succ[idx] = code != 0 ? idx + dy * cols + dx : sink;
        }
      }
    }
  }
}

template <typename Dem>
void launch(const void* dem, int* fdr, int* succ, int rows, int cols, float nodata,
            float step_diag, cudaStream_t s) {
  const int tile_rows = (rows + kTileH - 1) / kTileH;
  const dim3 grid((cols + kTileW - 1) / kTileW, tile_rows < kMaxGridY ? tile_rows : kMaxGridY);
  const dim3 block(kTileW, kThreadRows);
  d8_kernel<Dem><<<grid, block, 0, s>>>(static_cast<const Dem*>(dem), fdr, succ, rows, cols,
                                        tile_rows, nodata, step_diag);
}

}  // namespace

// dem: rows x cols of float32 (dem_type 0), int32 (1) or int16 (2); fdr and
// succ: rows x cols int32.  nodata: the DEM's NoData value as float32;
// step_diag: the diagonal step in pixels.  Grids of 2^31 cells or more are
// refused (flat int32 indices, and the sink rows * cols).
extern "C" int launch_d8(const void* dem, int dem_type, int* fdr, int* succ, int rows, int cols,
                         float nodata, float step_diag, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (static_cast<long long>(rows) * cols >= (1LL << 31)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dem_type) {
    case 0: launch<float>(dem, fdr, succ, rows, cols, nodata, step_diag, s); break;
    case 1: launch<int>(dem, fdr, succ, rows, cols, nodata, step_diag, s); break;
    case 2: launch<short>(dem, fdr, succ, rows, cols, nodata, step_diag, s); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
