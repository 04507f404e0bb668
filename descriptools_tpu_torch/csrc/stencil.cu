// Stencil stage of the descriptor suite: slope, slope_rad, TWI and
// modified TWI of every cell, in one pass.
//
// One kernel body, stencil_tile_kernel, behind two entry points; only how
// it finds the halo in its source (Source<kPadded>: no ring, or a 1-cell
// ring) differs:
// - launch_stencil (a whole grid) replaces descriptools_tpu/ops/pallas/
//   stencil.py::_fused_kernel (slope + TWI over DMA-streamed row bands) and
//   extends it to all four rasters of the stencil stage
//   (descriptools_tpu/pipeline.py descriptor_suite).  Neighbours outside
//   the grid read as NoData, like the 1-cell NoData ring of the JAX pad.
// - launch_stencil_padded (the interior of a 1-ring-padded block) replaces
//   descriptools_tpu/ops/pallas/stencil.py::_slope_kernel and emits the
//   same four rasters: the ring holds a tile's real neighbours, or NoData at
//   the grid's border (the per-tile stencil of descriptools_tpu/tiled.py).
//
// Bound: a cell moves 24 B (the DEM and fac read, four float32 rasters
// written), 0.12 ms per 4096 x 4096 tile at 3.35 TB/s, and needs at least
// about 215 operations (chip_smoke.py's stencil_floor: the minima, two
// divisions and the tail's fast paths), 0.11 ms at 4 warp instructions per
// SM per clock on an H100 at 1980 MHz: the bytes bound the function.  What
// holds a kernel back is instruction issue all the same: on top of the
// floor it runs the tail's tests of special operands and register moves
// (the tail, atanf, tanf, two logf, powf and three IEEE divisions, stays
// as it is, for bitwise rasters), and its own staging and indexing.
// Design, to spend as few instructions as possible outside that tail:
// - a block of 32 x 8 threads stages a 32-column x 32-row tile and its
//   one-cell halo in shared memory (tile.cuh's stage_tile), NoData where
//   the source holds no cell.  The compute has no bounds test per
//   neighbour and no integer division; each thread then takes 4 cells down
//   its column, and a warp stores each raster along a row, coalesced;
// - slope in two IEEE divisions instead of eight: for d > 0,
//   fl(fl(zc - n) / d) does not increase with n (rounding is monotone), so
//   the steepest gradient of the 4 cardinal (or the 4 diagonal) neighbours
//   is that of their least elevation.  -100 neighbours are left out before
//   the minimum; fminf skips NaN ones, whose gradient never passed the
//   strict > of the 8-division form.  The result is bitwise that form's;
// - fac is read in its own type (int32 or float32); __int2float_rn is
//   PyTorch's cast.
// Exactness: the divisors are formed on the host as f32(px * double(step))
// and every division is IEEE (no fast math, built with -fmad=false), so the
// slope is bitwise the plain PyTorch one; atanf/tanf/logf/powf are called
// in the plain version's order and differ from other libraries' by a few
// ulp.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tile.cuh"

namespace {

constexpr float kNoData = -100.0f;
constexpr float kEps = 0.01f;

__device__ __forceinline__ float fac_value(float f) { return f; }
__device__ __forceinline__ float fac_value(int f) { return __int2float_rn(f); }

// The least of m and a neighbour, NoData neighbours left out.
__device__ __forceinline__ float least_valid(float m, float nbr) {
  return nbr != kNoData ? fminf(m, nbr) : m;
}

// slope, slope_rad, TWI and mod-TWI of one cell from its steepest gradient.
__device__ __forceinline__ void write_stage(int idx, float zc, float best, float f,
                                            float px2, float n_topo,
                                            float* __restrict__ slope,
                                            float* __restrict__ slope_rad,
                                            float* __restrict__ twi,
                                            float* __restrict__ mod_twi) {
  const float sl = zc == kNoData ? kNoData : best * 100.0f;
  const float sr = zc == kNoData ? kNoData : atanf(__fdiv_rn(sl, 100.0f));
  const float area = (f == 0.0f ? 1.0f : f) * px2;
  const float t = tanf(sr + kEps);
  slope[idx] = sl;
  slope_rad[idx] = sr;
  twi[idx] = f <= kNoData ? kNoData : logf(__fdiv_rn(area, t));
  mod_twi[idx] = f <= kNoData ? kNoData : logf(__fdiv_rn(powf(area, n_topo), t));
}

// The source holds grid row i (from -kRing to rows + kRing - 1) and
// column j likewise at src[(i + kRing) * pitch + j + kRing]: the whole grid
// has no ring (cells beyond it read as NoData), the padded block its 1-cell
// ring, read as given.  A source of tile.cuh's stage_tile.
template <bool kPadded>
struct Source {
  static constexpr int kRing = kPadded ? 1 : 0;
  const float* src;
  int rows, cols, pitch;
  __device__ Source(const float* s, int r, int c)
      : src(s), rows(r), cols(c), pitch(c + 2 * kRing) {}
  __device__ int at(int i, int j) const { return (i + kRing) * pitch + j + kRing; }
  __device__ bool holds(int i, int j) const {
    return i >= -kRing && i < rows + kRing && j >= -kRing && j < cols + kRing;
  }
  __device__ float value(float v) const { return v; }
  __device__ float fill() const { return kNoData; }
};

// fac and the outputs: rows x cols.  d_card, d_diag: the slope's divisors
// of the cardinal and the diagonal neighbours.
template <bool kPadded, typename Fac>
__global__ void __launch_bounds__(kThreads)
    stencil_tile_kernel(const float* __restrict__ src, const Fac* __restrict__ fac,
                        float* __restrict__ slope, float* __restrict__ slope_rad,
                        float* __restrict__ twi, float* __restrict__ mod_twi, int rows,
                        int cols, float d_card, float d_diag, float px2, float n_topo) {
  const Source<kPadded> g(src, rows, cols);
  __shared__ float tile[kTileFloats];
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  stage_tile(g, tile, i0, j0);
  __syncthreads();
  const int j = j0 + tx;
  if (j >= cols) return;
#pragma unroll 1
  for (int c = 0; c < kCells; ++c) {
    const int r = ty + c * kThreadRows;  // the cell's row in the tile
    const int i = i0 + r;
    if (i < rows) {
      const float* w = tile + (r + 1) * kHaloW + tx + 1;  // the cell
      const float zc = w[0];
      float m_card = CUDART_INF_F;
      float m_diag = CUDART_INF_F;
      m_card = least_valid(m_card, w[1]);            // E
      m_card = least_valid(m_card, w[kHaloW]);       // S
      m_card = least_valid(m_card, w[-1]);           // W
      m_card = least_valid(m_card, w[-kHaloW]);      // N
      m_diag = least_valid(m_diag, w[kHaloW + 1]);   // SE
      m_diag = least_valid(m_diag, w[kHaloW - 1]);   // SW
      m_diag = least_valid(m_diag, w[-kHaloW - 1]);  // NW
      m_diag = least_valid(m_diag, w[-kHaloW + 1]);  // NE
      float best = 0.0f;
      const float g_card = __fdiv_rn(zc - m_card, d_card);
      if (g_card > best) best = g_card;
      const float g_diag = __fdiv_rn(zc - m_diag, d_diag);
      if (g_diag > best) best = g_diag;
      const int idx = i * cols + j;
      write_stage(idx, zc, best, fac_value(fac[idx]), px2, n_topo, slope, slope_rad, twi,
                  mod_twi);
    }
  }
}

template <bool kPadded>
int launch(const float* src, const void* fac, int fac_is_int32, float* slope,
           float* slope_rad, float* twi, float* mod_twi, int rows, int cols, float d_card,
           float d_diag, float px2, float n_topo, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  // Offsets are int: the source, with its ring and the halo rows a tile
  // reads past the grid, must hold fewer than 2^31 cells.
  if (static_cast<long long>(rows + 2 * kTileH) * (cols + 2) >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((cols + kTileW - 1) / kTileW, (rows + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kThreadRows);
  const auto s = static_cast<cudaStream_t>(stream);
  if (fac_is_int32) {
    stencil_tile_kernel<kPadded, int><<<grid, block, 0, s>>>(
        src, static_cast<const int*>(fac), slope, slope_rad, twi, mod_twi, rows, cols, d_card,
        d_diag, px2, n_topo);
  } else {
    stencil_tile_kernel<kPadded, float><<<grid, block, 0, s>>>(
        src, static_cast<const float*>(fac), slope, slope_rad, twi, mod_twi, rows, cols, d_card,
        d_diag, px2, n_topo);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fac: int32 (fac_is_int32 != 0) or float32.  d_card, d_diag: the slope's
// divisors of the 4 cardinal and the 4 diagonal neighbours (the wrapper
// checks that the 8 D8 divisors take just these two values).
extern "C" int launch_stencil(const float* dem, const void* fac, int fac_is_int32, float* slope,
                              float* slope_rad, float* twi, float* mod_twi, int rows, int cols,
                              float d_card, float d_diag, float px2, float n_topo, void* stream) {
  return launch<false>(dem, fac, fac_is_int32, slope, slope_rad, twi, mod_twi, rows, cols,
                       d_card, d_diag, px2, n_topo, stream);
}

// padded: (rows + 2) x (cols + 2); fac and the outputs: rows x cols.
extern "C" int launch_stencil_padded(const float* padded, const void* fac, int fac_is_int32,
                                     float* slope, float* slope_rad, float* twi,
                                     float* mod_twi, int rows, int cols, float d_card,
                                     float d_diag, float px2, float n_topo, void* stream) {
  return launch<true>(padded, fac, fac_is_int32, slope, slope_rad, twi, mod_twi, rows, cols,
                      d_card, d_diag, px2, n_topo, stream);
}
