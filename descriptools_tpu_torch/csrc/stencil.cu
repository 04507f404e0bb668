// Stencil stage of the descriptor suite: slope, slope_rad, TWI and
// modified TWI of every cell, in one pass.
//
// stencil_kernel replaces descriptools_tpu/ops/pallas/stencil.py::
// _fused_kernel (slope + TWI over DMA-streamed row bands) and extends it to
// all four rasters of the stencil stage (descriptools_tpu/pipeline.py
// descriptor_suite).  Out-of-grid neighbours read as NoData, like the
// 1-cell NoData ring of the JAX pad.
//
// stencil_padded_kernel replaces descriptools_tpu/ops/pallas/stencil.py::
// _slope_kernel (slope of the interior of a 1-ring-padded block) and emits
// the same four rasters: the ring holds a tile's real neighbours, or NoData
// at the grid's border (the per-tile stencil of descriptools_tpu/tiled.py).
//
// Bound: device-memory bytes.  Per cell it reads the DEM (4 B, each value
// reused by up to 9 threads through L1/L2) and fac (4 B) and writes four
// float32 rasters (16 B), with ~10 divisions and 4 transcendentals: far
// below the card's arithmetic rate.  Design: one thread per cell, the
// threads of a block on consecutive cells of the row-major raster so that
// loads and stores coalesce.
// Exactness: the 8 divisors are formed on the host as f32(px * double(step))
// and every division is IEEE (no fast math, built with -fmad=false), so the
// slope is bitwise the plain PyTorch one; atanf/tanf/logf/powf differ from
// other libraries' by a few ulp.

#include <cuda_runtime.h>

namespace {

constexpr float kNoData = -100.0f;
constexpr float kEps = 0.01f;

struct Divisors {
  float d[8];
};

// D8 order: E, SE, S, SW, W, NW, N, NE.
__constant__ int kDy[8] = {0, 1, 1, 1, 0, -1, -1, -1};
__constant__ int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};

// One direction of the slope's max: keeps the steeper valid gradient.
__device__ __forceinline__ void steepest(float zc, float nbr, float div, float& best) {
  const float grad = __fdiv_rn(zc - nbr, div);
  if (nbr != kNoData && grad > best) best = grad;
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

__global__ void stencil_kernel(const float* __restrict__ dem,
                               const float* __restrict__ fac,
                               float* __restrict__ slope,
                               float* __restrict__ slope_rad,
                               float* __restrict__ twi,
                               float* __restrict__ mod_twi, int rows, int cols,
                               Divisors div, float px2, float n_topo) {
  const long long cell = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= static_cast<long long>(rows) * cols) return;
  const int idx = static_cast<int>(cell);
  const int i = idx / cols;
  const int j = idx - i * cols;
  const float zc = dem[idx];
  float best = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int y = i + kDy[k];
    const int x = j + kDx[k];
    const bool inside = y >= 0 && y < rows && x >= 0 && x < cols;
    steepest(zc, inside ? dem[y * cols + x] : kNoData, div.d[k], best);
  }
  write_stage(idx, zc, best, fac[idx], px2, n_topo, slope, slope_rad, twi, mod_twi);
}

// padded: (rows + 2) x (cols + 2); fac and the outputs: rows x cols.
__global__ void stencil_padded_kernel(const float* __restrict__ padded,
                                      const float* __restrict__ fac,
                                      float* __restrict__ slope,
                                      float* __restrict__ slope_rad,
                                      float* __restrict__ twi,
                                      float* __restrict__ mod_twi, int rows,
                                      int cols, Divisors div, float px2,
                                      float n_topo) {
  const long long cell = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= static_cast<long long>(rows) * cols) return;
  const int idx = static_cast<int>(cell);
  const int i = idx / cols;
  const int j = idx - i * cols;
  const int pcols = cols + 2;
  const int c = (i + 1) * pcols + (j + 1);
  const float zc = padded[c];
  float best = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    steepest(zc, padded[c + kDy[k] * pcols + kDx[k]], div.d[k], best);
  }
  write_stage(idx, zc, best, fac[idx], px2, n_topo, slope, slope_rad, twi, mod_twi);
}

constexpr int kThreads = 256;

unsigned blocks_for(int rows, int cols) {
  const long long n = static_cast<long long>(rows) * cols;
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

Divisors divisors_of(const float* divisors) {
  Divisors div;
  for (int k = 0; k < 8; ++k) div.d[k] = divisors[k];
  return div;
}

}  // namespace

extern "C" int launch_stencil(const float* dem, const float* fac, float* slope,
                              float* slope_rad, float* twi, float* mod_twi,
                              int rows, int cols, const float* divisors,
                              float px2, float n_topo, void* stream) {
  const unsigned blocks = blocks_for(rows, cols);
  if (blocks == 0) return 0;
  stencil_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dem, fac, slope, slope_rad, twi, mod_twi, rows, cols, divisors_of(divisors),
      px2, n_topo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_stencil_padded(const float* padded, const float* fac, float* slope,
                                     float* slope_rad, float* twi, float* mod_twi,
                                     int rows, int cols, const float* divisors,
                                     float px2, float n_topo, void* stream) {
  const unsigned blocks = blocks_for(rows, cols);
  if (blocks == 0) return 0;
  stencil_padded_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      padded, fac, slope, slope_rad, twi, mod_twi, rows, cols, divisors_of(divisors),
      px2, n_topo);
  return static_cast<int>(cudaGetLastError());
}
