// The calibration's counting pass over HAND, integer or float.
//
// cutoff_count_kernel (entry launch_cutoff_count) has no TPU counterpart:
// the JAX package calibrates integer HAND alone (its joint histogram) and
// sends float HAND to the host.  Here either is calibrated on the card,
// exactly: parallel/classify.py::_float_cutoffs (_integer_cutoff on
// integer HAND) turns each threshold th of a search stage into the float32
// cutoff at which the oracle's float64 predicate fl64((h - mn) / (mx - mn))
// <= th flips (>= th under "over"), so "hand <= cut" in float32 is that
// predicate, and this kernel counts, for all of one stage's cutoffs in one
// pass, the valid cells hit by each cutoff (pred) and the valid flooded
// ones among them (tp), and the flooded cells of the whole raster (for FN).
//
// Validity and the flooded bit are those of parallel/classify.py:
// _valid_mask (not NoData, and not equal to hand[0, 0] where that corner
// is data: descriptools' probe quirk) and _block_classmap (flood 1 or 2).
// An invalid cell reads as NaN, which no cutoff hits.
//
//   Bound: 8 B a cell (hand f32, flood int32), read once a pass.
//   The design:
//   - one thread counts a strided run of cells, four at a time (16-byte
//     loads where the rasters allow), into one register a cutoff: pred in
//     bits 0-15 and tp in bits 16-31, both incremented by one predicated
//     add of 1 + 65536 * flooded (the grid is sized so that no thread
//     counts 2^16 cells);
//   - the cutoffs are kernel parameters (a struct by value, at most
//     kMaxCuts), so the compares read the constant bank, and the cutoff
//     loop is unrolled to a compile-time width (4, 8, 16 or 32; padded
//     cutoffs are NaN, which nothing hits);
//   - at the end each warp sums its registers (__reduce_add_sync), one lane
//     adds them to the block's shared bins, and the block flushes them with
//     one 64-bit atomicAdd a counter.
//   The caller zeroes the counts and reads them once (one host read a
//   stage); parallel/classify.py::_counts forms TP, FP and FN from them.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCuts = 32;
constexpr int kCountThreads = 256;
constexpr float kClassNoData = -100.0f;
constexpr long long kMaxCellsPerThread = 1 << 15;  // well below the 16-bit fields' 2^16

struct CutList {
  float c[kMaxCuts];
};

__device__ __forceinline__ float masked(float h, float h00) {
  const bool valid = h != kClassNoData && !(h00 != kClassNoData && h == h00);
  return valid ? h : __int_as_float(0x7fc00000);  // NaN: no cutoff hits it
}

__device__ __forceinline__ unsigned weight(int f) {
  return 1u + ((f == 1 || f == 2) ? 65536u : 0u);
}

template <int K, bool kOver>
__device__ __forceinline__ void count_cell(float h, unsigned w, const CutList& cuts,
                                           unsigned (&acc)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool hit = kOver ? h >= cuts.c[j] : h <= cuts.c[j];
    if (hit) acc[j] += w;
  }
}

template <int K, bool kOver, bool kVec>
__global__ void __launch_bounds__(kCountThreads)
cutoff_count_kernel(const float* __restrict__ hand, const int* __restrict__ flood,
                    const float* __restrict__ h00_ptr, long long n, int k, CutList cuts,
                    unsigned long long* __restrict__ out) {
  __shared__ unsigned bins[2 * K + 1];
  for (int t = threadIdx.x; t < 2 * K + 1; t += blockDim.x) bins[t] = 0;
  __syncthreads();
  const float h00 = *h00_ptr;
  unsigned acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0;
  unsigned nfl = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (kVec) {
    const long long n4 = n / 4;
    const float4* h4 = reinterpret_cast<const float4*>(hand);
    const int4* f4 = reinterpret_cast<const int4*>(flood);
    for (long long q = first; q < n4; q += stride) {
      const float4 h = h4[q];
      const int4 f = f4[q];
      const unsigned w0 = weight(f.x), w1 = weight(f.y), w2 = weight(f.z), w3 = weight(f.w);
      nfl += (w0 >> 16) + (w1 >> 16) + (w2 >> 16) + (w3 >> 16);
      count_cell<K, kOver>(masked(h.x, h00), w0, cuts, acc);
      count_cell<K, kOver>(masked(h.y, h00), w1, cuts, acc);
      count_cell<K, kOver>(masked(h.z, h00), w2, cuts, acc);
      count_cell<K, kOver>(masked(h.w, h00), w3, cuts, acc);
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      const unsigned w = weight(flood[i]);
      nfl += w >> 16;
      count_cell<K, kOver>(masked(hand[i], h00), w, cuts, acc);
    }
  }
  const unsigned lane = threadIdx.x & 31u;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {  // k is the same for every thread: a uniform branch
      const unsigned pred = __reduce_add_sync(0xffffffffu, acc[j] & 0xFFFFu);
      const unsigned tp = __reduce_add_sync(0xffffffffu, acc[j] >> 16);
      if (lane == 0) {
        atomicAdd(&bins[j], pred);
        atomicAdd(&bins[K + j], tp);
      }
    }
  }
  const unsigned fl = __reduce_add_sync(0xffffffffu, nfl);
  if (lane == 0) atomicAdd(&bins[2 * K], fl);
  __syncthreads();
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    atomicAdd(&out[t], static_cast<unsigned long long>(bins[t]));
    atomicAdd(&out[k + t], static_cast<unsigned long long>(bins[K + t]));
  }
  if (threadIdx.x == 0) atomicAdd(&out[2 * k], static_cast<unsigned long long>(bins[2 * K]));
}

template <int K, bool kOver>
void launch_width(const float* hand, const int* flood, const float* h00, long long n, int k,
                  const CutList& cuts, unsigned long long* out, int blocks, bool vec,
                  cudaStream_t s) {
  if (vec) {
    cutoff_count_kernel<K, kOver, true><<<blocks, kCountThreads, 0, s>>>(hand, flood, h00, n, k,
                                                                          cuts, out);
  } else {
    cutoff_count_kernel<K, kOver, false><<<blocks, kCountThreads, 0, s>>>(hand, flood, h00, n, k,
                                                                           cuts, out);
  }
}

template <bool kOver>
void launch_rule(const float* hand, const int* flood, const float* h00, long long n, int k,
                 const CutList& cuts, unsigned long long* out, int blocks, bool vec,
                 cudaStream_t s) {
  if (k <= 4) {
    launch_width<4, kOver>(hand, flood, h00, n, k, cuts, out, blocks, vec, s);
  } else if (k <= 8) {
    launch_width<8, kOver>(hand, flood, h00, n, k, cuts, out, blocks, vec, s);
  } else if (k <= 16) {
    launch_width<16, kOver>(hand, flood, h00, n, k, cuts, out, blocks, vec, s);
  } else {
    launch_width<32, kOver>(hand, flood, h00, n, k, cuts, out, blocks, vec, s);
  }
}

}  // namespace

// hand (f32) and flood (int32), n cells each; h00: hand[0, 0] on the card;
// cuts: k sorted or unsorted float32 cutoffs on the host (1 <= k <= 32);
// over: the "over" rule (hand >= cut), else "under" (hand <= cut);
// counts: 2k + 1 zeroed uint64 on the card, filled with pred per cutoff,
// tp per cutoff and the flooded cells.
extern "C" int launch_cutoff_count(const void* hand, const void* flood, const void* h00,
                                   long long n, const float* cuts, int k, int over,
                                   void* counts, int sms, void* stream) {
  if (k < 1 || k > kMaxCuts || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  CutList list;
  for (int j = 0; j < kMaxCuts; ++j) list.c[j] = j < k ? cuts[j] : __builtin_nanf("");
  const bool vec = n % 4 == 0 && reinterpret_cast<std::uintptr_t>(hand) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(flood) % 16 == 0;
  const long long per_block = static_cast<long long>(kCountThreads) * (vec ? 4 : 1);
  long long blocks = (n + per_block - 1) / per_block;
  const long long resident = static_cast<long long>(sms > 0 ? sms : 1) * 8;
  if (blocks > resident) blocks = resident;
  const long long floor_blocks =
      (n + kCountThreads * kMaxCellsPerThread - 1) / (kCountThreads * kMaxCellsPerThread);
  if (blocks < floor_blocks) blocks = floor_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* hp = static_cast<const float*>(hand);
  const auto* fp = static_cast<const int*>(flood);
  const auto* zp = static_cast<const float*>(h00);
  auto* out = static_cast<unsigned long long*>(counts);
  if (over) {
    launch_rule<true>(hp, fp, zp, n, k, list, out, static_cast<int>(blocks), vec, s);
  } else {
    launch_rule<false>(hp, fp, zp, n, k, list, out, static_cast<int>(blocks), vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
