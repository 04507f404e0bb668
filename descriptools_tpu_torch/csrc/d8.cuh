// D8 decoding shared by the walk kernels (walk.cu, flow_fold.cu).
#pragma once

#include <climits>

constexpr int kUnres = INT_MIN;  // flow code of a walk that found no absorber

// ESRI D8 code -> (dy, dx, diagonal?); false for 0 / invalid codes.
__device__ __forceinline__ bool d8_step(int code, int& dy, int& dx, bool& diag) {
  switch (code) {
    case 1: dy = 0; dx = 1; diag = false; return true;     // E
    case 2: dy = 1; dx = 1; diag = true; return true;      // SE
    case 4: dy = 1; dx = 0; diag = false; return true;     // S
    case 8: dy = 1; dx = -1; diag = true; return true;     // SW
    case 16: dy = 0; dx = -1; diag = false; return true;   // W
    case 32: dy = -1; dx = -1; diag = true; return true;   // NW
    case 64: dy = -1; dx = 0; diag = false; return true;   // N
    case 128: dy = -1; dx = 1; diag = true; return true;   // NE
    default: return false;
  }
}

// The same decode without a branch, for the downslope kernel: the code's
// bit k (E, SE, S, SW, W, NW, N, NE for k = 0..7) indexes two tables of
// 2-bit fields (the offset + 1), and the code is valid where it is one of
// the 8 (a power of two from 1 to 128).  dy, dx and diag mean nothing where
// it is not.
__device__ __forceinline__ bool d8_decode(int code, int& dy, int& dx, bool& diag) {
  constexpr unsigned kDy = 0x01A9u;  // dy + 1 by bit: 1 2 2 2 1 0 0 0
  constexpr unsigned kDx = 0x901Au;  // dx + 1 by bit: 2 2 1 0 0 0 1 2
  const unsigned u = static_cast<unsigned>(code);
  const unsigned k = static_cast<unsigned>(__ffs(code) - 1) & 7u;
  dy = static_cast<int>((kDy >> (2u * k)) & 3u) - 1;
  dx = static_cast<int>((kDx >> (2u * k)) & 3u) - 1;
  diag = (k & 1u) != 0u;
  return u - 1u < 128u && (u & (u - 1u)) == 0u;
}
