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
