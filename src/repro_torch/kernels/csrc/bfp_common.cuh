// Shared pieces of the BFP kernels: the cache layout constants, exact
// powers of two, the shared exponent from the float's exponent bits,
// truncating mantissas, nibbles and warp reductions.  Each kernel library
// is one translation unit that includes this header once.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bfp {

constexpr int G = 32;          // BFP group size
constexpr int INIT = 32;       // 8-bit attention-sink tokens
constexpr int LOCAL = 64;      // 8-bit K ring
constexpr int EXP_MIN = -14;   // 5-bit shared exponent range
constexpr int EXP_MAX = 15;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// exact 2^e for e in the normal range
__device__ __forceinline__ float exp2i(int e) {
  return __int_as_float((e + 127) << 23);
}

// floor(log2(absmax)) from the exponent bits, clipped; zero -> EXP_MIN
__device__ __forceinline__ int shared_exp(float absmax) {
  const int e = int((__float_as_uint(absmax) >> 23) & 0xFF) - 127;
  return min(max(e, EXP_MIN), EXP_MAX);
}

// x / 2^(e - bits + 2), truncated toward zero and clipped to the mantissa
__device__ __forceinline__ int mantissa(float x, int e, int bits) {
  const float lim = float((1 << (bits - 1)) - 1);
  const float m = truncf(x * exp2i(bits - 2 - e));
  return int(fminf(fmaxf(m, -lim), lim));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// two 4-bit mantissas in one byte: low nibble first
__device__ __forceinline__ int8_t nibbles(int lo, int hi) {
  return int8_t(uint8_t((lo & 0xF) | ((hi & 0xF) << 4)));
}

__device__ __forceinline__ int lo_nibble(int8_t byte) {
  return ((byte & 0xF) ^ 8) - 8;
}

__device__ __forceinline__ int hi_nibble(int8_t byte) { return byte >> 4; }

// one score of the online softmax for the row whose score this lane holds:
// softcap, mask, update the row's (m, l); returns P for the lane's key and
// sets `corr`, the factor that rescales the row's accumulator
__device__ __forceinline__ float softmax_step(float x, bool valid, float cap,
                                              float& m, float& l,
                                              float& corr) {
  if (cap > 0.f) x = cap * tanhf(x / cap);
  x = valid ? x : NEG_INF;
  const float m_new = fmaxf(m, warp_max(x));
  const float p = valid ? expf(x - m_new) : 0.f;
  corr = expf(m - m_new);
  l = l * corr + warp_sum(p);
  m = m_new;
  return p;
}

}  // namespace bfp

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
