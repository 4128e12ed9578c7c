// FP->BFP converter kernels of the serving path, for Hopper (sm_90a).
//
// K1 bfp_quantize_kv_pair
//   Replaces repro/kernels/bfp_quant.py::bfp_quantize_kv_pair_kernel.
//   Fresh prefill K -> 8-bit mantissas in per-token 32-groups along
//   head_dim; V -> 8-bit mantissas in 32-token groups per channel.
// K2 convert_prefill_cache
//   Replaces repro/kernels/bfp_quant.py::convert_prefill_cache_kernel.
//   Dense prefill K (minus the online offsets) and V -> all 12 packed
//   regions of the asymmetric cache: 8-bit init block and rings, 4-bit
//   bulk nibble-packed (K in channel pairs, V in token pairs), V bulk
//   exponents bulk-relative (slot j = group j+1).
//
// Bound: bytes.  Each input float is read once and each packed byte is
// written once; a 32-group needs one max and one shift per element, a few
// operations per 4-byte load, far below the card's compute rate.
//
// Design: one block per (batch row, kv head, 32-token chunk), one thread
// per channel.  A chunk is exactly one V group, so thread c keeps its
// channel's 32 V values in registers, reduces their absmax itself and
// writes mantissas (and, for V bulk, token-pair nibbles) with the block's
// threads on consecutive addresses.  For K, warp g owns channel group g:
// each token's group is one coalesced 128-byte load, its absmax one warp
// reduction, and channel-pair nibbles one shuffle.  One exponent
// reduction per group feeds both mantissa widths.  The exponent is read
// from the float's exponent bits and every scale is an exact power of two
// built from bits, so the results equal the plain PyTorch version bit
// for bit.  K2's grid spans the whole cache (max_seq / 32 chunks) so
// that every byte of every region is written, zero where no token lies.

#include "bfp_common.cuh"

namespace {

using namespace bfp;

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

__global__ void quant_kv_pair_kernel(const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     int8_t* __restrict__ km,
                                     int8_t* __restrict__ ke,
                                     int8_t* __restrict__ vm,
                                     int8_t* __restrict__ ve, int S, int H,
                                     int hd, int bits) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int chunk = blockIdx.y, t0 = chunk * G;
  const int c = threadIdx.x, lane = c & 31, g = c >> 5, ng = hd / G;

  // K: warp g quantizes channel group g of every token of the chunk
  for (int t = 0; t < G; ++t) {
    const size_t row = (size_t(b) * S + t0 + t) * H + h;
    const float x = k[row * hd + c];
    const int e = shared_exp(warp_max(fabsf(x)));
    km[row * hd + c] = int8_t(mantissa(x, e, bits));
    if (lane == 0) ke[row * ng + g] = int8_t(e);
  }

  // V: thread c quantizes channel c of the chunk's 32-token group
  float x[G];
  float amax = 0.f;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    x[t] = v[((size_t(b) * S + t0 + t) * H + h) * hd + c];
    amax = fmaxf(amax, fabsf(x[t]));
  }
  const int e = shared_exp(amax);
#pragma unroll
  for (int t = 0; t < G; ++t)
    vm[((size_t(b) * S + t0 + t) * H + h) * hd + c] =
        int8_t(mantissa(x[t], e, bits));
  ve[((size_t(b) * (S / G) + chunk) * H + h) * hd + c] = int8_t(e);
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

struct Regions {
  int8_t *kim, *kie, *klm, *kle, *kbm, *kbe;
  int8_t *vim, *vie, *vlm, *vle, *vbm, *vbe;
};

__global__ void prefill_cache_kernel(const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ off,
                                     Regions r, int S, int H, int hd,
                                     int s_bulk) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int chunk = blockIdx.y, t0 = chunk * G;
  const int c = threadIdx.x, lane = c & 31, g = c >> 5, ng = hd / G;
  const int cg = S / G;
  const int ring_lo = max(INIT, S - LOCAL);
  const int n_bulk = max(0, S - LOCAL - INIT);   // K bulk tokens [32, S-64)
  const int n_bulk_g = max(0, cg - 3);           // V bulk groups 1..cg-3
  const size_t bh = size_t(b) * H + h;

  // row index of token slot `s` of a region with `n` slots per batch row
  auto at = [&](int n, int s) { return (size_t(b) * n + s) * H + h; };

  if (chunk < cg) {
    // ---- K: one exponent per (token, channel group) feeds 8b and 4b ----
    const float o = off[bh * hd + c];
    for (int t = 0; t < G; ++t) {
      const int tok = t0 + t;
      const float x = k[((size_t(b) * S + tok) * H + h) * hd + c] - o;
      const int e = shared_exp(warp_max(fabsf(x)));
      if (chunk == 0) {
        r.kim[at(INIT, tok) * hd + c] = int8_t(mantissa(x, e, 8));
        if (lane == 0) r.kie[at(INIT, tok) * ng + g] = int8_t(e);
      } else if (tok >= ring_lo) {
        const int slot = (tok - INIT) % LOCAL;
        r.klm[at(LOCAL, slot) * hd + c] = int8_t(mantissa(x, e, 8));
        if (lane == 0) r.kle[at(LOCAL, slot) * ng + g] = int8_t(e);
      } else {
        const int m4 = mantissa(x, e, 4);
        const int hi = __shfl_down_sync(FULL, m4, 1);
        const int slot = tok - INIT;
        if ((lane & 1) == 0)
          r.kbm[at(s_bulk, slot) * (hd / 2) + c / 2] = nibbles(m4, hi);
        if (lane == 0) r.kbe[at(s_bulk, slot) * ng + g] = int8_t(e);
      }
    }

    // ---- V: group `chunk`, channel c ----
    float x[G];
    float amax = 0.f;
#pragma unroll
    for (int t = 0; t < G; ++t) {
      x[t] = v[((size_t(b) * S + t0 + t) * H + h) * hd + c];
      amax = fmaxf(amax, fabsf(x[t]));
    }
    const int e = shared_exp(amax);
    if (chunk == 0) {
#pragma unroll
      for (int t = 0; t < G; ++t)
        r.vim[at(G, t) * hd + c] = int8_t(mantissa(x[t], e, 8));
      r.vie[at(1, 0) * hd + c] = int8_t(e);
    } else if (chunk >= cg - 2) {
      const int slot = chunk % 2;
#pragma unroll
      for (int t = 0; t < G; ++t)
        r.vlm[at(2 * G, slot * G + t) * hd + c] = int8_t(mantissa(x[t], e, 8));
      r.vle[at(2, slot) * hd + c] = int8_t(e);
    } else {
#pragma unroll
      for (int t = 0; t < G; t += 2)
        r.vbm[at(s_bulk / 2, (chunk - 1) * (G / 2) + t / 2) * hd + c] =
            nibbles(mantissa(x[t], e, 4), mantissa(x[t + 1], e, 4));
      r.vbe[at(s_bulk / G, chunk - 1) * hd + c] = int8_t(e);
    }
  }

  // ---- zero every byte of this chunk's slots that holds no token ----
  if (chunk >= 1) {
    // K bulk slots of positions t0 .. t0+31
    for (int t = 0; t < G; ++t) {
      const int slot = t0 + t - INIT;
      if (slot < n_bulk) continue;
      if (c < hd / 2) r.kbm[at(s_bulk, slot) * (hd / 2) + c] = 0;
      if (c < ng) r.kbe[at(s_bulk, slot) * ng + c] = 0;
    }
    // V bulk slot chunk-1
    if (chunk - 1 >= n_bulk_g) {
      for (int t = 0; t < G / 2; ++t)
        r.vbm[at(s_bulk / 2, (chunk - 1) * (G / 2) + t) * hd + c] = 0;
      r.vbe[at(s_bulk / G, chunk - 1) * hd + c] = 0;
    }
  } else {
    // K ring slots that no token reached (fewer than 64 ring tokens)
    const int n_ring = S > INIT ? S - ring_lo : 0;
    for (int slot = n_ring; slot < LOCAL; ++slot) {
      r.klm[at(LOCAL, slot) * hd + c] = 0;
      if (c < ng) r.kle[at(LOCAL, slot) * ng + c] = 0;
    }
    // V ring slots that hold no complete group >= 1
    for (int slot = 0; slot < 2; ++slot) {
      const bool filled = (cg - 2 >= 1 && (cg - 2) % 2 == slot) ||
                          (cg - 1 >= 1 && (cg - 1) % 2 == slot);
      if (filled) continue;
      for (int t = 0; t < G; ++t) r.vlm[at(2 * G, slot * G + t) * hd + c] = 0;
      r.vle[at(2, slot) * hd + c] = 0;
    }
  }
}

}  // namespace

extern "C" {

int bfp_quantize_kv_pair(const float* k, const float* v, int8_t* km,
                         int8_t* ke, int8_t* vm, int8_t* ve, int B, int S,
                         int H, int hd, int bits, cudaStream_t stream) {
  dim3 grid(B * H, S / G);
  quant_kv_pair_kernel<<<grid, hd, 0, stream>>>(k, v, km, ke, vm, ve, S, H,
                                                hd, bits);
  return int(cudaGetLastError());
}

int convert_prefill_cache(const float* k, const float* v, const float* off,
                          int8_t* kim, int8_t* kie, int8_t* klm, int8_t* kle,
                          int8_t* kbm, int8_t* kbe, int8_t* vim, int8_t* vie,
                          int8_t* vlm, int8_t* vle, int8_t* vbm, int8_t* vbe,
                          int B, int S, int H, int hd, int s_bulk,
                          cudaStream_t stream) {
  Regions r{kim, kie, klm, kle, kbm, kbe, vim, vie, vlm, vle, vbm, vbe};
  dim3 grid(B * H, (s_bulk + INIT) / G);
  prefill_cache_kernel<<<grid, hd, 0, stream>>>(k, v, off, r, S, H, hd,
                                                s_bulk);
  return int(cudaGetLastError());
}

}  // extern "C"
