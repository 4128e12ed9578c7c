// K4 bfp_attention_decode_cache, for Hopper (sm_90a).
//
// Replaces repro/kernels/bfp_attention.py::bfp_attention_decode_asym_batched.
// One-token GQA decode over the whole packed asymmetric cache: the 8-bit
// init block, the 4-bit bulk, the 8-bit K ring (with the <= 32 freshly
// demoted K tokens below it read from the bulk), the 8-bit V group ring and
// the residual V group re-quantized at its current length; left-pad start
// per row; optional softcap.
//
// Bound: bytes.  Each cache byte below the length is read once; there are
// 2 * rep multiply-adds per 4-bit value.
//
// Design: split-KV.  The TPU kernel's serial last grid step is an artifact
// of its sequential grid; here every block covers 128 positions of one
// (batch row, kv head), one 32-token tile (one V group) per warp, and picks
// each tile's region from its position: K per lane (lane = key, 16-byte
// loads of its row), V per lane (lane = channel, consecutive channels on
// consecutive addresses).  Tiles beyond the length or wholly below the
// row's start are dead and skipped.  The block merges its warps' flash
// states and writes one partial (m, l, o); a combine kernel merges the
// partials of all blocks into the normalized output.

#include <cstring>

#include "bfp_common.cuh"

namespace {

using namespace bfp;

constexpr int DC_WARPS = 4;
constexpr int DC_SPLIT = DC_WARPS * G;  // positions per block

struct Cache {
  const int8_t *kim, *kie, *klm, *kle, *kbm, *kbe;
  const float* vr;
  const int8_t *vim, *vie, *vlm, *vle, *vbm, *vbe;
};

// s[r] += q[r] . K over one 32-channel group whose mantissas (32 bytes at
// 8 bits, 16 nibble pairs at 4 bits) dequantize with the scale `sc`
template <int REP, int HD, bool FOUR>
__device__ __forceinline__ void dot_group(const int8_t* mant, float sc,
                                          const float (*qs)[HD], int d0,
                                          float* s) {
  constexpr int N = FOUR ? 16 : 32;
  int8_t bytes[N];
#pragma unroll
  for (int c = 0; c < N; c += 16) {
    const int4 w = *reinterpret_cast<const int4*>(mant + c);
    memcpy(bytes + c, &w, 16);
  }
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (FOUR) {
      const float k0 = float(lo_nibble(bytes[t])) * sc;
      const float k1 = float(hi_nibble(bytes[t])) * sc;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        s[r] = fmaf(qs[r][d0 + 2 * t], k0, s[r]);
        s[r] = fmaf(qs[r][d0 + 2 * t + 1], k1, s[r]);
      }
    } else {
      const float kv = float(bytes[t]) * sc;
#pragma unroll
      for (int r = 0; r < REP; ++r) s[r] = fmaf(qs[r][d0 + t], kv, s[r]);
    }
  }
}

template <int NG, int REP>
__global__ void __launch_bounds__(DC_WARPS * 32)
    decode_partial_kernel(const float* __restrict__ q, Cache c,
                          const int* __restrict__ start,
                          float* __restrict__ part_o,
                          float* __restrict__ part_ml, int B, int H, int Hkv,
                          int s_bulk, int L, float cap, float sqrt_hd) {
  constexpr int HD = NG * G;
  __shared__ float qs[REP][HD];
  __shared__ float wm[DC_WARPS][REP], wl[DC_WARPS][REP];
  __shared__ float wo[DC_WARPS][REP][HD];
  const int split = blockIdx.x;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < REP * HD; i += blockDim.x)
    qs[i / HD][i % HD] = q[(size_t(b) * H + h * REP + i / HD) * HD + i % HD];
  __syncthreads();

  float m[REP], l[REP], acc[REP][NG];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i) acc[r][i] = 0.f;
  }

  const int p0 = split * DC_SPLIT + warp * G;  // first position of the tile
  const int row_start = start[b];
  const int cg = L / G, r_len = L % G;
  const int R0 = G * max(cg - 2, 1);           // first window position
  const int k_ring_lo = max(INIT, L - LOCAL);  // first K position in ring

  if (p0 < L && p0 + G > row_start) {
    const int gg = p0 / G;
    const int p = p0 + lane;

    // ---- scores: lane = key position ----
    float s[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) s[r] = 0.f;
    if (p < L) {
      if (p < INIT || p >= k_ring_lo) {
        const size_t row = p < INIT
            ? (size_t(b) * INIT + p) * Hkv + h
            : (size_t(b) * LOCAL + (p - INIT) % LOCAL) * Hkv + h;
        const int8_t* mant = (p < INIT ? c.kim : c.klm) + row * HD;
        const int8_t* ex = (p < INIT ? c.kie : c.kle) + row * NG;
#pragma unroll
        for (int gi = 0; gi < NG; ++gi)
          dot_group<REP, HD, false>(mant + gi * G, exp2i(int(ex[gi]) - 6), qs,
                                    gi * G, s);
      } else {
        const size_t row = (size_t(b) * s_bulk + p - INIT) * Hkv + h;
        const int8_t* mant = c.kbm + row * (HD / 2);
        const int8_t* ex = c.kbe + row * NG;
#pragma unroll
        for (int gi = 0; gi < NG; ++gi)
          dot_group<REP, HD, true>(mant + gi * (G / 2), exp2i(int(ex[gi]) - 2),
                                   qs, gi * G, s);
      }
    }
    const bool valid = p < L && p >= row_start;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float corr;
      s[r] = softmax_step(s[r] / sqrt_hd, valid, cap, m[r], l[r], corr);
#pragma unroll
      for (int i = 0; i < NG; ++i) acc[r][i] *= corr;
    }

    // ---- P.V: lane = channel; the tile is one V group ----
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int d = lane + G * i;
      float vv[G];
      if (gg == 0) {
        const float sc = exp2i(int(c.vie[(size_t(b) * Hkv + h) * HD + d]) - 6);
#pragma unroll
        for (int j = 0; j < G; ++j)
          vv[j] = float(c.vim[((size_t(b) * G + j) * Hkv + h) * HD + d]) * sc;
      } else if (p0 < R0) {
        const size_t erow = (size_t(b) * (s_bulk / G) + gg - 1) * Hkv + h;
        const float sc = exp2i(int(c.vbe[erow * HD + d]) - 2);
#pragma unroll
        for (int j = 0; j < G; j += 2) {
          const size_t row =
              (size_t(b) * (s_bulk / 2) + (p0 - INIT + j) / 2) * Hkv + h;
          const int8_t byte = c.vbm[row * HD + d];
          vv[j] = float(lo_nibble(byte)) * sc;
          vv[j + 1] = float(hi_nibble(byte)) * sc;
        }
      } else if (gg < cg) {
        const int slot = gg % 2;
        const float sc =
            exp2i(int(c.vle[((size_t(b) * 2 + slot) * Hkv + h) * HD + d]) - 6);
#pragma unroll
        for (int j = 0; j < G; ++j)
          vv[j] = float(c.vlm[((size_t(b) * 2 * G + slot * G + j) * Hkv + h) *
                                  HD + d]) * sc;
      } else {
        // the residual group, re-quantized at its current length r_len
        float amax = 0.f;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          vv[j] = j < r_len ? c.vr[((size_t(b) * G + j) * Hkv + h) * HD + d]
                            : 0.f;
          amax = fmaxf(amax, fabsf(vv[j]));
        }
        const int e = shared_exp(amax);
        const float sc = exp2i(e - 6);
#pragma unroll
        for (int j = 0; j < G; ++j) vv[j] = float(mantissa(vv[j], e, 8)) * sc;
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int r = 0; r < REP; ++r)
          acc[r][i] = fmaf(__shfl_sync(FULL, s[r], j), vv[j], acc[r][i]);
      }
    }
  }

  // ---- merge the block's four warp states into one partial ----
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      wm[warp][r] = m[r];
      wl[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < NG; ++i) wo[warp][r][lane + G * i] = acc[r][i];
  }
  __syncthreads();
  for (int i = tid; i < REP * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < DC_WARPS; ++w) mm = fmaxf(mm, wm[w][r]);
    float o = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < DC_WARPS; ++w) {
      const float a = expf(wm[w][r] - mm);
      o += wo[w][r][d] * a;
      ll += wl[w][r] * a;
    }
    const size_t row = (size_t(split) * B + b) * H + h * REP + r;
    part_o[row * HD + d] = o;
    if (d == 0) {
      part_ml[row * 2] = mm;
      part_ml[row * 2 + 1] = ll;
    }
  }
}

__global__ void decode_combine_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_ml,
                                      float* __restrict__ out, int BH, int hd,
                                      int n_splits) {
  const int row = blockIdx.x, d = threadIdx.x;
  float mm = NEG_INF;
  for (int s = 0; s < n_splits; ++s)
    mm = fmaxf(mm, part_ml[(size_t(s) * BH + row) * 2]);
  float o = 0.f, l = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t prow = size_t(s) * BH + row;
    const float a = expf(part_ml[prow * 2] - mm);
    o += part_o[prow * hd + d] * a;
    l += part_ml[prow * 2 + 1] * a;
  }
  out[size_t(row) * hd + d] = l > 0.f ? o / fmaxf(l, 1e-30f) : 0.f;
}

struct Args {
  const float* q;
  Cache c;
  const int* start;
  float *part_o, *part_ml, *out;
  int B, H, Hkv, s_bulk, L, n_splits;
  float cap, sqrt_hd;
};

template <int NG, int REP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_splits, a.B * a.Hkv);
  decode_partial_kernel<NG, REP><<<grid, DC_WARPS * 32, 0, stream>>>(
      a.q, a.c, a.start, a.part_o, a.part_ml, a.B, a.H, a.Hkv, a.s_bulk, a.L,
      a.cap, a.sqrt_hd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<<<a.B * a.H, NG * G, 0, stream>>>(
      a.part_o, a.part_ml, a.out, a.B * a.H, NG * G, a.n_splits);
  return cudaGetLastError();
}

template <int NG>
cudaError_t launch_rep(int rep, const Args& a, cudaStream_t stream) {
  switch (rep) {
    case 1: return launch<NG, 1>(a, stream);
    case 2: return launch<NG, 2>(a, stream);
    case 4: return launch<NG, 4>(a, stream);
    case 8: return launch<NG, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bfp_attention_decode_cache(
    const float* q, const int8_t* kim, const int8_t* kie, const int8_t* klm,
    const int8_t* kle, const int8_t* kbm, const int8_t* kbe, const float* vr,
    const int8_t* vim, const int8_t* vie, const int8_t* vlm,
    const int8_t* vle, const int8_t* vbm, const int8_t* vbe, const int* start,
    float* part_o, float* part_ml, float* out, int B, int H, int Hkv, int hd,
    int s_bulk, int L, int n_splits, float cap, float sqrt_hd,
    cudaStream_t stream) {
  const Args a{q,     {kim, kie, klm, kle, kbm, kbe, vr, vim, vie, vlm, vle,
                       vbm, vbe},
               start, part_o, part_ml, out, B, H, Hkv, s_bulk, L, n_splits,
               cap,   sqrt_hd};
  switch (hd) {
    case 32: return int(launch_rep<1>(H / Hkv, a, stream));
    case 64: return int(launch_rep<2>(H / Hkv, a, stream));
    case 128: return int(launch_rep<4>(H / Hkv, a, stream));
    default: return int(cudaErrorInvalidValue);
  }
}
