// K3 bfp_attention_prefill, for Hopper (sm_90a).
//
// Replaces repro/kernels/bfp_attention.py::bfp_attention_prefill_batched.
// Causal GQA flash attention of float32 queries on BFP K (per-token
// 32-groups along head_dim) and V (32-token groups per channel),
// dequantized in the tile; online softmax with P in float32; optional
// softcap and sliding window; rows with no valid key give 0.
//
// Bound: operations.  Each causal (query, key) pair costs 2 * hd
// multiply-adds in float32 (the reference keeps float32 scores and P),
// against bytes that grow only linearly in S.
//
// Design: one block per (batch row, kv head, q tile); the q tile folds the
// GQA group, so its 32 rows (32/rep positions x rep heads) share each K/V
// tile.  A key tile is 32 tokens, exactly one V group: the block
// dequantizes it once into shared memory (exact powers of two built from
// bits), and each of the 4 warps runs 8 query rows against it — lane = key
// for the scores, lane = channel for P.V — with the softmax state in
// registers.  Tiles above the causal diagonal or outside the window are
// never loaded.  Plain float32 FMA, no tensor cores: float32 scores and P
// are the function.

#include "bfp_common.cuh"

namespace {

using namespace bfp;

constexpr int PF_WARPS = 4;
constexpr int PF_RPW = 8;                   // query rows per warp
constexpr int PF_ROWS = PF_WARPS * PF_RPW;  // rows per block

template <int NG>
__global__ void __launch_bounds__(PF_WARPS * 32)
    prefill_attn_kernel(const float* __restrict__ q,
                        const int8_t* __restrict__ km,
                        const int8_t* __restrict__ ke,
                        const int8_t* __restrict__ vm,
                        const int8_t* __restrict__ ve,
                        float* __restrict__ out, int S, int H, int Hkv,
                        int bits, int causal, int window, float cap,
                        float sqrt_hd) {
  constexpr int HD = NG * G;
  extern __shared__ float smem[];
  float* qs = smem;                    // [PF_ROWS][HD]
  float* ks = qs + PF_ROWS * HD;       // [G][HD + 1] (padded: lane = key)
  float* vs = ks + G * (HD + 1);       // [G][HD]
  const int rep = H / Hkv, bq = PF_ROWS / rep;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int q0 = blockIdx.x * bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * PF_RPW;

  // row r of the tile is position q0 + r / rep, head h * rep + r % rep
  for (int i = tid; i < PF_ROWS * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    qs[i] = q[((size_t(b) * S + q0 + r / rep) * H + h * rep + r % rep) * HD +
              d];
  }

  float m[PF_RPW], l[PF_RPW], acc[PF_RPW][NG];
#pragma unroll
  for (int r = 0; r < PF_RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i) acc[r][i] = 0.f;
  }

  const int n_kt = causal ? (q0 + bq - 1) / G + 1 : S / G;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * G;
    if (causal && window > 0 && q0 - (k0 + G - 1) >= window) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < G * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD;
      const size_t row = (size_t(b) * S + k0 + j) * Hkv + h;
      ks[j * (HD + 1) + d] =
          float(km[row * HD + d]) * exp2i(int(ke[row * NG + d / G]) - bits + 2);
      const size_t vrow = (size_t(b) * (S / G) + kt) * Hkv + h;
      vs[j * HD + d] =
          float(vm[row * HD + d]) * exp2i(int(ve[vrow * HD + d]) - bits + 2);
    }
    __syncthreads();

    float s[PF_RPW];
#pragma unroll
    for (int r = 0; r < PF_RPW; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float kv = ks[lane * (HD + 1) + d];
#pragma unroll
      for (int r = 0; r < PF_RPW; ++r)
        s[r] = fmaf(qs[(row0 + r) * HD + d], kv, s[r]);
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < PF_RPW; ++r) {
      const int dd = q0 + (row0 + r) / rep - kpos;
      const bool valid = !causal || (dd >= 0 && (window <= 0 || dd < window));
      float corr;
      s[r] = softmax_step(s[r] / sqrt_hd, valid, cap, m[r], l[r], corr);
#pragma unroll
      for (int i = 0; i < NG; ++i) acc[r][i] *= corr;
    }

#pragma unroll 4
    for (int j = 0; j < G; ++j) {
      float vv[NG];
#pragma unroll
      for (int i = 0; i < NG; ++i) vv[i] = vs[j * HD + lane + G * i];
#pragma unroll
      for (int r = 0; r < PF_RPW; ++r) {
        const float pj = __shfl_sync(FULL, s[r], j);
#pragma unroll
        for (int i = 0; i < NG; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < PF_RPW; ++r) {
    const int row = row0 + r;
    const size_t o =
        ((size_t(b) * S + q0 + row / rep) * H + h * rep + row % rep) * HD;
#pragma unroll
    for (int i = 0; i < NG; ++i)
      out[o + lane + G * i] =
          l[r] > 0.f ? acc[r][i] / fmaxf(l[r], 1e-30f) : 0.f;
  }
}

template <int NG>
cudaError_t launch(const float* q, const int8_t* km, const int8_t* ke,
                   const int8_t* vm, const int8_t* ve, float* out, int B,
                   int S, int H, int Hkv, int bits, int causal, int window,
                   float cap, float sqrt_hd, cudaStream_t stream) {
  constexpr int HD = NG * G;
  const size_t smem = sizeof(float) * (PF_ROWS * HD + G * (HD + 1) + G * HD);
  const cudaError_t err = cudaFuncSetAttribute(
      prefill_attn_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(S / (PF_ROWS / (H / Hkv)), B * Hkv);
  prefill_attn_kernel<NG><<<grid, PF_WARPS * 32, smem, stream>>>(
      q, km, ke, vm, ve, out, S, H, Hkv, bits, causal, window, cap, sqrt_hd);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bfp_attention_prefill(const float* q, const int8_t* km,
                                     const int8_t* ke, const int8_t* vm,
                                     const int8_t* ve, float* out, int B,
                                     int S, int H, int Hkv, int hd, int bits,
                                     int causal, int window, float cap,
                                     float sqrt_hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return int(launch<1>(q, km, ke, vm, ve, out, B, S, H, Hkv, bits,
                                  causal, window, cap, sqrt_hd, stream));
    case 64: return int(launch<2>(q, km, ke, vm, ve, out, B, S, H, Hkv, bits,
                                  causal, window, cap, sqrt_hd, stream));
    case 128: return int(launch<4>(q, km, ke, vm, ve, out, B, S, H, Hkv, bits,
                                   causal, window, cap, sqrt_hd, stream));
    default: return int(cudaErrorInvalidValue);
  }
}
