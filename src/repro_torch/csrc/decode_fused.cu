// decode_fused: single-pass decode attention, one query row per (sequence,
// query head) against that sequence's KV-cache prefix, the port of the Pallas
// kernel src/repro/kernels/decode_fused.py:fused_decode_kernel.
//
// q (B, Hq, D), k and v caches (B, Hkv, Smax, D) in float32 or bfloat16,
// D <= 128 (not padded), cache_len (B,) int32 on the card, out (B, Hq, D) in
// q's dtype.  One block serves up to 8 query heads of one GQA group of one
// (b, kv head) — for Llama-3.2-1B the whole group of 4 — one warp per head,
// so each K/V tile is read from memory once for the group.  The block reads
// cache_len[b] from device memory at run time (no host sync, one launch for
// every mix of lengths) and loops over tiles of 32 keys only while
// k_lo < cache_len[b]; with a window it also skips the tiles wholly behind
// the frontier cache_len - 1 - window and masks positions inside a tile.
// Semantics of the Pallas kernel: q is scaled in its own dtype (the scale
// rounded to that dtype first) before the float32 upcast; masked scores are
// -1e30 with probability 0; the float32 carry (m, l, acc) is rescaled as in
// Algorithm 1; the output is acc / max(l, 1e-37), so cache_len == 0 gives
// exact zeros.
//
// Bound on the H100: decode reads each live K/V row once and does ~4·D
// FLOPs per key and head, far below the card's operations-per-byte line, so
// the bytes of the live prefix set the least time.  This first kernel has
// B·Hkv blocks (64 for Llama-3.2-1B at B = 8), each streaming its prefix
// alone — latency-bound; split-K over the prefix comes later.
#include "common.cuh"

constexpr int kMaxWarps = 8;   // query heads per block
constexpr int kTile = 32;      // keys per tile: one per lane
constexpr int kMaxD = 128;     // 4 dims per lane in acc
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float dwarp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

__device__ __forceinline__ float dwarp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32) decode_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ cache_len,
    T* __restrict__ o, int Hq, int Hkv, int Smax, int D, int window,
    float scale) {
  extern __shared__ float smem[];
  const int nw = blockDim.x / 32;
  float* qs = smem;                   // nw x D, scaled
  float* ks = qs + nw * D;            // kTile x (D + 1)
  float* vs = ks + kTile * (D + 1);   // kTile x D
  float* ps = vs + kTile * D;         // nw x kTile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bk = blockIdx.y, b = bk / Hkv, hk = bk % Hkv;
  const int group = Hq / Hkv;
  const int row = blockIdx.x * nw + warp;   // query head within the group
  const bool live_row = row < group;
  const int h = hk * group + row;
  const int cl = min(max(cache_len[b], 0), Smax);
  const T* kp = k + (size_t)bk * Smax * D;
  const T* vp = v + (size_t)bk * Smax * D;

  for (int i = threadIdx.x; i < nw * D; i += blockDim.x) {
    const int r = blockIdx.x * nw + i / D;
    float val = 0.0f;
    if (r < group) {
      const float qv = to_f32(q[((size_t)b * Hq + hk * group + r) * D + i % D]);
      val = to_f32(from_f32<T>(qv * scale));  // scaled in q's dtype
    }
    qs[i] = val;
  }

  float m = kNegInf, l = 0.0f, acc[kMaxD / 32];
#pragma unroll
  for (int c = 0; c < kMaxD / 32; ++c) acc[c] = 0.0f;
  const int frontier = cl - 1 - window;   // keys at or behind it are masked

  for (int k_lo = 0; k_lo < cl; k_lo += kTile) {
    if (window >= 0 && k_lo + kTile - 1 <= frontier) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
      const int r = i / D, d = i % D, kk = k_lo + r;
      const bool in = kk < cl;
      ks[r * (D + 1) + d] = in ? to_f32(kp[(size_t)kk * D + d]) : 0.0f;
      vs[r * D + d] = in ? to_f32(vp[(size_t)kk * D + d]) : 0.0f;
    }
    __syncthreads();
    if (!live_row) continue;

    const int kpos = k_lo + lane;
    float s = 0.0f;
    const float* qrow = qs + warp * D;
    const float* krow = ks + lane * (D + 1);
    for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
    bool ok = kpos < cl;
    if (window >= 0) ok = ok && kpos > frontier;
    s = ok ? s : kNegInf;

    const float m_new = fmaxf(m, dwarp_max(s));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.0f;
    l = l * alpha + dwarp_sum(p);
    ps[warp * kTile + lane] = p;
    __syncwarp();
    const float* prow = ps + warp * kTile;
#pragma unroll
    for (int c = 0; c < kMaxD / 32; ++c) {
      const int d = lane + 32 * c;
      if (d >= D) break;
      float pv = 0.0f;
      for (int j = 0; j < kTile; ++j) pv = fmaf(prow[j], vs[j * D + d], pv);
      acc[c] = acc[c] * alpha + pv;
    }
    __syncwarp();
    m = m_new;
  }

  if (!live_row) return;
  const float denom = fmaxf(l, 1e-37f);
  T* op = o + ((size_t)b * Hq + h) * D;
#pragma unroll
  for (int c = 0; c < kMaxD / 32; ++c) {
    const int d = lane + 32 * c;
    if (d < D) op[d] = from_f32<T>(acc[c] / denom);
  }
}

template <typename T>
static void launch(const void* q, const void* k, const void* v,
                   const void* cache_len, void* o, int B, int Hq, int Hkv,
                   int Smax, int D, int window, float scale,
                   cudaStream_t stream) {
  const int group = Hq / Hkv;
  const int nw = group < kMaxWarps ? group : kMaxWarps;
  dim3 grid((group + nw - 1) / nw, B * Hkv);
  const size_t smem =
      sizeof(float) * ((size_t)nw * D + (size_t)kTile * (D + 1) +
                       (size_t)kTile * D + (size_t)nw * kTile);
  decode_fused_kernel<T><<<grid, nw * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(cache_len),
      static_cast<T*>(o), Hq, Hkv, Smax, D, window, scale);
}

extern "C" int decode_fused_launch(const void* q, const void* k,
                                   const void* v, const void* cache_len,
                                   void* o, int B, int Hq, int Hkv, int Smax,
                                   int D, int window, float scale, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch<float>(q, k, v, cache_len, o, B, Hq, Hkv, Smax, D, window, scale,
                  st);
  else
    launch<__nv_bfloat16>(q, k, v, cache_len, o, B, Hq, Hkv, Smax, D, window,
                          scale, st);
  return (int)cudaGetLastError();
}
