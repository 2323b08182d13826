// flash_attention: tiled attention with an online-softmax carry, the port of
// the Pallas kernel src/repro/kernels/flash_attention.py:flash_attention_kernel.
//
// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) in float32 or bfloat16,
// D <= 128 (not padded), out (B, Hq, Sq, D) in q's dtype.  One block serves
// 8 query rows of one (b, h), one warp per row; query head h reads kv head
// h / (Hq / Hkv) (GQA).  K/V stream through shared memory in tiles of 32
// keys; per tile each lane scores one key, the warp reduces the tile max and
// sum, and the float32 carry (m, l, acc) is rescaled as in Algorithm 1.
// Semantics of the Pallas kernel: q scaled in float32 before the dot; keys
// masked by the padded tail, causal (k <= q) and window (k > q - window)
// from absolute positions (query i sits at i + q_offset); masked scores are
// -1e30 and their probabilities 0; K tiles that no row of the block needs
// are skipped; the output is acc / max(l, 1e-37).
//
// Bound on the H100: at M3ViT's S = 128, D = 64 a head's K and V are 32 KB
// in bf16 and the work is ~4 MFLOP, so the bytes set the least time; this
// kernel is limited by the float32 pipes and latency.  The resident query
// rows reuse each K/V tile across 8 rows (the paper's reuse schedule at
// tile granularity).
#include "common.cuh"

constexpr int kWarps = 8;      // query rows per block
constexpr int kTileKV = 32;    // keys per tile: one per lane
constexpr int kMaxD = 128;     // head_dim limit: 4 dims per lane in acc
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int Hq, int Hkv, int Sq, int Skv, int D,
                           int q_offset, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // kWarps x D, pre-scaled
  float* ks = qs + kWarps * D;             // kTileKV x (D + 1)
  float* vs = ks + kTileKV * (D + 1);      // kTileKV x D
  float* ps = vs + kTileKV * D;            // kWarps x kTileKV

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_tile = blockIdx.x * kWarps;
  const int qi = q_tile + warp;
  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + ((size_t)b * Hkv + hk) * Skv * D;
  const T* vp = v + ((size_t)b * Hkv + hk) * Skv * D;

  for (int i = threadIdx.x; i < kWarps * D; i += blockDim.x) {
    const int r = q_tile + i / D;
    qs[i] = r < Sq ? to_f32(qp[(size_t)r * D + i % D]) * scale : 0.0f;
  }

  const int qpos = qi + q_offset;
  const int q_lo = q_tile + q_offset, q_hi = q_lo + kWarps - 1;
  float m = kNegInf, l = 0.0f, acc[kMaxD / 32];
#pragma unroll
  for (int c = 0; c < kMaxD / 32; ++c) acc[c] = 0.0f;

  for (int k_lo = 0; k_lo < Skv; k_lo += kTileKV) {
    // tile-level skip, uniform over the block (the "metaqueue" of K tiles)
    if (causal && k_lo > q_hi) break;
    if (window >= 0 && k_lo + kTileKV - 1 <= q_lo - window) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kTileKV * D; i += blockDim.x) {
      const int r = i / D, d = i % D, kk = k_lo + r;
      const bool in = kk < Skv;
      ks[r * (D + 1) + d] = in ? to_f32(kp[(size_t)kk * D + d]) : 0.0f;
      vs[r * D + d] = in ? to_f32(vp[(size_t)kk * D + d]) : 0.0f;
    }
    __syncthreads();

    const int kpos = k_lo + lane;
    float s = 0.0f;
    const float* qrow = qs + warp * D;
    const float* krow = ks + lane * (D + 1);
    for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
    bool ok = kpos < Skv;
    if (causal) ok = ok && kpos <= qpos;
    if (window >= 0) ok = ok && kpos > qpos - window;
    s = ok ? s : kNegInf;

    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.0f;
    l = l * alpha + warp_sum(p);
    ps[warp * kTileKV + lane] = p;
    __syncwarp();
    const float* prow = ps + warp * kTileKV;
#pragma unroll
    for (int c = 0; c < kMaxD / 32; ++c) {
      const int d = lane + 32 * c;
      if (d >= D) break;
      float pv = 0.0f;
      for (int j = 0; j < kTileKV; ++j) pv = fmaf(prow[j], vs[j * D + d], pv);
      acc[c] = acc[c] * alpha + pv;
    }
    __syncwarp();
    m = m_new;
  }

  if (qi >= Sq) return;
  const float denom = fmaxf(l, 1e-37f);
  T* op = o + ((size_t)bh * Sq + qi) * D;
#pragma unroll
  for (int c = 0; c < kMaxD / 32; ++c) {
    const int d = lane + 32 * c;
    if (d < D) op[d] = from_f32<T>(acc[c] / denom);
  }
}

template <typename T>
static void launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, int D,
                   int q_offset, int causal, int window, float scale,
                   cudaStream_t stream) {
  dim3 grid((Sq + kWarps - 1) / kWarps, B * Hq);
  const size_t smem =
      sizeof(float) * ((size_t)kWarps * D + (size_t)kTileKV * (D + 1) +
                       (size_t)kTileKV * D + (size_t)kWarps * kTileKV);
  flash_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D,
      q_offset, causal, window, scale);
}

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      int q_offset, int causal, int window,
                                      float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, q_offset, causal,
                  window, scale, st);
  else
    launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, q_offset,
                          causal, window, scale, st);
  return (int)cudaGetLastError();
}
