// moe_fused: the whole routed expert layer — gather by token index, expert
// MLP, gate-weighted combine — without an (E, C, d) dispatch buffer, the port
// of the Pallas kernel src/repro/kernels/moe_fused.py:fused_moe_kernel.
//
// x (G, Tg, D) and the expert weights in float32 or bfloat16 (GELU: w1
// (E, D, F), b1 (E, F) float32, w2 (E, F, D), b2 (E, D) float32; SwiGLU: wg,
// wu (E, D, F), wd (E, F, D), no biases), the per-group queues tok_idx,
// slot_idx (G, E, C) int32 (-1 in dead slots) and gates (G, E, C) float32 (0
// in dead slots), sizes (G, E) int32, expert (G, Tg, K) int32 and valid
// (G, Tg, K) bool; out (G, Tg, D) in x's dtype.
//
// Two launches, counted as one by the wrapper:
//
// 1. moe_fused_expert_kernel — one block per (group, capacity block of 32
//    queue rows, expert), the expert slowest in launch order so the blocks
//    of one expert run together and its weights stay in L2 across groups.
//    A block reads its queue length first and returns before it touches the
//    expert's weights when the queue is empty or the block lies past its
//    end (the paper's metaqueue).  It gathers its rows of x by token index
//    into shared memory (float32), then walks the hidden dimension in chunks
//    of 64: h = act(xq @ w1 + b1) for the chunk (or act(xq @ wg) * (xq @ wu))
//    in float32 — no bf16 rounding of the hidden — and y += h @ w2, with y in
//    shared memory, so the (rows, F) hidden never exists either.  Each live
//    row's gate * (y + b2) goes, in float32, to the slot scratch (G, Tg, K,
//    D) at its (token, routing slot); dead rows write nothing.
// 2. moe_fused_combine_kernel — one block per token sums its valid slots in
//    ascending expert index, ((0 + c_e1) + c_e2) + ..., the order the
//    sequential TPU grid accumulates them in, and casts once to x's dtype.
//    No float atomics: the result does not depend on block order.
//
// The activation is exact (erf GELU / sigmoid SiLU) or the §IV-C LUT
// correction (common.cuh:lut_correction) with the half-table copied to
// shared memory.
//
// Bound on the H100: at M3ViT's shapes (8 groups x 128 tokens, 16 experts,
// top-4, d 192, f 768) a layer is ~2.4 GFLOP over ~10 MB (weights of the
// used experts, x, the slot scratch and out), so the bytes set the least
// time; this first kernel runs on the float32 FMA pipes and is limited by
// operation issue and shared-memory traffic.
#include "common.cuh"

constexpr int kRows = 32;       // queue rows per block
constexpr int kChunk = 64;      // hidden units per chunk
constexpr int kThreads = 256;   // 64 columns x 4 row lanes, 8 rows each
constexpr int kMaxK = 8;        // routing slots per token (top-k)
// dynamic shared memory a block may take: the card's 227 KB per block less
// room for the static arrays; d = 768 with the 2048-entry table needs 208 KB
constexpr int kMaxSmem = 216 * 1024;

enum Kind { kGelu = 0, kSwiglu = 1 };

template <int KIND>
__device__ __forceinline__ float activate(float h, int use_lut,
                                          const float* table, int n,
                                          float lut_scale) {
  if (use_lut) return lut_correction(h, table, n, lut_scale);
  if (KIND == kSwiglu) return h / (1.0f + expf(-h));
  return h * 0.5f * (1.0f + erff(h / 1.41421356237309515f));
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads) moe_fused_expert_kernel(
    const T* __restrict__ x, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ wu,
    const T* __restrict__ w2, const float* __restrict__ b2,
    const int* __restrict__ sizes, const int* __restrict__ tok_idx,
    const int* __restrict__ slot_idx, const float* __restrict__ gates,
    const float* __restrict__ table, int n_table, float lut_scale,
    float* __restrict__ scratch, int E, int C, int Tg, int K, int D, int F,
    int use_lut) {
  const int g = blockIdx.x, e = blockIdx.z;
  const int c0 = blockIdx.y * kRows;
  const int q = g * E + e;
  const int size = min(max(sizes[q], 0), C);
  if (c0 >= size) return;  // empty queue or past its end: w[e] untouched
  const int rows = min(kRows, size - c0);

  extern __shared__ float smem[];
  float* xs = smem;                  // kRows x D, gathered rows (float32)
  float* ys = xs + kRows * D;        // kRows x D, y = h @ w2 so far
  float* hs = ys + kRows * D;        // kRows x kChunk, this chunk's hidden
  float* ts = hs + kRows * kChunk;   // the LUT half-table
  __shared__ int toks[kRows], slots[kRows];
  __shared__ float gw[kRows];

  const int t = threadIdx.x;
  if (t < kRows) {
    const size_t i = (size_t)q * C + c0 + t;
    toks[t] = t < rows ? tok_idx[i] : -1;
    slots[t] = t < rows ? slot_idx[i] : -1;
    gw[t] = t < rows ? gates[i] : 0.0f;
  }
  if (use_lut)
    for (int i = t; i < n_table; i += kThreads) ts[i] = table[i];
  __syncthreads();
  for (int i = t; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, tok = toks[r];
    xs[i] = (tok >= 0 && tok < Tg)
                ? to_f32(x[((size_t)g * Tg + tok) * D + d]) : 0.0f;
    ys[i] = 0.0f;
  }
  __syncthreads();

  const int lane = t % kChunk, r0 = t / kChunk;  // rows r0 + 4 i, i < 8
  const T* w1e = w1 + (size_t)e * D * F;
  const T* wue = wu ? wu + (size_t)e * D * F : nullptr;
  const T* w2e = w2 + (size_t)e * F * D;
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    // h[:, f0:f0+64] for this block's rows, one column per thread
    const int f = f0 + lane;
    float a[8], u[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = u[i] = 0.0f;
    if (f < F) {
      for (int k = 0; k < D; ++k) {
        const float wa = to_f32(w1e[(size_t)k * F + f]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = fmaf(xs[(r0 + 4 * i) * D + k], wa, a[i]);
        if (KIND == kSwiglu) {
          const float wb = to_f32(wue[(size_t)k * F + f]);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            u[i] = fmaf(xs[(r0 + 4 * i) * D + k], wb, u[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float h = 0.0f;
      if (f < F) {
        if (KIND == kSwiglu)
          h = activate<KIND>(a[i], use_lut, ts, n_table, lut_scale) * u[i];
        else
          h = activate<KIND>(a[i] + b1[(size_t)e * F + f], use_lut, ts,
                             n_table, lut_scale);
      }
      hs[(r0 + 4 * i) * kChunk + lane] = h;
    }
    __syncthreads();
    // y[:, d] += h[:, chunk] @ w2[chunk, d], one column per thread per pass
    const int nf = min(kChunk, F - f0);
    for (int d = lane; d < D; d += kChunk) {
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
      for (int j = 0; j < nf; ++j) {
        const float wv = to_f32(w2e[(size_t)(f0 + j) * D + d]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i] = fmaf(hs[(r0 + 4 * i) * kChunk + j], wv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) ys[(r0 + 4 * i) * D + d] += acc[i];
    }
    __syncthreads();
  }

  // gate * (y + b2) of each live row into its (token, slot) of the scratch
  for (int i = t; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D, tok = toks[r], s = slots[r];
    if (tok < 0 || tok >= Tg || s < 0 || s >= K) continue;
    float y = ys[i];
    if (KIND == kGelu) y = y + b2[(size_t)e * D + d];
    scratch[(((size_t)g * Tg + tok) * K + s) * D + d] = gw[r] * y;
  }
}

template <typename T>
__global__ void moe_fused_combine_kernel(const float* __restrict__ scratch,
                                         const int* __restrict__ expert,
                                         const uint8_t* __restrict__ valid,
                                         T* __restrict__ out, int K, int D) {
  const size_t tok = blockIdx.x;  // g * Tg + t
  __shared__ int order[kMaxK];
  __shared__ int n_live;
  if (threadIdx.x == 0) {
    // the token's valid slots in ascending expert index (top-k experts are
    // distinct, so the order is strict)
    int prev = -1, n = 0;
    for (int r = 0; r < K; ++r) {
      int best = -1, best_e = 0;
      for (int j = 0; j < K; ++j) {
        const int ej = expert[tok * K + j];
        if (valid[tok * K + j] && ej > prev && (best < 0 || ej < best_e)) {
          best = j;
          best_e = ej;
        }
      }
      if (best < 0) break;
      order[n++] = best;
      prev = best_e;
    }
    n_live = n;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int r = 0; r < n_live; ++r)
      acc = acc + scratch[(tok * K + order[r]) * D + d];
    out[tok * D + d] = from_f32<T>(acc);
  }
}

template <typename T, int KIND>
static int launch_kind(const void* x, const void* w1, const void* b1,
                       const void* wu, const void* w2, const void* b2,
                       const void* sizes, const void* tok_idx,
                       const void* slot_idx, const void* gates,
                       const void* expert, const void* valid,
                       const void* table, int n_table, float lut_scale,
                       void* scratch, void* out, int G, int E, int C, int Tg,
                       int K, int D, int F, int use_lut,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * kRows * D +
                                       (size_t)kRows * kChunk +
                                       (use_lut ? (size_t)n_table : 0));
  // the opt-in above 48 KB, once per instantiation (so a launch inside a
  // CUDA-graph capture makes no attribute call); the wrapper keeps smem
  // within it
  static cudaError_t configured = cudaFuncSetAttribute(
      moe_fused_expert_kernel<T, KIND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (configured != cudaSuccess) return (int)configured;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  dim3 grid(G, (C + kRows - 1) / kRows, E);
  moe_fused_expert_kernel<T, KIND><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(wu),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const int*>(sizes), static_cast<const int*>(tok_idx),
      static_cast<const int*>(slot_idx), static_cast<const float*>(gates),
      static_cast<const float*>(table), n_table, lut_scale,
      static_cast<float*>(scratch), E, C, Tg, K, D, F, use_lut);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_fused_combine_kernel<T><<<G * Tg, 64, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<const int*>(expert),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), K, D);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* x, const void* w1, const void* b1,
                  const void* wu, const void* w2, const void* b2,
                  const void* sizes, const void* tok_idx,
                  const void* slot_idx, const void* gates,
                  const void* expert, const void* valid, const void* table,
                  int n_table, float lut_scale, void* scratch, void* out,
                  int G, int E, int C, int Tg, int K, int D, int F, int kind,
                  int use_lut, cudaStream_t stream) {
  if (kind == kSwiglu)
    return launch_kind<T, kSwiglu>(x, w1, b1, wu, w2, b2, sizes, tok_idx,
                                   slot_idx, gates, expert, valid, table,
                                   n_table, lut_scale, scratch, out, G, E, C,
                                   Tg, K, D, F, use_lut, stream);
  return launch_kind<T, kGelu>(x, w1, b1, wu, w2, b2, sizes, tok_idx,
                               slot_idx, gates, expert, valid, table, n_table,
                               lut_scale, scratch, out, G, E, C, Tg, K, D, F,
                               use_lut, stream);
}

extern "C" int moe_fused_launch(const void* x, const void* w1, const void* b1,
                                const void* wu, const void* w2,
                                const void* b2, const void* sizes,
                                const void* tok_idx, const void* slot_idx,
                                const void* gates, const void* expert,
                                const void* valid, const void* table,
                                int n_table, float lut_scale, void* scratch,
                                void* out, int G, int E, int C, int Tg, int K,
                                int D, int F, int kind, int use_lut,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, w1, b1, wu, w2, b2, sizes, tok_idx, slot_idx,
                         gates, expert, valid, table, n_table, lut_scale,
                         scratch, out, G, E, C, Tg, K, D, F, kind, use_lut,
                         st);
  return launch<__nv_bfloat16>(x, w1, b1, wu, w2, b2, sizes, tok_idx,
                               slot_idx, gates, expert, valid, table, n_table,
                               lut_scale, scratch, out, G, E, C, Tg, K, D, F,
                               kind, use_lut, st);
}
