// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes float32 or bfloat16 operands (dtype code below, the same
// codes as kernels/build.py's DTYPE_CODES), widens each element to float32
// as it is loaded, and accumulates in float32 — the numerics of the Pallas
// kernels it replaces, which upcast operands before every dot.  Stores round
// back with __float2bfloat16 (round to nearest even, as JAX's astype does).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DTypeCode { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ReLU(y) - delta(|y|) from the half-table (core/gelu.py:lut_correction).
// `scale` is 2^-step_log2, so |y| * scale is exact.  "In range" is decided
// in float before any int conversion; the index rounds half to even
// (__float2int_rn, as jnp.round / torch.round) and is clamped to n - 1; a
// non-finite y returns y * 0.5 * (1 + sign(y)): +inf -> +inf, -inf -> NaN,
// NaN -> NaN.  Written without branches (the index is clamped in float,
// where fminf also maps NaN to n - 1, and every case selects), so a warp
// never splits over a tile of values and the table loads can be issued
// together.
__device__ __forceinline__ float lut_correction(float y, const float* table,
                                                int n, float scale) {
  const float t = fabsf(y) * scale;
  const float delta = table[__float2int_rn(fminf(t, (float)(n - 1)))];
  const float r = fmaxf(y, 0.0f) - (t < (float)n ? delta : 0.0f);
  return isfinite(y) ? r : y * 0.5f * (1.0f + copysignf(1.0f, y));
}

// ---------------------------------------------------------------- GEMM tile
//
// One 64 x 64 output tile of C = A @ B (A: rows x K, row stride lda; B: K x
// cols, row stride ldb), computed by 256 threads as a 16 x 16 grid, each
// thread owning a 4 x 4 set of outputs at rows ty + 16 i, cols tx + 16 j.
// K advances in slabs of 16 through shared memory; ragged edges (rows >=
// row_end, cols >= col_end, k >= K) load as zeros, so no operand is padded.
constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kGemmThreads = 256;

struct GemmSmem {
  float a[kTileK][kTileM + 1];  // A slab stored k-major; +1 avoids bank conflicts
  float b[kTileK][kTileN];
};

template <typename T>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ A,
                                          const T* __restrict__ B, int lda,
                                          int ldb, int row0, int row_end,
                                          int col0, int col_end, int K,
                                          GemmSmem& s, float acc[4][4]) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    // A slab: 64 rows x 16 k, consecutive threads along k
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = t % kTileK;
      const int m = t / kTileK + 16 * i;
      const int r = row0 + m, k = k0 + kk;
      s.a[kk][m] = (r < row_end && k < K) ? to_f32(A[(size_t)r * lda + k])
                                          : 0.0f;
    }
    // B slab: 16 k x 64 cols, consecutive threads along cols
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = t % kTileN;
      const int kk = t / kTileN + 4 * i;
      const int c = col0 + n, k = k0 + kk;
      s.b[kk][n] = (c < col_end && k < K) ? to_f32(B[(size_t)k * ldb + c])
                                          : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}
