// unified_linear: y = act(x @ w + b), the port of the Pallas kernel
// src/repro/kernels/unified_linear.py:unified_linear_kernel.
//
// x (M, K) and w (K, N) in float32 or bfloat16, b (N,) float32 or absent,
// y (M, N) in x's dtype.  One block computes a 64 x 64 output tile with a
// float32 accumulator over K (common.cuh:gemm_tile), then a fused epilogue:
// float32 bias ("widened bias type"), then none / relu / erf-GELU / SiLU or
// the LUT correction, then one store.  The LUT half-table is an input and is
// copied into shared memory once per block.
//
// Bound on the H100: at the M3ViT shapes (M = 128 B, K and N in 192..4864)
// a call moves 0.5..12 MB and does 0.08..1.9 GFLOP, so the bytes set its
// least time; this first kernel runs on the float32 FMA pipes, not the
// tensor cores, and its time is set by FMA issue and by load latency at
// each 16-wide K slab, far above that bound.  wgmma and TMA staging are the
// later step.
#include "common.cuh"

enum Activation { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };

__device__ __forceinline__ float epilogue(float y, int act, int use_lut,
                                          const float* table, int table_n,
                                          float lut_scale) {
  if (act == kNone) return y;
  if (act == kRelu) return fmaxf(y, 0.0f);
  if (use_lut) return lut_correction(y, table, table_n, lut_scale);
  if (act == kGelu) return y * 0.5f * (1.0f + erff(y / 1.41421356237309515f));
  return y / (1.0f + expf(-y));  // SiLU: y * sigmoid(y)
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    unified_linear_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ table, int table_n,
                          float lut_scale, T* __restrict__ y, int M, int N,
                          int K, int act, int use_lut) {
  __shared__ GemmSmem s;
  extern __shared__ float table_s[];
  const bool lut = use_lut && (act == kGelu || act == kSilu);
  if (lut)
    for (int i = threadIdx.x; i < table_n; i += blockDim.x)
      table_s[i] = table[i];

  const int row0 = blockIdx.y * kTileM, col0 = blockIdx.x * kTileN;
  float acc[4][4];
  gemm_tile(x, w, K, N, row0, M, col0, N, K, s, acc);  // syncs after the table copy

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[c];
      v = epilogue(v, act, lut, table_s, table_n, lut_scale);
      y[(size_t)r * N + c] = from_f32<T>(v);
    }
  }
}

template <typename T>
static void launch(const void* x, const void* w, const void* bias,
                   const void* table, int table_n, float lut_scale, void* y,
                   int M, int N, int K, int act, int use_lut,
                   cudaStream_t stream) {
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  const size_t smem = use_lut ? (size_t)table_n * sizeof(float) : 0;
  unified_linear_kernel<T><<<grid, kGemmThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(table),
      table_n, lut_scale, static_cast<T*>(y), M, N, K, act, use_lut);
}

extern "C" int unified_linear_launch(const void* x, const void* w,
                                     const void* bias, const void* table,
                                     int table_n, int step_log2, void* y,
                                     int M, int N, int K, int act, int use_lut,
                                     int dtype, void* stream) {
  const float lut_scale = ldexpf(1.0f, -step_log2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch<float>(x, w, bias, table, table_n, lut_scale, y, M, N, K, act,
                  use_lut, st);
  else
    launch<__nv_bfloat16>(x, w, bias, table, table_n, lut_scale, y, M, N, K,
                          act, use_lut, st);
  return (int)cudaGetLastError();
}
