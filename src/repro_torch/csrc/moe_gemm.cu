// moe_gemm: out[g, e] = buf[g, e] @ w[e] over per-expert token queues, the
// port of the Pallas kernel src/repro/kernels/moe_gemm.py:moe_gemm_kernel.
//
// buf (G, E, C, D) and w (E, D, F) in float32 or bfloat16, group_sizes
// (G, E) int32, out (G, E, C, F) in buf's dtype.  The routing groups that
// the reference vmaps over are a leading grid axis here, so one launch
// serves every group of a layer.  Contract: an expert whose queue is empty
// is skipped before any of its weights are read; rows at or past
// group_sizes[g, e] come out exactly zero; the queue's live rows are the
// only rows of buf that are read.
//
// Bound on the H100: with 16 experts x 68 slots x 192..768 the layer is a
// few hundred MFLOP spread over G * E small GEMMs; the bytes set its least
// time, and this first kernel, on the float32 FMA pipes, is limited by
// operation issue and load latency.  The grid's z axis makes each
// (group, expert) queue its own set of blocks so the card stays busy, and
// tiles past a queue's end write zeros and return without touching w.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    moe_gemm_kernel(const T* __restrict__ buf, const T* __restrict__ w,
                    const int* __restrict__ sizes, T* __restrict__ out, int E,
                    int C, int D, int F) {
  __shared__ GemmSmem s;
  const int z = blockIdx.z;           // g * E + e
  const int e = z % E;
  const int live = min(max(sizes[z], 0), C);
  const int row0 = blockIdx.y * kTileM, col0 = blockIdx.x * kTileN;
  T* o = out + (size_t)z * C * F;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  if (row0 >= live) {  // empty expert or a tile past the queue: zeros only
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      if (r >= C) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c < F) o[(size_t)r * F + c] = from_f32<T>(0.0f);
      }
    }
    return;
  }

  float acc[4][4];
  gemm_tile(buf + (size_t)z * C * D, w + (size_t)e * D * F, D, F, row0, live,
            col0, F, D, s, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < F)
        o[(size_t)r * F + c] = from_f32<T>(r < live ? acc[i][j] : 0.0f);
    }
  }
}

template <typename T>
static void launch(const void* buf, const void* w, const void* sizes,
                   void* out, int Z, int E, int C, int D, int F,
                   cudaStream_t stream) {
  dim3 grid((F + kTileN - 1) / kTileN, (C + kTileM - 1) / kTileM, Z);
  moe_gemm_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(w),
      static_cast<const int*>(sizes), static_cast<T*>(out), E, C, D, F);
}

extern "C" int moe_gemm_launch(const void* buf, const void* w,
                               const void* sizes, void* out, int Z, int E,
                               int C, int D, int F, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch<float>(buf, w, sizes, out, Z, E, C, D, F, st);
  else
    launch<__nv_bfloat16>(buf, w, sizes, out, Z, E, C, D, F, st);
  return (int)cudaGetLastError();
}
