// gelu_lut: y = ReLU(x) - delta(|x|) elementwise, the port of the Pallas
// kernel src/repro/kernels/gelu_lut.py:lut_activation_kernel.
//
// x, y in float32 or bfloat16 (any shape, flattened, contiguous); the
// float32 half-table (2048 entries at step 2^-8 by default) is copied into
// shared memory once per block and every lookup reads it from there.  The
// arithmetic is common.cuh:lut_correction, in float32.
//
// Bound on the H100: a few operations per element against 4..8 bytes moved,
// so it is bound by bytes.  A grid-stride loop over at most a few blocks per
// SM keeps the table copy per block rare; no padding of x to a 128-lane
// layout is made (the TPU wrapper's).
#include "common.cuh"

template <typename T>
__global__ void lut_activation_kernel(const T* __restrict__ x,
                                      T* __restrict__ y, long long n,
                                      const float* __restrict__ table,
                                      int table_n, float scale) {
  extern __shared__ float table_s[];
  for (int i = threadIdx.x; i < table_n; i += blockDim.x) table_s[i] = table[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    y[i] = from_f32<T>(lut_correction(to_f32(x[i]), table_s, table_n, scale));
}

template <typename T>
static void launch(const void* x, void* y, long long n, const void* table,
                   int table_n, float scale, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 8) blocks = 132 * 8;  // 8 blocks per SM on 132 SMs
  if (blocks < 1) blocks = 1;
  lut_activation_kernel<T><<<(int)blocks, threads,
                             (size_t)table_n * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n,
      static_cast<const float*>(table), table_n, scale);
}

extern "C" int lut_activation_launch(const void* x, void* y, long long n,
                                     const void* table, int table_n,
                                     int step_log2, int dtype, void* stream) {
  const float scale = ldexpf(1.0f, -step_log2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch<float>(x, y, n, table, table_n, scale, st);
  else
    launch<__nv_bfloat16>(x, y, n, table, table_n, scale, st);
  return (int)cudaGetLastError();
}
