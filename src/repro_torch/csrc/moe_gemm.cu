// moe_gemm: out[g, e] = buf[g, e] @ w[e] over per-expert token queues, the
// port of the Pallas kernel src/repro/kernels/moe_gemm.py:moe_gemm_kernel.
//
// buf (G, E, C, D) and w (E, D, F) in bfloat16 or float32, group_sizes
// (G, E) int32, out (G, E, C, F) in buf's dtype.  The routing groups that
// the reference vmaps over are a grid axis here, so one launch serves every
// group of a layer.  Contract: a block reads its queue length first, and
// for an empty expert or a tile past the queue writes zeros and returns
// before any of that expert's weights are read; rows at or past
// group_sizes[g, e] come out exactly zero (rows of a GEMM are independent,
// so the mask on the store suffices even with NaN in the queue tails).
//
// What bounds it on the H100: a layer at B = 8 is 8 groups x 16 experts x
// <= 68 queued rows against 192 x 768 weights — a few hundred MFLOP in 128
// small GEMMs; the bytes (live rows, each used expert's weights once, the
// whole output) set the least time.  The bf16 kernel runs the tensor-core
// mainloop of gemm_sm90.cuh on each (group, expert, F tile): the expert's
// weights are wgmma's 64-row M side and the queue its n side (n = 72 covers
// C = 68 in one tile; a 3-D tensor map over (G E, C, D) zero-fills past C),
// so no tile is mostly empty rows.  Blocks walk experts slowest, so the 8
// groups' blocks of one expert run together and share its weights in L2.
// float32 keeps the SIMT kernel (common.cuh:gemm_tile): wgmma would take it
// only as TF32.
#include "common.cuh"
#include "gemm_sm90.cuh"

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

// ------------------------------------------------- bf16 tensor cores

// grid (F tiles of 64 NWG columns, queue tiles of BT rows, E * G queues with
// the expert slowest)
template <int BT, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32)
    moe_gemm_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap xmap,
                       const int* __restrict__ sizes,
                       __nv_bfloat16* __restrict__ out, int G, int E, int C,
                       int D, int F, int stages) {
  using ML = sm90::Mainloop<BT, NWG>;
  extern __shared__ uint8_t smem[];
  const int e = blockIdx.z / G, g = blockIdx.z % G;
  const int z = g * E + e;
  const int live = min(max(sizes[z], 0), C);
  const int n0 = blockIdx.x * NWG * sm90::kWgRows, t0 = blockIdx.y * BT;
  __nv_bfloat16* o = out + (size_t)z * C * F;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  if (t0 >= live) {  // empty expert or a tile past the queue: zeros only
    const int rows = min(BT, C - t0), cols = min(NWG * sm90::kWgRows, F - n0);
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
      o[(size_t)(t0 + i / cols) * F + n0 + i % cols] = zero;
    return;
  }

  ML ml(smem, stages);
  if (threadIdx.x == 0) ml.init();
  __syncthreads();
  const int kt_total = (D + sm90::kTileK - 1) / sm90::kTileK;
  if (threadIdx.x >= ML::kConsumers) {  // the producer warp
    if (threadIdx.x == ML::kConsumers)
      ml.produce(&wmap, &xmap, n0, e, t0, z, 0, kt_total);
    return;
  }
  float acc[ML::kAcc];
  // K whole, one range; promotion groups of up to kPromote k-tiles
  ml.template consume<false>(kt_total, 1, 0, 1,
                             stages < sm90::kPromote ? stages : sm90::kPromote,
                             acc);

  // rows past the queue are stored as exact zeros, two adjacent f a thread
  const float* st = ml.stage(acc);
  constexpr int kN = NWG * sm90::kWgRows;
  for (int i = 2 * threadIdx.x; i < BT * kN; i += 2 * ML::kConsumers) {
    const int tl = i / kN, nl = i % kN;
    const int t = t0 + tl, n = n0 + nl;
    if (t >= C || n >= F) continue;  // F is even: n + 1 < F with n
    *reinterpret_cast<__nv_bfloat162*>(o + (size_t)t * F + n) =
        t < live ? __floats2bfloat162_rn(st[tl * ML::kLd + nl],
                                         st[tl * ML::kLd + nl + 1])
                 : __floats2bfloat162_rn(0.0f, 0.0f);
  }
}

template <int BT, int NWG>
static int launch_tc(const void* buf, const void* w, const void* sizes,
                     void* out, int G, int E, int C, int D, int F, int stages,
                     cudaStream_t stream) {
  CUtensorMap wmap, xmap;
  int err = sm90::encode_3d(&wmap, w, F, D, E, sm90::kTileK);
  if (err == 0) err = sm90::encode_3d(&xmap, buf, D, C, (uint64_t)G * E, BT);
  if (err != 0) return err;
  auto kernel = moe_gemm_tc_kernel<BT, NWG>;
  const size_t smem = sm90::smem_bytes(BT, NWG, stages);
  static size_t granted = 0;
  err = sm90::allow_smem(kernel, smem, granted);
  if (err != 0) return err;
  dim3 grid((F + NWG * sm90::kWgRows - 1) / (NWG * sm90::kWgRows),
            (C + BT - 1) / BT, G * E);
  kernel<<<grid, NWG * 128 + 32, smem, stream>>>(
      wmap, xmap, static_cast<const int*>(sizes),
      static_cast<__nv_bfloat16*>(out), G, E, C, D, F, stages);
  return (int)cudaGetLastError();
}

// bf16 only; bt in {8, 16, 32, 64, 72, 128}, nwg in {1, 2} (the planner's
// choices); returns a CUDA error, sm90::kEncodeError + a CUresult, or -1
// for a tile shape with no instance
extern "C" int moe_gemm_tc_launch(const void* buf, const void* w,
                                  const void* sizes, void* out, int G, int E,
                                  int C, int D, int F, int bt, int nwg,
                                  int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MG_TC(BT, NWG)                                                  \
  if (bt == BT && nwg == NWG)                                           \
    return launch_tc<BT, NWG>(buf, w, sizes, out, G, E, C, D, F, stages, \
                              st);
  MG_TC(8, 1) MG_TC(16, 1) MG_TC(32, 1) MG_TC(64, 1) MG_TC(72, 1)
  MG_TC(128, 1) MG_TC(8, 2) MG_TC(16, 2) MG_TC(32, 2) MG_TC(64, 2)
  MG_TC(72, 2) MG_TC(128, 2)
#undef MG_TC
  return -1;
}
