// unified_linear: y = act(x @ w + b), the port of the Pallas kernel
// src/repro/kernels/unified_linear.py:unified_linear_kernel.
//
// x (M, K) and w (K, N) in bfloat16 or float32, b (N,) float32 or absent,
// y (M, N) in x's dtype, or float32 where the caller asks (out_f32: a
// tensor-parallel row shard's partial sums, added over the ranks before
// one rounding).  Every variant ends in the same fused epilogue: float32
// bias ("widened bias type"), then none / relu / erf-GELU / SiLU or the
// LUT correction, then one round-to-nearest-even store (none to float32).
//
// What bounds it on the H100, and what the design does about it:
// - Decode (M = 8, Llama-3.2-1B, 2048..8192 wide): the weights' bytes, 1.95
//   GB a step at 3.35 TB/s.  The tensor-core kernel computes y^T = w^T x^T
//   (gemm_sm90.cuh), so 64 rows of N fill wgmma's M side and the 8 tokens
//   its n side; K is split so that about two blocks per SM stream weights
//   through a deep TMA ring, and the splits' float32 partials are summed
//   by the last block of each tile to arrive, in ascending split order (a
//   per-tile ticket the wrapper owns and the kernel resets): deterministic,
//   no float atomics, the epilogue applied once to the full sum.
// - Prefill and M3ViT (M = 1024): operations (2.0 TFLOP a prefill) on the
//   bf16 tensor cores: 128 N rows x 128 tokens a block over two consumer
//   warpgroups; narrow or short layers take tiles down to 64 x 16 so the
//   grid covers the 132 SMs (kernels/gemm_plan.py chooses).  The epilogue
//   goes through shared memory so its stores are coalesced and the LUT is
//   a shared-memory gather.
// - A row's bits do not depend on M: the K ranges a split-K launch gives
//   its blocks are the ranges a whole-K block sums one by one (each from
//   zero, added in ascending order), with the same promotion group, all
//   fixed by N, K and the SM count (kernels/gemm_plan.py).  So a prompt's
//   rows prefilled alone, in a batch, or a chunk at a time get the same
//   bits.  Where a range spans more than one promotion group, the running
//   total takes a third register tile (FOLD), which the consumers can hold
//   at 128 x 128 once a producer warpgroup gives them its registers.
// - float32 operands, and bf16 rows whose pitch is not a multiple of 16
//   bytes (TMA needs it), take the SIMT kernel below (common.cuh:gemm_tile,
//   64 x 64 tiles on the FMA pipes): wgmma would take float32 only as TF32,
//   which the float32 tolerance does not allow.  That is a shape and dtype
//   dispatch made in the wrapper, counted on its own.
#include "common.cuh"
#include "gemm_sm90.cuh"

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

// ------------------------------------------------- SIMT (float32, unaligned)

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    unified_linear_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ table, int table_n,
                          float lut_scale, void* __restrict__ y, int M,
                          int N, int K, int act, int use_lut, int out_f32) {
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
      if (out_f32)
        static_cast<float*>(y)[(size_t)r * N + c] = v;
      else
        static_cast<T*>(y)[(size_t)r * N + c] = from_f32<T>(v);
    }
  }
}

template <typename T>
static void launch(const void* x, const void* w, const void* bias,
                   const void* table, int table_n, float lut_scale, void* y,
                   int M, int N, int K, int act, int use_lut, int out_f32,
                   cudaStream_t stream) {
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  const size_t smem = use_lut ? (size_t)table_n * sizeof(float) : 0;
  unified_linear_kernel<T><<<grid, kGemmThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(table),
      table_n, lut_scale, y, M, N, K, act, use_lut, out_f32);
}

extern "C" int unified_linear_launch(const void* x, const void* w,
                                     const void* bias, const void* table,
                                     int table_n, int step_log2, void* y,
                                     int M, int N, int K, int act, int use_lut,
                                     int dtype, int out_f32, void* stream) {
  const float lut_scale = ldexpf(1.0f, -step_log2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch<float>(x, w, bias, table, table_n, lut_scale, y, M, N, K, act,
                  use_lut, out_f32, st);
  else
    launch<__nv_bfloat16>(x, w, bias, table, table_n, lut_scale, y, M, N, K,
                          act, use_lut, out_f32, st);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16 tensor cores

// grid (N tiles of 64 NWG rows, M tiles of BT tokens, K splits).  K is cut
// into `ranges` ranges of whole k-tiles (sm90::split_range), the planner's
// count from N, K and the SM count; a row's sum runs over them in the same
// order at every M (gemm_sm90.cuh, Mainloop::consume).  With splits > 1
// (splits == ranges) block z sums range z alone, stores its float32 partial
// tile to `partials` ([tile][split][register][thread]) and takes a ticket;
// the last block of the tile sums the splits in ascending order, resets the
// ticket, and runs the epilogue.  With one split a block runs every range
// itself, each from zero, added in ascending order.
// FOLD's third register tile does not fit the registers a thread gets when
// the whole block shares the file evenly (ptxas spilled it at 128 x 128):
// there the producer is a whole warpgroup, which gives its registers to the
// consumers (setmaxnreg, as in moe_fused.cu), and only its first thread
// issues the copies.
template <int NWG, bool FOLD>
constexpr int tc_threads() { return NWG * 128 + (FOLD ? 128 : 32); }
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int BT, int NWG, bool FOLD>
__global__ void __launch_bounds__(tc_threads<NWG, FOLD>(), 1)
    unified_linear_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                             const __grid_constant__ CUtensorMap xmap,
                             const float* __restrict__ bias,
                             const float* __restrict__ table, int table_n,
                             float lut_scale, void* __restrict__ y, int M,
                             int N, int K, int act, int use_lut, int out_f32,
                             int stages, int ranges, int promote,
                             float* __restrict__ partials,
                             int* __restrict__ tickets) {
  using ML = sm90::Mainloop<BT, NWG>;
  extern __shared__ uint8_t smem[];
  __shared__ int ticket;
  ML ml(smem, stages);
  float* table_s = reinterpret_cast<float*>(ml.empty + stages);
  const int splits = gridDim.z, s = blockIdx.z;
  const int kt_total = (K + sm90::kTileK - 1) / sm90::kTileK;
  const int r0 = splits > 1 ? s : 0, r1 = splits > 1 ? s + 1 : ranges;
  int kt0, kt1, unused;
  sm90::split_range(kt_total, ranges, r0, kt0, unused);
  sm90::split_range(kt_total, ranges, r1 - 1, unused, kt1);
  const int n0 = blockIdx.x * NWG * sm90::kWgRows, t0 = blockIdx.y * BT;
  if (threadIdx.x == 0) ml.init();
  __syncthreads();
  if (threadIdx.x >= ML::kConsumers) {  // the producer warp (warpgroup)
    if constexpr (FOLD)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
          kProducerRegs));
    if (threadIdx.x == ML::kConsumers)
      ml.produce(&wmap, &xmap, n0, 0, t0, 0, kt0, kt1);
    return;
  }
  if constexpr (FOLD)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));

  // the LUT half-table goes to shared memory: the epilogue's lookups are
  // a gather, which global loads would serialize line by line
  const int tid = threadIdx.x;
  const bool lut = use_lut && (act == kGelu || act == kSilu);
  if (lut) {
    for (int i = tid; i < table_n; i += ML::kConsumers) table_s[i] = table[i];
    sm90::named_barrier_sync(1, ML::kConsumers);
  }
  float acc[ML::kAcc];
  ml.template consume<FOLD>(kt_total, ranges, r0, r1, promote, acc);

  if (splits > 1) {
    constexpr int kT = ML::kConsumers;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* base = partials + (size_t)tile * splits * ML::kAcc * kT;
    float* mine = base + (size_t)s * ML::kAcc * kT;
#pragma unroll
    for (int i = 0; i < ML::kAcc; ++i) __stcg(mine + i * kT + tid, acc[i]);
    __threadfence();
    sm90::named_barrier_sync(1, kT);
    if (tid == 0) ticket = atomicAdd(&tickets[tile], 1);
    sm90::named_barrier_sync(1, kT);
    if (ticket != splits - 1) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < ML::kAcc; ++i) acc[i] = __ldcg(base + i * kT + tid);
    for (int j = 1; j < splits; ++j) {
      const float* p = base + (size_t)j * ML::kAcc * kT;
#pragma unroll
      for (int i = 0; i < ML::kAcc; ++i) acc[i] += __ldcg(p + i * kT + tid);
    }
    if (tid == 0) tickets[tile] = 0;
  }

  // bias, activation and one store per element, two adjacent n a thread
  const float* st = ml.stage(acc);
  constexpr int kN = NWG * sm90::kWgRows;
  for (int i = 2 * tid; i < BT * kN; i += 2 * ML::kConsumers) {
    const int tl = i / kN, nl = i % kN;
    const int t = t0 + tl, n = n0 + nl;
    if (t >= M || n >= N) continue;  // N is even: n + 1 < N with n
    float v0 = st[tl * ML::kLd + nl], v1 = st[tl * ML::kLd + nl + 1];
    if (bias != nullptr) {
      v0 += bias[n];
      v1 += bias[n + 1];
    }
    v0 = epilogue(v0, act, lut, table_s, table_n, lut_scale);
    v1 = epilogue(v1, act, lut, table_s, table_n, lut_scale);
    if (out_f32)
      *reinterpret_cast<float2*>(static_cast<float*>(y) + (size_t)t * N +
                                 n) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) +
                                         (size_t)t * N + n) =
          __floats2bfloat162_rn(v0, v1);
  }
}

template <int BT, int NWG, bool FOLD>
static int launch_tc(const void* x, const void* w, const void* bias,
                     const void* table, int table_n, float lut_scale, void* y,
                     int M, int N, int K, int act, int use_lut, int out_f32,
                     int splits, int stages, int ranges, int promote,
                     void* partials,
                     void* tickets, cudaStream_t stream) {
  CUtensorMap wmap, xmap;
  int err = sm90::encode_3d(&wmap, w, N, K, 1, sm90::kTileK);
  if (err == 0) err = sm90::encode_3d(&xmap, x, K, M, 1, BT);
  if (err != 0) return err;
  auto kernel = unified_linear_tc_kernel<BT, NWG, FOLD>;
  const size_t smem = sm90::smem_bytes(BT, NWG, stages) +
                      (use_lut ? (size_t)table_n * sizeof(float) : 0);
  static size_t granted = 0;
  err = sm90::allow_smem(kernel, smem, granted);
  if (err != 0) return err;
  dim3 grid((N + NWG * sm90::kWgRows - 1) / (NWG * sm90::kWgRows),
            (M + BT - 1) / BT, splits);
  kernel<<<grid, tc_threads<NWG, FOLD>(), smem, stream>>>(
      wmap, xmap, static_cast<const float*>(bias),
      static_cast<const float*>(table), table_n, lut_scale,
      y, M, N, K, act, use_lut, out_f32, stages, ranges, promote,
      static_cast<float*>(partials), static_cast<int*>(tickets));
  return (int)cudaGetLastError();
}

// bf16 only; bt in {8, 16, 32, 64, 72, 128}, nwg in {1, 2}, fold only at
// the large-M tiles (the planner's choices); `ranges` K ranges summed with
// promotion groups of `promote` k-tiles, split over `splits` blocks (1 or
// ranges);
// returns a CUDA error, sm90::kEncodeError + a CUresult, or -1 for a tile
// shape with no instance
extern "C" int unified_linear_tc_launch(const void* x, const void* w,
                                        const void* bias, const void* table,
                                        int table_n, int step_log2, void* y,
                                        int M, int N, int K, int act,
                                        int use_lut, int bt, int nwg,
                                        int splits, int stages, int ranges,
                                        int promote, int fold, int out_f32,
                                        void* partials, void* tickets,
                                        void* stream) {
  const float lut_scale = ldexpf(1.0f, -step_log2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits != 1 && splits != ranges) return -1;
#define UL_TC(BT, NWG, FOLD)                                                \
  if (bt == BT && nwg == NWG && (fold != 0) == FOLD)                        \
    return launch_tc<BT, NWG, FOLD>(x, w, bias, table, table_n, lut_scale, \
                                    y, M, N, K, act, use_lut, out_f32,     \
                                    splits, stages, ranges, promote,       \
                                    partials, tickets, st);
  UL_TC(8, 1, false) UL_TC(16, 1, false) UL_TC(32, 1, false)
  UL_TC(64, 1, false) UL_TC(72, 1, false) UL_TC(128, 1, false)
  UL_TC(8, 2, false) UL_TC(16, 2, false) UL_TC(32, 2, false)
  UL_TC(64, 2, false) UL_TC(72, 2, false) UL_TC(128, 2, false)
  UL_TC(16, 1, true) UL_TC(32, 1, true) UL_TC(64, 1, true)
  UL_TC(128, 1, true) UL_TC(64, 2, true) UL_TC(128, 2, true)
#undef UL_TC
  return -1;
}
