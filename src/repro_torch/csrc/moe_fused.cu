// moe_fused: the whole routed expert layer — gather by token index, expert
// MLP, gate-weighted combine — without an (E, C, d) dispatch buffer, the port
// of the Pallas kernel src/repro/kernels/moe_fused.py:fused_moe_kernel.
//
// x (G, Tg, D) and the expert weights in float32 or bfloat16 (GELU: w1
// (E, D, F), b1 (E, F) float32, w2 (E, F, D), b2 (E, D) float32; SwiGLU: wg,
// wu (E, D, F), wd (E, F, D), no biases), the routing (G, Tg, K): expert and
// position int32, gate float32, valid bool; sizes (G, E) int32; out
// (G, Tg, D) in x's dtype.
//
// Three launches, counted as one by the wrapper:
// 1. moe_fused_queue_kernel builds the per-group queues by reference (the
//    arrays of kernels/moe_fused.py:build_queues: token, routing slot and
//    gate of each queue row, -1 / -1 / 0 in dead rows) from the routing on
//    the card.
// 2. An expert kernel (two variants below) writes each live queue row's
//    gate * (y + b2) in float32 to the slot scratch (G, Tg, K, D) at its
//    (token, routing slot).
// 3. moe_fused_combine_kernel, one block per token, sums the token's valid
//    slots in ascending expert index, ((0 + c_e1) + c_e2) + ..., the order
//    the sequential TPU grid accumulates them in, and casts once to x's
//    dtype.  No float atomics: the result does not depend on block order.
//
// The expert kernel's variants (kernels/gemm_plan.py:plan_moe_fused):
//
// tc — bf16, D and F multiples of 8 (16-byte rows), D <= 768 (GELU; SwiGLU's
//   two first-product matrices stop it lower).  The tensor cores, in the
//   FlashAttention shape of flash_attention.cu:
//   * Rows packed by expert across groups.  Block (tile j, d-slice,
//     expert e) owns packed rows [64 j, 64 j + 64) of the
//     concatenation over g of queue(g, e)[0 : size(g, e)], found from the G
//     sizes of column e; the grid is fixed at launch from the capacity
//     bound, ceil(G C / 64) tiles an expert, the expert slowest so one
//     expert's tiles meet its weights in L2.  A tile at or past the expert's
//     live rows (an empty queue included) returns before it reads any
//     weight (the metaqueue).  Rows are independent in both products, so
//     packing changes no result.  At M3ViT's batch 8 about 70 of the 144
//     tiles are live, 64 rows each (the first kernel's blocks held ~32 live
//     rows of 68 slots).
//   * x rows gathered by token index with 16-byte cp.async into a 128-byte
//     swizzled K-major tile (D / 64 atoms of 64 rows), dead rows zero-filled:
//     Hopper's TMA has no gather.
//   * A producer warpgroup, whose first thread streams the expert's weights
//     by TMA through an mbarrier ring, one stage per 64-wide chunk of F:
//     w1[e][:, chunk] (wg and wu for SwiGLU) and w2[e][chunk, d-slice], both
//     MN-major (the transpose bit), out-of-bounds rows and columns
//     zero-filled.  It gives its registers to the consumers (setmaxnreg 40 /
//     232): at 168 a thread, ptxas spilled y and serialized the wgmmas
//     (C7512).
//   * Two consumer warpgroups take the chunks in turn (even, odd).  For each
//     chunk, h = xq w1[:, chunk] by wgmma from shared memory into float32
//     registers, then + b1 and the activation (the LUT from the shared-
//     memory half-table through common.cuh:lut_correction, or exact erf GELU
//     / SiLU) in float32, then y += h w2[chunk, :] with h as the register A
//     operand: the m64nNk16 accumulator's fragment layout is the A-fragment
//     layout, as P feeds P V in flash_attention_tc_kernel.  The (rows, F)
//     hidden never leaves registers.  The reference keeps h in float32; a
//     single bf16 h puts 8 % of M3ViT's outputs outside the bf16 tolerance
//     (tests/test_torch_moe_numerics.py), so h goes in as the bf16 pair
//     hi = bf16(h), lo = bf16(h - hi), both multiplied (none outside).
//   * y (64 rows x 64 NY columns of the d-slice, NY <= 3: 96 floats a
//     thread) accumulates on the tensor cores across all of a warpgroup's
//     chunks, with no promotion into a second float32 tile (no registers for
//     one): K is 768 here, not the GEMMs' 8192, and the output is bf16;
//     chip_smoke.py phase 2 holds it to the unchanged tolerance at the main
//     path's shapes and at d = f = 768.  The two warpgroups' partial y meet
//     in shared memory as y_even + y_odd (one float add: a second launch is
//     bit-identical), and all consumer threads store each live row's
//     gate * (y + b2) to the scratch, coalesced float4s along d.
//   * F whole in every block, at every number of routing groups: a row's
//     sum over F runs in the same order whatever the batch, so a frame's
//     output does not depend on the frames beside it.
//   * Every wgmma is issued outside any branch: the exit and the warpgroup
//     index are warp-uniform (__shfl_sync), the chunk loop's bounds are
//     uniform and each chunk commits and waits unconditionally, so ptxas
//     keeps them asynchronous (no C7518).
// simt — float32 (wgmma would take it only as TF32), bf16 rows that are not
//   16-byte multiples, and what tc's shared memory cannot hold: one block
//   per (group, capacity block of 32 queue rows, expert), rows gathered into
//   shared memory as float32, the hidden walked in chunks of 64 on the FMA
//   pipes (the port's first kernel).
//
// Bound on the H100: at M3ViT's shapes (8 groups x 128 tokens, 16 experts,
// top-4, d 192, f 768) a layer is ~2.4 GFLOP over ~10 MB (weights of the
// used experts, x, the slot scratch and out), so the bytes set the least
// time, ~3 us.  A tc block streams its expert's 590 KB from L2 (the
// expert's ~4 tiles share one read from memory) and runs ~57 MFLOP of
// wgmma (the hi/lo pair doubles the second product); with ~70 live blocks
// for 132 SMs a launch costs one block's latency, and on the H100 the
// activation between the two products (the LUT's shared-memory lookups)
// takes the largest share of it (PERF.md).
#include "common.cuh"
#include "gemm_sm90.cuh"  // encode_3d, and through it sm90.cuh

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

// The per-group queues by reference (kernels/moe_fused.py:build_queues):
// tok_idx and slot_idx (G, E, C) int32 with -1 in dead slots and gates
// (G, E, C) float32 with 0 in dead slots; each valid routing slot (token t,
// slot j) of group g at (g, expert, position).  One block per group: its
// queues are cleared, then filled.
__global__ void moe_fused_queue_kernel(const int* __restrict__ expert,
                                       const float* __restrict__ gate,
                                       const int* __restrict__ position,
                                       const uint8_t* __restrict__ valid,
                                       int* __restrict__ tok_idx,
                                       int* __restrict__ slot_idx,
                                       float* __restrict__ gates, int E,
                                       int C, int Tg, int K) {
  const size_t g = blockIdx.x, q0 = g * E * C;
  for (int i = threadIdx.x; i < E * C; i += blockDim.x) {
    tok_idx[q0 + i] = -1;
    slot_idx[q0 + i] = -1;
    gates[q0 + i] = 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Tg * K; i += blockDim.x) {
    const size_t j = g * Tg * K + i;
    const int e = expert[j], p = position[j];
    if (!valid[j] || e < 0 || e >= E || p < 0 || p >= C) continue;
    const size_t q = q0 + (size_t)e * C + p;
    tok_idx[q] = i / K;
    slot_idx[q] = i % K;
    gates[q] = gate[j];
  }
}

// One block per token: its valid slots in ascending expert index.
template <typename T>
__global__ void moe_fused_combine_kernel(const float* __restrict__ scratch,
                                         const int* __restrict__ expert,
                                         const uint8_t* __restrict__ valid,
                                         T* __restrict__ out, int K, int D) {
  const size_t tok = blockIdx.x;  // g * Tg + t
  __shared__ int order[kMaxK];
  const uint8_t* ok = valid + tok * K;
  const int* ex = expert + tok * K;
  int n_live = 0;
  for (int i = 0; i < K; ++i) n_live += ok[i] != 0;
  if (threadIdx.x < K && ok[threadIdx.x]) {
    // slot j's place among the token's valid slots in ascending expert
    // index (slot index breaks a tie, as a stable sort would)
    const int j = threadIdx.x, ej = ex[j];
    int rank = 0;
    for (int i = 0; i < K; ++i)
      rank += ok[i] && (ex[i] < ej || (ex[i] == ej && i < j));
    order[rank] = j;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int r = 0; r < n_live; ++r)
      acc = acc + scratch[(tok * K + order[r]) * D + d];
    out[tok * D + d] = from_f32<T>(acc);
  }
}

// The queues (before an expert kernel) and the ordered combine (after it),
// on the stream of both variants.
static int launch_queues(const void* expert, const void* gate,
                         const void* position, const void* valid,
                         void* queues, int G, int E, int C, int Tg, int K,
                         cudaStream_t stream) {
  int* tok_idx = static_cast<int*>(queues);
  const size_t n = (size_t)G * E * C;
  moe_fused_queue_kernel<<<G, 256, 0, stream>>>(
      static_cast<const int*>(expert), static_cast<const float*>(gate),
      static_cast<const int*>(position), static_cast<const uint8_t*>(valid),
      tok_idx, tok_idx + n, reinterpret_cast<float*>(tok_idx + 2 * n), E, C,
      Tg, K);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_combine(const void* scratch, const void* expert,
                          const void* valid, void* out, int G, int Tg, int K,
                          int D, cudaStream_t stream) {
  moe_fused_combine_kernel<T><<<G * Tg, 64, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<const int*>(expert),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), K, D);
  return (int)cudaGetLastError();
}

template <typename T, int KIND>
static int launch_kind(const void* x, const void* w1, const void* b1,
                       const void* wu, const void* w2, const void* b2,
                       const void* sizes, const int* queues,
                       const void* table, int n_table, float lut_scale,
                       void* scratch, int G, int E, int C, int Tg, int K,
                       int D, int F, int use_lut, cudaStream_t stream) {
  const size_t n = (size_t)G * E * C;
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
  dim3 grid(G, (C + kRows - 1) / kRows, E);
  moe_fused_expert_kernel<T, KIND><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(wu),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const int*>(sizes), queues, queues + n,
      reinterpret_cast<const float*>(queues + 2 * n),
      static_cast<const float*>(table), n_table, lut_scale,
      static_cast<float*>(scratch), E, C, Tg, K, D, F, use_lut);
  return (int)cudaGetLastError();
}

// the simt variant (float32, or bf16 that tc does not take).  queues: the
// int32 scratch of 3 G E C entries the queue kernel fills (tok_idx,
// slot_idx, gates); scratch: the (G, Tg, K, D) float32 slot scratch.
extern "C" int moe_fused_launch(
    const void* x, const void* w1, const void* b1, const void* wu,
    const void* w2, const void* b2, const void* sizes, const void* expert,
    const void* gate, const void* position, const void* valid,
    const void* table, int n_table, float lut_scale, void* queues,
    void* scratch, void* out, int G, int E, int C, int Tg, int K, int D,
    int F, int kind, int use_lut, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_queues(expert, gate, position, valid, queues, G, E, C, Tg,
                          K, st);
  if (err != 0) return err;
  const int* q = static_cast<const int*>(queues);
  if (dtype == kFloat32)
    err = kind == kSwiglu
              ? launch_kind<float, kSwiglu>(x, w1, b1, wu, w2, b2, sizes, q,
                                            table, n_table, lut_scale,
                                            scratch, G, E, C, Tg, K, D, F,
                                            use_lut, st)
              : launch_kind<float, kGelu>(x, w1, b1, wu, w2, b2, sizes, q,
                                          table, n_table, lut_scale, scratch,
                                          G, E, C, Tg, K, D, F, use_lut, st);
  else
    err = kind == kSwiglu
              ? launch_kind<__nv_bfloat16, kSwiglu>(
                    x, w1, b1, wu, w2, b2, sizes, q, table, n_table,
                    lut_scale, scratch, G, E, C, Tg, K, D, F, use_lut, st)
              : launch_kind<__nv_bfloat16, kGelu>(
                    x, w1, b1, wu, w2, b2, sizes, q, table, n_table,
                    lut_scale, scratch, G, E, C, Tg, K, D, F, use_lut, st);
  if (err != 0) return err;
  return dtype == kFloat32
             ? launch_combine<float>(scratch, expert, valid, out, G, Tg, K,
                                     D, st)
             : launch_combine<__nv_bfloat16>(scratch, expert, valid, out, G,
                                             Tg, K, D, st);
}

// ------------------------------------------------- bf16 tensor cores (tc)

constexpr int kTcRows = 64;                    // packed queue rows: wgmma M
constexpr int kTcChunk = 64;                   // hidden units a ring stage
constexpr int kTcWgs = 2;                      // consumer warpgroups
constexpr int kTcConsumers = 128 * kTcWgs;
// + a producer warpgroup, whose first thread issues the TMA copies: the
// register file is split by warpgroup (setmaxnreg below), so a lone
// producer warp would cost a whole warpgroup's registers all the same
constexpr int kTcThreads = kTcConsumers + 128;
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kAtom = 64 * 128;                // 64 rows x 128 B: one box

// bytes of the ring, which the epilogue reuses as the float32 y tile of
// 64 rows x (64 NY + 4) (padded against bank conflicts)
__host__ __device__ constexpr size_t tc_ring_bytes(int stage_atoms, int ny,
                                                   int stages) {
  return (size_t)stages * stage_atoms * kAtom >
                 (size_t)kTcRows * (64 * ny + 4) * 4
             ? (size_t)stages * stage_atoms * kAtom
             : (size_t)kTcRows * (64 * ny + 4) * 4;
}

// dynamic shared memory (kernels/gemm_plan.py:fused_smem_bytes): 1 KB of
// alignment slack, the x tile (ka atoms), the ring, the LUT half-table
// (rounded to 8 bytes), then the full and empty barriers
__host__ __device__ constexpr size_t tc_smem_bytes(int ka, int stage_atoms,
                                                   int ny, int stages,
                                                   int n_table) {
  return 1024 + (size_t)ka * kAtom + tc_ring_bytes(stage_atoms, ny, stages) +
         (size_t)(n_table + 1) / 2 * 8 + 16 * (size_t)stages;
}

// grid (ceil(G C / 64) tiles, d-slices of 64 NY columns, E); 3-D maps over
// w1 / wu (F, D, E) and w2 (D, F, E), boxes of 64 x 64.  LUT: the
// activation is the table's (a template argument, so the exact GELU / SiLU
// code is not interleaved with it in the element loop).
template <int KIND, int NY, bool LUT>
__global__ void __launch_bounds__(kTcThreads, 1) moe_fused_tc_kernel(
    const __grid_constant__ CUtensorMap w1map,
    const __grid_constant__ CUtensorMap wumap,
    const __grid_constant__ CUtensorMap w2map,
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ b1,
    const float* __restrict__ b2, const int* __restrict__ sizes,
    const int* __restrict__ tok_idx, const int* __restrict__ slot_idx,
    const float* __restrict__ gates, const float* __restrict__ table,
    int n_table, float lut_scale, float* __restrict__ scratch, int G, int E,
    int C, int Tg, int K, int D, int F, int ka_n, int stages) {
  constexpr int KW = KIND == kSwiglu ? 2 : 1;  // first-product matrices
  const int tile = blockIdx.x, e = blockIdx.z;
  const int n0 = blockIdx.y * 64 * NY;         // this block's d-slice
  const int p0 = tile * kTcRows;
  int total = 0;                               // the expert's live rows
  for (int g = 0; g < G; ++g) total += min(max(sizes[g * E + e], 0), C);
  // lane 0's value, so that ptxas sees the exit (and every branch after
  // it) as uniform over each warp and keeps the wgmmas asynchronous
  total = __shfl_sync(0xffffffffu, total, 0);
  if (p0 >= total) return;  // the metaqueue: no weight of e is read

  const int stage_atoms = KW * ka_n + NY;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = smem_raw + ((1024u - (sm90::smem_addr(smem_raw) & 1023u)) &
                            1023u);
  uint8_t* ring = xs + (size_t)ka_n * kAtom;
  float* ts = reinterpret_cast<float*>(
      ring + tc_ring_bytes(stage_atoms, NY, stages));
  uint64_t* full = reinterpret_cast<uint64_t*>(ts + (n_table + 1) / 2 * 2);
  uint64_t* empty = full + stages;
  __shared__ int rtok[kTcRows], rslot[kTcRows], rgrp[kTcRows];
  __shared__ float rgate[kTcRows];

  const int tid = threadIdx.x;
  if (tid < kTcRows) {  // packed row p0 + tid: its group and queue row
    const int p = p0 + tid;
    int tok = -1, slot = -1, grp = 0;
    float gw = 0.0f;
    if (p < total) {
      int before = 0, g = 0;
      for (; g < G; ++g) {
        const int s = min(max(sizes[g * E + e], 0), C);
        if (p < before + s) break;
        before += s;
      }
      const size_t i = ((size_t)g * E + e) * C + (p - before);
      tok = tok_idx[i];
      slot = slot_idx[i];
      gw = gates[i];
      grp = g;
      if (tok < 0 || tok >= Tg || slot < 0 || slot >= K) tok = -1;
    }
    rtok[tid] = tok;
    rslot[tid] = slot;
    rgrp[tid] = grp;
    rgate[tid] = gw;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);      // the producer's expect_tx
      sm90::mbar_init(&empty[s], 4);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the chunks of F, in ascending order
  const int n_chunks = (F + kTcChunk - 1) / kTcChunk;
  if (tid >= kTcConsumers) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kTcConsumers) {
      sm90::prefetch_map(&w1map);
      if (KIND == kSwiglu) sm90::prefetch_map(&wumap);
      sm90::prefetch_map(&w2map);
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % stages;
        sm90::mbar_wait(&empty[s], ((c / stages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], stage_atoms * kAtom);
        uint8_t* st = ring + (size_t)s * stage_atoms * kAtom;
        for (int ka = 0; ka < ka_n; ++ka) {
          sm90::tma_load_3d(st + ka * kAtom, &w1map, &full[s],
                            c * kTcChunk, ka * 64, e);
          if (KIND == kSwiglu)
            sm90::tma_load_3d(st + (ka_n + ka) * kAtom, &wumap, &full[s],
                              c * kTcChunk, ka * 64, e);
        }
#pragma unroll
        for (int a = 0; a < NY; ++a)
          sm90::tma_load_3d(st + (KW * ka_n + a) * kAtom, &w2map, &full[s],
                            n0 + a * 64, c * kTcChunk, e);
      }
    }
    return;
  }

  // the consumers: y, h and its bf16 pair take ~170 registers a thread,
  // past the 168 that 384 threads get at launch (ptxas would spill and
  // serialize the wgmmas, C7512)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  // the LUT half-table, then the x rows by token index (16-byte chunk q of
  // row r at chunk q ^ (r % 8) of its 128-byte row)
  if (LUT)
    for (int i = tid; i < n_table; i += kTcConsumers) ts[i] = table[i];
  const int q_row = ka_n * 8;
  for (int i = tid; i < kTcRows * q_row; i += kTcConsumers) {
    const int r = i / q_row, q = i % q_row, tok = rtok[r];
    const bool in = tok >= 0 && q * 8 < D;
    const __nv_bfloat16* src =
        in ? x + ((size_t)rgrp[r] * Tg + tok) * D + q * 8 : x;
    const uint32_t dst = sm90::smem_addr(xs + (q / 8) * kAtom + r * 128 +
                                         (((q % 8) ^ (r & 7)) << 4));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  // the x tile was written by the generic proxy; wgmma reads it through the
  // async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  sm90::named_barrier_sync(1, kTcConsumers);

  // Thread i of a warpgroup holds the accumulator entries idx = 4 j + 2 hh
  // + e2 at row 16 (i / 32) + (i % 32) / 4 + 8 hh and column 8 j + 2 (i % 4)
  // + e2 of each 64 x 64 tile.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform
  const int lane = tid % 32;
  const int r0 = 16 * ((tid % 128) / 32) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t x_addr = sm90::smem_addr(xs);
  float y[NY][32];
#pragma unroll
  for (int a = 0; a < NY; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[a][i] = 0.0f;

  for (int c = wg; c < n_chunks; c += kTcWgs) {
    const int s = c % stages;
    // With an odd ring depth the two warpgroups share a stage, and a wait on
    // a phase's parity is right only while the barrier is at most one phase
    // behind: so first wait until the stage's previous chunk was handed
    // back (its full phase has then completed too).  This warpgroup handed
    // back chunk c - 2 stages itself, so that wait is safe as well.
    if (c >= stages) sm90::mbar_wait(&empty[s], ((c - stages) / stages) & 1);
    sm90::mbar_wait(&full[s], (c / stages) & 1);
    const uint32_t st =
        sm90::smem_addr(ring + (size_t)s * stage_atoms * kAtom);

    // h = xq w1[:, chunk] (and u = xq wu[:, chunk]): 16 of d a wgmma, x 32
    // bytes along each 128-byte row, w1 16 rows of 128 bytes
    float h[32], u[KIND == kSwiglu ? 32 : 1];
    // this thread's 16 columns of b1 for the chunk, in flight while the
    // tensor cores run (F is a multiple of 8: a pair is in or out whole)
    float2 bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = c * kTcChunk + 8 * j + c0;
      bias[j] = KIND == kGelu && f < F
                    ? *reinterpret_cast<const float2*>(b1 + (size_t)e * F + f)
                    : make_float2(0.0f, 0.0f);
    }
    sm90::wgmma_fence();
    for (int ka = 0; ka < ka_n; ++ka)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t xd =
            sm90::desc_sw128(x_addr + ka * kAtom + kk * 32, 16, 1024);
        const int acc = ka > 0 || kk > 0;
        sm90::wgmma_m64n64k16_ss_bt(
            h, xd, sm90::desc_sw128(st + ka * kAtom + kk * 2048, 1024, 1024),
            acc);
        if constexpr (KIND == kSwiglu)
          sm90::wgmma_m64n64k16_ss_bt(
              u, xd,
              sm90::desc_sw128(st + (ka_n + ka) * kAtom + kk * 2048, 1024,
                               1024),
              acc);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(h);
    if constexpr (KIND == kSwiglu) sm90::fence_regs(u);

    // + b1 and the activation in float32 (columns past F give 0), then the
    // bf16 pair packed in place as the A fragments of the four 16-unit
    // slices of the chunk
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int f = c * kTcChunk + 8 * (i >> 2) + c0;
      float v[2];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        if constexpr (KIND == kSwiglu)
          v[e2] = activate<KIND>(h[i + e2], LUT, ts, n_table,
                                 lut_scale) *
                  u[i + e2];
        else
          v[e2] = activate<KIND>(
              h[i + e2] + (e2 ? bias[i >> 2].y : bias[i >> 2].x), LUT,
              ts, n_table, lut_scale);
        v[e2] = f < F ? v[e2] : 0.0f;
      }
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 l2 = __floats2bfloat162_rn(
          v[0] - __low2float(h2), v[1] - __high2float(h2));
      hi[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&l2);
    }

    // y += h_hi w2[chunk, slice] + h_lo w2[chunk, slice]: 16 hidden units a
    // wgmma, 16 rows of 128 bytes of each w2 atom
    // (the NY accumulators in turn, so consecutive wgmmas are independent)
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int a = 0; a < NY; ++a)
        sm90::wgmma_m64n64k16_rs(
            y[a], hi[kk],
            sm90::desc_sw128(st + (KW * ka_n + a) * kAtom + kk * 2048, 1024,
                             1024),
            1);
#pragma unroll
      for (int a = 0; a < NY; ++a)
        sm90::wgmma_m64n64k16_rs(
            y[a], lo[kk],
            sm90::desc_sw128(st + (KW * ka_n + a) * kAtom + kk * 2048, 1024,
                             1024),
            1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < NY; ++a) sm90::fence_regs(y[a]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::fence_regs(hi[kk]);
      sm90::fence_regs(lo[kk]);
    }
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // y = y_odd + y_even through the idle ring, then gate * (y + b2) of each
  // live row into its (token, slot) of the scratch, consecutive threads
  // along d
  constexpr int kLd = 64 * NY + 4;
  float* yt = reinterpret_cast<float*>(ring);
  sm90::named_barrier_sync(1, kTcConsumers);  // no wgmma reads the ring now
  if (wg == 1)
#pragma unroll
    for (int a = 0; a < NY; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        yt[(r0 + 8 * ((i >> 1) & 1)) * kLd + a * 64 + 8 * (i >> 2) + c0 +
           (i & 1)] = y[a][i];
  sm90::named_barrier_sync(1, kTcConsumers);
  if (wg == 0)
#pragma unroll
    for (int a = 0; a < NY; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float& o = yt[(r0 + 8 * ((i >> 1) & 1)) * kLd + a * 64 +
                      8 * (i >> 2) + c0 + (i & 1)];
        o = y[a][i] + o;
      }
  sm90::named_barrier_sync(1, kTcConsumers);
  const int cols = min(64 * NY, D - n0);  // a multiple of 8
  for (int i = tid; i < kTcRows * 16 * NY; i += kTcConsumers) {
    const int r = i / (16 * NY), col = 4 * (i % (16 * NY)), tok = rtok[r];
    if (tok < 0 || col >= cols) continue;
    float4 v = *reinterpret_cast<const float4*>(yt + r * kLd + col);
    if (KIND == kGelu) {
      const float4 b = *reinterpret_cast<const float4*>(
          b2 + (size_t)e * D + n0 + col);
      v = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
    }
    const float gw = rgate[r];
    *reinterpret_cast<float4*>(
        scratch + (((size_t)rgrp[r] * Tg + tok) * K + rslot[r]) * D + n0 +
        col) = make_float4(gw * v.x, gw * v.y, gw * v.z, gw * v.w);
  }
}

template <int KIND, int NY, bool LUT>
static int launch_tc(const void* x, const void* w1, const void* b1,
                     const void* wu, const void* w2, const void* b2,
                     const void* sizes, const int* queues, const void* table,
                     int n_table, float lut_scale, void* scratch, int G,
                     int E, int C, int Tg, int K, int D, int F, int stages,
                     cudaStream_t stream) {
  constexpr int KW = KIND == kSwiglu ? 2 : 1;
  CUtensorMap w1m, wum, w2m;
  int err = sm90::encode_3d(&w1m, w1, F, D, E, 64);
  if (err == 0 && KIND == kSwiglu)
    err = sm90::encode_3d(&wum, wu, F, D, E, 64);
  if (err == 0) err = sm90::encode_3d(&w2m, w2, D, F, E, 64);
  if (err != 0) return err;
  if (KIND != kSwiglu) wum = w1m;
  const int ka_n = (D + 63) / 64;
  if (!LUT) n_table = 0;
  const size_t smem = tc_smem_bytes(ka_n, KW * ka_n + NY, NY, stages, n_table);
  auto kernel = moe_fused_tc_kernel<KIND, NY, LUT>;
  static size_t granted = 0;
  err = sm90::allow_smem(kernel, smem, granted);
  if (err != 0) return err;
  const size_t n = (size_t)G * E * C;
  dim3 grid((G * C + kTcRows - 1) / kTcRows, (D + 64 * NY - 1) / (64 * NY),
            E);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      w1m, wum, w2m, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<const int*>(sizes), queues, queues + n,
      reinterpret_cast<const float*>(queues + 2 * n),
      static_cast<const float*>(table), n_table, lut_scale,
      static_cast<float*>(scratch), G, E, C, Tg, K, D, F, ka_n, stages);
  return (int)cudaGetLastError();
}

// the tc variant: bf16 only, D and F multiples of 8; ny (64-column atoms of
// y a warpgroup holds) and stages from kernels/gemm_plan.py:plan_moe_fused;
// queues and scratch as for moe_fused_launch.
// Returns a CUDA error or sm90::kEncodeError + a CUresult.
extern "C" int moe_fused_tc_launch(
    const void* x, const void* w1, const void* b1, const void* wu,
    const void* w2, const void* b2, const void* sizes, const void* expert,
    const void* gate, const void* position, const void* valid,
    const void* table, int n_table, float lut_scale, void* queues,
    void* scratch, void* out, int G, int E, int C, int Tg, int K, int D,
    int F, int kind, int use_lut, int ny, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_queues(expert, gate, position, valid, queues, G, E, C, Tg,
                          K, st);
  if (err != 0) return err;
  const int* q = static_cast<const int*>(queues);
#define MOE_FUSED_TC(KIND, LUT)                                           \
  (ny == 3   ? launch_tc<KIND, 3, LUT>(ARGS)                              \
   : ny == 2 ? launch_tc<KIND, 2, LUT>(ARGS)                              \
             : launch_tc<KIND, 1, LUT>(ARGS))
#define ARGS                                                               \
  x, w1, b1, wu, w2, b2, sizes, q, table, n_table, lut_scale, scratch, G, \
      E, C, Tg, K, D, F, stages, st
  if (kind == kSwiglu)
    err = use_lut ? MOE_FUSED_TC(kSwiglu, true) : MOE_FUSED_TC(kSwiglu, false);
  else
    err = use_lut ? MOE_FUSED_TC(kGelu, true) : MOE_FUSED_TC(kGelu, false);
#undef ARGS
#undef MOE_FUSED_TC
  if (err != 0) return err;
  return launch_combine<__nv_bfloat16>(scratch, expert, valid, out, G, Tg, K,
                                       D, st);
}
