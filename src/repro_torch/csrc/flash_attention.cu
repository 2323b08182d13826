// flash_attention: tiled attention with an online-softmax carry, the port of
// the Pallas kernel src/repro/kernels/flash_attention.py:flash_attention_kernel.
//
// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out (B, Hq, Sq, D) contiguous
// in q's dtype; query head h reads kv head h / (Hq / Hkv) (GQA).
// Semantics of the Pallas kernel, kept by both variants: the scale applied
// in float32 (to q, or to the float32 scores);
// keys masked by the padded tail, causal (k <= q) and window (k > q - window)
// from absolute positions (query i sits at i + q_offset); masked scores are
// -1e30 and their probabilities 0; the softmax statistics are float32 and
// the carry (m, l, acc) is rescaled as in Algorithm 1; K tiles that no row
// of the block needs are skipped (uniformly over the block: the causal
// early exit, the window's look-back); the output is acc / max(l, 1e-37),
// so a fully masked row gives exact zeros; bf16 rounds to nearest even.
//
// Bound on the H100: at the paths' shapes (S = 128 visible keys, D = 64) a
// head is 4 MFLOP over 64 KB of bf16 q/k/v/o, so the bytes set the least
// time; what a launch costs in practice is latency (a block sees one or
// two K tiles).  Two variants (kernels/attn_plan.py picks one):
//
// tc — bf16, D % 16 == 0, D <= 128.  One block per (b, q head, 64 query
//   rows): one consumer warpgroup and one producer warp.  The producer's
//   lane 0 loads the Q tile once and streams K/V tiles of 64 keys through a
//   2-stage TMA ring (128-byte swizzle, mbarriers, out-of-bounds rows and
//   head dims zero-filled) from 4-D tensor maps built from the tensors'
//   strides, so transposed (B, S, H, D) views need no copy.  D is padded to
//   64-wide atoms in shared memory (D = 48 reads 16 zero columns).
//   S = Q K^T is wgmma m64n64k16 from shared memory, both operands K-major,
//   into float32; `scale` (times log2 e, for exp2f) multiplies the float32
//   S (the reference scales q in float32, and q * scale rounded to bf16 is
//   exact only for a power of two).  Masking and the online max and sum
//   run in registers (a tile that every row sees whole skips the mask): a
//   row lives in one quad of lanes, reduced with two shuffles.  The next
//   tile's S is not issued ahead of this tile's softmax: its second
//   register tile costs a resident block per SM, and the LM prefill's
//   blocks see one or two tiles each.  P V runs on the tensor cores with A
//   from registers: the S accumulator's fragment layout is the A-fragment
//   layout of m64nNk16, so P never goes through shared memory;
//   V's tile is MN-major (transpose bit 1).  P is split into a bf16 pair,
//   hi = bf16(P), lo = bf16(P - hi), and both are multiplied: the reference
//   keeps P in float32, and a single bf16 P puts a share of the outputs
//   outside the bf16 tolerance (one bf16 ulp of the output plus
//   1e-5; tests/test_torch_attention_numerics.py holds both models against
//   the Pallas kernel), the pair none.  That doubles P V's tensor work,
//   which is small beside the latency.  Each tile's P V goes into a fresh
//   register tile that is added as acc * alpha + pv with float32 adds, as
//   the reference adds it, so the tensor core's own accumulation never
//   spans more than one tile.
// simt — float32, D not a multiple of 16, or anything tc refuses: 8 query
//   rows a block, one warp per row, K/V tiles of 32 keys widened to float32
//   in shared memory (the first kernel of the port).
#include "common.cuh"
#include "sm90.cuh"

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

// ------------------------------------------------- bf16 tensor cores (tc)

constexpr int kTcRows = 64;                  // query rows a block: wgmma M
constexpr int kTcKeys = 64;                  // keys a K/V tile: wgmma N of S
constexpr int kTcStages = 2;                 // K/V ring depth
constexpr int kAtomBytes = 64 * 128;         // 64 rows x 64 bf16 (one swizzle row)
constexpr int kTcConsumers = 128;            // one warpgroup
constexpr int kTcThreads = kTcConsumers + 32;  // + the producer warp

// dynamic shared memory: 1 KB of alignment slack, Q (NA atoms), the K and V
// rings (stages x NA atoms each), then the barriers (q, full, empty)
__host__ __device__ constexpr size_t tc_smem_bytes(int na) {
  return 1024 + (size_t)na * kAtomBytes * (1 + 2 * kTcStages) +
         8 * (1 + 2 * kTcStages);
}

// K tiles [kt0, kt1) that the block's query rows (absolute positions
// q_lo..q_hi) need; every tile in between is needed, so producer and
// consumer walk the same range
__device__ __forceinline__ void tc_tiles(int Skv, int q_lo, int q_hi,
                                         int causal, int window, int& kt0,
                                         int& kt1) {
  kt1 = (Skv + kTcKeys - 1) / kTcKeys;
  if (causal) kt1 = min(kt1, q_hi < 0 ? 0 : q_hi / kTcKeys + 1);
  kt0 = 0;
  if (window >= 0) {
    const int x = q_lo - window - (kTcKeys - 1);  // need k_lo > x
    kt0 = x < 0 ? 0 : x / kTcKeys + 1;
  }
}

// S = Q K^T of one tile into s (committed, not waited): 16 head dims a
// wgmma, 32 bytes along each 128-byte row, 8-row groups 1024 bytes apart
template <int NA>
__device__ __forceinline__ void issue_s(float (&s)[32], uint32_t q_addr,
                                        uint32_t k_addr) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NA; ++kk) {
    const uint32_t off = (kk / 4) * kAtomBytes + (kk % 4) * 32;
    sm90::wgmma_m64n64k16_ss(s, sm90::desc_sw128(q_addr + off, 16, 1024),
                             sm90::desc_sw128(k_addr + off, 16, 1024),
                             kk > 0);
  }
  sm90::wgmma_commit();
}

// grid (query tiles of 64 rows, B * Hq); 4-D maps over (D, S, H, B)
template <int NA>
__global__ void __launch_bounds__(kTcThreads)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
                              int Sq, int Skv, int D, int q_offset,
                              int causal, int window, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024u - (sm90::smem_addr(smem_raw) & 1023u)) &
                            1023u);
  uint8_t* ks = qs + NA * kAtomBytes;
  uint8_t* vs = ks + kTcStages * NA * kAtomBytes;
  uint64_t* qbar =
      reinterpret_cast<uint64_t*>(vs + kTcStages * NA * kAtomBytes);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kTcStages;

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kTcRows;
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + kTcRows, Sq) - 1 + q_offset;
  int kt0, kt1;
  tc_tiles(Skv, q_lo, q_hi, causal, window, kt0, kt1);

  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < kTcStages; ++s) {
      sm90::mbar_init(&full[s], 1);                  // the producer's expect_tx
      sm90::mbar_init(&empty[s], kTcConsumers / 32);  // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {  // the producer warp
    if (threadIdx.x == kTcConsumers) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&kmap);
      sm90::prefetch_map(&vmap);
      sm90::mbar_arrive_expect_tx(qbar, NA * kAtomBytes);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        sm90::tma_load_4d(qs + a * kAtomBytes, &qmap, qbar, a * 64, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds it free
        sm90::mbar_arrive_expect_tx(&full[stage], 2 * NA * kAtomBytes);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const int at = stage * NA + a;
          sm90::tma_load_4d(ks + at * kAtomBytes, &kmap, &full[stage], a * 64,
                            kt * kTcKeys, hk, b);
          sm90::tma_load_4d(vs + at * kAtomBytes, &vmap, &full[stage], a * 64,
                            kt * kTcKeys, hk, b);
        }
        if (++stage == kTcStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroup.  Thread i holds the accumulator entries
  // idx = 4 j + 2 hh + e at row 16 (i / 32) + (i % 32) / 4 + 8 hh and
  // column 8 j + 2 (i % 4) + e of each 64 x 64 tile.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  float acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const uint32_t q_addr = sm90::smem_addr(qs);

  const float scale2 = scale * 1.4426950408889634f;  // exp2 units
  int stage = 0;
  uint32_t phase = 0;
  sm90::mbar_wait(qbar, 0);
  for (int kt = kt0; kt < kt1; ++kt) {
    sm90::mbar_wait(&full[stage], phase);
    float s[32];
    issue_s<NA>(s, q_addr, sm90::smem_addr(ks + stage * NA * kAtomBytes));
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    const uint32_t v_addr = sm90::smem_addr(vs + stage * NA * kAtomBytes);

    // scale, mask, and the tile's row maxima (a row lives in one quad);
    // a tile every row of the block sees whole skips the mask
    const int k_lo = kt * kTcKeys;
    const bool whole = k_lo + kTcKeys <= Skv &&
                       (!causal || k_lo + kTcKeys - 1 <= q_lo) &&
                       (window < 0 || k_lo > q_hi - window);
    uint32_t ok_bits = 0;
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int key = k_lo + 8 * (i >> 2) + c0 + (i & 1);
      const int qpos = q0 + r0 + 8 * hh + q_offset;
      bool ok = whole || key < Skv;
      if (causal) ok = ok && (whole || key <= qpos);
      if (window >= 0) ok = ok && (whole || key > qpos - window);
      s[i] = ok ? s[i] * scale2 : kNegInf;
      ok_bits |= (uint32_t)ok << i;
      tmax[hh] = fmaxf(tmax[hh], s[i]);
    }
    float alpha[2], m_new[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffff, tmax[hh], 1));
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffff, tmax[hh], 2));
      m_new[hh] = fmaxf(m[hh], tmax[hh]);
      alpha[hh] = exp2f(m[hh] - m_new[hh]);
    }

    // P in float32, split into the bf16 pair hi + lo, packed in place as
    // the A fragments of the four 16-key chunks
    uint32_t p_hi[4][4], p_lo[4][4];
    float rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hh = (i >> 1) & 1;
      float p[2];
      __nv_bfloat16 hi[2], lo[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = (ok_bits >> (i + e)) & 1u ? exp2f(s[i + e] - m_new[hh]) : 0.0f;
        rsum[hh] += p[e];
        hi[e] = __float2bfloat16(p[e]);
        lo[e] = __float2bfloat16(p[e] - __bfloat162float(hi[e]));
      }
      __nv_bfloat162 h2 = __halves2bfloat162(hi[0], hi[1]);
      __nv_bfloat162 l2 = __halves2bfloat162(lo[0], lo[1]);
      p_hi[i / 8][(i % 8) / 2] = *reinterpret_cast<uint32_t*>(&h2);
      p_lo[i / 8][(i % 8) / 2] = *reinterpret_cast<uint32_t*>(&l2);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rsum[hh] += __shfl_xor_sync(0xffffffff, rsum[hh], 1);
      rsum[hh] += __shfl_xor_sync(0xffffffff, rsum[hh], 2);
      l[hh] = l[hh] * alpha[hh] + rsum[hh];
      m[hh] = m_new[hh];
    }

    // pv = P_hi V + P_lo V into a fresh tile: 16 keys a wgmma, 16 rows of
    // 128 bytes, 8-row groups 1024 bytes apart
    float pv[NA][32];
    sm90::wgmma_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t vd =
            sm90::desc_sw128(v_addr + a * kAtomBytes + kk * 2048, 1024, 1024);
        sm90::wgmma_m64n64k16_rs(pv[a], p_hi[kk], vd, kk > 0);
        sm90::wgmma_m64n64k16_rs(pv[a], p_lo[kk], vd, 1);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) sm90::fence_regs(pv[a]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::fence_regs(p_hi[kk]);
      sm90::fence_regs(p_lo[kk]);
    }
    if (lane == 0) sm90::mbar_arrive(&empty[stage]);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[a][i] = acc[a][i] * alpha[(i >> 1) & 1] + pv[a][i];
    if (++stage == kTcStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // out = acc / max(l, 1e-37), bf16 pairs
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[hh], 1e-37f);
    __nv_bfloat16* orow = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = a * 64 + 8 * j + c0;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[a][4 * j + 2 * hh] / denom,
                                    acc[a][4 * j + 2 * hh + 1] / denom);
      }
  }
}

// bf16 (B, H, S, D) tensor with element strides (sb, sh, ss) and a
// contiguous D as a 4-D map over (D, S, H, B); box 64 x 64 rows
static int encode_bhsd(CUtensorMap* map, const void* base, int B, int H,
                       int S, int D, long long sb, long long sh,
                       long long ss) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, kTcRows, 1, 1};
  return sm90::encode_bf16(map, base, 4, dims, strides, box);
}

template <int NA>
static int launch_tc(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Sq, int Skv, int D,
                     const long long* qst, const long long* kst,
                     const long long* vst, int q_offset, int causal,
                     int window, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = encode_bhsd(&qm, q, B, Hq, Sq, D, qst[0], qst[1], qst[2]);
  if (err == 0) err = encode_bhsd(&km, k, B, Hkv, Skv, D, kst[0], kst[1], kst[2]);
  if (err == 0) err = encode_bhsd(&vm, v, B, Hkv, Skv, D, vst[0], vst[1], vst[2]);
  if (err != 0) return err;
  auto kernel = flash_attention_tc_kernel<NA>;
  const size_t smem = tc_smem_bytes(NA);
  static size_t granted = 0;
  err = sm90::allow_smem(kernel, smem, granted);
  if (err != 0) return err;
  dim3 grid((Sq + kTcRows - 1) / kTcRows, B * Hq);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, D,
      q_offset, causal, window, scale);
  return (int)cudaGetLastError();
}

// bf16 only, D % 16 == 0, D <= 128 (kernels/attn_plan.py); strides in
// elements, (batch, head, seq) for each of q, k, v, D contiguous; out
// (B, Hq, Sq, D) contiguous.  Returns a CUDA error or sm90::kEncodeError +
// a CUresult.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, int q_offset, int causal,
    int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long qst[3] = {qsb, qsh, qss}, kst[3] = {ksb, ksh, kss},
                  vst[3] = {vsb, vsh, vss};
  if (D <= 64)
    return launch_tc<1>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, qst, kst, vst,
                        q_offset, causal, window, scale, st);
  return launch_tc<2>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, qst, kst, vst,
                      q_offset, causal, window, scale, st);
}
