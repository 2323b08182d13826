// decode_fused: single-pass decode attention, one query row per (sequence,
// query head) against that sequence's KV-cache prefix, the port of the Pallas
// kernel src/repro/kernels/decode_fused.py:fused_decode_kernel.
//
// q (B, Hq, D), k and v caches (B, Hkv, Smax, D) in float32 or bfloat16,
// D <= 256 (not padded), cache_len (B,) int32 on the card, out (B, Hq, D) in
// q's dtype.  Semantics of the Pallas kernel: q is scaled in its own dtype
// (the scale rounded to that dtype first) before the float32 upcast; keys at
// or past cache_len[b], and with a window those at or behind the frontier
// cache_len - 1 - window, are masked: score -1e30, probability 0; the
// float32 carry (m, l, acc) is rescaled as in Algorithm 1; the output is
// acc / max(l, 1e-37), so cache_len == 0 gives exact zeros.
//
// Bound on the H100: decode reads each live K/V row once and does ~4·D
// FLOPs per key and head, far below the card's operations-per-byte line, so
// the bytes of the live prefix set the least time (a few microseconds a
// step at the LM's 129-160 keys).  What stands in the way is latency and
// parallelism: one block per (b, kv head) is 64 blocks for 132 SMs, each
// walking its prefix alone.  So the prefix is split:
//
// - Grid (splits, B * Hkv, head chunks).  Split s owns the keys
//   [s * split, (s + 1) * split) of the Smax slots, fixed at launch
//   (kernels/attn_plan.py:plan_decode; 8 splits of 64 at Smax 512).  A
//   block serves up to 8 query heads of one GQA group, one warp each (the
//   LM's group of 4), so a K/V row is read once per group.
// - The block reads cache_len[b] on the card (no host sync, one launch for
//   any mix of lengths).  A split that starts at or past the live length,
//   or lies wholly behind the window frontier, loads nothing and stores an
//   empty partial (m = -1e30, l = 0, acc = 0).
// - K/V tiles of 32 keys arrive by 16-byte cp.async (not TMA: a block moves
//   at most two tiles of 4 KB, and cp.async's zero fill masks the rows past
//   the live length per row) into a 2-stage ring: both tiles of a split are
//   in flight at once and the first is scored while the second lands.
//   Rows are padded by 16 bytes in shared memory, so the lanes' 16-byte
//   reads of their key rows fall in distinct banks; values are widened to
//   float32 in registers.  The q.K dot products (lane = key) and the P.V
//   sums (lane = head dim) are float32 on the CUDA cores: 4 query rows per
//   group leave the tensor cores nothing to do.  At D = 256 (RecurrentGemma's
//   MQA: 16 query heads on one kv head, two chunks of 8) a bf16 tile is 16
//   KB and the two rings 66 KB, past the 48 KB a launch gets by default.
// - Combine in the same launch, deterministically: every split stores its
//   float32 (m, l, acc[D]) partial and takes a ticket on its (b, kv head,
//   chunk) counter; the last block to arrive merges the splits in ascending
//   split order (m = max m_s; l = sum l_s e^(m_s - m); acc likewise),
//   writes the output and resets the counter.  No float atomics: two
//   launches on the same inputs are bit-identical.
#include "common.cuh"
#include "sm90.cuh"

constexpr int kMaxWarps = 8;   // query heads per block
constexpr int kTile = 32;      // keys per tile: one per lane
constexpr int kStages = 2;     // tiles of a split in flight
constexpr int kMaxD = 256;     // head_dim limit: 8 dims a lane (kDL)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float dwarp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return v;
}

__device__ __forceinline__ float dwarp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffff, v, o);
  return v;
}

// 16-byte async copy into shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 16 bytes of T widened to float32 (8 bf16 or 4 floats)
__device__ __forceinline__ int widen16(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
  return 4;
}
__device__ __forceinline__ int widen16(const uint4& r, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  return 8;
}

// a split's key range [lo, hi) and whether any of it is live
struct SplitRange {
  int lo, hi;
  bool live;
};

__device__ __forceinline__ SplitRange split_keys(int s, int split, int Smax,
                                                 int cl, int window) {
  SplitRange r;
  r.lo = s * split;
  r.hi = min(min(r.lo + split, Smax), cl);
  r.live = r.lo < r.hi;
  if (window >= 0 && r.hi - 1 <= cl - 1 - window) r.live = false;
  return r;
}

// grid (splits, B * Hkv, chunks of up to 8 query heads); block 32 * nw.
// Shared memory: q (nw x Dp floats, scaled), the K and V rings (kStages x
// kTile rows of Dp elements + 16 bytes), p (nw x kTile floats).
// partials: [(b * Hkv + hk) * chunks + z][split][head of the chunk][D + 2]
// as (m, l, acc[0..D)).  Dp = D rounded up to 16 bytes of T; `vec`: rows
// and bases are 16-byte aligned, so tiles load by cp.async (otherwise by
// element, for ragged D).
// kDL: head dims a lane holds in acc, 4 for D <= 128 and 8 above, so the
// D <= 128 instances keep their registers (and occupancy)
template <typename T, int kDL>
__global__ void __launch_bounds__(kMaxWarps * 32) decode_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ cache_len,
    T* __restrict__ o, float* __restrict__ partials, int* __restrict__ tickets,
    int Hq, int Hkv, int Smax, int D, int Dp, int vec, int split, int window,
    float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nw = blockDim.x / 32;
  const int pitch = Dp * (int)sizeof(T) + 16;   // bytes of a staged row
  float* qs = reinterpret_cast<float*>(smem);    // nw x Dp
  uint8_t* ks = smem + (size_t)nw * Dp * 4;      // kStages x kTile x pitch
  uint8_t* vs = ks + (size_t)kStages * kTile * pitch;
  float* ps = reinterpret_cast<float*>(vs + (size_t)kStages * kTile * pitch);
  __shared__ int ticket;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x, splits = gridDim.x;
  const int bk = blockIdx.y, b = bk / Hkv, hk = bk % Hkv;
  const int z = blockIdx.z, chunks = gridDim.z;
  const int group = Hq / Hkv;
  const int row = z * nw + warp;             // query head within the group
  const bool live_row = row < group;
  const int h = hk * group + row;
  const int cl = min(max(cache_len[b], 0), Smax);
  const int frontier = cl - 1 - window;      // keys at or behind it masked
  const SplitRange sr = split_keys(s, split, Smax, cl, window);
  const T* kp = k + (size_t)bk * Smax * D;
  const T* vp = v + (size_t)bk * Smax * D;
  const int ntiles = sr.live ? (sr.hi - sr.lo + kTile - 1) / kTile : 0;

  // issue both tiles' copies first, then stage q while they fly
  const int row_chunks = Dp * (int)sizeof(T) / 16;
  for (int t = 0; t < ntiles && vec; ++t) {
    uint8_t* kd = ks + (size_t)t * kTile * pitch;
    uint8_t* vd = vs + (size_t)t * kTile * pitch;
    for (int i = threadIdx.x; i < kTile * row_chunks; i += blockDim.x) {
      const int r = i / row_chunks, c = i % row_chunks;
      const int key = sr.lo + t * kTile + r;
      const bool in = key < sr.hi;
      const size_t off = (size_t)(in ? key : 0) * D * sizeof(T) + c * 16;
      cp_async16(kd + r * pitch + c * 16,
                 reinterpret_cast<const uint8_t*>(kp) + off, in ? 16 : 0);
      cp_async16(vd + r * pitch + c * 16,
                 reinterpret_cast<const uint8_t*>(vp) + off, in ? 16 : 0);
    }
    cp_async_commit();
  }
  if (!vec)  // ragged D: element copies, zero padding to Dp
    for (int t = 0; t < ntiles; ++t)
      for (int i = threadIdx.x; i < kTile * Dp; i += blockDim.x) {
        const int r = i / Dp, d = i % Dp, key = sr.lo + t * kTile + r;
        const bool in = key < sr.hi && d < D;
        T* kd = reinterpret_cast<T*>(ks + ((size_t)t * kTile + r) * pitch);
        T* vd = reinterpret_cast<T*>(vs + ((size_t)t * kTile + r) * pitch);
        kd[d] = in ? kp[(size_t)key * D + d] : from_f32<T>(0.0f);
        vd[d] = in ? vp[(size_t)key * D + d] : from_f32<T>(0.0f);
      }
  for (int i = threadIdx.x; i < nw * Dp; i += blockDim.x) {
    const int r = z * nw + i / Dp, d = i % Dp;
    float val = 0.0f;
    if (r < group && d < D) {
      const float qv = to_f32(q[((size_t)b * Hq + hk * group + r) * D + d]);
      val = to_f32(from_f32<T>(qv * scale));  // scaled in q's dtype
    }
    qs[i] = val;
  }

  float m = kNegInf, l = 0.0f, acc[kDL];
#pragma unroll
  for (int c = 0; c < kDL; ++c) acc[c] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    if (vec) {
      if (t + 1 < ntiles)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and q) visible to every warp
    if (!live_row) continue;
    const uint8_t* kt = ks + (size_t)t * kTile * pitch;
    const T* vt = reinterpret_cast<const T*>(vs + (size_t)t * kTile * pitch);
    const int kpos = sr.lo + t * kTile + lane;

    // lane = key: its row in 16-byte pieces, widened in registers
    float sc = 0.0f;
    const float* qrow = qs + warp * Dp;
    const uint4* krow = reinterpret_cast<const uint4*>(kt + lane * pitch);
    for (int c = 0; c < row_chunks; ++c) {
      float f[8];
      const int n = widen16(krow[c], f, T());
      const float* qc = qrow + c * n;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n) sc = fmaf(qc[e], f[e], sc);
    }
    bool ok = kpos < sr.hi;
    if (window >= 0) ok = ok && kpos > frontier;
    sc = ok ? sc : kNegInf;

    const float m_new = fmaxf(m, dwarp_max(sc));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(sc - m_new) : 0.0f;
    l = l * alpha + dwarp_sum(p);
    ps[warp * kTile + lane] = p;
    __syncwarp();
    const float* prow = ps + warp * kTile;
    // lane = head dims lane, lane + 32, ...: one V row per key, coalesced
#pragma unroll
    for (int c = 0; c < kDL; ++c) {
      const int d = lane + 32 * c;
      if (d >= D) break;
      float pv = 0.0f;
      for (int j = 0; j < kTile; ++j)
        pv = fmaf(prow[j],
                  to_f32(*reinterpret_cast<const T*>(
                      reinterpret_cast<const uint8_t*>(vt) + j * pitch +
                      d * sizeof(T))),
                  pv);
      acc[c] = acc[c] * alpha + pv;
    }
    __syncwarp();
    m = m_new;
  }

  // this split's partial (an empty split stores m = -1e30, l = 0, acc = 0)
  const int P = D + 2;
  const size_t group_slot = (size_t)bk * chunks + z;
  float* base = partials + group_slot * splits * nw * P;
  if (live_row) {
    float* mine = base + ((size_t)s * nw + warp) * P;
    if (lane == 0) {
      __stcg(mine, m);
      __stcg(mine + 1, l);
    }
#pragma unroll
    for (int c = 0; c < kDL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) __stcg(mine + 2 + d, acc[c]);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(&tickets[group_slot], 1);
  __syncthreads();
  if (ticket != splits - 1) return;
  __threadfence();

  // the last block: merge the splits in ascending order
  if (live_row) {
    float mx = kNegInf;
    for (int j = 0; j < splits; ++j)
      mx = fmaxf(mx, __ldcg(base + ((size_t)j * nw + warp) * P));
    float lsum = 0.0f, out[kDL];
#pragma unroll
    for (int c = 0; c < kDL; ++c) out[c] = 0.0f;
    for (int j = 0; j < splits; ++j) {
      const float* part = base + ((size_t)j * nw + warp) * P;
      const float w = expf(__ldcg(part) - mx);
      lsum += __ldcg(part + 1) * w;
#pragma unroll
      for (int c = 0; c < kDL; ++c) {
        const int d = lane + 32 * c;
        if (d < D) out[c] += __ldcg(part + 2 + d) * w;
      }
    }
    const float denom = fmaxf(lsum, 1e-37f);
    T* op = o + ((size_t)b * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < kDL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) op[d] = from_f32<T>(out[c] / denom);
    }
  }
  if (threadIdx.x == 0) tickets[group_slot] = 0;
}

template <typename T, int kDL>
static int launch(const void* q, const void* k, const void* v,
                  const void* cache_len, void* o, void* partials,
                  void* tickets, int B, int Hq, int Hkv, int Smax, int D,
                  int window, float scale, int split, int splits, int vec,
                  cudaStream_t stream) {
  const int group = Hq / Hkv;
  const int nw = group < kMaxWarps ? group : kMaxWarps;
  const int epv = 16 / (int)sizeof(T);
  const int Dp = (D + epv - 1) / epv * epv;
  dim3 grid(splits, B * Hkv, (group + nw - 1) / nw);
  const size_t smem = (size_t)nw * Dp * 4 +
                      2 * (size_t)kStages * kTile * (Dp * sizeof(T) + 16) +
                      (size_t)nw * kTile * 4;
  static size_t granted = 48 * 1024;   // rows of D >= 128 may need more
  const int err =
      sm90::allow_smem(decode_fused_kernel<T, kDL>, smem, granted);
  if (err != 0) return err;
  decode_fused_kernel<T, kDL><<<grid, nw * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(cache_len),
      static_cast<T*>(o), static_cast<float*>(partials),
      static_cast<int*>(tickets), Hq, Hkv, Smax, D, Dp, vec, split, window,
      scale);
  return (int)cudaGetLastError();
}

// partials: splits * B * Hkv * chunks * min(group, 8) * (D + 2) floats;
// tickets: B * Hkv * chunks int32 zeros, left at zero.  `split` keys per
// split (a multiple of 32, at most 64: two tiles), `splits` = ceil(Smax /
// split).
extern "C" int decode_fused_launch(const void* q, const void* k,
                                   const void* v, const void* cache_len,
                                   void* o, void* partials, void* tickets,
                                   int B, int Hq, int Hkv, int Smax, int D,
                                   int window, float scale, int split,
                                   int splits, int vec, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split <= 0 || split > kStages * kTile || split % kTile != 0) return -1;
  if (D <= 0 || D > kMaxD) return -1;
  const bool wide = D > 128;
  if (dtype == kFloat32)
    return (wide ? launch<float, 8> : launch<float, 4>)(
        q, k, v, cache_len, o, partials, tickets, B, Hq, Hkv, Smax, D,
        window, scale, split, splits, vec, st);
  return (wide ? launch<__nv_bfloat16, 8> : launch<__nv_bfloat16, 4>)(
      q, k, v, cache_len, o, partials, tickets, B, Hq, Hkv, Smax, D, window,
      scale, split, splits, vec, st);
}
