// gemm_sm90.cuh: the bf16 tensor-core GEMM mainloop that unified_linear.cu
// and moe_gemm.cu share (wgmma fed by TMA through an mbarrier ring).
//
// One block computes a float32 tile
//     acc(n, t) = sum_k W[k, n] * X[t, k]
// over a range of 64-wide k-tiles, where W is a weight matrix in the layout
// the port keeps ((K, N) or expert e of (E, D, F): N contiguous) and X holds
// the tokens ((M, K) or queue z of (Z, C, D): K contiguous).  That is
// y^T = w^T x^T: 64 rows of the weights' N fill wgmma's M side and the
// tokens are its n side (8..128), so a decode step's 8 tokens waste no
// rows of the tensor core, and one code path serves a GEMM at any M.
// W's tiles are therefore MN-major and enter wgmma with the transpose bit
// (allowed for 16-bit types); X's tiles are K-major.  No weight is stored
// transposed.
//
// Pipeline: warps 0 .. 4*NWG-1 are NWG consumer warpgroups, each owning 64
// rows of N; warp 4*NWG is the producer, whose lane 0 issues the TMA copies
// (cp.async.bulk.tensor, 128-byte swizzle, OOB zero fill) for each k-tile
// into a ring of `stages` shared-memory stages.  A stage's `full` mbarrier
// completes when its bytes land; its `empty` mbarrier when every consumer
// warp has retired the wgmma that read it.  The tensor maps are encoded on
// the host per call (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so nothing new is linked) and passed as
// __grid_constant__ parameters.  TMA, not cp.async: encoding two maps a
// launch is host work only (no device event is added to the host-bound
// paths), and it keeps the producer at one thread and the ragged edges (M,
// N, K, a queue's end) in hardware.
//
// Numerics: bf16 products are exact in float32.  The m64nBTk16 wgmmas of
// kPromote k-tiles (4: 256 k; fewer if the ring is shallower) accumulate
// into a fresh register tile, which is then added into the float32
// accumulator with ordinary round-to-nearest adds, so the tensor core's own
// accumulation never spans more than 256 products.  Without that, a sum
// over K = 8192 leaves the float32 tolerance the plain version is held to:
// chip_smoke.py phase 2 reads how many outputs of one PyTorch bf16 matmul,
// which accumulates on the tensor cores throughout, fall outside it.  float32 operands do not come here: wgmma would take them
// only as TF32.  The promotion's register tile is why a block's tile stops
// at 128 x 128 (two tiles of 64 floats a thread).
#pragma once

#include "sm90.cuh"  // the PTX helpers and the tensor-map encoder

namespace sm90 {

constexpr int kTileK = 64;                         // one 128-byte swizzle row
constexpr int kWgRows = 64;                        // wgmma's M side
constexpr int kWTileBytes = kTileK * kWgRows * 2;  // 8 KB per warpgroup
// k-tiles whose wgmmas share one register tile before it is promoted into
// the float32 accumulator (see Numerics above; at most the ring's depth)
constexpr int kPromote = 4;

__host__ __device__ constexpr int stage_bytes(int bt, int nwg) {
  return nwg * kWTileBytes + bt * kTileK * 2;
}

// the float32 output tile staged for the epilogue: bt rows of 64 nwg
// columns, padded by 4 so the accumulator's scatter into it is free of bank
// conflicts
__host__ __device__ constexpr int staged_ld(int nwg) { return nwg * 64 + 4; }

// the ring, or the staged tile that reuses it once the mainloop is done
__host__ __device__ constexpr size_t ring_bytes(int bt, int nwg, int stages) {
  return (size_t)stages * stage_bytes(bt, nwg) >
                 (size_t)bt * staged_ld(nwg) * 4
             ? (size_t)stages * stage_bytes(bt, nwg)
             : (size_t)bt * staged_ld(nwg) * 4;
}

// dynamic shared memory of one block: 1 KB of alignment slack, the ring,
// then its two barrier arrays
inline size_t smem_bytes(int bt, int nwg, int stages) {
  return 1024 + ring_bytes(bt, nwg, stages) + 16 * (size_t)stages;
}

// k-tiles [kt0, kt1) of split s of `splits` over kt_total k-tiles: ascending,
// contiguous, each k-tile exactly once (kernels/gemm_plan.py:k_ranges)
__host__ __device__ inline void split_range(int kt_total, int splits, int s,
                                            int& kt0, int& kt1) {
  kt0 = (int)((long long)s * kt_total / splits);
  kt1 = (int)((long long)(s + 1) * kt_total / splits);
}

// acc(64 x BT) (+)= W^T (64 x 16, MN-major: transpose bit 1) *
//                   X^T (16 x BT, K-major: transpose bit 0)
template <int BT>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<72> {
  __device__ __forceinline__ static void mma(float (&d)[36], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35"
        "}, %36, %37, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ------------------------------------------------------------ the mainloop

// Shared-memory ring of one block: stages x NWG weight tiles (64 k rows x
// 128 B), stages x BT token rows (128 B) — reused as the staged output tile
// after the mainloop — then the full and empty barriers.
template <int BT, int NWG>
struct Mainloop {
  static constexpr int kAcc = BT / 2;  // accumulator floats per thread
  static constexpr int kConsumers = NWG * 128;
  uint8_t* a;
  uint8_t* b;
  uint64_t* full;
  uint64_t* empty;
  int stages;

  __device__ Mainloop(uint8_t* smem, int stages_) : stages(stages_) {
    const uint32_t pad = (1024u - (smem_addr(smem) & 1023u)) & 1023u;
    a = smem + pad;
    b = a + (size_t)stages * NWG * kWTileBytes;
    full = reinterpret_cast<uint64_t*>(a + ring_bytes(BT, NWG, stages));
    empty = full + stages;
  }

  // thread 0, before a __syncthreads that publishes the barriers
  __device__ void init() {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                  // the producer's expect_tx
      mbar_init(&empty[s], kConsumers / 32);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // lane 0 of the producer warp: weight rows [n0, n0 + 64 NWG) of matrix wz,
  // token rows [t0, t0 + BT) of matrix xz, k-tiles [kt0, kt1)
  __device__ void produce(const CUtensorMap* wmap, const CUtensorMap* xmap,
                          int n0, int wz, int t0, int xz, int kt0, int kt1) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(wmap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(xmap))
                 : "memory");
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds it free
      mbar_arrive_expect_tx(&full[stage], stage_bytes(BT, NWG));
#pragma unroll
      for (int g = 0; g < NWG; ++g)
        tma_load_3d(a + ((size_t)stage * NWG + g) * kWTileBytes, wmap,
                    &full[stage], n0 + g * kWgRows, kt * kTileK, wz);
      tma_load_3d(b + (size_t)stage * BT * kTileK * 2, xmap, &full[stage],
                  kt * kTileK, t0, xz);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  // consumer warpgroups: acc over k-tiles [kt0, kt1).  Thread i of
  // warpgroup g holds acc[4j + 2h + e] = tile(n, t) at
  //   n = 64 g + 16 (i / 32) + (i % 32) / 4 + 8 h,  t = 8 j + 2 (i % 4) + e.
  // The wgmmas of `promote` consecutive k-tiles accumulate into one
  // register tile, which is then added into acc and their stages handed
  // back.
  __device__ void consume(int kt0, int kt1, float (&acc)[kAcc]) {
    const int g = threadIdx.x / 128;
    const int promote = stages < kPromote ? stages : kPromote;
    float part[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.0f;
    int stage = 0, held = 0;
    uint32_t phase = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint32_t a0 =
          smem_addr(a + ((size_t)stage * NWG + g) * kWTileBytes);
      const uint32_t b0 = smem_addr(b + (size_t)stage * BT * kTileK * 2);
      wgmma_fence();
      fence_regs(part);
      const int fresh = held == 0;
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk)
        // W: 16 k rows of 128 B per k16 step, 8-row groups 1024 B apart;
        // X: 32 B along each 128-byte row, 8-row groups 1024 B apart
        Wgmma<BT>::mma(part, desc_sw128(a0 + kk * 2048, 1024, 1024),
                       desc_sw128(b0 + kk * 32, 16, 1024),
                       kk > 0 || !fresh);
      wgmma_commit();
      if (++held == promote || kt + 1 == kt1) {
        wgmma_wait_all();
        fence_regs(part);
        if ((threadIdx.x & 31) == 0)
          for (int r = 0; r < held; ++r)
            mbar_arrive(&empty[(stage - r + stages) % stages]);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
        held = 0;
      }
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  // Epilogue staging.  After the mainloop the ring is free: the consumers
  // (all of them, past a barrier, so no wgmma still reads it) scatter acc
  // into it as a float tile [t][n] of row pitch staged_ld(NWG), so the
  // store loop can run over consecutive n, coalesced, with one inline copy
  // of the epilogue instead of BT / 2 unrolled ones.
  static constexpr int kLd = staged_ld(NWG);
  __device__ const float* stage(const float (&acc)[kAcc]) {
    float* st = reinterpret_cast<float*>(a);
    const int tid = threadIdx.x, lane = tid % 32;
    const int nl = (tid / 128) * kWgRows + ((tid % 128) / 32) * 16 + lane / 4;
    named_barrier_sync(1, kConsumers);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st[(8 * j + 2 * (lane % 4) + e) * kLd + nl + 8 * h] =
              acc[4 * j + 2 * h + e];
    named_barrier_sync(1, kConsumers);
    return st;
  }
};

// ------------------------------------------------------------ host side

// 3-D bf16 tensor of dims (d0 innermost, d1, d2), densely packed; box
// {64, box1, 1}, 128-byte swizzle, out-of-bounds elements read as zeros.
// Returns 0 or kEncodeError + the CUresult.
inline int encode_3d(CUtensorMap* map, const void* base, uint64_t d0,
                     uint64_t d1, uint64_t d2, uint32_t box1) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kTileK, box1, 1};
  return encode_bf16(map, base, 3, dims, strides, box);
}

}  // namespace sm90
