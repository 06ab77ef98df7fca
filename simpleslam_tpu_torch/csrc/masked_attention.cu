// Key-masked attention forward for the LightGlue matcher, by hand for Hopper.
//
// Replaces the TPU kernel simpleslam_tpu/ops/pallas/attention.py::_attn_kernel
// (called through pallas_masked_attention). Same function:
//     out = softmax(q k^T / sqrt(d) + (1 - m) * (-1e9)) v
// with the softmax's denominator clamped at 1e-30, so a row whose keys are
// all masked stays finite; keys past Nk count as -inf. q (BH, Nq, 64), k/v
// (BH, Nk, 64), mask (BH, Nk) of bytes (nonzero = live key), out (BH, Nq,
// 64) float32 contiguous. Nq and Nk may be ragged. q, k and v are read as
// the caller lays them out: any row and head strides (16-byte multiples),
// the head dim contiguous; the mask's head stride may be 0 (a broadcast).
//
// Operand types, one compiled variant each (the wrapper raises on others):
//   q, k float32, v bf16   the matcher's self-attention (rotary q and k);
//   q, k, v bf16           its cross-attention;
//   q, k, v float32        tests and the smoke's checks.
//
// Arithmetic: float32-accurate products on the tensor cores. The TPU
// kernel upcasts to float32 and takes float32 products. One tensor-core
// pass is not enough: emulated on the q/k/v of every call of a 9-layer
// LightGlue forward with the trained weights (logits up to ~800), the worst
// error against float64, over max(1, max|v|), read 8e-2 for one bf16 pass
// of q k^T and P v, 1.3e-2 for one TF32 pass and 2.1e-4 for three bf16
// passes, against 2.5e-5 for plain float32 and 1.9e-5 for this scheme
// (tests/test_torch_attention.py holds the emulation to 1e-4):
//   q k^T, float32 q and k: each operand split into a TF32 high part
//     hi = rna(x) and a TF32 low part lo = rna(x - hi); three passes
//     lo.hi + hi.lo + hi.hi (lo.lo dropped, ~2^-22 relative). The low part
//     is computed from the high part that the MMA uses: the tensor cores
//     would truncate an unrounded float32.
//   q k^T, bf16 q and k: one bf16 pass; bf16 x bf16 is exact in float32.
//   P v: P (in [0, 1]) split into bf16 hi + lo, two bf16 passes with a bf16
//     v (lo.v first); a float32 v is split the same way, four passes.
//   softmax: online (running max, sum, rescale) in float32 registers,
//     exponentials by ex2.approx of the max-subtracted logit.
//
// Design. One block owns (one bh, 64 queries) and a producer warpgroup
// with G consumer warpgroups (G = 2 for float32 q k^T, 3 for bf16). Each
// consumer group covers all 64 query rows (warp w: rows 16w..16w+15) and
// takes every G-th 64-key tile of the head (group g: tiles g, g + G, ...);
// their running (max, sum, acc) are merged through shared memory at the
// end. The producer streams the tiles through a ring of G + 2 shared-memory
// stages with cp.async (16 bytes a thread, zero-fill past Nk), splits a
// float32 K tile into TF32 hi (in place) and lo, and hands each stage over
// with an mbarrier ("full"); the consumer group hands it back ("empty").
// So the loads and the split run beside the MMAs and the softmax, and the
// consumer groups drift apart. Products are wgmma (sm_90a), one warpgroup
// per 64 query rows, from operands in the 128-byte-swizzle layout:
//   q k^T: q is written to shared memory once per block (float32 as TF32 hi
//     and lo tiles) and is the K-major A operand; the K tile is the K-major
//     B operand: m64n64k8 TF32 x 3 passes x 8 steps, or m64n64k16 bf16 x 4
//     steps.
//   P v: P goes from the S accumulator registers straight into A operand
//     registers (bf16 hi and lo), V is an MN-major bf16 B operand (its rows
//     as they land, the transpose flag set): m64n64k16 x 2 passes x 4
//     steps. TF32 takes only K-major operands, which is why P v is bf16. A
//     float32 v (the all-float32 variant only) goes through mma.sync
//     m16n8k16 with v split into bf16 hi/lo as it is read.
// The head's mask is staged once per block as bit words (32 keys a word);
// keys past Nk get -inf in the last tile only. Shared memory bounds Nk
// (masked_attention_max_keys): 286208 keys in the self-attention variant,
// 1138048 in the cross-attention variant, 24064 in the all-float32 one.
//
// Bound on an H100 SXM at (BH = 4, N = 2048, d = 64): each of q k^T and P v
// is 2 N^2 d BH = 2.15 GFLOP. Self-attention mix: 3 TF32 passes (6.4 GFLOP
// at 495 TFLOP/s) + 2 bf16 passes (4.3 GFLOP at 989) = 13.0 + 4.3 = 17.4
// us, against 7 MB of I/O (2 us at 3.35 TB/s). Cross mix: 1 + 2 bf16 passes
// = 6.5 us against 5 MB (1.5 us). Both are bound by operations. The old
// float32 CUDA-core bound (4.3 GFLOP at 67 TFLOP/s) was 64 us. Measured on
// an H100 (PERF.md: chip_smoke.py phase 3, device time, and an ablation
// with parts compiled out): about 50 us self and 25 us cross, 2.9x and
// 3.9x the bound. The producer alone (loads and split, no math) takes about 30 us and 13 us: every block
// streams its head's whole K/V from L2 (98 MB per self-attention call over
// 128 blocks), two tiles in flight. The consumers alone take about 35 us
// and 23 us (the softmax on the CUDA cores, a wait on each MMA). Next
// steps: thread-block clusters with TMA multicast of each K/V tile to the
// blocks of a head; a consumer pipeline across tiles (q k^T of the next
// tile under the softmax), which needs more stages than the self mix's
// float32 K hi/lo tiles leave room for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                       // head dim (checked by the wrapper)
constexpr int kBQ = 64;                      // queries per block
constexpr int kBK = 64;                      // keys per tile
constexpr int kGroupThreads = 128;           // one warpgroup
constexpr float kNeg = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;
  float* out;
  long long q_sh, q_sr, k_sh, k_sr, v_sh, v_sr, m_sh;   // strides, elements
  int Nq, Nk;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ ~2^-22 |x|), both TF32, lo taken from the hi the MMA uses
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) = hi + lo as bf16 pairs
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- warpgroup MMA --------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: rows of 128 bytes in
// groups of 8 (1024 bytes apart); the start may sit inside a row (the
// k-offset of a K-major operand), the group base must be 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from touching accumulators across an async MMA.
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

#define ACC32(d)                                                              \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),  \
      "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]),             \
      "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]),             \
      "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]),             \
      "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),             \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),             \
      "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]),             \
      "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define DREGS                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (64 x 64 per warpgroup) += a (64 x 8) . b (8 x 64), TF32, both K-major
// in shared memory
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8][4], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DREGS
      ", %32, %33, p, 1, 1;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d += a (64 x 16) . b (16 x 64), bf16, both K-major in shared memory
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[8][4], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DREGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d += a (64 x 16, bf16 in registers) . b (16 x 64, bf16, MN-major in
// shared memory: the transpose flag set)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DREGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- shared-memory layout -----------------------------------------------

// Byte offset of 16-byte chunk `ch` of row `r` of a 64-row tile in the
// 128-byte-swizzle layout: 128-byte columns of 64 rows (8 KB each); row r
// of a column at 128 r, its chunk c at (c ^ (r & 7)) * 16.
__device__ __forceinline__ int sw128_off(int r, int ch) {
  return (ch >> 3) * (kBK * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

template <bool kQKF32, bool kVF32>
struct Cfg {
  static constexpr int kKTile = kBK * kD * (kQKF32 ? 4 : 2);
  static constexpr int kLoTile = kQKF32 ? kKTile : 0;   // K's TF32 lo part
  static constexpr int kVTile = kBK * kD * (kVF32 ? 4 : 2);
  static constexpr int kStage = kKTile + kLoTile + kVTile;
  // Consumer groups, and tiles the producer prepares ahead of them (each
  // group holds one stage). Three groups only for bf16 q k^T: with 512
  // threads a thread gets 128 registers, fewer than the float32 q k^T
  // variant needs without spilling.
  static constexpr int kGroups = kQKF32 ? 2 : 3;
  static constexpr int kAhead = 2;
  static constexpr int kStages = kGroups + kAhead;
  static constexpr int kThreads = (1 + kGroups) * kGroupThreads;
  static constexpr int kQ = kBQ * kD * (kQKF32 ? 8 : 2);   // q (hi, lo)
  static constexpr int kBars = 2 * kStages * 8;            // full, empty
  static constexpr int kSmem = kStages * kStage + kQ + kBars;   // + mask
};

// Issue this thread's cp.async copies of the 64 keys from j0 into a stage.
// Thread i of the producer copies 16-byte chunks i, i + 128, ... of the K
// tile (chunk e: row e / chunks-per-row) and of the V tile.
template <bool kQKF32, bool kVF32>
__device__ __forceinline__ void load_tile(const Params& p, const char* kb,
                                          const char* vb, char* stage,
                                          int j0, int ptid) {
  using C = Cfg<kQKF32, kVF32>;
  constexpr int kKC = kD * (kQKF32 ? 4 : 2) / 16;   // chunks per row
  constexpr int kVC = kD * (kVF32 ? 4 : 2) / 16;
  const long long kr = p.k_sr * (kQKF32 ? 4 : 2), vr = p.v_sr * (kVF32 ? 4 : 2);
#pragma unroll
  for (int i = 0; i < kBK * kKC / kGroupThreads; ++i) {
    const int e = ptid + i * kGroupThreads, r = e / kKC, c = e % kKC;
    const bool live = j0 + r < p.Nk;
    cp_async16(smem_u32(stage + sw128_off(r, c)),
               kb + (live ? (j0 + r) * kr + c * 16 : 0), live);
  }
  char* vs = stage + C::kKTile + C::kLoTile;
#pragma unroll
  for (int i = 0; i < kBK * kVC / kGroupThreads; ++i) {
    const int e = ptid + i * kGroupThreads, r = e / kVC, c = e % kVC;
    const bool live = j0 + r < p.Nk;
    cp_async16(smem_u32(vs + sw128_off(r, c)),
               vb + (live ? (j0 + r) * vr + c * 16 : 0), live);
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

template <bool kQKF32, bool kVF32>
__global__ void __launch_bounds__(Cfg<kQKF32, kVF32>::kThreads, 1)
masked_attention_kernel(const Params p) {
  using C = Cfg<kQKF32, kVF32>;
  constexpr int kStages = C::kStages, kThreads = C::kThreads;
  extern __shared__ __align__(1024) char smem[];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int wg = tid / kGroupThreads;   // 0: producer; then the consumers
  const int gtid = tid % kGroupThreads;
  const int n_tiles = (p.Nk + kBK - 1) / kBK;

  char* q_hi = smem + kStages * C::kStage;   // or q's bf16 tile
  char* q_lo = q_hi + kBQ * kD * 4;
  const uint32_t bars = smem_u32(q_hi + C::kQ);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };
  uint32_t* live = reinterpret_cast<uint32_t*>(smem + C::kSmem);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), kGroupThreads);    // the producer's threads
      mbar_init(empty_bar(s), kGroupThreads);   // one consumer group
    }
  }
  // The head's mask as bit words: bit b of word w is key 32 w + b live
  // (0 past Nk).
  {
    const unsigned char* mb = p.mask + (long long)bh * p.m_sh;
    const int lane = tid % 32;
    for (int w = tid / 32; w < 2 * n_tiles; w += kThreads / 32) {
      const int j = 32 * w + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, j < p.Nk && mb[j]);
      if (lane == 0) live[w] = bits;
    }
  }
  // q, the A operand of every q k^T, into shared memory once per block
  // (K-major, 128-byte swizzle; rows past Nq zero): float32 split into
  // TF32 hi and lo tiles, bf16 as it is.
  {
    constexpr int kQC = kD * (kQKF32 ? 4 : 2) / 16;   // chunks per row
    const char* qb = static_cast<const char*>(p.q) +
                     (long long)bh * p.q_sh * (kQKF32 ? 4 : 2);
    for (int e = tid; e < kBQ * kQC; e += kThreads) {
      const int r = e / kQC, c = e % kQC;
      const int row = blockIdx.x * kBQ + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < p.Nq)
        x = *reinterpret_cast<const uint4*>(
            qb + (long long)row * p.q_sr * (kQKF32 ? 4 : 2) + c * 16);
      if constexpr (kQKF32) {
        uint4 hi, lo;
        split_tf32(__uint_as_float(x.x), hi.x, lo.x);
        split_tf32(__uint_as_float(x.y), hi.y, lo.y);
        split_tf32(__uint_as_float(x.z), hi.z, lo.z);
        split_tf32(__uint_as_float(x.w), hi.w, lo.w);
        *reinterpret_cast<uint4*>(q_hi + sw128_off(r, c)) = hi;
        *reinterpret_cast<uint4*>(q_lo + sw128_off(r, c)) = lo;
      } else {
        *reinterpret_cast<uint4*>(q_hi + sw128_off(r, c)) = x;
      }
    }
  }
  fence_async_smem();
  __syncthreads();

  float o[8][4];
  float m_run[2] = {-INFINITY, -INFINITY};   // rows r0, r1
  float l_run[2] = {0.f, 0.f};               // this thread's partial sums
  const int grp = wg - 1;                    // consumer key group
  const int wq = gtid / 32, lane = tid % 32;   // warp w: rows 16w..16w+15
  const int g = lane / 4, t = lane % 4;

  if (wg == 0) {
    // ---- producer: loads every tile, splits a float32 K tile into TF32
    // hi (in place) and lo, and hands the stage to the tile's consumer
    // group. Each thread splits the chunks it copied itself, so its own
    // cp.async wait is enough before the split.
    const char* kb = static_cast<const char*>(p.k) +
                     (long long)bh * p.k_sh * (kQKF32 ? 4 : 2);
    const char* vb = static_cast<const char*>(p.v) +
                     (long long)bh * p.v_sh * (kVF32 ? 4 : 2);
    constexpr int kAhead = C::kAhead;
    auto issue = [&](int j) {   // tile j into stage j % kStages, once free
      if (j < n_tiles) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty_bar(s), (j / kStages - 1) & 1);
        load_tile<kQKF32, kVF32>(p, kb, vb, smem + s * C::kStage, j * kBK,
                                 gtid);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    // Tile j is handed over before tile j + kAhead is issued: that issue
    // waits for the stage of tile j + kAhead - kStages, which the group of
    // tile j may still be working on.
    for (int j = 0; j < kAhead; ++j) issue(j);
    for (int j = 0; j < n_tiles; ++j) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1));
      char* ks = smem + (j % kStages) * C::kStage;
      if constexpr (kQKF32) {
#pragma unroll
        for (int i = 0; i < kBK * 16 / kGroupThreads; ++i) {
          const int e = gtid + i * kGroupThreads;
          const int off = sw128_off(e / 16, e % 16);
          const float4 x = *reinterpret_cast<const float4*>(ks + off);
          uint4 hi, lo;
          split_tf32(x.x, hi.x, lo.x);
          split_tf32(x.y, hi.y, lo.y);
          split_tf32(x.z, hi.z, lo.z);
          split_tf32(x.w, hi.w, lo.w);
          *reinterpret_cast<uint4*>(ks + off) = hi;
          *reinterpret_cast<uint4*>(ks + C::kKTile + off) = lo;
        }
      }
      fence_async_smem();   // copies and split -> the async proxy
      mbar_arrive(full_bar(j % kStages));
      issue(j + kAhead);
    }
  } else {
    // ---- consumers: group grp takes tiles grp, grp + kGroups, ...
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
    for (int j = grp; j < n_tiles; j += C::kGroups) {
      const int s = j % kStages;
      mbar_wait(full_bar(s), (j / kStages) & 1);
      const char* ks = smem + s * C::kStage;
      const char* vs = ks + C::kKTile + C::kLoTile;

      // S = q k^T, 64 rows x 64 keys per warpgroup
      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      wgmma_fence();
      if constexpr (kQKF32) {
        const uint32_t kh = smem_u32(ks), kl = kh + C::kKTile,
                       qh = smem_u32(q_hi), ql = smem_u32(q_lo);
#pragma unroll
        for (int st = 0; st < 8; ++st) {
          // dims 8 st.. of every row: column st / 4, 32 bytes per step
          const uint32_t off = (st >> 2) * (kBK * 128) + (st & 3) * 32;
          wgmma_tf32_ss(sc, sw128_desc(ql + off), sw128_desc(kh + off));
          wgmma_tf32_ss(sc, sw128_desc(qh + off), sw128_desc(kl + off));
          wgmma_tf32_ss(sc, sw128_desc(qh + off), sw128_desc(kh + off));
        }
      } else {
        const uint32_t k = smem_u32(ks), q = smem_u32(q_hi);
#pragma unroll
        for (int st = 0; st < 4; ++st)   // 16 dims, 32 bytes per step
          wgmma_bf16_ss(sc, sw128_desc(q + st * 32),
                        sw128_desc(k + st * 32));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sc);

      // online softmax, rows r0 (e = 0, 1) and r1 (e = 2, 3); this thread's
      // keys are 8 n + 2 t + (e & 1), bits 8 n + (e & 1) of the live words
      // shifted by 2 t. Maxima and sums as trees (short dependent chains).
      const int key0 = j * kBK;
      const uint32_t w0 = live[2 * j] >> (2 * t), w1 = live[2 * j + 1] >> (2 * t);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t bit = (n < 4 ? w0 : w1) & (1u << (8 * (n & 3) + (e & 1)));
          sc[n][e] = fmaf(sc[n][e], p.scale, bit ? 0.f : kNeg);
        }
      if (key0 + kBK > p.Nk) {   // the last tile: keys past Nk count as -inf
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + 8 * n + 2 * t + (e & 1) >= p.Nk) sc[n][e] = -INFINITY;
      }
      auto row_tree = [&](int h, auto op) {   // op over row h's 16 values
        float a[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) a[n] = op(sc[n][2 * h], sc[n][2 * h + 1]);
#pragma unroll
        for (int w = 4; w >= 1; w /= 2)
#pragma unroll
          for (int n = 0; n < w; ++n) a[n] = op(a[n], a[n + w]);
        return a[0];
      };
      float corr[2], m_new[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = row_tree(h, [](float a, float b) { return fmaxf(a, b); });
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        m_new[h] = fmaxf(m_run[h], tmax);   // finite: the tile has a key < Nk
        corr[h] = ex2((m_run[h] - m_new[h]) * kLog2e);
        m_run[h] = m_new[h];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = ex2((sc[n][e] - m_new[e >> 1]) * kLog2e);
          o[n][e] *= corr[e >> 1];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l_run[h] = l_run[h] * corr[h] +
                   row_tree(h, [](float a, float b) { return a + b; });

      // O += P v: P from the S registers as bf16 hi + lo A fragments
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[kk][0], pl[kk][0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[kk][1], pl[kk][1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[kk][2],
                   pl[kk][2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[kk][3],
                   pl[kk][3]);
      }
      if constexpr (!kVF32) {
        const uint32_t v_addr = smem_u32(vs);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // keys 16 kk.., 2048 bytes apart
          wgmma_bf16_rs(o, pl[kk], sw128_desc(v_addr + kk * 2048));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_rs(o, ph[kk], sw128_desc(v_addr + kk * 2048));
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(o);
      } else {
        // warp-level m16n8k16 tiles: b0 = keys 16kk + 2t, +1; b1 = keys
        // 16kk + 8 + 2t, +1; dim 8n + g; v split into bf16 hi + lo
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            float x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 16 * kk + 2 * t + (e & 1) + 8 * (e >> 1);
              const int dim = 8 * n + g;
              x[e] = *reinterpret_cast<const float*>(
                  vs + sw128_off(r, dim / 4) + 4 * (dim % 4));
            }
            uint32_t vh0, vl0, vh1, vl1;
            split_bf16(x[0], x[1], vh0, vl0);
            split_bf16(x[2], x[3], vh1, vl1);
            mma_bf16(o[n], pl[kk], vl0, vl1);
            mma_bf16(o[n], pl[kk], vh0, vh1);
            mma_bf16(o[n], ph[kk], vl0, vl1);
            mma_bf16(o[n], ph[kk], vh0, vh1);
          }
      }
      mbar_arrive(empty_bar(s));   // this group is done with the stage
    }
    // The quad's partial sums -> row sums.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    }
  }

  // Merge the consumer groups through shared memory (the stages are idle
  // once every thread is here): groups 1.. leave (acc, max, sum), group 0
  // combines them and writes the output.
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  constexpr int kPart = kBQ * kD + 2 * kBQ;   // floats per group: acc, m, l
  const int lr0 = 16 * wq + g, lr1 = lr0 + 8;         // rows within the block
  const int r0 = blockIdx.x * kBQ + lr0, r1 = r0 + 8;
  if (grp >= 1) {
    float* so = reinterpret_cast<float*>(smem) + (grp - 1) * kPart;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(so + lr0 * kD + 8 * n + 2 * t) =
          make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(so + lr1 * kD + 8 * n + 2 * t) =
          make_float2(o[n][2], o[n][3]);
    }
    if (t == 0) {
      so[kBQ * kD + lr0] = m_run[0];
      so[kBQ * kD + lr1] = m_run[1];
      so[kBQ * kD + kBQ + lr0] = l_run[0];
      so[kBQ * kD + kBQ + lr1] = l_run[1];
    }
  }
  __syncthreads();
  if (grp == 0) {
    const float* parts = reinterpret_cast<const float*>(smem);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = h ? lr1 : lr0;
      float mx = m_run[h];
#pragma unroll
      for (int q = 0; q < C::kGroups - 1; ++q)
        mx = fmaxf(mx, parts[q * kPart + kBQ * kD + lr]);
      float c = ex2((m_run[h] - mx) * kLog2e), l = l_run[h] * c;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * h] *= c;
        o[n][2 * h + 1] *= c;
      }
#pragma unroll
      for (int q = 0; q < C::kGroups - 1; ++q) {
        const float* part = parts + q * kPart;
        c = ex2((part[kBQ * kD + lr] - mx) * kLog2e);   // 0 if it saw no key
        l += part[kBQ * kD + kBQ + lr] * c;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 x =
              *reinterpret_cast<const float2*>(part + lr * kD + 8 * n + 2 * t);
          o[n][2 * h] += x.x * c;
          o[n][2 * h + 1] += x.y * c;
        }
      }
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int r = h ? r1 : r0;
      float* ob = p.out + ((long long)bh * p.Nq + r) * kD;
      if (r < p.Nq) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(ob + 8 * n + 2 * t) =
              make_float2(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
      }
    }
  }
}

constexpr int kMaxSmem = 232448;   // an H100 block's dynamic shared memory

// Shared memory of one block: stages, q, barriers, then two mask words per
// key tile.
template <bool kQKF32, bool kVF32>
long long smem_bytes(int Nk) {
  return Cfg<kQKF32, kVF32>::kSmem + (long long)(Nk + kBK - 1) / kBK * 8;
}

template <bool kQKF32, bool kVF32>
int launch(const Params& p, int BH, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        masked_attention_kernel<kQKF32, kVF32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long smem = smem_bytes<kQKF32, kVF32>(p.Nk);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((p.Nq + kBQ - 1) / kBQ, BH);
  masked_attention_kernel<kQKF32, kVF32>
      <<<grid, Cfg<kQKF32, kVF32>::kThreads, (size_t)smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Strides are in elements; qk_bf16 and
// v_bf16 pick the variant (q and k share a type). Launches on `stream`,
// allocates nothing, and returns a CUDA error code (0 = launched).
extern "C" int masked_attention(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int BH, int Nq,
                                int Nk, long long q_sh, long long q_sr,
                                long long k_sh, long long k_sr, long long v_sh,
                                long long v_sr, long long m_sh, int qk_bf16,
                                int v_bf16, float scale, void* stream) {
  if (BH <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    static_cast<const unsigned char*>(mask),
           static_cast<float*>(out),
           q_sh, q_sr, k_sh, k_sr, v_sh, v_sr, m_sh, Nq, Nk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!qk_bf16 && v_bf16) return launch<true, false>(p, BH, s);
  if (qk_bf16 && v_bf16) return launch<false, false>(p, BH, s);
  if (!qk_bf16 && !v_bf16) return launch<true, true>(p, BH, s);
  return (int)cudaErrorInvalidValue;
}

// The largest Nk a variant's block can hold the mask words of.
extern "C" int masked_attention_max_keys(int qk_bf16, int v_bf16) {
  long long fixed;
  if (!qk_bf16 && v_bf16) fixed = smem_bytes<true, false>(0);
  else if (qk_bf16 && v_bf16) fixed = smem_bytes<false, false>(0);
  else fixed = smem_bytes<true, true>(0);
  return (int)((kMaxSmem - fixed) / 8 * kBK);
}
