// Key-masked attention backward for the LightGlue matcher, by hand for
// Hopper.
//
// Replaces the backward of simpleslam_tpu/ops/pallas/attention.py::
// _pallas_attention_diff, _pad_bwd (:109): the vector-Jacobian product of
// xla_masked_attention, which REPLACES masked logits by -1e9. For q
// (BH, Nq, 64), k/v (BH, Nk, 64), mask (BH, Nk) and the float32 upstream
// gradient g (BH, Nq, 64):
//     S = q k^T / 8, masked -> -1e9;  P = softmax(S)
//     dV = P^T g;  dP = g v^T;  D = rowsum(P dP);  dS = P (dP - D), 0 where
//     masked;  dQ = dS k / 8;  dK = dS^T q / 8
// written as dq, dk, dv in q's, k's and v's types, each rounded once. So
// masked keys pass no gradient to q or k, and a head with no live key has
// P = 1/Nk (every key equal at -1e9): dq = 0, dk = 0, dv = the mean of g.
// Operands as the forward takes them: any row and head strides (16-byte
// multiples) with the head dim contiguous, a mask head stride of 0, ragged
// Nq and Nk, and the same three type mixes (self: f32 q, k with bf16 v;
// cross: all bf16; all-f32). g may be strided the same way.
//
// Two launches per call, from one entry point:
//   1. row statistics: per (bh, 64-query tile), one pass over the key tiles
//      computes S and dP and keeps, online, each row's max m, sum
//      l = sum exp(S - m) and u = sum exp(S - m) dP; it writes m, 1/l and
//      D = u / l (float32 scratch, 4 per row);
//   2. gradients, two block roles split by blockIdx.x:
//        key blocks   (bh, 64-key tile): hold K and V, loop over the query
//                     tiles (q, g and their statistics), write dK and dV;
//        query blocks (bh, 64-query tile): hold q and g, loop over the key
//                     tiles (K, V), write dQ.
//      Each rebuilds P = exp(S - m) / l (masked keys 0; a head with no live
//      key 1/Nk, from the mask) and dP with the products of launch 1.
// Why the statistics are recomputed and not taken from the forward. The
// trained self-attention's logits reach ~800; there dS = P (dP - D) is a
// small difference of large terms, and dq = dS k cancels again (each row
// of dS sums to 0). A float32 log-sum-exp rounds by ~3e-5 at |lse| ~ 800,
// so P = exp(S - lse) rows sum to 1 +- 3e-5, and D = rowsum(g * out) from
// the forward's output (whose P v is float32-accurate, not float32) is not
// the D of this P and dP. Emulated on the 36 attention calls of one
// training step from the trained tree (tests/test_torch_attention_bwd.py),
// the worst float32 gradient against float64, over its largest entry, read
// 1.5e-3 with a float32 forward lse and D from out, 1.05e-4 with (max,
// log-sum) as two floats and D from out, and 9.0e-5 with the statistics of
// this kernel, against 9.8e-5 for plain float32; the worst bf16 gradient
// (the cross-attention's) 0.57, 0.033 and 5.1e-3, against 5.1e-3. The
// second design would also need the forward's wgmma S and this kernel's
// mma.sync S to agree bit for bit. So the forward is untouched (serving
// runs the same kernel) and every P, dP and D here comes from one set of
// products: the key blocks' S^T and dP^T take the same passes in the same
// order as launch 1's S and dP, with the operands' roles swapped.
//
// Arithmetic: float32-accurate products on the tensor cores, by the
// forward's operand splitting. Where both operands are float32, three
// TF32 passes (lo.hi, hi.lo, hi.hi per 8-deep step, each part rounded to
// nearest, lo from the rounded hi); where one is bf16, the float32 one is
// split into bf16 hi + lo and two bf16 passes (lo first) are exact against
// the bf16 one; bf16 against bf16 is one exact pass. The products:
//   S   = q k^T   f32 q, k: 3 TF32; bf16: 1 bf16
//   dP  = g v^T   bf16 v: 2 bf16 (g split); f32 v: 3 TF32
//   dV += P^T g   3 TF32 (P from registers)
//   dK += dS^T q  f32 q: 3 TF32; bf16 q: 2 bf16 (dS split)
//   dQ += dS k    f32 k: 3 TF32; bf16 k: 2 bf16 (dS split)
// Exponentials are ex2.approx of (S/8 - m) log2(e).
//
// Design. Warp-level mma.sync (m16n8k8 TF32, m16n8k16 bf16): every
// product reads its shared-memory operand with per-thread fragment loads,
// so the transposed products (P^T g, dS^T q, dS k) read the row-major
// tiles as they land, with no staged transpose and no K-major rule to
// satisfy, and P and dS go from the accumulator registers straight into A
// fragments (for TF32 the 8-deep step's k order is permuted to the
// accumulator's column order: slot t is column 2t, slot t + 4 column
// 2t + 1). Two warpgroups a block, each warp 16 rows of the 64-row tile;
// the groups take alternate tiles of the loop (at N = 96 one each, which
// halves the chain of dependent steps) and group 1's sums are added to
// group 0's at the end. No float atomics: every output element is summed
// in a fixed order, so a call repeats bit for bit. Tiles stream through
// two shared-memory stages a group with cp.async (16 bytes a thread,
// zero-fill past N; rows padded to 272 / 144 bytes so fragment loads
// spread over the banks), each stage handed over with an mbarrier that
// cp.async.mbarrier.arrive completes; a group's next tile loads under the
// products of its current one. The head's mask is staged once as bit
// words, which also tells whether the head has a live key.
//
// Bound on an H100 SXM at the training shape (BH 32, N 96, d 64, self
// mix): the backward reads q, k (f32), v (bf16), g (f32) and the mask and
// writes dq, dk (f32) and dv (bf16): 4.7 MB, 1.4 us at 3.35 TB/s; its five
// distinct products are 2 N^2 d BH = 37.7 MFLOP each, 12 TF32 passes and 2
// bf16 ones (0.99 us). So it is bound by bytes, as forward plus backward is
// (about 0.0016 ms, chip_smoke.py::diff_bounds). At this size no design
// reaches that: each launch is one wave of blocks, each block a chain of
// dependent steps (load, S, dP, P, dV, dS, dK). The design keeps the chain
// short: one entry point and no host work between the launches, the key
// and query roles side by side in launch 2, two warpgroups a block on
// alternate tiles, the next tile's loads under the current tile's
// products, and no device memory for P or dS. Measured on an H100
// (chip_smoke.py phase 6b, device time of both launches): 0.035 ms self,
// 0.022 ms cross, about 25x the bound; 0.049 / 0.027 ms with one
// warpgroup a block. At (BH 4, N 2048, self) it is bound by operations
// (0.056 ms; launch 1's repeated S and dP add 0.017 ms) and reads 0.62 ms.
// No profiler reaches the card's machine; the likely causes are latency
// (two warps a sub-partition, each mma.sync in a chain of passes) and the
// TF32 splits, which every warp recomputes for the tile it shares. Next
// steps: wgmma for S and dP (K-major operands, as the forward) and a
// transposed staging of P, dS and q for the other products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim (checked by the wrapper)
constexpr int kB = 64;          // rows of a tile: queries or keys
constexpr int kGroupThreads = 128;   // a warpgroup: 16 rows of a tile a warp
constexpr int kGroups = 2;            // warpgroups a block; alternate tiles
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kStages = 2 * kGroups;  // two a group
constexpr int kRowF32 = 272;    // padded shared-memory row, float32 tile
constexpr int kRowBF16 = 144;   // padded shared-memory row, bf16 tile
constexpr int kSlot = kB * kRowF32;   // one tile of either type
// Shared memory: two fixed tiles, kStages stages of two tiles, each
// group's row statistics (D, m, 1/l) of 64 query rows, kStages + 1
// mbarriers, then two mask words per key tile.
constexpr int kStatOff = (2 + 2 * kStages) * kSlot;
constexpr int kBarOff = kStatOff + kGroups * 3 * kB * 4;
constexpr int kLiveOff = kBarOff + 8 * (kStages + 1);
constexpr int kMaxSmem = 232448;   // an H100 block's dynamic shared memory
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;
  const float* g;
  float* stats;   // (BH, Nq, 4): m, 1/l, D, unused; launch 1 writes it
  void* dq;   // null: not wanted (no query blocks)
  void* dk;   // null: not wanted
  void* dv;   // null: not wanted (both null: no key blocks)
  long long q_sh, q_sr, k_sh, k_sr, v_sh, v_sr, g_sh, g_sr, m_sh;
  int Nq, Nk, kv_blocks;
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

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// The barrier's current phase completes once this thread's cp.async copies
// issued so far have landed (one of its `count` arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
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

// c (16 x 8) += a (16 x 16) . b (16 x 8), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8) += a (16 x 8) . b (8 x 8), TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- shared-memory tiles ---------------------------------------------------

__device__ __forceinline__ float f32_at(const char* t, int r, int c) {
  return *reinterpret_cast<const float*>(t + r * kRowF32 + 4 * c);
}
__device__ __forceinline__ float2 f32x2_at(const char* t, int r, int c) {
  return *reinterpret_cast<const float2*>(t + r * kRowF32 + 4 * c);
}
__device__ __forceinline__ uint32_t bf16x2_at(const char* t, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(t + r * kRowBF16 + 2 * c);
}
__device__ __forceinline__ uint32_t bf16_at(const char* t, int r, int c) {
  return *reinterpret_cast<const unsigned short*>(t + r * kRowBF16 + 2 * c);
}

// Issue this thread's cp.async copies (thread `tid` of a warpgroup) of rows
// row0 .. row0 + 63 of one head's (N, 64) operand (row stride `sr`
// elements; rows past N zero) into a padded tile.
template <bool kF32>
__device__ __forceinline__ void load_tile(char* dst, const char* src,
                                          long long sr, int row0, int n,
                                          int tid) {
  constexpr int kEl = kF32 ? 4 : 2, kC = kD * kEl / 16;
  constexpr int kRow = kF32 ? kRowF32 : kRowBF16;
#pragma unroll
  for (int i = 0; i < kB * kC / kGroupThreads; ++i) {
    const int e = tid + i * kGroupThreads, r = e / kC, c = e % kC;
    const bool live = row0 + r < n;
    cp_async16(smem_u32(dst + r * kRow + 16 * c),
               src + (live ? (long long)(row0 + r) * sr * kEl + 16 * c : 0),
               live);
  }
}

// ---- the two product shapes of a warp (16 rows x 64 columns) -------------

// acc[n] (rows m0 + 0..15, columns 8n..8n+7) += X[m0 + i][:] . Y[8n + j][:]
// over the head dim: both tiles row-major, rows against rows. The passes
// are ordered by the operands' roles in S = q k^T and dP = g v^T: with
// kSwapped (X is k or v: S^T, dP^T) the mixed TF32 passes run hi.lo before
// lo.hi, so S^T and dP^T are the transposes of S and dP term by term.
template <bool kXF32, bool kYF32, bool kSwapped>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[8][4],
                                              const char* X, int m0,
                                              const char* Y, int g, int t) {
  const int r0 = m0 + g, r1 = r0 + 8;
  if constexpr (kXF32 && kYF32) {   // three TF32 passes
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int c0 = 8 * s + t, c1 = c0 + 4;
      uint32_t ah[4], al[4];
      split_tf32(f32_at(X, r0, c0), ah[0], al[0]);
      split_tf32(f32_at(X, r1, c0), ah[1], al[1]);
      split_tf32(f32_at(X, r0, c1), ah[2], al[2]);
      split_tf32(f32_at(X, r1, c1), ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(f32_at(Y, 8 * n + g, c0), bh0, bl0);
        split_tf32(f32_at(Y, 8 * n + g, c1), bh1, bl1);
        if constexpr (kSwapped) {
          mma_tf32(acc[n], ah, bl0, bl1);
          mma_tf32(acc[n], al, bh0, bh1);
        } else {
          mma_tf32(acc[n], al, bh0, bh1);
          mma_tf32(acc[n], ah, bl0, bl1);
        }
        mma_tf32(acc[n], ah, bh0, bh1);
      }
    }
  } else if constexpr (!kXF32 && !kYF32) {   // one exact bf16 pass
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int c0 = 16 * s + 2 * t, c1 = c0 + 8;
      const uint32_t a[4] = {bf16x2_at(X, r0, c0), bf16x2_at(X, r1, c0),
                             bf16x2_at(X, r0, c1), bf16x2_at(X, r1, c1)};
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma_bf16(acc[n], a, bf16x2_at(Y, 8 * n + g, c0),
                 bf16x2_at(Y, 8 * n + g, c1));
    }
  } else if constexpr (kXF32) {   // float32 X split into bf16 hi + lo
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int c0 = 16 * s + 2 * t, c1 = c0 + 8;
      uint32_t ah[4], al[4];
      float2 x = f32x2_at(X, r0, c0);
      split_bf16(x.x, x.y, ah[0], al[0]);
      x = f32x2_at(X, r1, c0);
      split_bf16(x.x, x.y, ah[1], al[1]);
      x = f32x2_at(X, r0, c1);
      split_bf16(x.x, x.y, ah[2], al[2]);
      x = f32x2_at(X, r1, c1);
      split_bf16(x.x, x.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t b0 = bf16x2_at(Y, 8 * n + g, c0),
                       b1 = bf16x2_at(Y, 8 * n + g, c1);
        mma_bf16(acc[n], al, b0, b1);
        mma_bf16(acc[n], ah, b0, b1);
      }
    }
  } else {   // float32 Y split into bf16 hi + lo
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int c0 = 16 * s + 2 * t, c1 = c0 + 8;
      const uint32_t a[4] = {bf16x2_at(X, r0, c0), bf16x2_at(X, r1, c0),
                             bf16x2_at(X, r0, c1), bf16x2_at(X, r1, c1)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        float2 y = f32x2_at(Y, 8 * n + g, c0);
        split_bf16(y.x, y.y, bh0, bl0);
        y = f32x2_at(Y, 8 * n + g, c1);
        split_bf16(y.x, y.y, bh1, bl1);
        mma_bf16(acc[n], a, bl0, bl1);
        mma_bf16(acc[n], a, bh0, bh1);
      }
    }
  }
}

// acc[n] (rows 0..15 of the warp, head dims 8n..8n+7) += A . Y[:, 8n + j],
// A (16 x 64) the accumulator fragments c of an earlier product (P or dS),
// summed over the 64 rows of Y: registers against a row-major tile.
template <bool kYF32>
__device__ __forceinline__ void mma_regs_rows(float (&acc)[8][4],
                                              const float (&c)[8][4],
                                              const char* Y, int g, int t) {
  if constexpr (kYF32) {   // three TF32 passes; slot t = row 8s + 2t,
                           // slot t + 4 = row 8s + 2t + 1
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      uint32_t ah[4], al[4];
      split_tf32(c[s][0], ah[0], al[0]);
      split_tf32(c[s][2], ah[1], al[1]);
      split_tf32(c[s][1], ah[2], al[2]);
      split_tf32(c[s][3], ah[3], al[3]);
      const int k0 = 8 * s + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(f32_at(Y, k0, 8 * n + g), bh0, bl0);
        split_tf32(f32_at(Y, k0 + 1, 8 * n + g), bh1, bl1);
        mma_tf32(acc[n], al, bh0, bh1);
        mma_tf32(acc[n], ah, bl0, bl1);
        mma_tf32(acc[n], ah, bh0, bh1);
      }
    }
  } else {   // A split into bf16 hi + lo, two passes against a bf16 Y
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(c[2 * kk][0], c[2 * kk][1], ah[0], al[0]);
      split_bf16(c[2 * kk][2], c[2 * kk][3], ah[1], al[1]);
      split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], ah[3], al[3]);
      const int k0 = 16 * kk + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + g;
        const uint32_t b0 = bf16_at(Y, k0, col) | (bf16_at(Y, k0 + 1, col) << 16);
        const uint32_t b1 =
            bf16_at(Y, k0 + 8, col) | (bf16_at(Y, k0 + 9, col) << 16);
        mma_bf16(acc[n], al, b0, b1);
        mma_bf16(acc[n], ah, b0, b1);
      }
    }
  }
}

// Rows row0 + 16 warp + g (+ 8) of a warp's accumulator, times `mul`, into
// a contiguous (BH, N, 64) output of float32 or bf16.
template <bool kF32>
__device__ __forceinline__ void store_rows(void* dst, int N, int row0, int bh,
                                           const float (&acc)[8][4], float mul,
                                           int warp, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * warp + g + 8 * h;
    if (row >= N) continue;
    const long long base = ((long long)bh * N + row) * kD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float a = acc[n][2 * h] * mul, b = acc[n][2 * h + 1] * mul;
      const int d = 8 * n + 2 * t;
      if constexpr (kF32)
        *reinterpret_cast<float2*>(static_cast<float*>(dst) + base + d) =
            make_float2(a, b);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dst) + base +
                                     d) = pack_bf16(a, b);
    }
  }
}

// The maximum (kMax) or the sum of row h's 16 values in this thread's
// fragments, then over the quad that shares the row: a fixed order, and
// the same bits in the quad's four threads.
template <bool kMax>
__device__ __forceinline__ float quad_reduce(const float (&x)[8][4], int h) {
  float a[8];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    a[n] = kMax ? fmaxf(x[n][2 * h], x[n][2 * h + 1])
                : x[n][2 * h] + x[n][2 * h + 1];
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n)
      a[n] = kMax ? fmaxf(a[n], a[n + w]) : a[n] + a[n + w];
#pragma unroll
  for (int o = 1; o <= 2; o *= 2) {
    const float b = __shfl_xor_sync(0xffffffffu, a[0], o);
    a[0] = kMax ? fmaxf(a[0], b) : a[0] + b;
  }
  return a[0];
}

__device__ __forceinline__ void group_sync(int gr) {   // one warpgroup
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gr), "n"(kGroupThreads)
               : "memory");
}

// kStats: launch 1, query blocks only, writing each row's (m, 1/l, D).
// Else launch 2: p.kv_blocks key blocks, then the query blocks. Warpgroup
// gr takes the loop's tiles gr, gr + kGroups, ...; group 1's sums are
// merged into group 0's at the end, in that order.
template <bool kQKF32, bool kVF32, bool kStats>
__global__ void __launch_bounds__(kThreads, 1)
masked_attention_bwd_kernel(const Params p) {
  extern __shared__ __align__(128) char smem[];
  constexpr int kQK = kQKF32 ? 4 : 2, kV = kVF32 ? 4 : 2;
  const int bh = blockIdx.y, tid = threadIdx.x;
  const int gr = tid / kGroupThreads, gtid = tid % kGroupThreads;
  const int warp = tid / 32, wq = warp % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bool kv_role = !kStats && (int)blockIdx.x < p.kv_blocks;
  const int tile = kv_role ? (int)blockIdx.x : (int)blockIdx.x - p.kv_blocks;
  const int n_qt = (p.Nq + kB - 1) / kB, n_kt = (p.Nk + kB - 1) / kB;
  const int n_iter = kv_role ? n_qt : n_kt;

  char* fixed0 = smem;          // key block: K; query block: q
  char* fixed1 = smem + kSlot;  // key block: V; query block: g
  auto stage = [&](int it) { return smem + (2 + 2 * (it % kStages)) * kSlot; };
  float* stat = reinterpret_cast<float*>(smem + kStatOff) + gr * 3 * kB;
  const uint32_t bars = smem_u32(smem + kBarOff);   // full[kStages], fixed
  auto full_bar = [&](int it) { return bars + 8 * (it % kStages); };
  const uint32_t fixed_bar = bars + 8 * kStages;
  uint32_t* live = reinterpret_cast<uint32_t*>(smem + kLiveOff);

  const char* qb = static_cast<const char*>(p.q) + bh * p.q_sh * kQK;
  const char* kb = static_cast<const char*>(p.k) + bh * p.k_sh * kQK;
  const char* vb = static_cast<const char*>(p.v) + bh * p.v_sh * kV;
  const char* gb = reinterpret_cast<const char*>(p.g + bh * p.g_sh);
  const float4* st = reinterpret_cast<const float4*>(p.stats) +
                     (long long)bh * p.Nq;
  // Tile it of the loop: key block: q and g of query tile it; query block:
  // K and V of key tile it. Its group loads it.
  auto issue = [&](int it) {
    char* s = stage(it);
    if (kv_role) {
      load_tile<kQKF32>(s, qb, p.q_sr, it * kB, p.Nq, gtid);
      load_tile<true>(s + kSlot, gb, p.g_sr, it * kB, p.Nq, gtid);
    } else {
      load_tile<kQKF32>(s, kb, p.k_sr, it * kB, p.Nk, gtid);
      load_tile<kVF32>(s + kSlot, vb, p.v_sr, it * kB, p.Nk, gtid);
    }
  };
  // the fixed tiles: group 0 loads the first, group 1 the second
  if (kv_role) {
    if (gr == 0) load_tile<kQKF32>(fixed0, kb, p.k_sr, tile * kB, p.Nk, gtid);
    else load_tile<kVF32>(fixed1, vb, p.v_sr, tile * kB, p.Nk, gtid);
  } else {
    if (gr == 0) load_tile<kQKF32>(fixed0, qb, p.q_sr, tile * kB, p.Nq, gtid);
    else load_tile<true>(fixed1, gb, p.g_sr, tile * kB, p.Nq, gtid);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, kGroupThreads);
    mbar_init(fixed_bar, kThreads);
  }
  // The head's mask as bit words: bit b of word w is key 32 w + b live (0
  // past Nk); and whether any key of the head is live.
  bool any = false;
  {
    const unsigned char* mb = p.mask + bh * p.m_sh;
    for (int w = warp; w < 2 * n_kt; w += kThreads / 32) {
      const int j = 32 * w + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, j < p.Nk && mb[j]);
      if (lane == 0) live[w] = bits;
      any |= bits != 0u;
    }
  }
  const bool any_live = __syncthreads_or(any) != 0;   // + barriers' init
  cp_async_arrive(fixed_bar);
  if (gr < n_iter) {
    issue(gr);
    cp_async_arrive(full_bar(gr));
  }

  // This thread's rows of the fixed tile: 16 wq + g + 8 h. Key block: the
  // key is below Nk, is live. Query block: the query is below Nq, and its
  // statistics (launch 2).
  bool row_in[2], row_live[2] = {false, false};
  float row_m[2] = {0.f, 0.f}, row_il[2] = {0.f, 0.f}, row_d[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tile * kB + 16 * wq + g + 8 * h;
    if (kv_role) {
      row_in[h] = r < p.Nk;
      row_live[h] = (live[r / 32] >> (r % 32)) & 1u;
    } else {
      row_in[h] = r < p.Nq;
      if (!kStats && row_in[h]) {
        const float4 x = st[r];
        row_m[h] = x.x;
        row_il[h] = x.y;
        row_d[h] = x.z;
      }
    }
  }
  const float inv_nk = 1.f / (float)p.Nk;
  // launch 1: running max, sum of exp and sum of exp dP of rows h
  float run_m[2] = {-INFINITY, -INFINITY}, run_l[2] = {0.f, 0.f},
        run_u[2] = {0.f, 0.f};

  float acc0[8][4], acc1[8][4];   // key block: dK, dV; query block: dQ
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[n][e] = acc1[n][e] = 0.f;
  mbar_wait(fixed_bar, 0);

  for (int it = gr; it < n_iter; it += kGroups) {
    if (it + kGroups < n_iter) {
      issue(it + kGroups);   // its stage was released by the last group_sync
      cp_async_arrive(full_bar(it + kGroups));
    }
    if (kv_role) {   // the statistics of query tile it
      if (gtid < kB) {
        const int q = it * kB + gtid;
        const float4 x = q < p.Nq ? st[q] : make_float4(0.f, 0.f, 0.f, 0.f);
        stat[gtid] = x.z;
        stat[kB + gtid] = x.x;
        stat[2 * kB + gtid] = x.y;
      }
      group_sync(gr);
    }
    mbar_wait(full_bar(it), (it / kStages) & 1);
    const char* s0 = stage(it);
    const char* s1 = s0 + kSlot;

    // S and dP (query block) or their transposes (key block)
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    if (kv_role) {
      mma_rows_rows<kQKF32, kQKF32, true>(sc, fixed0, 16 * wq, s0, g, t);
      mma_rows_rows<kVF32, true, true>(dp, fixed1, 16 * wq, s1, g, t);
    } else {
      mma_rows_rows<kQKF32, kQKF32, false>(sc, fixed0, 16 * wq, s0, g, t);
      mma_rows_rows<true, kVF32, false>(dp, fixed1, 16 * wq, s1, g, t);
    }

    // Element (n, e): row 16 wq + g + 8 (e >> 1) of the fixed tile,
    // column 8 n + 2 t + (e & 1) of the streamed one.
    uint32_t w0 = 0u, w1 = 0u;   // query block: key tile it's mask words
    if (!kv_role) {
      w0 = live[2 * it];
      w1 = live[2 * it + 1];
    }
    auto key_live = [&](int h, int c) {
      return kv_role ? row_live[h]
                     : (((c < 32 ? w0 : w1) >> (c % 32)) & 1u) != 0u;
    };
    if constexpr (kStats) {
      // online (max, sum, sum of exp dP) over the live keys, rows h
      if (any_live) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] = key_live(e >> 1, 8 * n + 2 * t + (e & 1))
                           ? sc[n][e] * p.scale
                           : -INFINITY;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the same in the quad's threads; -inf until a live key is seen,
          // and then every exp and the correction are 0
          const float m_new = fmaxf(run_m[h], quad_reduce<true>(sc, h));
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          const float corr = ex2((run_m[h] - m_use) * kLog2e);
          run_m[h] = m_new;
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              sc[n][e] = ex2((sc[n][e] - m_use) * kLog2e);
              dp[n][e] *= sc[n][e];
            }
          run_l[h] = run_l[h] * corr + quad_reduce<false>(sc, h);
          run_u[h] = run_u[h] * corr + quad_reduce<false>(dp, h);
        }
      }
    } else {
      // P into sc, dS into dp
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, c = 8 * n + 2 * t + (e & 1);
          bool q_in, k_in;
          float m, il, d;
          if (kv_role) {
            q_in = it * kB + c < p.Nq;
            k_in = row_in[h];
            d = stat[c];
            m = stat[kB + c];
            il = stat[2 * kB + c];
          } else {
            q_in = row_in[h];
            k_in = it * kB + c < p.Nk;
            d = row_d[h];
            m = row_m[h];
            il = row_il[h];
          }
          float pr = 0.f;
          if (q_in) {
            if (any_live)
              pr = key_live(h, c)
                       ? ex2((sc[n][e] * p.scale - m) * kLog2e) * il
                       : 0.f;
            else
              pr = k_in ? inv_nk : 0.f;
          }
          sc[n][e] = pr;
          dp[n][e] = any_live ? pr * (dp[n][e] - d) : 0.f;
        }
      if (kv_role) {
        mma_regs_rows<true>(acc1, sc, s1, g, t);     // dV += P^T g
        mma_regs_rows<kQKF32>(acc0, dp, s0, g, t);   // dK += dS^T q
      } else {
        mma_regs_rows<kQKF32>(acc0, dp, s0, g, t);   // dQ += dS K
      }
    }
    group_sync(gr);   // the stage and the statistics are free again
  }

  // Merge: group 1 leaves its sums in the (now idle) stages, group 0 adds
  // them to its own and writes the result.
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem + 2 * kSlot);
  const int lr0 = 16 * wq + g;   // this thread's rows in the tile: lr0, +8
  if constexpr (kStats) {
    if (gr == 1 && t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* x = part + 3 * (lr0 + 8 * h);
        x[0] = run_m[h];
        x[1] = run_l[h];
        x[2] = run_u[h];
      }
    }
    __syncthreads();
    if (gr == 0 && t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!row_in[h]) continue;
        const float* x = part + 3 * (lr0 + 8 * h);
        const float m = fmaxf(run_m[h], x[0]);
        // (m, 1/l, D); zeros for a head with no live key (unused there)
        float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m != -INFINITY) {
          const float c0 = ex2((run_m[h] - m) * kLog2e),
                      c1 = ex2((x[0] - m) * kLog2e);
          const float l = run_l[h] * c0 + x[1] * c1,
                      u = run_u[h] * c0 + x[2] * c1;
          out = make_float4(m, 1.f / l, u / l, 0.f);
        }
        reinterpret_cast<float4*>(p.stats)[(long long)bh * p.Nq + tile * kB +
                                           lr0 + 8 * h] = out;
      }
    }
  } else {
    auto park = [&](float* dst, const float (&acc)[8][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(dst + (lr0 + 8 * h) * kD + 8 * n +
                                     2 * t) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    };
    auto add = [&](const float* src, float (&acc)[8][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 x = *reinterpret_cast<const float2*>(
              src + (lr0 + 8 * h) * kD + 8 * n + 2 * t);
          acc[n][2 * h] += x.x;
          acc[n][2 * h + 1] += x.y;
        }
    };
    if (gr == 1) {
      park(part, acc0);
      if (kv_role) park(part + kB * kD, acc1);
    }
    __syncthreads();
    if (gr == 0) {
      add(part, acc0);
      if (kv_role) {
        add(part + kB * kD, acc1);
        if (p.dk != nullptr)
          store_rows<kQKF32>(p.dk, p.Nk, tile * kB, bh, acc0, p.scale, wq, g,
                             t);
        if (p.dv != nullptr)
          store_rows<kVF32>(p.dv, p.Nk, tile * kB, bh, acc1, 1.f, wq, g, t);
      } else {
        store_rows<kQKF32>(p.dq, p.Nq, tile * kB, bh, acc0, p.scale, wq, g,
                           t);
      }
    }
  }
}

long long smem_bytes(int Nk) {
  return kLiveOff + (long long)(Nk + kB - 1) / kB * 8;
}

template <bool kQKF32, bool kVF32, bool kStats>
int launch(const Params& p, int BH, int blocks, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        masked_attention_bwd_kernel<kQKF32, kVF32, kStats>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long smem = smem_bytes(p.Nk);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  masked_attention_bwd_kernel<kQKF32, kVF32, kStats>
      <<<dim3(blocks, BH), kThreads, (size_t)smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launch 1 on the query tiles, then launch 2 on the key and query blocks.
template <bool kQKF32, bool kVF32>
int launch_both(Params p, int BH, cudaStream_t stream) {
  const int n_qt = (p.Nq + kB - 1) / kB, n_kt = (p.Nk + kB - 1) / kB;
  const int kv_blocks = (p.dk != nullptr || p.dv != nullptr) ? n_kt : 0;
  const int blocks = kv_blocks + (p.dq != nullptr ? n_qt : 0);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  p.kv_blocks = 0;
  const int err = launch<kQKF32, kVF32, true>(p, BH, n_qt, stream);
  if (err != 0) return err;
  p.kv_blocks = kv_blocks;
  return launch<kQKF32, kVF32, false>(p, BH, blocks, stream);
}

}  // namespace

// Plain C entry point for ctypes. Strides are in elements; qk_bf16 and
// v_bf16 pick the variant (q and k share a type). g is float32; stats is
// float32 scratch of BH * Nq * 4 (16-byte aligned); dq, dk, dv are
// contiguous outputs in q's, k's and v's types, each may be null (not
// computed). Launches both kernels on `stream`, allocates nothing, and
// returns a CUDA error code (0 = launched).
extern "C" int masked_attention_bwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* g, void* stats, void* dq, void* dk, void* dv, int BH, int Nq,
    int Nk, long long q_sh, long long q_sr, long long k_sh, long long k_sr,
    long long v_sh, long long v_sr, long long g_sh, long long g_sr,
    long long m_sh, int qk_bf16, int v_bf16, float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || Nq <= 0 || Nk <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    static_cast<const unsigned char*>(mask),
           static_cast<const float*>(g), static_cast<float*>(stats),
           dq,   dk,   dv,   q_sh, q_sr, k_sh, k_sr, v_sh, v_sr, g_sh, g_sr,
           m_sh, Nq,   Nk,   0,    scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!qk_bf16 && v_bf16) return launch_both<true, false>(p, BH, s);
  if (qk_bf16 && v_bf16) return launch_both<false, false>(p, BH, s);
  if (!qk_bf16 && !v_bf16) return launch_both<true, true>(p, BH, s);
  return (int)cudaErrorInvalidValue;
}

// The largest Nk a block can hold the mask words of (the same for every
// variant: the tiles take the float32 size).
extern "C" int masked_attention_bwd_max_keys(int qk_bf16, int v_bf16) {
  (void)qk_bf16;
  (void)v_bf16;
  return (int)((kMaxSmem - smem_bytes(0)) / 8 * kB);
}
