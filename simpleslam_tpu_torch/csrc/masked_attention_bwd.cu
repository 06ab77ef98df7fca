// Key-masked attention backward for the LightGlue matcher, by hand for
// Hopper (sm_90a: wgmma, mbarriers, clusters, programmatic dependent
// launch).
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
// Why the statistics are recomputed and not taken from the forward. The
// trained self-attention's logits reach ~800; there dS = P (dP - D) is a
// small difference of large terms, and dq = dS k cancels again (each row
// of dS sums to 0). A float32 log-sum-exp rounds by ~3e-5 at |lse| ~ 800,
// so P = exp(S - lse) rows sum to 1 +- 3e-5, and D = rowsum(g * out) from
// the forward's output is not the D of this P and dP. Emulated on the 36
// attention calls of one training step from the trained tree
// (tests/test_torch_attention_bwd.py), the worst float32 gradient against
// float64, over its largest entry, reads 1.5e-3 with a float32 forward lse
// and D from out, and 9.0e-5 with the statistics of this kernel, against
// 9.8e-5 for plain float32. So every P, dP and D here comes from one set
// of products: each block role forms S and dP with the same wgmma passes
// in the same order (below), the row statistics (max m, 1/l, D) come from
// those products, and P = exp(S - m) / l is formed the same way wherever
// it is used.
//
// Arithmetic: float32-accurate products on the tensor cores, by operand
// splitting. Where both operands are float32, three TF32 passes per 8-deep
// step (lo.hi, hi.lo, hi.hi; hi rounded to nearest, lo = rna(x - hi));
// where one is bf16, the float32 one is split into bf16 hi + lo and two
// bf16 passes (lo first) are exact against the bf16 one; bf16 against
// bf16 is one exact pass:
//   S   = q k^T   f32 q, k: 3 TF32; bf16: 1 bf16
//   dP  = g v^T   bf16 v: 2 bf16 (g split); f32 v: 3 TF32
//   dV += P^T g   3 TF32 (P from registers)
//   dK += dS^T q  f32 q: 3 TF32; bf16 q: 2 bf16 (dS split)
//   dQ += dS k    f32 k: 3 TF32; bf16 k: 2 bf16 (dS split)
// Exponentials are ex2.approx of (S/8 - m) log2(e).
//
// Design. Every product is a warpgroup MMA (wgmma) on operands that a
// producer warpgroup has split into TF32 / bf16 hi and lo parts in shared
// memory once per tile, read by both consumer warpgroups of the block. A
// block holds 128 fixed rows, 64 for each consumer group, and streams
// 32-row tiles (m64n32 products for S and dP; m64n64 for the gradients,
// which contract over the streamed rows); each group sums its own rows in
// a fixed order (no float atomics: a call repeats bit for bit; sums over
// long loops go through chunk sums of 16 tiles, so that float32 rounding
// does not grow with Nk). Three block roles:
//   query, pass 1  (bh, 128 queries): q and g fixed, K and V streamed; S
//                  and dP, and online per row m, l = sum exp(S - m) and
//                  u = sum exp(S - m) dP, from which every reader forms
//                  (m, 1/l, D = u / l) the same way (row_stats);
//   query, pass 2  the same, then P and dS, dQ += dS k;
//   key            (bh, 128 keys): K and V fixed, q, g and the query rows'
//                  statistics streamed; S^T = k q^T and dP^T = v g^T put
//                  P^T and dS^T in the accumulator registers, which are
//                  the A operands of dV += P^T g and dK += dS^T q.
// The key role's S^T and dP^T take the query role's passes in the same
// order with the operands' roles swapped ((k_hi, q_lo) for (q_lo, k_hi)):
// each element is the same dot products of the same TF32 / bf16 parts
// summed in the same order, so P^T and dS^T are the transposes of the
// query role's P and dS bit for bit (the card test
// test_masked_attention_bwd_orientations_agree holds this: one live key a
// head gives P = 1 and dP - D = 0 exactly, so dk = dq = 0 and dv = sum g).
// Operand layouts (128-byte swizzle, as the forward kernel's):
//   row tiles, K-major over the head dim: float32 rows as two 128-byte
//     columns, bf16 rows as one; the A or B operand of S and dP;
//   transposed tiles [64 head dims][32 streamed rows], K-major over the
//     rows, TF32 hi and lo: the B operand of dV (g^T), and of dK (q^T) and
//     dQ (k^T) where q and k are float32 (TF32 has no transpose flag). The
//     A operand comes from the S^T / S accumulator, whose thread holds
//     columns 2t and 2t + 1 of each 8-column step where the TF32 A
//     fragment wants t and t + 4: the producer writes the rows of each
//     8-group in the order 0 2 4 6 1 3 5 7, so slot t is row 2t and slot
//     t + 4 row 2t + 1;
//   bf16 q and k as the B operand of dK and dQ: the row tile itself with
//     the descriptor's transpose flag (as the forward's V).
// The producer streams each tile with cp.async (16 bytes a thread, whole
// rows a warp, zero-fill past N) into a landing buffer, then, once one of
// the two stages is free, splits it into the stage and hands it over with
// an mbarrier; the next tiles land, and the next stage is split, under the
// consumers' products. The producer also carries the tile's statistics
// (key role) or live-key word (query role) into a small ring beside the
// stages, so that no consumer waits on device memory inside its loop; it
// loads them as a tile's split begins and stores them as it ends, so that
// the load runs under the split.
// Launches. Pass 1 must finish for a head before its key blocks form P.
// Where a head's blocks fit in one cluster (key blocks + query blocks <=
// 8: N <= 512, the training shape N = 96 included) the call is ONE launch:
// each head is a cluster whose query blocks run pass 1, write the
// statistics and arrive on the cluster barrier, then run pass 2, while its
// key blocks' producers wait on that barrier before streaming statistics.
// Larger heads take two launches: pass 1 alone, then the key blocks and
// the query blocks' pass 2, launched as a programmatic dependent launch so
// that their prologue (fixed tiles loaded and split) runs under pass 1's
// tail; they wait (griddepcontrol.wait) only where they read statistics.
// Without dk and dv there are no key blocks, and the launches are the same.
// In the two-launch form pass 1 is split over two key halves (two blocks a
// query tile fill the card), each writing a partial record (m, l, u) that
// every reader combines in the same order. Shared memory does not grow
// with Nk (the mask is read a tile at a time).
//
// Bound on an H100 SXM (chip_smoke.py::bwd_bounds): at the training shape
// (BH 32, N 96, self mix) the backward reads q, k (f32), v (bf16), g (f32)
// and the mask and writes dq, dk (f32) and dv (bf16): 4.7 MB, 1.4 us at
// 3.35 TB/s, against 1.0 us of tensor-core work, so it is bound by bytes;
// at (BH 4, N 2048, self) by operations, 0.056 ms.
// Measured (chip_smoke.py phase 6b, device time; NVIDIA H100 80GB HBM3,
// 700.00 W): (32, 96) 0.0236 ms self, 0.0173 ms cross, one launch; (4,
// 2048) 0.237 ms self, 0.152 ms cross, two launches, against SDPA
// float32's backward alone at 0.531 ms. The mma.sync design this one
// replaces (two launches, each warp splitting its own fragments) read
// 0.0351 / 0.0221 and 0.6105 / 0.354 ms on the same card (PERF.md). What sets the time now (clock64 spans per tile,
// tools/bwd_spans.py): at (4, 2048) the consumers' products and softmax
// (the key blocks' producer, which splits q and g into four layouts, hi
// and lo each, keeps just ahead of them); at (32, 96) the chain of one
// launch: pass 1's three tiles, then the key blocks' three.
// Two things the compiler needs here: the warpgroup index broadcast from
// lane 0 (else it takes every branch on it as divergent and serializes
// every wgmma, C7520), and the softmax's per-element work free of
// branches (it was the consumers' largest phase).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Built with -DMAB_SPANS (tools/bwd_spans.py), thread 0 of each warpgroup
// adds the clock64 cycles of each phase of its loop to g_spans[role][phase]
// (role 0 key, 1 query; phases: producer wait for loads, wait for a free
// stage, split; consumer wait for a full stage, S and dP, softmax,
// gradient products). Without it the spans compile to nothing.
#ifdef MAB_SPANS
__device__ unsigned long long g_spans[2][8];
#define SPAN_BEGIN(v) const unsigned long long v = clock64();
#define SPAN_END(role, i, v) \
  if (threadIdx.x % 128 == 0) atomicAdd(&g_spans[role][i], clock64() - (v));
#else
#define SPAN_BEGIN(v)
#define SPAN_END(role, i, v)
#endif

namespace {

constexpr int kD = 64;          // head dim (checked by the wrapper)
constexpr int kBF = 64;         // fixed rows of a consumer group
constexpr int kBS = 32;         // rows of a streamed tile
constexpr int kGT = 128;        // a warpgroup
constexpr int kGroups = 2;      // consumer warpgroups, 64 fixed rows each
constexpr int kRows = kGroups * kBF;   // a block's fixed rows
constexpr int kThreads = (1 + kGroups) * kGT;   // and the producer
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kMaxSmem = 232448;    // an H100 block's dynamic shared memory
constexpr int kMaxKeys = 1 << 20;   // a cap on the grid; no resource limit
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;
  const float* g;
  float* stats;   // (splits, BH, Nq, 4): m, l, u, any key live (1 / 0)
  void* dq;       // null: not wanted
  void* dk;
  void* dv;
  long long q_sh, q_sr, k_sh, k_sr, v_sh, v_sr, g_sh, g_sr, m_sh;
  int Nq, Nk;
  int key_blocks;   // blockIdx.x below it: key role; the rest query role
  int pass1;        // query blocks run pass 1 (the statistics)
  int pass2;        // query blocks run pass 2 (dQ)
  int stats_out;    // pass 1 writes the statistics to `stats`
  int splits;       // pass 1's key ranges: 1, or 2 (two partial records)
  int cluster;      // the head's blocks meet on the cluster barrier
  int pdl_wait;     // wait for the previous launch before reading stats
  float scale;
};

// ---- small helpers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the producer warpgroup, named barrier 2
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kGT) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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

// A row's statistics (m, 1/l, D = u / l, any key live) from pass 1's
// partial records (m, l = sum exp(S - m), u = sum exp(S - m) dP, live),
// one per key range, combined in a fixed order: every reader (pass 2's
// query blocks, the key blocks) forms the same bits. Zero where no key is
// live.
__device__ __forceinline__ float4 row_stats(const float4* st, long long i,
                                            long long stride, int splits) {
  float4 a = st[i];
  if (splits == 2) {
    const float4 b = st[i + stride];
    const float m = fmaxf(a.x, b.x);
    if (m == -INFINITY) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float ca = ex2((a.x - m) * kLog2e), cb = ex2((b.x - m) * kLog2e);
    a = make_float4(m, a.y * ca + b.y * cb, a.z * ca + b.z * cb, 1.f);
  }
  if (a.x == -INFINITY) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(a.x, 1.f / a.y, a.z / a.y, 1.f);
}

// ---- warpgroup MMA ----------------------------------------------------------

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
// Keep the compiler from touching accumulators or A fragments across an
// async MMA.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[n][e])::"memory");
}

#define ACC16(d)                                                              \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),  \
      "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]),             \
      "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]),             \
      "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
#define ACC32(d)                                                              \
  ACC16(d), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),       \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),             \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),             \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define DREGS16                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define DREGS32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (64 x 32 per warpgroup) += a (64 x 8) . b (8 x 32), TF32, both K-major
// in shared memory
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[4][4],
                                                  uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " DREGS16
      ", %16, %17, p, 1, 1;\n}\n"
      : ACC16(d)
      : "l"(a), "l"(b), "r"(1));
}
// d (64 x 32) += a (64 x 16) . b (16 x 32), bf16, both K-major in shared
// memory
__device__ __forceinline__ void wgmma_bf16_ss_n32(float (&d)[4][4],
                                                  uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " DREGS16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC16(d)
      : "l"(a), "l"(b), "r"(1));
}
// d (64 x 64) += a (64 x 8, TF32 in registers) . b (8 x 64, K-major in
// shared memory)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DREGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 64) += a (64 x 16, bf16 in registers) . b (16 x 64, bf16,
// MN-major in shared memory: the transpose flag set)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DREGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- shared-memory layouts -------------------------------------------------

// 16-byte chunk c (0..15) of row r of an R-row float32 tile: two 128-byte
// swizzle columns of R rows.
__device__ __forceinline__ int off_f32(int R, int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}
// 16-byte chunk c (0..7) of row r of a bf16 tile (one 128-byte column)
__device__ __forceinline__ int off_b16(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}
// the 8 bytes of float32 chunk c (dims 4c..4c+3) of row r in a bf16 tile
__device__ __forceinline__ int off_b16_half(int r, int c) {
  return r * 128 + (((c >> 1) ^ (r & 7)) << 4) + ((c & 1) << 3);
}
// the word (head dim d, position p) of a transposed tile [64][32]
__device__ __forceinline__ int off_t(int d, int p) {
  return d * 128 + (((p >> 2) ^ (d & 7)) << 4) + ((p & 3) << 2);
}
// the position of streamed row r in a transposed tile: rows 0 2 4 6 1 3 5
// 7 of each 8-group, so that slot t holds row 2t and slot t + 4 row 2t + 1
__device__ __forceinline__ int perm8(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}
// the landing buffer: float32 rows of 256 bytes, bf16 rows of 128 bytes,
// chunks swizzled so that a warp's 32 rows of one chunk spread over the
// banks
template <bool kF32>
__device__ __forceinline__ int off_raw(int r, int c) {
  return kF32 ? r * 256 + ((c ^ (r & 15)) << 4) : r * 128 + ((c ^ (r & 7)) << 4);
}

constexpr int round1k(int x) { return (x + 1023) / 1024 * 1024; }

template <bool kQKF32, bool kVF32>
struct Cfg {
  static constexpr int kQKEl = kQKF32 ? 4 : 2, kVEl = kVF32 ? 4 : 2;
  static constexpr int kFixF32 = kBF * kD * 4;   // 16 KB: one part of a fixed f32 tile
  static constexpr int kFixB16 = kBF * kD * 2;   // 8 KB
  static constexpr int kStrF32 = kBS * kD * 4;   // 8 KB: a streamed f32 part
  static constexpr int kStrB16 = kBS * kD * 2;   // 4 KB
  static constexpr int kT = kD * kBS * 4;        // 8 KB: a transposed part
  // Two stages (one for the all-float32 variant, tests only: its fixed
  // tiles leave no room), each read by both consumer groups while the
  // producer splits the next tile into the other; landing buffers, each
  // one tile's loads in flight.
  static constexpr bool kAllF32 = kQKF32 && kVF32;
  static constexpr int kStages = kAllF32 ? 1 : 2;
  static constexpr int kLand = kAllF32 ? 1 : (kQKF32 ? 2 : 3);
  // key role: each group's fixed K (A of S^T) and V (A of dP^T); a stage
  // holds q (B of S^T), g (B of dP^T), g^T (B of dV) and q^T (B of dK,
  // float32 q)
  static constexpr int kKeyFixK = kQKF32 ? 2 * kFixF32 : kFixB16;   // a group's
  static constexpr int kKeyFixV = kVF32 ? 2 * kFixF32 : kFixB16;
  static constexpr int kKeyV0 = kGroups * kKeyFixK;
  static constexpr int kKeyQ = 0;
  static constexpr int kKeyG = kKeyQ + (kQKF32 ? 2 * kStrF32 : kStrB16);
  static constexpr int kKeyGT = kKeyG + (kVF32 ? 2 * kStrF32 : 2 * kStrB16);
  static constexpr int kKeyQT = kKeyGT + 2 * kT;
  static constexpr int kKeyStage = kKeyQT + (kQKF32 ? 2 * kT : 0);
  static constexpr int kKeyLandG = kBS * kD * kQKEl;   // after raw q
  static constexpr int kKeyLand = kKeyLandG + kBS * kD * 4;
  static constexpr int kKeyStage0 = kKeyV0 + kGroups * kKeyFixV;
  static constexpr int kKeyLand0 = kKeyStage0 + kStages * kKeyStage;
  static constexpr int kKeyEnd = kKeyLand0 + kLand * kKeyLand;
  // query role: each group's fixed q (A of S) and g (A of dP), and the
  // block's rows' statistics; a stage holds K (B of S), V (B of dP) and
  // K^T (B of dQ, float32 k)
  static constexpr int kQFixQ = kQKF32 ? 2 * kFixF32 : kFixB16;   // a group's
  static constexpr int kQFixG = kVF32 ? 2 * kFixF32 : 2 * kFixB16;
  static constexpr int kQG0 = kGroups * kQFixQ;
  static constexpr int kQFixStat = kQG0 + kGroups * kQFixG;
  static constexpr int kQStage0 = kQFixStat + kRows * 16;
  static constexpr int kQK = 0;
  static constexpr int kQV = kQK + (kQKF32 ? 2 * kStrF32 : kStrB16);
  static constexpr int kQKT = kQV + (kVF32 ? 2 * kStrF32 : kStrB16);
  static constexpr int kQStage = kQKT + (kQKF32 ? 2 * kT : 0);
  static constexpr int kQLandV = kBS * kD * kQKEl;   // after raw k
  static constexpr int kQLand = kQLandV + kBS * kD * kVEl;
  static constexpr int kQLand0 = kQStage0 + kStages * kQStage;
  static constexpr int kQEnd = kQLand0 + kLand * kQLand;
  // barriers full[kStages], empty[kStages], the key role's four live-key
  // words, then a small ring beside the stages: a tile's 32 query rows'
  // statistics (key role) or its live-key word (query role)
  static constexpr int kBars = round1k(kKeyEnd > kQEnd ? kKeyEnd : kQEnd);
  static constexpr int kLive = kBars + 16 * kStages;
  static constexpr int kRing = kLive + 16;
  static constexpr int kSmem = kRing + kStages * kBS * 16;
  static_assert(kSmem <= kMaxSmem, "shared memory");
};

// ---- loads ------------------------------------------------------------------

// A fixed tile of 64 rows (row0.., zero past n) in this thread's
// registers: chunks e = tid + 384 j of 16 bytes, row e / kC, chunk e % kC
// (kC 16 for float32 rows, 8 for bf16). Every load is issued before any is
// used, so a block's prologue waits for memory once per operand pair.
template <int kC>
struct Fixed {
  static constexpr int kN = (kBF * kC + kThreads - 1) / kThreads;
  uint4 x[kN];
};
template <int kC>
__device__ __forceinline__ Fixed<kC> fetch_fixed(const char* src,
                                                 long long sr_bytes, int row0,
                                                 int n, int tid) {
  Fixed<kC> f;
#pragma unroll
  for (int j = 0; j < Fixed<kC>::kN; ++j) {
    const int e = tid + j * kThreads, r = e / kC, c = e % kC;
    f.x[j] = make_uint4(0u, 0u, 0u, 0u);
    if (e < kBF * kC && row0 + r < n)
      f.x[j] = *reinterpret_cast<const uint4*>(src + (row0 + r) * sr_bytes +
                                               16 * c);
  }
  return f;
}
// float32 rows split into TF32 hi and lo row tiles (K-major, 128-byte
// swizzle)
__device__ __forceinline__ void put_tf32(char* hi, const Fixed<16>& f,
                                         int tid) {
#pragma unroll
  for (int j = 0; j < Fixed<16>::kN; ++j) {
    const int e = tid + j * kThreads, r = e >> 4, c = e & 15;
    if (e >= kBF * 16) break;
    uint4 h, l;
    split_tf32(__uint_as_float(f.x[j].x), h.x, l.x);
    split_tf32(__uint_as_float(f.x[j].y), h.y, l.y);
    split_tf32(__uint_as_float(f.x[j].z), h.z, l.z);
    split_tf32(__uint_as_float(f.x[j].w), h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off_f32(kBF, r, c)) = h;
    *reinterpret_cast<uint4*>(hi + kBF * kD * 4 + off_f32(kBF, r, c)) = l;
  }
}
// bf16 rows as they are
__device__ __forceinline__ void put_b16(char* dst, const Fixed<8>& f,
                                        int tid) {
#pragma unroll
  for (int j = 0; j < Fixed<8>::kN; ++j) {
    const int e = tid + j * kThreads, r = e >> 3, c = e & 7;
    if (e >= kBF * 8) break;
    *reinterpret_cast<uint4*>(dst + off_b16(r, c)) = f.x[j];
  }
}
// float32 rows split into bf16 hi and lo tiles
__device__ __forceinline__ void put_bf16_split(char* hi, const Fixed<16>& f,
                                               int tid) {
#pragma unroll
  for (int j = 0; j < Fixed<16>::kN; ++j) {
    const int e = tid + j * kThreads, r = e >> 4, c = e & 15;
    if (e >= kBF * 16) break;
    const float4 x = make_float4(
        __uint_as_float(f.x[j].x), __uint_as_float(f.x[j].y),
        __uint_as_float(f.x[j].z), __uint_as_float(f.x[j].w));
    uint2 h, l;
    split_bf16(x.x, x.y, h.x, l.x);
    split_bf16(x.z, x.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + off_b16_half(r, c)) = h;
    *reinterpret_cast<uint2*>(hi + kBF * kD * 2 + off_b16_half(r, c)) = l;
  }
}
// a float32 operand's fixed tile as TF32 hi / lo, or a bf16 one as it is
template <bool kF32>
__device__ __forceinline__ void put_fixed(char* dst,
                                          const Fixed<kF32 ? 16 : 8>& f,
                                          int tid) {
  if constexpr (kF32) put_tf32(dst, f, tid);
  else put_b16(dst, f, tid);
}
// This producer thread's cp.async copies of streamed rows row0..row0+31 of
// one operand into the landing buffer: chunk e = gtid + 128 j is row e /
// kC, chunk e % kC, so a warp reads whole rows (coalesced). The split
// reads the chunks column-wise (a warp: one chunk of 32 rows), after the
// producer's barrier.
template <bool kF32>
__device__ __forceinline__ void land_rows(char* land, const char* src,
                                          long long sr_bytes, int row0, int n,
                                          int gtid) {
  constexpr int kC = kF32 ? 16 : 8;
#pragma unroll
  for (int j = 0; j < kBS * kC / kGT; ++j) {
    const int e = gtid + j * kGT, r = e / kC, c = e % kC;
    const bool live = row0 + r < n;
    cp_async16(smem_u32(land + off_raw<kF32>(r, c)),
               src + (live ? (row0 + r) * sr_bytes + 16 * c : 0), live);
  }
}
// The producer's split of landed chunks of a streamed float32 operand (chunk
// e = gtid + 128 j is row e % 32, chunk e / 32, so that a warp writes one
// head dim of 32 rows of a transposed tile, a 128-byte row):
// TF32 hi/lo row tiles (rows != nullptr), bf16 hi/lo row tiles
// (rows16 != nullptr), TF32 hi/lo transposed tiles (tr != nullptr).
__device__ __forceinline__ void split_rows(const char* land, char* rows,
                                           char* rows16, char* tr, int gtid) {
#pragma unroll
  for (int j = 0; j < kBS * 16 / kGT; ++j) {
    const int e = gtid + j * kGT, r = e % kBS, c = e / kBS;
    const float4 x = *reinterpret_cast<const float4*>(land + off_raw<true>(r, c));
    if (rows != nullptr || tr != nullptr) {
      uint4 h, l;
      split_tf32(x.x, h.x, l.x);
      split_tf32(x.y, h.y, l.y);
      split_tf32(x.z, h.z, l.z);
      split_tf32(x.w, h.w, l.w);
      if (rows != nullptr) {
        *reinterpret_cast<uint4*>(rows + off_f32(kBS, r, c)) = h;
        *reinterpret_cast<uint4*>(rows + kBS * kD * 4 + off_f32(kBS, r, c)) = l;
      }
      if (tr != nullptr) {
        const int pos = perm8(r);
        const uint32_t hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          *reinterpret_cast<uint32_t*>(tr + off_t(4 * c + i, pos)) = hs[i];
          *reinterpret_cast<uint32_t*>(tr + kD * kBS * 4 + off_t(4 * c + i, pos)) = ls[i];
        }
      }
    }
    if (rows16 != nullptr) {
      uint2 h, l;
      split_bf16(x.x, x.y, h.x, l.x);
      split_bf16(x.z, x.w, h.y, l.y);
      *reinterpret_cast<uint2*>(rows16 + off_b16_half(r, c)) = h;
      *reinterpret_cast<uint2*>(rows16 + kBS * kD * 2 + off_b16_half(r, c)) = l;
    }
  }
}
// ... and of a streamed bf16 operand: copied as it is.
__device__ __forceinline__ void copy_rows16(const char* land, char* rows,
                                            int gtid) {
#pragma unroll
  for (int j = 0; j < kBS * 8 / kGT; ++j) {
    const int e = gtid + j * kGT, r = e % kBS, c = e / kBS;
    *reinterpret_cast<uint4*>(rows + off_b16(r, c)) =
        *reinterpret_cast<const uint4*>(land + off_raw<false>(r, c));
  }
}

// ---- products ---------------------------------------------------------------

// One step of acc (64 fixed x 32 streamed) += X Y^T over the head dim (8
// dims for TF32, three passes; 16 for bf16), X the fixed row tile (A), Y
// the streamed row tile (B). The passes are named by the query role's
// operands (X = q or g, Y = k or v); with kSwap (the key role: X = k or v,
// Y = q or g) the mixed TF32 passes run in the mirrored order, so that
// each element is the same sum of the same products.
template <bool kXF32, bool kYF32, bool kSwap>
__device__ __forceinline__ void rows_step(float (&acc)[4][4], uint32_t X,
                                          uint32_t Y, int st) {
  if constexpr (kXF32 && kYF32) {   // three TF32 passes
    const uint32_t Xl = X + kBF * kD * 4, Yl = Y + kBS * kD * 4;
    const uint32_t xo = (st >> 2) * (kBF * 128) + (st & 3) * 32;
    const uint32_t yo = (st >> 2) * (kBS * 128) + (st & 3) * 32;
    if constexpr (kSwap) {   // (x_hi, y_lo) mirrors (y_lo, x_hi)
      wgmma_tf32_ss_n32(acc, sw128_desc(X + xo), sw128_desc(Yl + yo));
      wgmma_tf32_ss_n32(acc, sw128_desc(Xl + xo), sw128_desc(Y + yo));
    } else {
      wgmma_tf32_ss_n32(acc, sw128_desc(Xl + xo), sw128_desc(Y + yo));
      wgmma_tf32_ss_n32(acc, sw128_desc(X + xo), sw128_desc(Yl + yo));
    }
    wgmma_tf32_ss_n32(acc, sw128_desc(X + xo), sw128_desc(Y + yo));
  } else if constexpr (!kXF32 && !kYF32) {   // one exact bf16 pass
    wgmma_bf16_ss_n32(acc, sw128_desc(X + st * 32), sw128_desc(Y + st * 32));
  } else if constexpr (kXF32) {   // X (the query role's g) in bf16 hi, lo
    const uint32_t Xl = X + kBF * kD * 2;
    wgmma_bf16_ss_n32(acc, sw128_desc(Xl + st * 32), sw128_desc(Y + st * 32));
    wgmma_bf16_ss_n32(acc, sw128_desc(X + st * 32), sw128_desc(Y + st * 32));
  } else {   // Y (the key role's g) in bf16 hi, lo
    const uint32_t Yl = Y + kBS * kD * 2;
    wgmma_bf16_ss_n32(acc, sw128_desc(X + st * 32), sw128_desc(Yl + st * 32));
    wgmma_bf16_ss_n32(acc, sw128_desc(X + st * 32), sw128_desc(Y + st * 32));
  }
}

// S (or S^T) into sc and dP (or dP^T) into dp: the steps of the head dim
// in order, S's first.
template <bool kQKF32, bool kVF32, bool kSwap>
__device__ __forceinline__ void scores(float (&sc)[4][4], float (&dp)[4][4],
                                       uint32_t Xs, uint32_t Ys, uint32_t Xp,
                                       uint32_t Yp) {
  constexpr bool kPX = kSwap ? kVF32 : true, kPY = kSwap ? true : kVF32;
  constexpr int nS = kQKF32 ? 8 : 4, nP = kPX && kPY ? 8 : 4;
#pragma unroll
  for (int i = 0; i < nS; ++i) rows_step<kQKF32, kQKF32, kSwap>(sc, Xs, Ys, i);
#pragma unroll
  for (int j = 0; j < nP; ++j) rows_step<kPX, kPY, kSwap>(dp, Xp, Yp, j);
}

// The A fragments of acc (64 x 64 head dims) += A . Y over the 32 streamed
// rows, A the accumulator c of S^T / S after P or dS (64 x 32 in
// registers): TF32 hi / lo for a transposed TF32 tile Y (slot t: column
// 2t, slot t + 4: column 2t + 1 of each 8-column step), bf16 hi / lo for a
// bf16 row tile read through the transpose flag.
__device__ __forceinline__ void frags_tf32(const float (&c)[4][4],
                                           uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    split_tf32(c[s][0], ah[s][0], al[s][0]);
    split_tf32(c[s][2], ah[s][1], al[s][1]);
    split_tf32(c[s][1], ah[s][2], al[s][2]);
    split_tf32(c[s][3], ah[s][3], al[s][3]);
  }
}
__device__ __forceinline__ void frags_bf16(const float (&c)[4][4],
                                           uint32_t (&ah)[2][4],
                                           uint32_t (&al)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    split_bf16(c[2 * kk][0], c[2 * kk][1], ah[kk][0], al[kk][0]);
    split_bf16(c[2 * kk][2], c[2 * kk][3], ah[kk][1], al[kk][1]);
    split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], ah[kk][2], al[kk][2]);
    split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], ah[kk][3], al[kk][3]);
  }
}
// step s of the 8-row steps (TF32, three passes) or of the 16-row steps
// (bf16, two passes; rows 16 s.., 2048 bytes apart)
template <bool kYF32>
__device__ __forceinline__ void grad_step(float (&acc)[8][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], uint32_t Y,
                                          int s) {
  if constexpr (kYF32) {
    const uint32_t Yl = Y + kD * kBS * 4;
    wgmma_tf32_rs(acc, al, sw128_desc(Y + s * 32));
    wgmma_tf32_rs(acc, ah, sw128_desc(Yl + s * 32));
    wgmma_tf32_rs(acc, ah, sw128_desc(Y + s * 32));
  } else {
    wgmma_bf16_rs(acc, al, sw128_desc(Y + s * 2048));
    wgmma_bf16_rs(acc, ah, sw128_desc(Y + s * 2048));
  }
}
// a gradient's A fragments: 4 TF32 steps or 2 bf16 steps
template <bool kYF32>
struct Frags {
  static constexpr int kS = kYF32 ? 4 : 2;
  uint32_t h[kS][4], l[kS][4];
};
template <bool kYF32>
__device__ __forceinline__ void make_frags(const float (&c)[4][4],
                                           Frags<kYF32>& f) {
  if constexpr (kYF32) frags_tf32(c, f.h, f.l);
  else frags_bf16(c, f.h, f.l);
}
template <bool kYF32>
__device__ __forceinline__ void fence_frags(Frags<kYF32>& f) {
  fence_regs(f.h);
  fence_regs(f.l);
}
// acc (64 x 64 head dims) += c . Y, issued and waited for
template <bool kYF32>
__device__ __forceinline__ void grad(float (&acc)[8][4],
                                     const float (&c)[4][4], uint32_t Y) {
  Frags<kYF32> f;
  make_frags(c, f);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < Frags<kYF32>::kS; ++s) grad_step<kYF32>(acc, f.h[s], f.l[s], Y, s);
  wgmma_commit();
  wgmma_wait_all();
  fence_frags(f);
  fence_acc(acc);
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

// The maximum (kMax) or the sum of row h's 8 values in this thread's
// fragments, then over the quad that shares the row: a fixed order, and
// the same bits in the quad's four threads.
template <bool kMax>
__device__ __forceinline__ float quad_reduce(const float (&x)[4][4], int h) {
  float a[4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
    a[n] = kMax ? fmaxf(x[n][2 * h], x[n][2 * h + 1])
                : x[n][2 * h] + x[n][2 * h + 1];
#pragma unroll
  for (int w = 2; w >= 1; w /= 2)
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

// ---- the key role: (bh, 128 keys), loop over the query tiles -------------

template <bool kQKF32, bool kVF32>
__device__ void key_block(const Params& p, char* smem, int tile, int bh) {
  using C = Cfg<kQKF32, kVF32>;
  constexpr int kL = C::kLand, kS = C::kStages;
  // the warpgroup's index, made warp-uniform for the compiler (else it
  // takes every branch on it as divergent and serializes the wgmmas)
  const int tid = threadIdx.x, gtid = tid % kGT;
  const int wg = __shfl_sync(0xffffffffu, tid / kGT, 0);
  const int n_qt = (p.Nq + kBS - 1) / kBS;
  auto stage = [&](int s) { return smem + C::kKeyStage0 + s * C::kKeyStage; };
  const uint32_t bars = smem_u32(smem + C::kBars);
  uint32_t* live = reinterpret_cast<uint32_t*>(smem + C::kLive);
  const char* qb = static_cast<const char*>(p.q) + bh * p.q_sh * C::kQKEl;
  const char* kb = static_cast<const char*>(p.k) + bh * p.k_sh * C::kQKEl;
  const char* vb = static_cast<const char*>(p.v) + bh * p.v_sh * C::kVEl;
  const char* gb = reinterpret_cast<const char*>(p.g + bh * p.g_sh);
  const long long q_rb = p.q_sr * C::kQKEl, k_rb = p.k_sr * C::kQKEl,
                  v_rb = p.v_sr * C::kVEl, g_rb = p.g_sr * 4;
  const int key0 = tile * kRows;

  // prologue: each group's fixed K and V rows, split, and the block's live
  // keys
  {
    const auto fk0 = fetch_fixed<kQKF32 ? 16 : 8>(kb, k_rb, key0, p.Nk, tid);
    const auto fk1 =
        fetch_fixed<kQKF32 ? 16 : 8>(kb, k_rb, key0 + kBF, p.Nk, tid);
    const auto fv0 = fetch_fixed<kVF32 ? 16 : 8>(vb, v_rb, key0, p.Nk, tid);
    const auto fv1 =
        fetch_fixed<kVF32 ? 16 : 8>(vb, v_rb, key0 + kBF, p.Nk, tid);
    if (tid < kRows) {
      const int j = key0 + tid;
      const unsigned bits =
          __ballot_sync(0xffffffffu, j < p.Nk && p.mask[bh * p.m_sh + j]);
      if (tid % 32 == 0) live[tid / 32] = bits;
    }
    put_fixed<kQKF32>(smem, fk0, tid);
    put_fixed<kQKF32>(smem + C::kKeyFixK, fk1, tid);
    put_fixed<kVF32>(smem + C::kKeyV0, fv0, tid);
    put_fixed<kVF32>(smem + C::kKeyV0 + C::kKeyFixV, fv1, tid);
  }
  fence_async_smem();
  __syncthreads();
  if (p.cluster) cluster_arrive();

  if (wg == 0) {
    // ---- producer: q and g of each query tile, kL tiles in flight
    auto land = [&](int it) {
      return smem + C::kKeyLand0 + (it % kL) * C::kKeyLand;
    };
    auto issue = [&](int it) {   // one cp.async group per call
      if (it < n_qt) {
        land_rows<kQKF32>(land(it), qb, q_rb, it * kBS, p.Nq, gtid);
        land_rows<true>(land(it) + C::kKeyLandG, gb, g_rb, it * kBS, p.Nq,
                        gtid);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < kL; ++j) issue(j);
    // The query rows' statistics come from pass 1 (the previous launch, or
    // the cluster's query blocks): threads 0..31 load query it * 32 +
    // gtid's (m, 1/l, D, any key live; zero past Nq) as the tile's split
    // begins and store it as it ends (a barrier or release between would
    // wait for the load).
    if (p.pdl_wait) griddep_wait();
    if (p.cluster) cluster_wait();
    const float4* stats = reinterpret_cast<const float4*>(p.stats);
    const long long st_stride = (long long)gridDim.y * p.Nq;
    for (int it = 0; it < n_qt; ++it) {
      const int s = it % kS;
      SPAN_BEGIN(t_load)
      cp_async_wait<kL - 1>();
      producer_sync();   // tile it has landed, every thread's copies
      SPAN_END(0, 0, t_load)
      const int q = it * kBS + gtid;
      const float4 st_cur =
          gtid < kBS && q < p.Nq
              ? row_stats(stats, (long long)bh * p.Nq + q, st_stride, p.splits)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      SPAN_BEGIN(t_free)
      if (it >= kS) mbar_wait(bars + 8 * (kS + s), (it / kS - 1) & 1);
      SPAN_END(0, 1, t_free)
      SPAN_BEGIN(t_split)
      char* st = stage(s);
      const char* ld = land(it);
      if constexpr (kQKF32)
        split_rows(ld, st + C::kKeyQ, nullptr, st + C::kKeyQT, gtid);
      else
        copy_rows16(ld, st + C::kKeyQ, gtid);
      split_rows(ld + C::kKeyLandG, kVF32 ? st + C::kKeyG : nullptr,
                 kVF32 ? nullptr : st + C::kKeyG, st + C::kKeyGT, gtid);
      if (gtid < kBS) {
        reinterpret_cast<float4*>(smem + C::kRing + s * kBS * 16)[gtid] =
            st_cur;
      }
      fence_async_smem();
      mbar_arrive(bars + 8 * s);
      producer_sync();   // every thread is done with the landing buffer
      issue(it + kL);
      SPAN_END(0, 2, t_split)
    }
  } else {
    // ---- consumers: group gr holds keys key0 + 64 gr .. and takes every
    // query tile
    const int gr = wg - 1, wq = gtid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = key0 + kBF * gr;
    bool row_in[2], row_live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = kBF * gr + 16 * wq + g + 8 * h;
      row_in[h] = key0 + r < p.Nk;
      row_live[h] = (live[r / 32] >> (r % 32)) & 1u;
    }
    const float inv_nk = 1.f / (float)p.Nk;
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    const uint32_t kx = smem_u32(smem + gr * C::kKeyFixK),
                   vx = smem_u32(smem + C::kKeyV0 + gr * C::kKeyFixV);
    for (int it = 0; it < n_qt; ++it) {
      const int s = it % kS;
      SPAN_BEGIN(t_full)
      mbar_wait(bars + 8 * s, (it / kS) & 1);
      SPAN_END(0, 3, t_full)
      SPAN_BEGIN(t_scores)
      const uint32_t sa = smem_u32(stage(s));
      const float4* qs =
          reinterpret_cast<const float4*>(smem + C::kRing + s * kBS * 16);
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      wgmma_fence();
      scores<kQKF32, kVF32, true>(sc, dp, kx, sa + C::kKeyQ, vx,
                                  sa + C::kKeyG);   // S^T, dP^T
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sc);
      fence_acc(dp);
      SPAN_END(0, 4, t_scores)
      SPAN_BEGIN(t_soft)
      // P^T into sc, dS^T into dp. Element (n, e): key 16 wq + g + 8 (e >>
      // 1) of the group's rows, query column c = 8 n + 2 t + (e & 1). The
      // columns' statistics are read first, and every element takes the
      // same instructions (selects, no branches): a query past Nq has zero
      // statistics, a head with no live key P = 1/Nk.
      float cm[8], cil[8], cd[8];
      bool any_live = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = qs[8 * (j >> 1) + 2 * t + (j & 1)];   // m, 1/l, D, live
        cm[j] = x.x;
        cil[j] = x.y;
        cd[j] = x.z;
        any_live |= x.w != 0.f;   // the same for every query of the head
      }
      const int q_left = p.Nq - it * kBS - 2 * t;   // column c in if c - 2t < this
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, j = 2 * n + (e & 1);
          const bool q_in = 8 * n + (e & 1) < q_left;
          const float ex =
              ex2((__fmul_rn(sc[n][e], p.scale) - cm[j]) * kLog2e) * cil[j];
          const float pr =
              !q_in ? 0.f
                    : (any_live ? (row_live[h] ? ex : 0.f)
                                : (row_in[h] ? inv_nk : 0.f));
          sc[n][e] = pr;
          dp[n][e] = any_live ? pr * (dp[n][e] - cd[j]) : 0.f;
        }
      SPAN_END(0, 5, t_soft)
      SPAN_BEGIN(t_grad)
      // dV += P^T g, then dK += dS^T q (one set of A fragments live)
      if (p.dv != nullptr) grad<true>(dv, sc, sa + C::kKeyGT);
      if (p.dk != nullptr)
        grad<kQKF32>(dk, dp, sa + (kQKF32 ? C::kKeyQT : C::kKeyQ));
      SPAN_END(0, 6, t_grad)
      mbar_arrive(bars + 8 * (kS + s));   // this group is done with the stage
    }
    if (p.dk != nullptr)
      store_rows<kQKF32>(p.dk, p.Nk, row0, bh, dk, p.scale, wq, g, t);
    if (p.dv != nullptr)
      store_rows<kVF32>(p.dv, p.Nk, row0, bh, dv, 1.f, wq, g, t);
    if (p.cluster) cluster_wait();   // (the producer waited before stats)
  }
}

// ---- the query role: (bh, 128 queries), loop over the key tiles ----------

template <bool kQKF32, bool kVF32>
__device__ void query_block(const Params& p, char* smem, int tile, int half,
                            int bh) {
  using C = Cfg<kQKF32, kVF32>;
  constexpr int kL = C::kLand, kS = C::kStages;
  const int tid = threadIdx.x, gtid = tid % kGT;
  const int wg = __shfl_sync(0xffffffffu, tid / kGT, 0);   // (as key_block)
  // pass 1 over this block's key range (the half of the key tiles `half`
  // where pass 1 is split), pass 2 over every key tile
  const int n_kt = (p.Nk + kBS - 1) / kBS;
  const int per = (n_kt + p.splits - 1) / p.splits, kt1 = half * per;
  const int n1 = p.pass1 ? min(per, n_kt - kt1) : 0;
  const int n_tot = n1 + (p.pass2 ? n_kt : 0);
  float4* rstat = reinterpret_cast<float4*>(smem + C::kQFixStat);
  auto stage = [&](int s) { return smem + C::kQStage0 + s * C::kQStage; };
  const uint32_t bars = smem_u32(smem + C::kBars);
  const char* qb = static_cast<const char*>(p.q) + bh * p.q_sh * C::kQKEl;
  const char* kb = static_cast<const char*>(p.k) + bh * p.k_sh * C::kQKEl;
  const char* vb = static_cast<const char*>(p.v) + bh * p.v_sh * C::kVEl;
  const char* gb = reinterpret_cast<const char*>(p.g + bh * p.g_sh);
  const long long q_rb = p.q_sr * C::kQKEl, k_rb = p.k_sr * C::kQKEl,
                  v_rb = p.v_sr * C::kVEl, g_rb = p.g_sr * 4;
  const int row0 = tile * kRows;

  // prologue: each group's fixed q and g rows, split; pass 2 alone reads
  // the rows' statistics from the first launch
  {
    const auto fq0 = fetch_fixed<kQKF32 ? 16 : 8>(qb, q_rb, row0, p.Nq, tid);
    const auto fq1 =
        fetch_fixed<kQKF32 ? 16 : 8>(qb, q_rb, row0 + kBF, p.Nq, tid);
    const auto fg0 = fetch_fixed<16>(gb, g_rb, row0, p.Nq, tid);
    const auto fg1 = fetch_fixed<16>(gb, g_rb, row0 + kBF, p.Nq, tid);
    put_fixed<kQKF32>(smem, fq0, tid);
    put_fixed<kQKF32>(smem + C::kQFixQ, fq1, tid);
    char* g0 = smem + C::kQG0;
    if constexpr (kVF32) {
      put_tf32(g0, fg0, tid);
      put_tf32(g0 + C::kQFixG, fg1, tid);
    } else {
      put_bf16_split(g0, fg0, tid);
      put_bf16_split(g0 + C::kQFixG, fg1, tid);
    }
  }
  if (!p.pass1) {
    if (p.pdl_wait) griddep_wait();
    if (tid < kRows)
      rstat[tid] = row0 + tid < p.Nq
                       ? row_stats(reinterpret_cast<const float4*>(p.stats),
                                   (long long)bh * p.Nq + row0 + tid,
                                   (long long)gridDim.y * p.Nq, p.splits)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  fence_async_smem();
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V of each key tile (pass 1, then pass 2), kL
    // tiles in flight
    if (p.cluster) cluster_arrive();
    auto land = [&](int it) {
      return smem + C::kQLand0 + (it % kL) * C::kQLand;
    };
    auto issue = [&](int it) {   // one cp.async group per call
      if (it < n_tot) {
        const int k0 = (it >= n1 ? it - n1 : kt1 + it) * kBS;
        land_rows<kQKF32>(land(it), kb, k_rb, k0, p.Nk, gtid);
        land_rows<kVF32>(land(it) + C::kQLandV, vb, v_rb, k0, p.Nk, gtid);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < kL; ++j) issue(j);
    // lanes of warp 0 load key (tile it) * 32 + lane's mask byte as the
    // tile's split begins, and write the tile's live-key word as it ends
    const unsigned char* mb = p.mask + bh * p.m_sh;
    for (int it = 0; it < n_tot; ++it) {
      const int s = it % kS;
      SPAN_BEGIN(t_load)
      cp_async_wait<kL - 1>();
      producer_sync();   // tile it has landed, every thread's copies
      SPAN_END(1, 0, t_load)
      const int key = (it >= n1 ? it - n1 : kt1 + it) * kBS + gtid;
      const unsigned char m_cur =
          gtid < 32 && key < p.Nk ? mb[key] : (unsigned char)0;
      SPAN_BEGIN(t_free)
      if (it >= kS) mbar_wait(bars + 8 * (kS + s), (it / kS - 1) & 1);
      SPAN_END(1, 1, t_free)
      SPAN_BEGIN(t_split)
      char* st = stage(s);
      const char* ld = land(it);
      if constexpr (kQKF32)
        split_rows(ld, st + C::kQK, nullptr, it >= n1 ? st + C::kQKT : nullptr,
                   gtid);
      else
        copy_rows16(ld, st + C::kQK, gtid);
      if constexpr (kVF32)
        split_rows(ld + C::kQLandV, st + C::kQV, nullptr, nullptr, gtid);
      else
        copy_rows16(ld + C::kQLandV, st + C::kQV, gtid);
      if (gtid < 32) {
        const unsigned bits = __ballot_sync(0xffffffffu, m_cur != 0);
        if (gtid == 0)
          *reinterpret_cast<uint32_t*>(smem + C::kRing + s * kBS * 16) = bits;
      }
      fence_async_smem();
      mbar_arrive(bars + 8 * s);
      producer_sync();   // every thread is done with the landing buffer
      issue(it + kL);
      SPAN_END(1, 2, t_split)
    }
    if (p.cluster) cluster_wait();
  } else {
    // ---- consumers: group gr holds queries row0 + 64 gr .. and takes
    // every key tile, pass 1's then pass 2's
    const int gr = wg - 1, wq = gtid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int lr0 = kBF * gr + 16 * wq + g;   // this thread's rows: lr0, +8
    bool row_in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) row_in[h] = row0 + lr0 + 8 * h < p.Nq;
    const float inv_nk = 1.f / (float)p.Nk;
    // Sums over long loops in two levels, so that float32 rounding grows
    // with kChunk + tiles / kChunk and not with the tiles: the tiles add
    // into a chunk sum, flushed into the total every kChunk tiles.
    constexpr int kChunk = 16;
    // pass 1: running max; totals and chunk sums of exp and of exp dP (the
    // same in the four threads of a quad, which share the rows)
    float run_m[2] = {-INFINITY, -INFINITY}, tot_l[2] = {0.f, 0.f},
          tot_u[2] = {0.f, 0.f}, ch_l[2] = {0.f, 0.f}, ch_u[2] = {0.f, 0.f};
    // pass 2: the rows' m, 1/l, D and whether the head has a live key
    float rm[2] = {0.f, 0.f}, ril[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
    bool rlive[2] = {false, false};
    auto set_stats = [&](int h, float4 x) {
      rm[h] = x.x;
      ril[h] = x.y;
      rd[h] = x.z;
      rlive[h] = x.w != 0.f;
    };
    // the end of pass 1: the rows' partial record (m, l, u, live) over
    // this block's key range, where asked to the output, and with one
    // range the rows' statistics for pass 2 (row_stats of the record)
    auto finish_stats = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 rec = make_float4(run_m[h], tot_l[h] + ch_l[h],
                                       tot_u[h] + ch_u[h],
                                       run_m[h] != -INFINITY ? 1.f : 0.f);
        set_stats(h, row_stats(&rec, 0, 0, 1));
        if (p.stats_out && t == 0 && row_in[h])
          reinterpret_cast<float4*>(p.stats)
              [((long long)half * gridDim.y + bh) * p.Nq + row0 + lr0 +
               8 * h] = rec;
      }
      if (p.stats_out && t == 0) __threadfence();
      if (p.cluster) cluster_arrive();   // the statistics are out
    };
    if (!p.pass1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) set_stats(h, rstat[lr0 + 8 * h]);
    }

    float dq[8][4], dq_c[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = dq_c[n][e] = 0.f;
    const uint32_t qx = smem_u32(smem + gr * C::kQFixQ),
                   gx = smem_u32(smem + C::kQG0 + gr * C::kQFixG);
    for (int it = 0; it < n_tot; ++it) {
      const bool second = it >= n1;
      if (it == n1 && n1 > 0) finish_stats();
      const int s = it % kS, kt = second ? it - n1 : kt1 + it, k0 = kt * kBS;
      SPAN_BEGIN(t_full)
      mbar_wait(bars + 8 * s, (it / kS) & 1);
      SPAN_END(1, 3, t_full)
      SPAN_BEGIN(t_scores)
      const uint32_t sa = smem_u32(stage(s));
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      wgmma_fence();
      scores<kQKF32, kVF32, false>(sc, dp, qx, sa + C::kQK, gx,
                                   sa + C::kQV);   // S, dP
      wgmma_commit();
      wgmma_wait_all();
      // the tile's live keys (bit c: key k0 + c; 0 past Nk), shifted so that
      // bit 2 n + j is this thread's key 8 n + 2 t + j
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
                             smem + C::kRing + s * kBS * 16) >>
                         (2 * t);
      uint32_t kl = 0u;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        kl |= ((w >> (8 * n)) & 3u) << (2 * n);
      fence_acc(sc);
      fence_acc(dp);
      SPAN_END(1, 4, t_scores)
      SPAN_BEGIN(t_soft)
      // Element (n, e): row lr0 + 8 (e >> 1), key 8 n + 2 t + (e & 1) of
      // the tile.
      if (!second) {
        // online (max, sum, sum of exp dP) over the live keys
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] = (kl >> (2 * n + (e & 1))) & 1u
                           ? __fmul_rn(sc[n][e], p.scale)
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
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              sc[n][e] = ex2((sc[n][e] - m_use) * kLog2e);
              dp[n][e] *= sc[n][e];
            }
          tot_l[h] *= corr;
          tot_u[h] *= corr;
          ch_l[h] = ch_l[h] * corr + quad_reduce<false>(sc, h);
          ch_u[h] = ch_u[h] * corr + quad_reduce<false>(dp, h);
        }
        if ((it + 1) % kChunk == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            tot_l[h] += ch_l[h];
            tot_u[h] += ch_u[h];
            ch_l[h] = ch_u[h] = 0.f;
          }
        }
      } else {
        // P into sc, dS into dp (every element the same instructions:
        // selects, no branches); dQ += dS k
        const int k_left = p.Nk - k0 - 2 * t;   // key c in if c - 2t < this
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const bool live = (kl >> (2 * n + (e & 1))) & 1u;
            const float ex =
                ex2((__fmul_rn(sc[n][e], p.scale) - rm[h]) * kLog2e) * ril[h];
            const float pr =
                !row_in[h] ? 0.f
                           : (rlive[h] ? (live ? ex : 0.f)
                                       : (8 * n + (e & 1) < k_left ? inv_nk
                                                                    : 0.f));
            sc[n][e] = pr;
            dp[n][e] = rlive[h] ? pr * (dp[n][e] - rd[h]) : 0.f;
          }
        SPAN_END(1, 5, t_soft)
        SPAN_BEGIN(t_grad)
        grad<kQKF32>(dq_c, dp, sa + (kQKF32 ? C::kQKT : C::kQK));   // dS k
        SPAN_END(1, 6, t_grad)
        if ((it - n1 + 1) % kChunk == 0) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dq[n][e] += dq_c[n][e];
              dq_c[n][e] = 0.f;
            }
        }
      }
      if (!second) {
        SPAN_END(1, 5, t_soft)   // pass 1's softmax is its statistics
      }
      mbar_arrive(bars + 8 * (kS + s));   // this group is done with the stage
    }
    if (p.pass1 && n_tot == n1) finish_stats();   // (an empty range too)
    if (p.pass2) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] += dq_c[n][e];
      store_rows<kQKF32>(p.dq, p.Nq, row0 + kBF * gr, bh, dq, p.scale, wq, g,
                         t);
    }
    if (p.cluster) cluster_wait();
  }
}

template <bool kQKF32, bool kVF32>
__global__ void __launch_bounds__(kThreads, 1)
masked_attention_bwd_kernel(const Params p) {
  extern __shared__ __align__(1024) char smem[];
  using C = Cfg<kQKF32, kVF32>;
  // a launch that follows this one (pass 2) may start its prologue now
  griddep_launch_dependents();
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(smem + C::kBars);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + 8 * s, kGT);   // full: the producer's threads
      mbar_init(bars + 8 * (C::kStages + s), kGroups * kGT);   // empty
    }
  }
  // (the roles' prologues end in __syncthreads, which orders the inits)
  const int bh = blockIdx.y;
  if ((int)blockIdx.x < p.key_blocks)
    key_block<kQKF32, kVF32>(p, smem, blockIdx.x, bh);
  else {   // pass 1 split over key ranges: `splits` blocks a query tile
    const int sp = p.pass1 ? p.splits : 1, b = blockIdx.x - p.key_blocks;
    query_block<kQKF32, kVF32>(p, smem, b / sp, b % sp, bh);
  }
}

template <bool kQKF32, bool kVF32>
int launch(const Params& p, int blocks, int BH, int cluster, bool pdl,
           cudaStream_t stream) {
  using C = Cfg<kQKF32, kVF32>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        masked_attention_bwd_kernel<kQKF32, kVF32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, BH, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  } else if (pdl) {
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.numAttrs = 1;
  }
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, masked_attention_bwd_kernel<kQKF32, kVF32>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Device kernels a call takes (1 or 2), and the launches themselves.
// One launch where a head's key and query blocks fit one cluster, else two
// (whatever is wanted: a call without dk or dv takes the same statistics
// as one with them, so its dq is the same bits).
int plan(const Params& p0, int* single) {
  const int n_qt = (p0.Nq + kRows - 1) / kRows,
            n_kt = (p0.Nk + kRows - 1) / kRows;
  *single = n_kt + n_qt <= kMaxCluster;
  return *single ? 1 : 2;
}

template <bool kQKF32, bool kVF32>
int launch_call(Params p, int BH, cudaStream_t stream) {
  const int n_qt = (p.Nq + kRows - 1) / kRows,
            n_kt = (p.Nk + kRows - 1) / kRows;
  const bool kv = p.dk != nullptr || p.dv != nullptr;
  int single;
  plan(p, &single);
  if (single) {   // one launch: pass 1 and pass 2 in each query block
    p.key_blocks = kv ? n_kt : 0;
    p.pass1 = 1;
    p.pass2 = p.dq != nullptr;
    p.stats_out = kv;
    p.splits = 1;
    p.cluster = kv;
    p.pdl_wait = 0;
    const int blocks = p.key_blocks + n_qt;
    return launch<kQKF32, kVF32>(p, blocks, BH, kv ? blocks : 1, false,
                                 stream);
  }
  // launch 1: pass 1 alone, each query block over half the key tiles (two
  // blocks a query tile fill the card where one a tile would leave half
  // the SMs idle)
  p.key_blocks = 0;
  p.pass1 = 1;
  p.pass2 = 0;
  p.stats_out = 1;
  p.splits = 2;
  p.cluster = 0;
  p.pdl_wait = 0;
  const int err = launch<kQKF32, kVF32>(p, 2 * n_qt, BH, 1, false, stream);
  if (err != 0) return err;
  p.key_blocks = kv ? n_kt : 0;   // launch 2: the key blocks and pass 2
  p.pass1 = 0;
  p.pass2 = p.dq != nullptr;
  p.stats_out = 0;
  p.pdl_wait = 1;
  return launch<kQKF32, kVF32>(p, p.key_blocks + (p.pass2 ? n_qt : 0), BH, 1,
                               true, stream);
}

}  // namespace

// Plain C entry point for ctypes. Strides are in elements; qk_bf16 and
// v_bf16 pick the variant (q and k share a type). g is float32; stats is
// float32 scratch of 2 * BH * Nq * 4 (16-byte aligned); dq, dk, dv are
// contiguous outputs in q's, k's and v's types, each may be null (not
// computed). Launches one or two kernels on `stream` (see
// masked_attention_bwd_kernels), allocates nothing, and returns a CUDA
// error code (0 = launched).
extern "C" int masked_attention_bwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* g, void* stats, void* dq, void* dk, void* dv, int BH, int Nq,
    int Nk, long long q_sh, long long q_sr, long long k_sh, long long k_sr,
    long long v_sh, long long v_sr, long long g_sh, long long g_sr,
    long long m_sh, int qk_bf16, int v_bf16, float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || Nq <= 0 || Nk <= 0 || Nk > kMaxKeys ||
      (dq == nullptr && dk == nullptr && dv == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    static_cast<const unsigned char*>(mask),
           static_cast<const float*>(g), static_cast<float*>(stats),
           dq,   dk,   dv,   q_sh, q_sr, k_sh, k_sr, v_sh, v_sr, g_sh, g_sr,
           m_sh, Nq,   Nk,   0,    0,    0,    0,    1,    0,    0,    scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!qk_bf16 && v_bf16) return launch_call<true, false>(p, BH, s);
  if (qk_bf16 && v_bf16) return launch_call<false, false>(p, BH, s);
  if (!qk_bf16 && !v_bf16) return launch_call<true, true>(p, BH, s);
  return (int)cudaErrorInvalidValue;
}

// The device kernels one call takes: 1 where a head's key and query blocks
// fit one cluster, else 2.
extern "C" int masked_attention_bwd_kernels(int Nq, int Nk) {
  Params p{};
  p.Nq = Nq;
  p.Nk = Nk;
  int single;
  return plan(p, &single);
}

// The largest Nk a call takes (the same for every variant; shared memory
// does not grow with Nk).
extern "C" int masked_attention_bwd_max_keys(int qk_bf16, int v_bf16) {
  (void)qk_bf16;
  (void)v_bf16;
  return kMaxKeys;
}

#ifdef MAB_SPANS
// Copies the spans out (8 per role) and zeroes them.
extern "C" int masked_attention_bwd_spans(unsigned long long* out) {
  unsigned long long zero[16] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_spans, zero, sizeof(zero));
  return (int)e;
}
#endif
