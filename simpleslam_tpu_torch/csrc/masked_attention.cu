// Key-masked attention forward for the LightGlue matcher, by hand for Hopper.
//
// Replaces the TPU kernel simpleslam_tpu/ops/pallas/attention.py::_attn_kernel
// (called through pallas_masked_attention). Same function:
//     out = softmax(q k^T / sqrt(d) + (1 - m) * (-1e9)) v
// with the softmax's denominator clamped at 1e-30, so a row whose keys are
// all masked stays finite. q (BH, Nq, 64), k/v (BH, Nk, 64), mask (BH, Nk)
// of bytes (nonzero = live key), out (BH, Nq, 64); all float32, contiguous.
// The wrapper (ops/attention.py) upcasts bf16 q/k/v to float32 before the
// launch: the kernel has one input type.
//
// Design. The TPU kernel keeps a whole K/V panel in VMEM and takes an exact
// softmax over the full key axis; a (256 x N) score tile next to the panel
// does not fit in a Hopper SM's 227 KB of shared memory. Here one block
// owns (one bh, a tile of 64 queries) and streams K/V through shared memory
// in tiles of 64 keys with an online softmax in float32: a running max, a
// running sum and a 64-wide accumulator per query row. Four threads share a
// query row, each holding 16 of its 64 dims (dims lane, lane+4, ...), so
// the reads of a K/V row hit four distinct banks and are broadcast across
// the eight rows of a warp; two xor-shuffles finish each dot product.
// Ragged Nq and Nk are masked here: keys past Nk add nothing, rows past Nq
// are not written.
//
// Bound on an H100 SXM at Nq = Nk = 2048, BH = 4: 4 Nq Nk d BH = 4.3 GFLOP,
// against ~8 MB of input and output (2.5 us at 3.35 TB/s), so it is bound by
// operations. This simple kernel does its products on the float32 CUDA cores
// (67 TFLOP/s peak, ~64 us for the call); bf16 tensor cores (wgmma, 989
// TFLOP/s, ~4.3 us) and TMA loads are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 64;                 // head dim (checked by the wrapper)
constexpr int kBQ = 64;                // queries per block
constexpr int kBK = 64;                // keys per shared-memory tile
constexpr int kLanes = 4;              // threads per query row
constexpr int kDPL = kD / kLanes;      // dims per thread
constexpr float kNeg = -1e9f;

__global__ void __launch_bounds__(kBQ * kLanes)
masked_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const unsigned char* __restrict__ mask,
                        float* __restrict__ out, int Nq, int Nk, float scale) {
  __shared__ __align__(16) float ks[kBK][kD];
  __shared__ __align__(16) float vs[kBK][kD];
  __shared__ float bias[kBK];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int qi = blockIdx.x * kBQ + row;
  const bool live_row = qi < Nq;

  const float* qb = q + (size_t)bh * Nq * kD;
  const float* kb = k + (size_t)bh * Nk * kD;
  const float* vb = v + (size_t)bh * Nk * kD;
  const unsigned char* mb = mask + (size_t)bh * Nk;

  float qr[kDPL], acc[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    qr[i] = live_row ? qb[(size_t)qi * kD + lane + kLanes * i] : 0.f;
    acc[i] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int j0 = 0; j0 < Nk; j0 += kBK) {
    __syncthreads();   // the previous tile is no longer read
    for (int e = tid; e < kBK * kD / 4; e += blockDim.x) {
      const int r = e / (kD / 4), c4 = e % (kD / 4);
      const int j = j0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < Nk) {
        kv = reinterpret_cast<const float4*>(kb + (size_t)j * kD)[c4];
        vv = reinterpret_cast<const float4*>(vb + (size_t)j * kD)[c4];
      }
      reinterpret_cast<float4*>(&ks[r][0])[c4] = kv;
      reinterpret_cast<float4*>(&vs[r][0])[c4] = vv;
    }
    for (int r = tid; r < kBK; r += blockDim.x) {
      const int j = j0 + r;
      bias[r] = j < Nk ? (1.f - (mb[j] ? 1.f : 0.f)) * kNeg : -INFINITY;
    }
    __syncthreads();

    float s[kBK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDPL; ++i)
        part = fmaf(qr[i], ks[j][lane + kLanes * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = part * scale + bias[j];
      tmax = fmaxf(tmax, s[j]);
    }
    // every tile holds at least one key j < Nk, so m_new is finite
    const float m_new = fmaxf(m_run, tmax);
    const float corr = expf(m_run - m_new);
    l_run *= corr;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      l_run += p;
#pragma unroll
      for (int i = 0; i < kDPL; ++i)
        acc[i] = fmaf(p, vs[j][lane + kLanes * i], acc[i]);
    }
    m_run = m_new;
  }

  if (live_row) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    float* ob = out + ((size_t)bh * Nq + qi) * kD;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) ob[lane + kLanes * i] = acc[i] * inv;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, allocates nothing,
// and returns cudaGetLastError() (0 = launched).
extern "C" int masked_attention_f32(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int BH, int Nq, int Nk,
                                    float scale, void* stream) {
  if (BH <= 0 || Nq <= 0 || Nk <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((Nq + kBQ - 1) / kBQ, BH);
  const dim3 block(kBQ * kLanes);
  masked_attention_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const unsigned char*>(mask),
      static_cast<float*>(out), Nq, Nk, scale);
  return (int)cudaGetLastError();
}
