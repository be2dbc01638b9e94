// One-token GQA decode attention straight from a posit8 KV cache, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode_pallas (the
// TPU kernel of every quantized-KV decode step).
//
// q (B, Kh, G, Dh) f32 attends to the cache slots [pad[b], pos] of
// k/v codes (B, T, Kh, Dh) uint8 with po2 scales (B, T, Kh, Gs) bf16
// (Gs = Dh / group; Gs == 1 is one scale per token and head).  The output
// is (B, Kh, G, Dh) f32.  The math is the TPU kernel's, step for step:
// the KV axis is walked in blocks of `blk` slots, and only the live ones
// (pad[b] / blk .. pos / blk) are read; each block is dequantized in the
// kernel (posit8 decode times the bf16 scale), scored (dot, times
// 1/sqrt(Dh), optional tanh softcap), masked with the -1e30 sentinel
// (kpos > pos, kpos < pad[b]) and folded into an online softmax
// (m, l, acc in f32).  A block wholly below the pad is skipped, which
// equals masking it: see _online_softmax_step in the reference.
//
// What bounds it on this card: bytes (one byte per cached element plus
// its share of a scale, read once; a few flops per byte).  Design: one
// block of 128 threads per (b, kv-head), a loop over the live KV blocks
// inside it (the TPU's sequential grid axis), the dequantized K and V
// block in shared memory (K rows padded by one float against bank
// conflicts), one warp per query row for the softmax statistics.  At
// small batch the (B, Kh) grid leaves most of the 132 SMs idle; splitting
// the KV axis across blocks and merging (m, l, acc) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "formats.cuh"

namespace {

using xrnpe::Posit;

constexpr int NT = 128;
constexpr float NEG = -1e30f;

__global__ void __launch_bounds__(NT)
flash_decode_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ ks,
                    const uint8_t* __restrict__ vc,
                    const __nv_bfloat16* __restrict__ vs,
                    const int* __restrict__ pad, float* __restrict__ out, int T,
                    int Kh, int G, int Dh, int Gs, int pos, int blk,
                    float softcap, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ldk = Dh + 1;
  float* qs = sm;                 // (G, Dh)
  float* acc = qs + G * Dh;       // (G, Dh)
  float* kb = acc + G * Dh;       // (blk, Dh + 1)
  float* vb = kb + blk * ldk;     // (blk, Dh)
  float* sb = vb + blk * Dh;      // (G, blk) scores, then p
  float* mrow = sb + G * blk;     // (G,)
  float* lrow = mrow + G;         // (G,)
  float* arow = lrow + G;         // (G,) alpha of the current block

  const size_t qoff = ((size_t)b * Kh + h) * G * Dh;
  for (int i = tid; i < G * Dh; i += NT) {
    qs[i] = q[qoff + i];
    acc[i] = 0.0f;
  }
  for (int r = tid; r < G; r += NT) {
    mrow[r] = NEG;
    lrow[r] = 0.0f;
  }
  const int pad_b = pad != nullptr ? pad[b] : 0;
  const int dg = Dh / Gs;
  __syncthreads();

  for (int t = pad_b / blk; t <= pos / blk; ++t) {
    for (int i = tid; i < blk * Dh; i += NT) {
      const int j = i / Dh, d = i % Dh;
      const size_t row = ((size_t)b * T + (size_t)t * blk + j) * Kh + h;
      kb[j * ldk + d] = Posit<8, 0>::decode(kc[row * Dh + d]) *
                        __bfloat162float(ks[row * Gs + d / dg]);
      vb[j * Dh + d] = Posit<8, 0>::decode(vc[row * Dh + d]) *
                       __bfloat162float(vs[row * Gs + d / dg]);
    }
    __syncthreads();
    for (int i = tid; i < G * blk; i += NT) {
      const int r = i / blk, j = i % blk;
      float s = 0.0f;
      for (int d = 0; d < Dh; ++d) s = fmaf(qs[r * Dh + d], kb[j * ldk + d], s);
      s *= scale;
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      const int kpos = t * blk + j;
      if (kpos > pos || kpos < pad_b) s = NEG;
      sb[i] = s;
    }
    __syncthreads();
    for (int r = warp; r < G; r += NT / 32) {
      float mx = mrow[r];
      for (int j = lane; j < blk; j += 32) mx = fmaxf(mx, sb[r * blk + j]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.0f;
      for (int j = lane; j < blk; j += 32) {
        const float p = expf(sb[r * blk + j] - mx);
        sb[r * blk + j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(mrow[r] - mx);
        lrow[r] = lrow[r] * alpha + sum;
        mrow[r] = mx;
        arow[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * Dh; i += NT) {
      const int r = i / Dh, d = i % Dh;
      float pv = 0.0f;
      for (int j = 0; j < blk; ++j) pv = fmaf(sb[r * blk + j], vb[j * Dh + d], pv);
      acc[i] = acc[i] * arow[r] + pv;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * Dh; i += NT) out[qoff + i] = acc[i] / lrow[i / Dh];
}

// Bytes of dynamic shared memory one launch needs.
int smem_bytes(int G, int Dh, int blk) {
  return static_cast<int>(sizeof(float)) *
         (2 * G * Dh + blk * (Dh + 1) + blk * Dh + G * blk + 3 * G);
}

}  // namespace

// Returns cudaGetLastError() after the launch.  `pad` may be null.
extern "C" int flash_decode(const void* q, const void* k_codes, const void* k_scale,
                            const void* v_codes, const void* v_scale, const void* pad,
                            void* out, int B, int T, int Kh, int G, int Dh, int Gs,
                            int pos, int blk, float softcap, float scale,
                            void* stream) {
  const int smem = smem_bytes(G, Dh, blk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(B, Kh);
  flash_decode_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k_codes),
      static_cast<const __nv_bfloat16*>(k_scale), static_cast<const uint8_t*>(v_codes),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(pad),
      static_cast<float*>(out), T, Kh, G, Dh, Gs, pos, blk, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}
