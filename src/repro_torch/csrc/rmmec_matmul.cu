// RMMEC packed mixed-precision matrix product for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmmec_matmul.py, rmmec_matmul_pallas (the
// TPU kernel run for every packed projection of the serving plane).
//
// Computes out (M, N) f32 = x (M, K) @ W, where W is stored as packed
// low-bit codes: int32 words (Kp, Np / per) holding per = 32 / bits
// codes each, little-endian within the word, with dequant scales
// (G, Np) f32 and a block mask (mask_rows, mask_cols) int32.  G == 1 is
// per-channel (applied once to the output); G > 1 gives one scale per
// K-group of `group` rows (applied to the decoded weight inside the K
// loop).  Kp >= K and Np >= N are whatever the packer padded to: the
// stacked-layer layout pads K only to the group and N only to the word,
// the 2-D layout pads both to kernel blocks; the kernel reads K rows and
// guards both edges itself.
//
// What bounds it on this card: at decode (M = batch, a few rows) the
// product is bound by the bytes of the packed words (0.5 or 1 byte per
// weight), far below the point where the FMA rate matters; at prefill
// (M = batch * prompt) it is bound by operations.  Design: one block per
// (BM x 64) output tile with a loop over K in steps of 32 inside the
// block (the TPU's sequential K grid axis becomes that loop; nothing is
// carried across blocks).  Each step decodes a 32 x 64 weight tile in
// registers with the format's branch-free decoder, templated on the
// format so no table is read, stores it to shared memory as f32 and
// runs a plain FMA tile.  Decode and accumulation stay in f32: posit16
// carries 12 fraction bits, which bf16 cannot hold, and posit8 is not
// exact in e4m3, so no tensor-core MMA is used yet.  A K step whose
// weight tile lies wholly inside gated-off mask blocks is skipped.
// Small M takes BM = 8 rows per block; wgmma and split-K are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "formats.cuh"

namespace {

using namespace xrnpe;

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NTHREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class F, typename TX, int BM, int TM, int TN>
__global__ void __launch_bounds__(NTHREADS)
rmmec_kernel(const TX* __restrict__ x, const uint32_t* __restrict__ w,
             const float* __restrict__ scales, const int* __restrict__ mask,
             float* __restrict__ out, int M, int K, int N, int Np, int group,
             int mk, int mn, int mask_cols) {
  constexpr int PER = 32 / F::BITS;
  constexpr int WCOLS = BN / PER;      // words per tile row
  constexpr int TCOLS = BN / TN;       // threads along N
  constexpr int TROWS = BM / TM;       // threads along M
  static_assert(TCOLS * TROWS == NTHREADS, "thread tiling");
  constexpr uint32_t CODE_MASK = (1u << F::BITS) - 1u;

  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TCOLS;
  const int ty = tid / TCOLS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nw = Np / PER;
  const int nend = min(n0 + BN, Np);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kend = min(k0 + BK, K);
    // block gating: every thread reaches the same verdict
    bool live = false;
    for (int kb = k0 / mk; kb <= (kend - 1) / mk && !live; ++kb)
      for (int nb = n0 / mn; nb <= (nend - 1) / mn; ++nb)
        if (mask[kb * mask_cols + nb] != 0) { live = true; break; }
    if (!live) continue;

    for (int i = tid; i < BM * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? to_float(x[(size_t)gm * K + gk]) : 0.0f;
    }
    for (int i = tid; i < BK * WCOLS; i += NTHREADS) {
      const int r = i / WCOLS, wc = i % WCOLS;
      const int gk = k0 + r, gwc = n0 / PER + wc;
      float* dst = &ws[r][wc * PER];
      if (gk < K && gwc < nw) {
        const uint32_t word = w[(size_t)gk * nw + gwc];
        const float* srow = scales + (size_t)(group > 0 ? gk / group : 0) * Np + gwc * PER;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          float v = F::decode((word >> (j * F::BITS)) & CODE_MASK);
          if (group > 0) v *= srow[j];
          dst[j] = v;
        }
      } else {
#pragma unroll
        for (int j = 0; j < PER; ++j) dst[j] = 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[ty + i * TROWS][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = ws[kk][tx + j * TCOLS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TROWS;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TCOLS;
      if (gm < M && gn < N) {
        float v = acc[i][j];
        if (group == 0) v *= scales[gn];  // per-channel: once, at output
        out[(size_t)gm * N + gn] = v;
      }
    }
  }
}

struct Args {
  const void* x;
  const uint32_t* w;
  const float* scales;
  const int* mask;
  float* out;
  int M, K, N, Np, group, mk, mn, mask_cols;
  cudaStream_t stream;
};

template <class F, typename TX>
cudaError_t launch_tiles(const Args& a) {
  const TX* x = static_cast<const TX*>(a.x);
  if (a.M <= 32) {
    dim3 grid((a.N + BN - 1) / BN, (a.M + 7) / 8);
    rmmec_kernel<F, TX, 8, 1, 2><<<grid, NTHREADS, 0, a.stream>>>(
        x, a.w, a.scales, a.mask, a.out, a.M, a.K, a.N, a.Np, a.group, a.mk,
        a.mn, a.mask_cols);
  } else {
    dim3 grid((a.N + BN - 1) / BN, (a.M + 63) / 64);
    rmmec_kernel<F, TX, 64, 4, 4><<<grid, NTHREADS, 0, a.stream>>>(
        x, a.w, a.scales, a.mask, a.out, a.M, a.K, a.N, a.Np, a.group, a.mk,
        a.mn, a.mask_cols);
  }
  return cudaGetLastError();
}

template <class F>
cudaError_t launch_format(const Args& a, int x_bf16) {
  return x_bf16 ? launch_tiles<F, __nv_bfloat16>(a) : launch_tiles<F, float>(a);
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a format this library has no decoder for).
extern "C" int rmmec_matmul(const void* x, int x_bf16, const void* words,
                            const void* scales, const void* mask, void* out,
                            int M, int K, int N, int Np, int group, int mk,
                            int mn, int mask_cols, int kind, int bits, int es,
                            int ebits, int mbits, int has_nan, int frac_bits,
                            void* stream) {
  Args a{x, static_cast<const uint32_t*>(words), static_cast<const float*>(scales),
         static_cast<const int*>(mask), static_cast<float*>(out),
         M, K, N, Np, group, mk, mn, mask_cols, static_cast<cudaStream_t>(stream)};
  if (kind == KIND_POSIT) {
    if (bits == 4 && es == 1) return launch_format<Posit<4, 1>>(a, x_bf16);
    if (bits == 8 && es == 0) return launch_format<Posit<8, 0>>(a, x_bf16);
    if (bits == 16 && es == 1) return launch_format<Posit<16, 1>>(a, x_bf16);
  } else if (kind == KIND_MINIFLOAT) {
    if (ebits == 2 && mbits == 1 && !has_nan) return launch_format<Minifloat<2, 1, false>>(a, x_bf16);
    if (ebits == 4 && mbits == 3 && has_nan) return launch_format<Minifloat<4, 3, true>>(a, x_bf16);
    if (ebits == 5 && mbits == 2 && has_nan) return launch_format<Minifloat<5, 2, true>>(a, x_bf16);
  } else if (kind == KIND_FIXED) {
    if (bits == 4 && frac_bits == 2) return launch_format<Fixed<4, 2>>(a, x_bf16);
    if (bits == 8 && frac_bits == 4) return launch_format<Fixed<8, 4>>(a, x_bf16);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
