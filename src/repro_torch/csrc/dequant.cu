// Standalone SIMD decode (dequantization) kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/codec.py, dequant_pallas (the TPU kernel
// that turns packed words and po2 scales into a dense f32 matrix).
//
// Computes out (K, N) f32 = decode(code) * scale from int32 words
// (Kp, Np / per) holding per = 32 / bits codes each, little-endian within
// the word, and scales (G, Np) f32: G == 1 is per-channel, G > 1 gives
// one scale row per K-group of `group` = Kp / G rows.  K <= Kp and
// N <= Np are the logical shape; the padding rows and columns are not
// written.  Each output is one f32 multiply of the exactly decoded code
// by its scale, so the result equals the plain PyTorch version bit for
// bit.
//
// What bounds it on this card: bytes.  It reads 0.5, 1 or 2 bytes a
// weight and writes 4, with one multiply per output, far below the
// point where arithmetic matters.  Design: one thread per word; the
// thread decodes its per codes in registers with the format's
// branch-free decoder from formats.cuh (templated on the format, so no
// table is read), as the RMMEC kernel does, and writes them as one or
// two vector stores when the row holds whole words.  Neighbouring
// threads take neighbouring words of a row, so loads and stores are
// coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "formats.cuh"

namespace {

using namespace xrnpe;

constexpr int NTHREADS = 256;

template <class F>
__global__ void __launch_bounds__(NTHREADS)
dequant_kernel(const uint32_t* __restrict__ w, const float* __restrict__ scales,
               float* __restrict__ out, int K, int N, int Np, int group,
               int nw_out, int vec) {
  constexpr int PER = 32 / F::BITS;
  constexpr uint32_t CODE_MASK = (1u << F::BITS) - 1u;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NTHREADS + threadIdx.x;
  if (i >= static_cast<int64_t>(K) * nw_out) return;
  const int k = static_cast<int>(i / nw_out);
  const int wc = static_cast<int>(i % nw_out);
  const int nw = Np / PER;
  const uint32_t word = __ldg(w + static_cast<size_t>(k) * nw + wc);
  const float* srow = scales + static_cast<size_t>(group > 0 ? k / group : 0) * Np
                      + wc * PER;
  float v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j)
    v[j] = F::decode((word >> (j * F::BITS)) & CODE_MASK) * __ldg(srow + j);
  float* dst = out + static_cast<size_t>(k) * N + wc * PER;
  if (vec) {  // N % PER == 0: the word's PER outputs are in bounds and aligned
    if constexpr (PER == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int j = 0; j < PER; j += 4)
        *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else {
    const int n0 = wc * PER;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (n0 + j < N) dst[j] = v[j];
  }
}

template <class F>
cudaError_t launch(const uint32_t* w, const float* scales, float* out, int K,
                   int N, int Np, int group, cudaStream_t stream) {
  constexpr int PER = 32 / F::BITS;
  const int nw_out = (N + PER - 1) / PER;
  const int64_t total = static_cast<int64_t>(K) * nw_out;
  if (total == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((total + NTHREADS - 1) / NTHREADS);
  dequant_kernel<F><<<blocks, NTHREADS, 0, stream>>>(
      w, scales, out, K, N, Np, group, nw_out, static_cast<int>(N % PER == 0));
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a format this library has no decoder for).  `group` is 0 for
// per-channel scales.
extern "C" int dequant(const void* words, const void* scales, void* out, int K,
                       int N, int Np, int group, int kind, int bits, int es,
                       int ebits, int mbits, int has_nan, int frac_bits,
                       void* stream) {
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const float* s = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == KIND_POSIT) {
    if (bits == 4 && es == 1) return launch<Posit<4, 1>>(w, s, o, K, N, Np, group, st);
    if (bits == 8 && es == 0) return launch<Posit<8, 0>>(w, s, o, K, N, Np, group, st);
    if (bits == 16 && es == 1) return launch<Posit<16, 1>>(w, s, o, K, N, Np, group, st);
  } else if (kind == KIND_MINIFLOAT) {
    if (ebits == 2 && mbits == 1 && !has_nan) return launch<Minifloat<2, 1, false>>(w, s, o, K, N, Np, group, st);
    if (ebits == 4 && mbits == 3 && has_nan) return launch<Minifloat<4, 3, true>>(w, s, o, K, N, Np, group, st);
    if (ebits == 5 && mbits == 2 && has_nan) return launch<Minifloat<5, 2, true>>(w, s, o, K, N, Np, group, st);
  } else if (kind == KIND_FIXED) {
    if (bits == 4 && frac_bits == 2) return launch<Fixed<4, 2>>(w, s, o, K, N, Np, group, st);
    if (bits == 8 && frac_bits == 4) return launch<Fixed<8, 4>>(w, s, o, K, N, Np, group, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
