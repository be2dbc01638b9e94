// Standalone SIMD decode (dequantization) kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/codec.py, dequant_pallas (the TPU kernel
// that turns packed words and po2 scales into a dense f32 matrix).
//
// Computes out (K, N) = decode(code) * scale from int32 words
// (Kp, Np / per) holding per = 32 / bits codes each, little-endian within
// the word, and scales (G, Np) f32: G == 1 is per-channel, G > 1 gives
// one scale row per K-group of `group` = Kp / G rows.  K <= Kp and
// N <= Np are the logical shape; the padding rows and columns are not
// written.  Each output is one f32 multiply of the exactly decoded code
// by its scale, so the result equals the plain PyTorch version bit for
// bit.  The output is f32, or bf16 (`out_bf16`): the f32 product rounded
// to nearest even as PyTorch's f32 -> bf16 cast rounds it (NaN to
// 0x7FC0), so a bf16 output equals the f32 one cast to bf16, bit for bit,
// without the f32 matrix ever being written.
//
// What bounds it on this card: bytes.  It reads 0.5, 1 or 2 bytes a
// weight and writes 4 (writes are 67-89% of the bytes), with one multiply
// per output, far below the point where arithmetic matters.  At the
// engine plane's sizes (4-17 MB of output) what keeps a kernel from the
// bound is how soon its loads are all in flight and its stores start: a
// thread per 4-byte word that reads its `per` scales one after another
// before it can multiply (word_kernel, the first design) reached 20-37%
// of the bound.
//
// Design (strip_kernel): a block of STRIP_WARPS warps owns a strip of
// STRIP_VECS 16-byte word vectors (uint4: 16 posit8 or 32 FP4 codes) of
// a band of rows, one vector a lane, and each warp walks the band's rows
// STRIP_WARPS apart: it issues the next row's loads before it decodes and
// stores the current one.  The warp stages a row's
// words in shared memory and each lane then takes every 32nd 4-column
// chunk of the strip, so each float4 store of the warp writes 512
// contiguous bytes (a lane storing its own vector's outputs would leave
// each store instruction 32 pieces of 16 bytes, 64-128 bytes apart), as
// streaming stores (st.global.cs: written once, never read back here).
// A lane's per-channel scales are loaded once as float4s, and grouped
// scales once per K-group.  Codes of at most
// 8 bits decode through a 256-entry f32 table in shared memory, filled
// once per block by formats.cuh's exact decoders (16-bit codes decode in
// registers).  The grid is sized to the card by the wrapper (SM count x
// STRIP_BLOCKS_PER_SM blocks), not to the word count.  A layout whose
// rows are not whole uint4s, or whose words or scales do not start on a
// 16-byte boundary, takes word_kernel: one thread per word, as before.

#include <cuda_runtime.h>
#include <stdint.h>

#include "formats.cuh"

namespace {

using namespace xrnpe;

// f32 -> bf16 bits, round to nearest even, NaN to 0x7FC0: PyTorch's cast
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7FC0u;
  u += 0x7FFFu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

// an output element: f32 as is, or the bits of its bf16 rounding
template <class OutT>
__device__ __forceinline__ OutT out_value(float x) {
  if constexpr (sizeof(OutT) == 2) {
    return bf16_bits(x);
  } else {
    return x;
  }
}

constexpr int WORD_THREADS = 256;
constexpr int STRIP_WARPS = 8;                      // warps of a strip block
constexpr int STRIP_THREADS = 32 * STRIP_WARPS;
constexpr int STRIP_VECS = 32;                      // uint4s of a strip: one a lane
enum Route { ROUTE_WORD = 0, ROUTE_STRIP = 1 };

template <class F, class OutT>
__global__ void __launch_bounds__(WORD_THREADS)
word_kernel(const uint32_t* __restrict__ w, const float* __restrict__ scales,
            OutT* __restrict__ out, int K, int N, int Np, int group,
            int nw_out, int vec) {
  constexpr int PER = 32 / F::BITS;
  constexpr uint32_t CODE_MASK = (1u << F::BITS) - 1u;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * WORD_THREADS + threadIdx.x;
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
  OutT* dst = out + static_cast<size_t>(k) * N + wc * PER;
  if constexpr (sizeof(OutT) == 2) {  // bf16: one element at a time
    const int n0 = wc * PER;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (n0 + j < N) dst[j] = out_value<OutT>(v[j]);
  } else if (vec) {  // N % PER == 0: the word's PER outputs are in bounds and aligned
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

// A lane's scales of scale row `grow`: the float4 of each of its chunks
// (columns n0 + 4 * (j * 32 + lane)), zeros past the row.
template <int NCH>
__device__ __forceinline__ void load_scales(float4 (&sc)[NCH], const float* __restrict__ scales,
                                            size_t grow, int Np, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int col = n0 + 4 * (j * 32 + lane);
    sc[j] = col < Np ? __ldg(reinterpret_cast<const float4*>(scales + grow * Np + col))
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// grid (strips, bands): block (x, y) takes uint4 columns 32x .. 32x+31 of
// rows y*band .. y*band + band-1; warp v of it the rows v, v+8, ... of the
// band.  A lane loads one uint4 of a row (coalesced), the warp stages the
// row's 128 words in shared memory, and lane l decodes and stores the
// 4-column chunks l, l + 32, ... of the strip, so each float4 store of the
// warp writes 512 contiguous bytes.  nv: uint4s of a packed row; nv_out:
// those holding outputs below N.
template <class F, class OutT>
__global__ void __launch_bounds__(STRIP_THREADS)
strip_kernel(const uint4* __restrict__ w, const float* __restrict__ scales,
             OutT* __restrict__ out, int K, int N, int Np, int group, int nv, int nv_out,
             int band) {
  constexpr int PER = 32 / F::BITS, OUT = 4 * PER;  // outputs of a uint4
  constexpr int NCH = OUT / 4;                      // 4-column chunks a lane stores
  constexpr uint32_t CODE_MASK = (1u << F::BITS) - 1u;
  constexpr bool LUT = F::BITS <= 8;
  __shared__ float lut[LUT ? 256 : 1];
  __shared__ __align__(16) uint32_t rows[STRIP_WARPS][4 * STRIP_VECS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = static_cast<int>(blockIdx.x) * STRIP_VECS + lane;
  const int n0 = static_cast<int>(blockIdx.x) * STRIP_VECS * OUT;  // the strip's first column
  const bool live = c < nv_out;
  const int y = static_cast<int>(blockIdx.y), r0 = y * band + warp, r1 = min(K, (y + 1) * band);
  constexpr int STEP = STRIP_WARPS;
  uint32_t* staged = rows[warp];

  // the first row's words and the lane's scales go out before anything else
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 cur = live && r0 < r1 ? __ldg(w + static_cast<size_t>(r0) * nv + c) : zero;
  float4 sc[NCH];
  int gcur = group > 0 ? r0 / group : 0;
  load_scales<NCH>(sc, scales, gcur, Np, n0, lane);
  if constexpr (LUT) {
    for (int i = threadIdx.x; i < (1 << F::BITS); i += STRIP_THREADS)
      lut[i] = F::decode(static_cast<uint32_t>(i));
    __syncthreads();
  }
  const bool vec_out = N % 4 == 0;  // rows of whole float4s

  for (int r = r0; r < r1; r += STEP) {
    const int rn = r + STEP;  // the next row's loads before this row's stores
    const uint4 nxt = live && rn < r1 ? __ldg(w + static_cast<size_t>(rn) * nv + c) : zero;
    if (group > 0 && r / group != gcur) {
      gcur = r / group;
      load_scales<NCH>(sc, scales, gcur, Np, n0, lane);
    }
    reinterpret_cast<uint4*>(staged)[lane] = cur;
    __syncwarp();
    OutT* dst = out + static_cast<size_t>(r) * N;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int q = j * 32 + lane, col = n0 + 4 * q;  // chunk q: codes 4q .. 4q+3
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t code =
            (staged[(4 * q + e) / PER] >> (((4 * q + e) % PER) * F::BITS)) & CODE_MASK;
        v[e] = LUT ? lut[code] : F::decode(code);
      }
      v[0] *= sc[j].x;
      v[1] *= sc[j].y;
      v[2] *= sc[j].z;
      v[3] *= sc[j].w;
      if (vec_out && col + 4 <= N) {
        if constexpr (sizeof(OutT) == 2) {  // four bf16s: one 8-byte store
          __stcs(reinterpret_cast<uint2*>(dst + col),
                 make_uint2(bf16_bits(v[0]) | (static_cast<uint32_t>(bf16_bits(v[1])) << 16),
                            bf16_bits(v[2]) | (static_cast<uint32_t>(bf16_bits(v[3])) << 16)));
        } else {
          __stcs(reinterpret_cast<float4*>(dst + col), make_float4(v[0], v[1], v[2], v[3]));
        }
      } else {  // the ragged edge
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < N) dst[col + e] = out_value<OutT>(v[e]);
      }
    }
    __syncwarp();  // the staged row is read before the next overwrites it
    cur = nxt;
  }
}

// `route`, `strips` and `bands` come from the wrapper's plan
// (kernels/codec.py, dequant_plan); the strip route checks what it needs.
template <class F, class OutT>
cudaError_t launch(const uint32_t* w, const float* scales, OutT* out, int K, int N, int Np,
                   int group, int route, int strips, int bands, cudaStream_t stream) {
  constexpr int PER = 32 / F::BITS;
  if (K == 0 || N == 0) return cudaSuccess;
  if (route == ROUTE_STRIP) {
    const int nw = Np / PER, nv_out = (N + 4 * PER - 1) / (4 * PER);
    const bool aligned = ((reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(scales)) & 15) == 0;
    if (nw % 4 != 0 || !aligned || strips != (nv_out + STRIP_VECS - 1) / STRIP_VECS ||
        bands < 1)
      return cudaErrorInvalidValue;
    const int band = (K + bands - 1) / bands;
    strip_kernel<F, OutT><<<dim3(strips, bands), STRIP_THREADS, 0, stream>>>(
        reinterpret_cast<const uint4*>(w), scales, out, K, N, Np, group, nw / 4, nv_out, band);
    return cudaGetLastError();
  }
  const int nw_out = (N + PER - 1) / PER;
  const int64_t total = static_cast<int64_t>(K) * nw_out;
  const unsigned blocks = static_cast<unsigned>((total + WORD_THREADS - 1) / WORD_THREADS);
  word_kernel<F, OutT><<<blocks, WORD_THREADS, 0, stream>>>(
      w, scales, out, K, N, Np, group, nw_out, static_cast<int>(N % PER == 0));
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a format this library has no decoder for, or a strip plan the layout
// does not fit).  `group` is 0 for per-channel scales; `out_bf16` 1
// writes bf16 outputs, 0 f32.
extern "C" int dequant(const void* words, const void* scales, void* out, int K,
                       int N, int Np, int group, int kind, int bits, int es,
                       int ebits, int mbits, int has_nan, int frac_bits, int route,
                       int strips, int bands, int out_bf16, void* stream) {
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const float* s = static_cast<const float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XRNPE_DEQUANT(...)                                                              \
  (out_bf16 ? launch<__VA_ARGS__, uint16_t>(w, s, static_cast<uint16_t*>(out), K, N, Np, \
                                            group, route, strips, bands, st)             \
            : launch<__VA_ARGS__, float>(w, s, static_cast<float*>(out), K, N, Np, group, \
                                         route, strips, bands, st))
  if (kind == KIND_POSIT) {
    if (bits == 4 && es == 1) return XRNPE_DEQUANT(Posit<4, 1>);
    if (bits == 8 && es == 0) return XRNPE_DEQUANT(Posit<8, 0>);
    if (bits == 16 && es == 1) return XRNPE_DEQUANT(Posit<16, 1>);
  } else if (kind == KIND_MINIFLOAT) {
    if (ebits == 2 && mbits == 1 && !has_nan) return XRNPE_DEQUANT(Minifloat<2, 1, false>);
    if (ebits == 4 && mbits == 3 && has_nan) return XRNPE_DEQUANT(Minifloat<4, 3, true>);
    if (ebits == 5 && mbits == 2 && has_nan) return XRNPE_DEQUANT(Minifloat<5, 2, true>);
  } else if (kind == KIND_FIXED) {
    if (bits == 4 && frac_bits == 2) return XRNPE_DEQUANT(Fixed<4, 2>);
    if (bits == 8 && frac_bits == 4) return XRNPE_DEQUANT(Fixed<8, 4>);
  }
#undef XRNPE_DEQUANT
  return static_cast<int>(cudaErrorInvalidValue);
}
