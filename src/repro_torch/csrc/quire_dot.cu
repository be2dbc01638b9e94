// Quire-exact Posit(8,0) row dot for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quire_dot.py, quire_dot_pallas (the TPU
// kernel of the XR-NPE's exact MAC: a dot product that rounds once).
//
// Computes, for each row i of two (B, K) int32 posit8 code matrices,
// the exact sum S_i = sum_k decode(a[i,k]) * decode(b[i,k]) as two int32
// quire limbs: hi = floor(S) and lo = frac(S) * 2^22, so that
// S = hi + lo * 2^-22 with 0 <= lo < 2^22 -- the canonical limbs the
// reference leaves after its last carry fold.  Codes are masked to 8
// bits; NaR (code 128) decodes to 0.
//
// Exactness: every posit8 value is an integer multiple of 2^-6 of
// magnitude <= 64, so each product is an integer multiple of 2^-12 of
// magnitude <= 2^24 in those units.  The kernel sums those integers in
// int64 -- per thread, then across the block by warp shuffles -- and
// splits the total once.  No float is rounded and nothing is atomic, so
// the limbs equal the reference's bit for bit (while hi fits int32, as
// it does in the reference: |S| < 2^31).
//
// What bounds it on this card: bytes (8 bytes of codes per product, one
// integer multiply-add each).  Design: one block per row; the TPU's
// sequential K grid axis becomes the block's strided loop over K (no sum
// crosses blocks); a 256-entry table of the codes' values in units of
// 2^-6, decoded once per block through formats.cuh, turns each code into
// an integer with one shared-memory load.

#include <cuda_runtime.h>
#include <stdint.h>

#include "formats.cuh"

namespace {

using namespace xrnpe;

constexpr int NTHREADS = 256;
constexpr int QUIRE_FRAC_BITS = 22;
constexpr int PROD_FRAC_BITS = 12;  // lsb of a product: 2^-6 * 2^-6

__global__ void __launch_bounds__(NTHREADS)
quire_dot_kernel(const int* __restrict__ a, const int* __restrict__ b,
                 int* __restrict__ hi, int* __restrict__ lo, int K) {
  __shared__ int table[256];
  __shared__ long long warp_sums[NTHREADS / 32];
  const int tid = threadIdx.x;
  // value of each code in units of 2^-6 (exact: |v| <= 64, lsb 2^-6)
  table[tid] = __float2int_rn(Posit<8, 0>::decode(static_cast<uint32_t>(tid)) * 64.0f);
  __syncthreads();

  const size_t row = static_cast<size_t>(blockIdx.x) * K;
  long long acc = 0;
  for (int k = tid; k < K; k += NTHREADS) {
    const int x = table[__ldg(a + row + k) & 0xFF];
    const int y = table[__ldg(b + row + k) & 0xFF];
    acc += static_cast<long long>(x * y);  // |x * y| <= 2^24: exact in int
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    long long s = 0;
#pragma unroll
    for (int w = 0; w < NTHREADS / 32; ++w) s += warp_sums[w];
    // s is S in units of 2^-12; >> is an arithmetic (floor) shift
    hi[blockIdx.x] = static_cast<int>(s >> PROD_FRAC_BITS);
    lo[blockIdx.x] = static_cast<int>((s & ((1LL << PROD_FRAC_BITS) - 1))
                                      << (QUIRE_FRAC_BITS - PROD_FRAC_BITS));
  }
}

}  // namespace

// a, b: (B, K) int32 codes; hi, lo: (B,) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int quire_dot(const void* a, const void* b, void* hi, void* lo,
                         int B, int K, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  quire_dot_kernel<<<B, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<int*>(hi), static_cast<int*>(lo), K);
  return static_cast<int>(cudaGetLastError());
}
