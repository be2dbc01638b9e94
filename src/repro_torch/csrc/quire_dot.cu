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
// magnitude <= 2^24 in those units.  The kernels sum those integers --
// at most 32 products in int32 (|sum| <= 2^29), then in int64 across
// iterations, lanes and warps -- and split the total once.  Integer addition is
// associative, so any order gives the same bits; no float is rounded and
// nothing is atomic, so the limbs equal the reference's bit for bit
// (while hi fits int32, as it does in the reference: |S| < 2^31).
//
// What bounds it on this card: bytes (8 bytes of codes per product, one
// integer multiply-add each).  At the bench's 64 x 1024 the whole input
// is 0.5 MB, 0.16 us at full bandwidth: there one DRAM round trip, the
// launch and the reduction are the time, and the design's aim is a single
// round trip; at 4096 x 4096 it is the bandwidth.  A block of ROW_THREADS
// per row (row_kernel) takes 16-byte loads (int4: four codes), ROW_UNROLL
// of each operand in flight a thread (a row of 8192 codes in one batch),
// issues its first loads before it builds the 256-entry table of the
// codes' values in units of 2^-6 in shared memory (through formats.cuh's
// exact decoder), reads each code's value with one shared-memory load and
// reduces by warp shuffles.  Rows that are not whole int4s (K % 4 != 0)
// or codes not on a 16-byte boundary take scalar_kernel, the same loop
// with 4-byte loads (the first design); the wrapper picks the route
// (kernels/quire_dot.py, quire_route).

#include <cuda_runtime.h>
#include <stdint.h>

#include "formats.cuh"

namespace {

using namespace xrnpe;

constexpr int QUIRE_FRAC_BITS = 22;
constexpr int PROD_FRAC_BITS = 12;  // lsb of a product: 2^-6 * 2^-6
constexpr int ROW_THREADS = 256;    // threads of a row-route block
constexpr int ROW_UNROLL = 8;       // int4 loads of each operand in flight a thread
constexpr int SCALAR_THREADS = 256;
enum Route { ROUTE_ROW = 0, ROUTE_SCALAR = 1 };

// The value of every code in units of 2^-6 (exact: |v| <= 64, lsb 2^-6).
__device__ __forceinline__ void fill_table(int* table, int nthreads) {
  for (int i = threadIdx.x; i < 256; i += nthreads)
    table[i] = __float2int_rn(Posit<8, 0>::decode(static_cast<uint32_t>(i)) * 64.0f);
}

// The four products of two int4s of codes, summed (|sum| <= 2^26).
__device__ __forceinline__ int dot4(const int* table, int4 x, int4 y) {
  return table[x.x & 0xFF] * table[y.x & 0xFF] + table[x.y & 0xFF] * table[y.y & 0xFF] +
         table[x.z & 0xFF] * table[y.z & 0xFF] + table[x.w & 0xFF] * table[y.w & 0xFF];
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s is S in units of 2^-12; >> is an arithmetic (floor) shift.
__device__ __forceinline__ void write_limbs(int* hi, int* lo, size_t row, long long s) {
  hi[row] = static_cast<int>(s >> PROD_FRAC_BITS);
  lo[row] = static_cast<int>((s & ((1LL << PROD_FRAC_BITS) - 1))
                             << (QUIRE_FRAC_BITS - PROD_FRAC_BITS));
}

// grid B, ROW_THREADS a block: block i takes row i (K % 4 == 0).
__global__ void __launch_bounds__(ROW_THREADS)
row_kernel(const int4* __restrict__ a, const int4* __restrict__ b, int* __restrict__ hi,
           int* __restrict__ lo, int K) {
  __shared__ int table[256];
  __shared__ long long warp_sums[ROW_THREADS / 32];
  const int nv = K / 4;
  const int4* ar = a + static_cast<size_t>(blockIdx.x) * nv;
  const int4* br = b + static_cast<size_t>(blockIdx.x) * nv;
  const int4 zero = make_int4(0, 0, 0, 0);  // code 0 is the value 0
  int4 x[ROW_UNROLL], y[ROW_UNROLL];
  auto load = [&](int v0) {
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const int v = v0 + u * ROW_THREADS;
      x[u] = v < nv ? __ldcs(ar + v) : zero;
      y[u] = v < nv ? __ldcs(br + v) : zero;
    }
  };
  load(threadIdx.x);  // the first loads out before the table
  fill_table(table, ROW_THREADS);
  __syncthreads();
  long long acc = 0;
  for (int v0 = threadIdx.x; v0 < nv; v0 += ROW_UNROLL * ROW_THREADS) {
    int part = 0;  // 4 * ROW_UNROLL products: |part| <= 2^29
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) part += dot4(table, x[u], y[u]);
    acc += part;
    if (v0 + ROW_UNROLL * ROW_THREADS < nv) load(v0 + ROW_UNROLL * ROW_THREADS);
  }
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    long long s = threadIdx.x < ROW_THREADS / 32 ? warp_sums[threadIdx.x] : 0;
    s = warp_sum(s);
    if (threadIdx.x == 0) write_limbs(hi, lo, blockIdx.x, s);
  }
}

// grid B, SCALAR_THREADS a block: any K, any alignment.
__global__ void __launch_bounds__(SCALAR_THREADS)
scalar_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ hi,
              int* __restrict__ lo, int K) {
  __shared__ int table[256];
  __shared__ long long warp_sums[SCALAR_THREADS / 32];
  fill_table(table, SCALAR_THREADS);
  __syncthreads();
  const size_t row = static_cast<size_t>(blockIdx.x) * K;
  long long acc = 0;
  for (int k = threadIdx.x; k < K; k += SCALAR_THREADS)
    acc += table[__ldg(a + row + k) & 0xFF] * table[__ldg(b + row + k) & 0xFF];
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    long long s = threadIdx.x < SCALAR_THREADS / 32 ? warp_sums[threadIdx.x] : 0;
    s = warp_sum(s);
    if (threadIdx.x == 0) write_limbs(hi, lo, blockIdx.x, s);
  }
}

}  // namespace

// a, b: (B, K) int32 codes; hi, lo: (B,) int32.  `route` comes from the
// wrapper's plan; a route the shape does not fit returns
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch.
extern "C" int quire_dot(const void* a, const void* b, void* hi, void* lo, int B, int K,
                         int route, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* h = static_cast<int*>(hi);
  int* l = static_cast<int*>(lo);
  const bool vec = K % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  if (route == ROUTE_ROW) {
    if (!vec) return static_cast<int>(cudaErrorInvalidValue);
    row_kernel<<<B, ROW_THREADS, 0, st>>>(static_cast<const int4*>(a),
                                          static_cast<const int4*>(b), h, l, K);
  } else if (route == ROUTE_SCALAR) {
    scalar_kernel<<<B, SCALAR_THREADS, 0, st>>>(static_cast<const int*>(a),
                                                static_cast<const int*>(b), h, l, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
