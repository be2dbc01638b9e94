// The paged posit8 KV write for Hopper (sm_90a): quantize the new K and
// V rows and scatter their codes and scales into the paged pool, in one
// launch.
//
// Replaces no TPU kernel.  The JAX package writes the pool with XLA's
// fused elementwise ops and a scatter; the port's plain version
// (kernels/ref.py quantize_kv and two index writes each for K and V) is
// ~200 PyTorch launches a layer and forward at the serving batch, and the
// host's time to enqueue them set the pace of continuous serving.  This
// kernel does the same work in one launch.
//
// What it computes, bit for bit as the plain version on the card: for
// each (token, KV head) row of K and of V and each group of Dh / Gs
// columns, the absmax; the scale amax * (1 / 64), clamped below at 1e-30
// (NaN stays NaN), rounded up to a power of two by the CUDA math
// library's log2f / ceilf / exp2f (PyTorch's own CUDA log2 / ceil / exp2
// for float), clamped again: the absmax_po2 grid of core/quant.py
// group_scales; each element divided by its scale (IEEE division), float32
// subnormals flushed to zero and encoded to posit8 (formats.cuh,
// Posit<8, 0>::encode); the scale stored as bf16 by the same conversion
// PyTorch's CUDA cast uses (__float2bfloat16_rn).  A NaN in a group makes
// its scale NaN and every code of the group NaR, as torch.amax does.
//
// Addressing, from the page table in the kernel itself: a decode token
// of request b lands at slot positions[b] % page of pool page
// page_table[b, positions[b] / page]; token j of a chunk of request b
// (chunks are whole pages from a page-aligned start) lands at slot
// j % page of logical block start[b] / page + j / page, and a block past
// the table's last column goes to the parking page 0.  Rows that map to
// one slot (parked rows, pad blocks) all write it, in no set order, as
// the plain version's index writes do.
//
// What bounds it on this card: nothing the card measures.  At the
// serving shapes it reads 0.5-1 MB and writes half of that (a bytes
// bound of 0.2-0.5 us); the launch (~2-3 us) and, before this kernel,
// the host's enqueue of ~200 launches (~4 ms) are the cost.  The design
// keeps the kernel to one pass over its bytes with no shared memory: a
// warp per (token, head, K|V) row, each lane `VEC` adjacent elements (8
// or 16 bytes in, 4 bytes of codes out) of a step of 32 * VEC columns,
// the group maxima reduced in registers and by warp shuffles.  The
// layout (`VEC`, `lanes`, `eg`, `span`) comes from the wrapper, chosen
// from Dh and Gs (kernels/kv_write.py write_layout): a group of g
// columns covers `span` whole steps across the warp (g a multiple of
// 32 * VEC, or the whole row), `lanes` adjacent lanes of one step
// (VEC <= g < 32 * VEC, g / VEC a power of two), or `eg` elements of
// one lane (g < VEC).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "formats.cuh"

namespace {

using namespace xrnpe;

constexpr int WARPS = 4;   // rows (warps) a block

struct Args {
  const void* src[2];   // K, V: (B, C, Kh, Dh) with rows of Dh contiguous
  long long sb[2];      // element stride between requests
  long long sc[2];      // element stride between a request's tokens
  uint8_t* codes[2];    // pool (P, page, Kh, Dh)
  __nv_bfloat16* scale[2];   // pool (P, page, Kh, Gs)
  const int* table;     // (B, NP) rows `pt_stride` apart
  const int* where;     // decode: positions (B,); chunk: starts (B,)
  int chunk, n_req, c, kh, dh, gs, page, np, pt_stride;
  int lanes, eg, span;
};

template <int V>
__device__ __forceinline__ void load_row(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else if constexpr (V == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x; x[1] = u.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&x)[V]) {
  // bf16 -> f32 is exact: the high half of the float's bits
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(u.x << 16); x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16); x[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (V == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    x[0] = __uint_as_float(u << 16); x[1] = __uint_as_float(u & 0xffff0000u);
  } else {
    x[0] = __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p))
                           << 16);
  }
}

template <int V>
__device__ __forceinline__ void store_codes(uint8_t* p, const uint32_t (&q)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(q[0] | (q[1] << 8));
  } else {
    *p = static_cast<uint8_t>(q[0]);
  }
}

// The scale of a group whose |x| maximum has the bits `amax` (a NaN's
// bits exceed +Inf's, so an integer max keeps it): PyTorch's ops one for
// one -- it divides by the host scalar 64 (posit8's largest finite
// value) as a product with its reciprocal; clamp(min) keeps NaN.
__device__ __forceinline__ float po2_scale(uint32_t amax) {
  float s = __fmul_rn(__uint_as_float(amax), 0.015625f);
  s = s < 1e-30f ? 1e-30f : s;
  s = exp2f(ceilf(log2f(s)));
  return s < 1e-30f ? 1e-30f : s;
}

template <typename T, int V>
__global__ void __launch_bounds__(WARPS * 32) kv_write_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int which = blockIdx.y;   // 0: K, 1: V
  const int n = row / a.kh;       // token (b, j) = (n / c, n % c)
  if (n >= a.n_req * a.c) return;   // warp-uniform
  const int h = row - n * a.kh;
  const int b = n / a.c, j = n - b * a.c;
  int pg, slot;
  if (a.chunk) {
    const int blk = a.where[b] / a.page + j / a.page;
    pg = blk < a.np ? a.table[static_cast<long long>(b) * a.pt_stride + blk] : 0;
    slot = j % a.page;
  } else {
    const int pos = a.where[b];
    pg = a.table[static_cast<long long>(b) * a.pt_stride + pos / a.page];
    slot = pos % a.page;
  }
  const long long dst = (static_cast<long long>(pg) * a.page + slot) * a.kh + h;
  const T* x = static_cast<const T*>(a.src[which]) + b * a.sb[which] + j * a.sc[which] +
               static_cast<long long>(h) * a.dh;
  uint8_t* out = a.codes[which] + dst * a.dh;
  __nv_bfloat16* sout = a.scale[which] + dst * a.gs;
  const int g = a.dh / a.gs;
  const int steps = (a.dh + 32 * V - 1) / (32 * V);
  for (int t0 = 0; t0 < steps; t0 += a.span) {
    float xv[V];
    uint32_t m[V];
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = 0u;
    for (int t = t0; t < t0 + a.span; ++t) {
      const int e = (t * 32 + lane) * V;
      if (e < a.dh) {
        load_row<V>(x + e, xv);
#pragma unroll
        for (int i = 0; i < V; ++i) m[i] = max(m[i], __float_as_uint(xv[i]) & 0x7fffffffu);
      }
    }
    // groups of `eg` (1, 2 or 4) elements inside a lane, then of
    // `lanes` lanes; after both, each element's m is its group's absmax
    if constexpr (V >= 2) {
      if (a.eg >= 2) {
        uint32_t p[V];
#pragma unroll
        for (int i = 0; i < V; ++i) p[i] = max(m[i], m[i ^ 1]);
#pragma unroll
        for (int i = 0; i < V; ++i) m[i] = p[i];
      }
    }
    if constexpr (V >= 4) {
      if (a.eg >= 4) {
        uint32_t p[V];
#pragma unroll
        for (int i = 0; i < V; ++i) p[i] = max(m[i], m[i ^ 2]);
#pragma unroll
        for (int i = 0; i < V; ++i) m[i] = p[i];
      }
    }
    for (int o = 1; o < a.lanes; o <<= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) m[i] = max(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
    }
    float s[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[i] = po2_scale(m[i]);
      const int ge = (t0 * 32 + lane) * V + i;   // a group's first column stores its scale
      if (ge < a.dh && ge % g == 0) sout[ge / g] = __float2bfloat16_rn(s[i]);
    }
    for (int t = t0; t < t0 + a.span; ++t) {
      const int e = (t * 32 + lane) * V;
      if (e >= a.dh) continue;
      if (a.span > 1) load_row<V>(x + e, xv);
      uint32_t q[V];
#pragma unroll
      for (int i = 0; i < V; ++i) q[i] = Posit<8, 0>::encode(__fdiv_rn(xv[i], s[i]));
      store_codes<V>(out + e, q);
    }
  }
}

template <typename T>
int launch(const Args& a, int vec, cudaStream_t stream) {
  const int rows = a.n_req * a.c * a.kh;
  const dim3 grid((rows + WARPS - 1) / WARPS, 2);
  if (vec == 4) {
    kv_write_kernel<T, 4><<<grid, WARPS * 32, 0, stream>>>(a);
  } else if (vec == 2) {
    kv_write_kernel<T, 2><<<grid, WARPS * 32, 0, stream>>>(a);
  } else if (vec == 1) {
    kv_write_kernel<T, 1><<<grid, WARPS * 32, 0, stream>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K and V of `n_req` requests x `c` tokens (decode: c == 1) quantized and
// written into the pool in place; `chunk` selects the chunk addressing
// (`where` holds starts) over the decode one (`where` holds positions).
// `f32`: the rows are float32, else bfloat16.  `vec`, `lanes`, `eg` and
// `span` are write_layout(dh, gs) of the wrapper.  Returns the launch's
// CUDA error.
extern "C" int paged_kv_write(const void* k, const void* v, void* k_codes, void* v_codes,
                              void* k_scale, void* v_scale, const void* page_table,
                              const void* where, int chunk, int n_req, int c, int kh,
                              int dh, int gs, int page, int np, int pt_stride, int k_sb,
                              int k_sc, int v_sb, int v_sc, int f32, int vec, int lanes,
                              int eg, int span, void* stream) {
  if (n_req * c == 0) return 0;
  Args a;
  a.src[0] = k;
  a.src[1] = v;
  a.sb[0] = k_sb;
  a.sb[1] = v_sb;
  a.sc[0] = k_sc;
  a.sc[1] = v_sc;
  a.codes[0] = static_cast<uint8_t*>(k_codes);
  a.codes[1] = static_cast<uint8_t*>(v_codes);
  a.scale[0] = static_cast<__nv_bfloat16*>(k_scale);
  a.scale[1] = static_cast<__nv_bfloat16*>(v_scale);
  a.table = static_cast<const int*>(page_table);
  a.where = static_cast<const int*>(where);
  a.chunk = chunk;
  a.n_req = n_req;
  a.c = c;
  a.kh = kh;
  a.dh = dh;
  a.gs = gs;
  a.page = page;
  a.np = np;
  a.pt_stride = pt_stride;
  a.lanes = lanes;
  a.eg = eg;
  a.span = span;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(a, vec, st) : launch<__nv_bfloat16>(a, vec, st);
}
