// GQA attention straight from a posit8 KV cache, for Hopper (sm_90a):
// one-token decode over a contiguous cache, one-token decode over a
// paged pool, and chunk prefill over a paged pool.
//
// Replaces, in src/repro/kernels/flash_decode.py:
//   flash_decode_kernel        <- flash_decode_pallas (static decode),
//   paged_flash_decode_kernel  <- paged_flash_decode_pallas (the
//                                 continuous engine's decode),
//   paged_flash_prefill_kernel <- paged_flash_prefill_pallas (its
//                                 pages-context chunk prefill).
//
// The math is the TPU kernels', step for step, and lives in ONE device
// function, online_softmax_step, the CUDA form of the reference's single
// _online_softmax_step: the three kernels differ only in where a KV block
// lies in memory and which query rows a block holds.  A KV block of `blk`
// slots is dequantized in shared memory (posit8 decode times the bf16
// scale; Gs = Dh / group scale columns, Gs == 1 one per token and head),
// scored against R query rows (dot, times 1/sqrt(Dh), optional tanh
// softcap), masked with the -1e30 sentinel and folded into an online
// softmax (m, l, acc in f32).  Row r sees the slots
// pad_lo <= kpos <= hz[r], its horizon hz[r] = start + (row0 + r) / G:
//   - decode: R = G rows of one (b, kv-head), start = the position, row0 0;
//   - prefill: rows r = qi*G + gi of a chunk at start .. start+C-1, so a
//     row's horizon is start + qi.
// Because every row's arithmetic is the same whatever R, row0 and the
// block's address, paged decode equals contiguous decode bitwise when
// page == blk, and a C = 1 prefill chunk equals paged decode bitwise.
//
// Memory layouts: contiguous codes (B, T, Kh, Dh) uint8 and scales
// (B, T, Kh, Gs) bf16; a pool (P, page, Kh, Dh) / (P, page, Kh, Gs) with a
// page table (B, NP) int32 mapping a request's logical block t to its
// page.  Each block reads its own positions / start and page ids (what
// the TPU prefetched as scalars) and walks only its live blocks
// (t <= horizon / blk): no page past the live prefix is ever read.  Like
// the TPU grid, the walk stops at the table's last column: rows of a
// padded final chunk whose horizon lies past it are never read back.
//
// What bounds them on this card.  Decode: bytes (one byte per cached
// element plus its share of a scale, read once; a few flops per byte).
// Prefill: operations -- a 256-token chunk with G = 7 is 1792 query rows
// per kv head over the whole live prefix, ~0.7 GFLOP in f32 against
// ~0.2 MB of codes.  Design: 128 threads per block; decode one block per
// (b, kv-head), prefill one block per (b, kv-head, tile of 32 query rows)
// (the TPU held all C*G rows' accumulators in VMEM, 448 KB at C = 256,
// twice a block's shared memory); a loop over the live KV blocks inside
// the block (the TPU's sequential grid axis); the dequantized K and V
// block in shared memory (K rows padded by one float against bank
// conflicts); one warp per query row for the softmax statistics.  Each
// prefill row tile dequantizes the pages again; splitting KV across
// blocks, tensor cores and keeping dequantized pages resident are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "formats.cuh"

namespace {

using xrnpe::Posit;

constexpr int NT = 128;
constexpr float NEG = -1e30f;
constexpr int PREFILL_ROWS = 32;  // query rows per paged-prefill block

// Shared memory of one block: R query rows against one KV block of blk slots.
struct Smem {
  float* qs;    // (R, Dh) queries
  float* acc;   // (R, Dh)
  float* kb;    // (blk, Dh + 1) dequantized K
  float* vb;    // (blk, Dh) dequantized V
  float* sb;    // (R, blk) scores, then p
  float* mrow;  // (R,) running max
  float* lrow;  // (R,) normalizer
  float* arow;  // (R,) alpha of the current block
  int* hz;      // (R,) last visible slot of each row
};

__device__ __forceinline__ Smem carve(float* sm, int R, int Dh, int blk) {
  Smem s;
  s.qs = sm;
  s.acc = s.qs + R * Dh;
  s.kb = s.acc + R * Dh;
  s.vb = s.kb + blk * (Dh + 1);
  s.sb = s.vb + blk * Dh;
  s.mrow = s.sb + R * blk;
  s.lrow = s.mrow + R;
  s.arow = s.lrow + R;
  s.hz = reinterpret_cast<int*>(s.arow + R);
  return s;
}

// Bytes of dynamic shared memory for R rows.
int smem_bytes(int R, int Dh, int blk) {
  return static_cast<int>(sizeof(float)) *
         (2 * R * Dh + blk * (Dh + 1) + blk * Dh + R * blk + 4 * R);
}

// acc = 0, m = -1e30, l = 0 and the horizon start + (row0 + r) / G of R
// rows (the queries are loaded by the caller).
__device__ __forceinline__ void init_rows(float* sm, int R, int Dh, int blk,
                                          int start, int row0, int G) {
  const Smem s = carve(sm, R, Dh, blk);
  for (int i = threadIdx.x; i < R * Dh; i += NT) s.acc[i] = 0.0f;
  for (int r = threadIdx.x; r < R; r += NT) {
    s.mrow[r] = NEG;
    s.lrow[r] = 0.0f;
    s.hz[r] = start + (row0 + r) / G;
  }
}

// One online-softmax step of R query rows over one KV block: the single
// copy of the math.  kc/ks/vc/vs point at slot 0 of the block for this
// block's KV head; slot j's codes are at kc + j*ld_code and its scales at
// ks + j*ld_scale.  The block holds logical slots kpos0 .. kpos0+blk-1.
// `sm` is the block's shared memory (see carve).  Starts and ends with
// all threads past a barrier.
__device__ __forceinline__ void online_softmax_step(
    float* sm, int R, int Dh, int Gs, int blk,
    const uint8_t* __restrict__ kc, const __nv_bfloat16* __restrict__ ks,
    const uint8_t* __restrict__ vc, const __nv_bfloat16* __restrict__ vs,
    size_t ld_code, size_t ld_scale, int kpos0, int pad_lo, float softcap,
    float scale) {
  const Smem s = carve(sm, R, Dh, blk);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ldk = Dh + 1;
  const int dg = Dh / Gs;
  for (int i = tid; i < blk * Dh; i += NT) {
    const int j = i / Dh, d = i % Dh;
    s.kb[j * ldk + d] = Posit<8, 0>::decode(__ldg(kc + j * ld_code + d)) *
                        __bfloat162float(__ldg(ks + j * ld_scale + d / dg));
    s.vb[j * Dh + d] = Posit<8, 0>::decode(__ldg(vc + j * ld_code + d)) *
                       __bfloat162float(__ldg(vs + j * ld_scale + d / dg));
  }
  __syncthreads();
  for (int i = tid; i < R * blk; i += NT) {
    const int r = i / blk, j = i % blk;
    float sc = 0.0f;
    for (int d = 0; d < Dh; ++d) sc = fmaf(s.qs[r * Dh + d], s.kb[j * ldk + d], sc);
    sc *= scale;
    if (softcap > 0.0f) sc = tanhf(sc / softcap) * softcap;
    const int kpos = kpos0 + j;
    if (kpos > s.hz[r] || kpos < pad_lo) sc = NEG;
    s.sb[i] = sc;
  }
  __syncthreads();
  for (int r = warp; r < R; r += NT / 32) {
    float mx = s.mrow[r];
    for (int j = lane; j < blk; j += 32) mx = fmaxf(mx, s.sb[r * blk + j]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int j = lane; j < blk; j += 32) {
      const float p = expf(s.sb[r * blk + j] - mx);
      s.sb[r * blk + j] = p;
      sum += p;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float alpha = expf(s.mrow[r] - mx);
      s.lrow[r] = s.lrow[r] * alpha + sum;
      s.mrow[r] = mx;
      s.arow[r] = alpha;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * Dh; i += NT) {
    const int r = i / Dh, d = i % Dh;
    float pv = 0.0f;
    for (int j = 0; j < blk; ++j) pv = fmaf(s.sb[r * blk + j], s.vb[j * Dh + d], pv);
    s.acc[i] = s.acc[i] * s.arow[r] + pv;
  }
  __syncthreads();
}

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
  const Smem s = carve(sm, G, Dh, blk);
  const size_t qoff = ((size_t)b * Kh + h) * G * Dh;
  for (int i = threadIdx.x; i < G * Dh; i += NT) s.qs[i] = q[qoff + i];
  init_rows(sm, G, Dh, blk, pos, 0, G);
  const int pad_b = pad != nullptr ? pad[b] : 0;
  __syncthreads();
  const size_t ld_code = (size_t)Kh * Dh, ld_scale = (size_t)Kh * Gs;
  for (int t = pad_b / blk; t <= pos / blk; ++t) {
    const size_t slot0 = ((size_t)b * T + (size_t)t * blk) * Kh + h;
    online_softmax_step(sm, G, Dh, Gs, blk, kc + slot0 * Dh, ks + slot0 * Gs,
                        vc + slot0 * Dh, vs + slot0 * Gs, ld_code, ld_scale,
                        t * blk, pad_b, softcap, scale);
  }
  for (int i = threadIdx.x; i < G * Dh; i += NT) out[qoff + i] = s.acc[i] / s.lrow[i / Dh];
}

__global__ void __launch_bounds__(NT)
paged_flash_decode_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kc,
                          const __nv_bfloat16* __restrict__ ks,
                          const uint8_t* __restrict__ vc,
                          const __nv_bfloat16* __restrict__ vs,
                          const int* __restrict__ page_table,
                          const int* __restrict__ positions, float* __restrict__ out,
                          int NP, int page, int Kh, int G, int Dh, int Gs,
                          float softcap, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, h = blockIdx.y;
  const Smem s = carve(sm, G, Dh, page);
  const size_t qoff = ((size_t)b * Kh + h) * G * Dh;
  const int pos = positions[b];
  for (int i = threadIdx.x; i < G * Dh; i += NT) s.qs[i] = q[qoff + i];
  init_rows(sm, G, Dh, page, pos, 0, G);
  __syncthreads();
  const size_t ld_code = (size_t)Kh * Dh, ld_scale = (size_t)Kh * Gs;
  for (int t = 0; t <= min(pos / page, NP - 1); ++t) {
    const size_t slot0 = (size_t)page_table[(size_t)b * NP + t] * page * Kh + h;
    online_softmax_step(sm, G, Dh, Gs, page, kc + slot0 * Dh, ks + slot0 * Gs,
                        vc + slot0 * Dh, vs + slot0 * Gs, ld_code, ld_scale,
                        t * page, 0, softcap, scale);
  }
  for (int i = threadIdx.x; i < G * Dh; i += NT) out[qoff + i] = s.acc[i] / s.lrow[i / Dh];
}

// q and out are (B, C, Kh, G, Dh): row r = qi*G + gi of (b, h) lies at
// ((b*C + qi)*Kh + h)*G + gi.
__device__ __forceinline__ size_t prefill_row(int b, int h, int row, int C, int Kh,
                                              int G) {
  const int qi = row / G, gi = row % G;
  return (((size_t)b * C + qi) * Kh + h) * G + gi;
}

__global__ void __launch_bounds__(NT)
paged_flash_prefill_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kc,
                           const __nv_bfloat16* __restrict__ ks,
                           const uint8_t* __restrict__ vc,
                           const __nv_bfloat16* __restrict__ vs,
                           const int* __restrict__ page_table,
                           const int* __restrict__ start, float* __restrict__ out,
                           int C, int NP, int page, int Kh, int G, int Dh, int Gs,
                           float softcap, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, h = blockIdx.y, row0 = blockIdx.z * PREFILL_ROWS;
  const int R = min(PREFILL_ROWS, C * G - row0);
  const Smem s = carve(sm, R, Dh, page);
  for (int i = threadIdx.x; i < R * Dh; i += NT) {
    const int r = i / Dh, d = i % Dh;
    s.qs[i] = q[prefill_row(b, h, row0 + r, C, Kh, G) * Dh + d];
  }
  const int st = start[b];
  init_rows(sm, R, Dh, page, st, row0, G);
  const int last = st + (row0 + R - 1) / G;  // horizon of the tile's last row
  __syncthreads();
  const size_t ld_code = (size_t)Kh * Dh, ld_scale = (size_t)Kh * Gs;
  for (int t = 0; t <= min(last / page, NP - 1); ++t) {
    const size_t slot0 = (size_t)page_table[(size_t)b * NP + t] * page * Kh + h;
    online_softmax_step(sm, R, Dh, Gs, page, kc + slot0 * Dh, ks + slot0 * Gs,
                        vc + slot0 * Dh, vs + slot0 * Gs, ld_code, ld_scale,
                        t * page, 0, softcap, scale);
  }
  for (int i = threadIdx.x; i < R * Dh; i += NT) {
    const int r = i / Dh, d = i % Dh;
    out[prefill_row(b, h, row0 + r, C, Kh, G) * Dh + d] = s.acc[i] / s.lrow[r];
  }
}

// Allows `smem` bytes of dynamic shared memory for `kernel` when above the
// default 48 KB; returns the CUDA error code.
template <typename K>
int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

// Each entry point returns cudaGetLastError() after the launch.

// `pad` may be null.
extern "C" int flash_decode(const void* q, const void* k_codes, const void* k_scale,
                            const void* v_codes, const void* v_scale, const void* pad,
                            void* out, int B, int T, int Kh, int G, int Dh, int Gs,
                            int pos, int blk, float softcap, float scale,
                            void* stream) {
  const int smem = smem_bytes(G, Dh, blk);
  if (const int err = allow_smem(flash_decode_kernel, smem)) return err;
  flash_decode_kernel<<<dim3(B, Kh), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k_codes),
      static_cast<const __nv_bfloat16*>(k_scale), static_cast<const uint8_t*>(v_codes),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(pad),
      static_cast<float*>(out), T, Kh, G, Dh, Gs, pos, blk, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int paged_flash_decode(const void* q, const void* k_codes, const void* k_scale,
                                  const void* v_codes, const void* v_scale,
                                  const void* page_table, const void* positions,
                                  void* out, int B, int NP, int page, int Kh, int G,
                                  int Dh, int Gs, float softcap, float scale,
                                  void* stream) {
  const int smem = smem_bytes(G, Dh, page);
  if (const int err = allow_smem(paged_flash_decode_kernel, smem)) return err;
  paged_flash_decode_kernel<<<dim3(B, Kh), NT, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k_codes),
      static_cast<const __nv_bfloat16*>(k_scale), static_cast<const uint8_t*>(v_codes),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(positions), static_cast<float*>(out), NP, page, Kh, G, Dh,
      Gs, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int paged_flash_prefill(const void* q, const void* k_codes, const void* k_scale,
                                   const void* v_codes, const void* v_scale,
                                   const void* page_table, const void* start, void* out,
                                   int B, int C, int NP, int page, int Kh, int G, int Dh,
                                   int Gs, float softcap, float scale, void* stream) {
  const int smem = smem_bytes(PREFILL_ROWS, Dh, page);
  if (const int err = allow_smem(paged_flash_prefill_kernel, smem)) return err;
  const dim3 grid(B, Kh, (C * G + PREFILL_ROWS - 1) / PREFILL_ROWS);
  paged_flash_prefill_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k_codes),
      static_cast<const __nv_bfloat16*>(k_scale), static_cast<const uint8_t*>(v_codes),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(start), static_cast<float*>(out), C, NP, page, Kh, G, Dh,
      Gs, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}
