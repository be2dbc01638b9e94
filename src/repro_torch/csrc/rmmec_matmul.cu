// RMMEC packed mixed-precision matrix product for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmmec_matmul.py:127, rmmec_matmul_pallas
// (pallas_call at :154), the TPU kernel run for every packed projection of
// the serving plane.
//
// Computes out (M, N) f32 = x (M, K) @ W, where W is stored as packed
// low-bit codes: int32 words (Kp, Np / per) holding per = 32 / bits
// codes each, little-endian within the word, with dequant scales
// (G, Np) f32 and a block mask (mask_rows, mask_cols) int32.  G == 1 is
// per-channel (applied once to the output); G > 1 gives one scale per
// K-group of `group` rows (applied to the decoded weight inside K).  Kp >= K
// and Np >= N are whatever the packer padded to: the stacked-layer layout
// pads K only to the group and N only to the word, the 2-D layout pads both
// to kernel blocks; the kernels read K rows and guard every edge themselves.
//
// What bounds it on this card.  At decode (M = 8, a batch of rows) bytes:
// the packed words, 0.5 or 1 byte a weight, ~8.4 MB for qwen2-0.5b's seven
// projections of a layer, ~2.5 us at 3.35 TB/s; with one block per 64 output
// columns (2 to 76 blocks) the card is mostly idle and each block waits on
// one long chain of loads, so the design splits K across blocks (split-K,
// below) and puts every first load of a block in flight at once.  At
// prefill (M = 1024) operations: 2*M*K*N, ~31 us for a layer on the bf16
// tensor cores against ~0.46 ms of f32 FMA, so the design decodes codes of
// <= 8 bits to bf16 and multiplies on the tensor cores, decoding each weight
// tile once per block and chunk for 64 or 128 rows of x.
//
// Routes (chosen by the wrapper, kernels/rmmec_matmul.py, launch_plan):
//   - bf16 x with a format of <= 8 bits (the main path): the tensor-core
//     design below, split-K for M <= 16, and for larger M wgmma_kernel
//     (Hopper's wgmma fed by TMA, further down) where the operands suit TMA
//     and the shape is one it was measured faster at, tiles elsewhere;
//   - f32 x, or posit16 with any x: a sequential fmaf over K per output
//     element in f32 (posit16 carries 12 fraction bits, which bf16 cannot
//     hold): the streaming kernels for M <= 16 (every untied posit16
//     read-out at decode), simt_kernel above.
//
// The streaming route (M <= 16).  What bounds it: bytes.  A posit16 weight
// carries at most 32 FLOP for its 2 bytes at M = 16, under the ~20 FLOP a
// byte at which f32 FMA (67 TFLOP/s) meets 3.35 TB/s, so the read of the
// packed words is the bound (command-r's 12288 x 256000 read-out: 6.3 GB,
// 1.88 ms); near M = 16 instruction issue (16 FMAs a code) can bound it
// first.  The design:
//   - Parallelism from columns, never from K: each output is one thread's
//     sequential fmaf over all of K; no split-K.
//   - stream_kernel (N of 256 x SMs or more): a warp owns a strip of 32
//     columns (eight to a block) and walks K in steps of 128 / bits rows;
//     lane l loads one 16-byte piece of the step (8 posit16 codes, 16 of 8
//     bits, 32 of 4 bits), decodes it into the warp's rows in shared memory
//     (row stride 36 floats: no bank conflicts), and after a __syncwarp
//     sums column l over the step's rows for every row of x.  Loads run
//     two steps ahead in registers, issued from always-valid addresses so
//     that nothing waits on them before their step; warps never wait on
//     each other.
//   - stream_narrow_kernel (fewer columns, e.g. musicgen's 2048): a block
//     owns a strip of 8 .. 128 columns; its 256 threads decode chunks of up
//     to 256 rows together (a cp.async ring of six chunks, one barrier a
//     chunk) while thread c < bn sums column c, so the decode of many rows
//     runs beside the columns' sequential chains.
//   - The decode is a table lookup, made by the wrapper from the port's
//     codec (stream_table) and replicated per lane in shared memory (no bank
//     conflicts): formats of <= 8 bits one f32 a code (4 bits: a byte's
//     two); posit16 an entry (base, mul) per high byte of the code, whose
//     value bits are base + sx * mul (sx the code sign-extended; one IMAD,
//     no __clz, no conversion) wherever the regime run is <= 6; zero, NaR
//     and longer runs (|value| <= 2^-12 or >= 2^12) carry mul 0, which
//     sends them to Posit<16,1>::decode out of line.
//   - Bitwise simt_kernel's numbers: each output is a sequential fmaf over k
//     ascending from +0 of float(x) and the decoded weight times its group
//     scale (rounded to f32); 32-row steps are skipped where simt_kernel
//     gates its 64-column tile, simt_kernel's zero rows past K (a K that is
//     not a multiple of 32) add +0; the per-channel scale at the end.  So a
//     row's output is the same at M <= 16 and above.  No scratch, no
//     counters, one launch a call.
//
// The tensor-core design: one K-chunk partial and one ordered fold.
//   - K is cut into chunks of KC = 128 rows, boundaries from K alone.  A
//     chunk partial is a chain of mma.sync m16n8k16 (bf16 -> f32) over the
//     chunk's k16 steps in order, from zero.  A: x's rows as bf16 (zero past
//     M and past K).  B: the weight tile decoded exactly to bf16 (every code
//     of a format of <= 8 bits is a bf16 value; a 256-entry table per block,
//     made once per format by the wrapper), times the group scale where
//     there is one (a power of two from the packer, so still exact), once
//     per block and chunk into shared memory, read with ldmatrix.  Products
//     of bf16 values are exact in f32, so only the order of the sum differs
//     from the f32 plain version.
//   - Fold: the partials of an output element are added in chunk order with
//     __fadd_rn, starting from chunk 0's; then the per-channel scale with
//     __fmul_rn.  A chunk whose mask blocks are all 0 does no MMA and folds
//     as an exact zero partial on both routes.
//   - Split-K (M <= 16, decode): one block per (64-column N-tile, chunk):
//     98 blocks for qwen2's q and o, 532 for gate, up and down.  Each block
//     streams its packed words with 16-byte loads, decodes, runs its partial
//     and writes it to scratch; the last block to arrive for an N-tile (a
//     per-tile acq_rel counter, reset by that block) folds the tile's
//     partials and writes out.  One launch a call.
//   - Tiles (M > 16, prefill): one block per (BM x BN) output tile walks
//     the chunks in order, each into its own accumulator folded into the
//     running total at the chunk's end; later chunks' words and x tiles
//     arrive by cp.async while the current one is multiplied (a ring of
//     three slots, two chunks ahead) and chunk c+1's weights are decoded
//     between chunk c's k16 steps.  64 x 64 tiles of 8 warps, or 128 x 128
//     where those fill half the card.
//   - Hence, bitwise: a row's output is the same whatever M is, whatever
//     the other rows hold and whichever route runs it (a row keeps its place
//     in its 16-row MMA group, row r at r % 16; wgmma's k16 steps give
//     mma.sync's bits).  simt_kernel has the same property by its sequential
//     K loop.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#include "formats.cuh"
#include "mma.cuh"

namespace {

using namespace xrnpe;
using bf16 = __nv_bfloat16;

// ===========================================================================
// SIMT route (f32 x; posit16)
// ===========================================================================

constexpr int SIMT_BN = 64;
constexpr int SIMT_BK = 32;
constexpr int SIMT_THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class F, typename TX, int BM, int TM, int TN>
__global__ void __launch_bounds__(SIMT_THREADS)
simt_kernel(const TX* __restrict__ x, const uint32_t* __restrict__ w,
            const float* __restrict__ scales, const int* __restrict__ mask,
            float* __restrict__ out, int M, int K, int N, int Np, int group,
            int mk, int mn, int mask_cols) {
  constexpr int PER = 32 / F::BITS;
  constexpr int WCOLS = SIMT_BN / PER;  // words per tile row
  constexpr int TCOLS = SIMT_BN / TN;   // threads along N
  constexpr int TROWS = BM / TM;        // threads along M
  static_assert(TCOLS * TROWS == SIMT_THREADS, "thread tiling");
  constexpr uint32_t CODE_MASK = (1u << F::BITS) - 1u;

  __shared__ float xs[BM][SIMT_BK + 1];
  __shared__ float ws[SIMT_BK][SIMT_BN];

  const int tid = threadIdx.x;
  const int tx = tid % TCOLS;
  const int ty = tid / TCOLS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * SIMT_BN;
  const int nw = Np / PER;
  const int nend = min(n0 + SIMT_BN, Np);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += SIMT_BK) {
    const int kend = min(k0 + SIMT_BK, K);
    // block gating: every thread reaches the same verdict
    bool live = false;
    for (int kb = k0 / mk; kb <= (kend - 1) / mk && !live; ++kb)
      for (int nb = n0 / mn; nb <= (nend - 1) / mn; ++nb)
        if (mask[kb * mask_cols + nb] != 0) { live = true; break; }
    if (!live) continue;

    for (int i = tid; i < BM * SIMT_BK; i += SIMT_THREADS) {
      const int r = i / SIMT_BK, c = i % SIMT_BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? to_float(x[(size_t)gm * K + gk]) : 0.0f;
    }
    for (int i = tid; i < SIMT_BK * WCOLS; i += SIMT_THREADS) {
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
    for (int kk = 0; kk < SIMT_BK; ++kk) {
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

// M > 16 (M <= 16 streams): 64-row tiles
template <class F, typename TX>
cudaError_t launch_tiles(const Args& a) {
  const TX* x = static_cast<const TX*>(a.x);
  dim3 grid((a.N + SIMT_BN - 1) / SIMT_BN, (a.M + 63) / 64);
  simt_kernel<F, TX, 64, 4, 4><<<grid, SIMT_THREADS, 0, a.stream>>>(
      x, a.w, a.scales, a.mask, a.out, a.M, a.K, a.N, a.Np, a.group, a.mk,
      a.mn, a.mask_cols);
  return cudaGetLastError();
}

template <class F>
cudaError_t launch_format(const Args& a, int x_bf16) {
  return x_bf16 ? launch_tiles<F, __nv_bfloat16>(a) : launch_tiles<F, float>(a);
}


// ===========================================================================
// tensor-core route (bf16 x, formats of <= 8 bits)
// ===========================================================================

constexpr int KC = 128;           // K rows of a chunk
constexpr int LDX = KC + 8;       // row stride of a staged x tile (bf16)
constexpr int SPLIT_M = 16;       // most rows of the split-K route
constexpr int SPLIT_BN = 64;      // columns of a split-K N-tile
constexpr int SPLIT_THREADS = 128;
constexpr int FOLD_BATCH = 16;    // chunks whose partials load in one round trip

// Route codes shared with kernels/rmmec_matmul.py (ROUTES).
enum Route {
  ROUTE_SIMT = 0, ROUTE_SPLIT_K = 1, ROUTE_TILE64 = 2, ROUTE_TILE128 = 3, ROUTE_STREAM = 4,
  ROUTE_WGMMA = 5
};

struct Operands {
  const bf16* x;
  const uint32_t* w;
  const float* scales;
  const int* mask;
  float* out;
  float* scratch;   // split-K: partials (chunks, M, tiles * SPLIT_BN)
  int* counters;    // split-K: one arrival count per N-tile, 0 between launches
  const uint32_t* table;  // the format's decode table (see Table)
  int M, K, N, Np, group, mk, mn, mask_cols;
};

// The block's copy of the format's decode table, made by the wrapper from
// the same decoders as formats.cuh's (kernels/rmmec_matmul.py, _table):
// 8-bit codes -> one bf16 each (in the low half); 4-bit formats: a byte (two
// codes) -> the two bf16 values, low code first.
// Loaded in two steps, so that other loads can be in flight beside it: the
// NT threads' registers first, then shared memory.
template <int NT>
struct Table {
  static_assert(256 % NT == 0 || NT % 256 == 0, "whole entries a thread");
  static constexpr int PER = NT >= 256 ? 1 : 256 / NT;
  uint32_t v[PER];
  __device__ __forceinline__ void load(const uint32_t* table) {
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (threadIdx.x + j * NT < 256) v[j] = __ldg(table + threadIdx.x + j * NT);
  }
  __device__ __forceinline__ void store(uint32_t* lut) const {
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (threadIdx.x + j * NT < 256) lut[threadIdx.x + j * NT] = v[j];
  }
};

// Does the chunk [k0, kend) x columns [n0, n1) touch a live mask block?
// Every thread reaches the same verdict.
__device__ __forceinline__ bool chunk_live(const Operands& op, int k0, int kend, int n0,
                                           int n1) {
  for (int kb = k0 / op.mk; kb <= (kend - 1) / op.mk; ++kb)
    for (int nb = n0 / op.mn; nb <= (n1 - 1) / op.mn; ++nb)
      if (op.mask[kb * op.mask_cols + nb] != 0) return true;
  return false;
}

// Four packed words of row k at word column wc (of nw); zeros past K and
// past the row's words.
__device__ __forceinline__ uint4 load_words(const Operands& op, int k, int wc, int nw,
                                            bool vec) {
  if (k >= op.K) return make_uint4(0u, 0u, 0u, 0u);
  const uint32_t* src = op.w + (size_t)k * nw + wc;
  if (vec && wc + 3 < nw) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = wc + e < nw ? __ldg(src + e) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Decodes four words of row k, whose first code is column n, into 4 * PER
// bf16 values, pairs[i] holding columns n + 2i (low half) and n + 2i + 1:
// exact table values, times the row's group scale where there is one.
// Entry e of the table is at lut[e << LS] (LS > 0: interleaved copies, the
// caller's lut points at its lane's).
template <int BITS, int LS = 0>
__device__ __forceinline__ void decode_pairs(const Operands& op, const uint32_t* lut,
                                             uint4 words, int k, int n,
                                             uint32_t (&pairs)[64 / BITS]) {
  constexpr int PER = 32 / BITS;
  constexpr uint32_t B = 0xffu << LS;
  const uint32_t w4[4] = {words.x, words.y, words.z, words.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (BITS == 8) {
      const uint32_t c = w4[e];
      pairs[2 * e] = lut[(c << LS) & B] | (lut[(c >> (8 - LS)) & B] << 16);
      pairs[2 * e + 1] = lut[(c >> (16 - LS)) & B] | (lut[(c >> (24 - LS)) & B] << 16);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        pairs[4 * e + b] =
            lut[(8 * b >= LS ? w4[e] >> (8 * b - LS) : w4[e] << (LS - 8 * b)) & B];
    }
  }
  if (op.group > 0) {
    const float* srow = op.scales + (size_t)(k / op.group) * op.Np;
#pragma unroll
    for (int i = 0; i < 2 * PER; ++i) {
      const int c = n + 2 * i;
      const float s0 = k < op.K && c < op.Np ? srow[c] : 0.0f;
      const float s1 = k < op.K && c + 1 < op.Np ? srow[c + 1] : 0.0f;
      const float v0 = __uint_as_float((pairs[i] & 0xffffu) << 16);
      const float v1 = __uint_as_float(pairs[i] & 0xffff0000u);
      pairs[i] = pack2(__float2bfloat16_rn(__fmul_rn(v0, s0)),
                       __float2bfloat16_rn(__fmul_rn(v1, s1)));
    }
  }
}

// decode_pairs of four words of row k (first code: column n) into `dst`.
template <int BITS>
__device__ __forceinline__ void decode_words(const Operands& op, const uint32_t* lut,
                                             uint4 words, int k, int n, bf16* dst) {
  constexpr int PER = 32 / BITS;
  uint32_t pairs[2 * PER];
  decode_pairs<BITS>(op, lut, words, k, n, pairs);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < PER / 2; ++i)
    d[i] = make_uint4(pairs[4 * i], pairs[4 * i + 1], pairs[4 * i + 2], pairs[4 * i + 3]);
}

// Stages x rows m0 .. m0+ROWS-1, columns k0 .. k0+KC-1 as bf16 into `xs`
// (stride LDX), zeros past M and past K, 16 bytes a piece: cp.async where
// x's rows are 16-byte aligned (`vec`), plain loads otherwise.  NT threads.
template <int ROWS, int NT>
__device__ __forceinline__ void stage_x(const Operands& op, bf16* xs, int m0, int k0, bool vec) {
  constexpr int PIECES = KC / 8;
  static_assert(ROWS * PIECES % NT == 0, "whole steps");
#pragma unroll
  for (int j = 0; j < ROWS * PIECES / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / PIECES, c = (i % PIECES) * 8, m = m0 + r, k = k0 + c;
    bf16* dst = xs + r * LDX + c;
    if (m >= op.M || k >= op.K) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {  // K % 8 == 0: a piece is wholly inside K
      cp_async16(dst, op.x + (size_t)m * op.K + k);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = k + e < op.K ? op.x[(size_t)m * op.K + k + e] : __float2bfloat16_rn(0.0f);
    }
  }
}

// One k16 step of a warp's part of a chunk partial: acc[MT][NT] (16 x 8 MMA
// tiles) += x rows xr0 .. (xs) times weight columns wc0 .. (ws, stride LDW).
template <int MT, int NT, int LDW>
__device__ __forceinline__ void mma_step(uint32_t xb, uint32_t wb, int xr0, int wc0, int ks,
                                         float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x % 32;
  const int vrow = ((lane / 8) % 2) * 8 + lane % 8;
  uint32_t a[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    ldmatrix_x4(a[mt], xb + ((xr0 + mt * 16 + lane % 16) * LDX + ks * 16 + (lane / 16) * 8) * 2);
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, wb + ((ks * 16 + vrow) * LDW + wc0 + nt * 8 + (lane / 16) * 8) * 2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
      mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
    }
  }
}

// A warp's part of a chunk partial: the chunk's first nks k16 steps in
// order.  side(ks) runs after step ks (other work to hide the MMAs' latency
// behind); a full chunk unrolls.
template <int MT, int NT, int LDW, class Side>
__device__ __forceinline__ void chunk_mma(const bf16* xs, const bf16* ws, int xr0, int wc0,
                                          int nks, float (&acc)[MT][NT][4], Side side) {
  const uint32_t xb = smem_addr(xs), wb = smem_addr(ws);
  if (nks == KC / 16) {
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      mma_step<MT, NT, LDW>(xb, wb, xr0, wc0, ks, acc);
      side(ks);
    }
  } else {
#pragma unroll 1
    for (int ks = 0; ks < nks; ++ks) {
      mma_step<MT, NT, LDW>(xb, wb, xr0, wc0, ks, acc);
      side(ks);
    }
  }
}

// One arrival on a split-K tile's counter (gpu scope, acquire-release: the
// block's partial, written before the barrier that precedes this, is visible
// to the block that sees the last count, and that block's reads after it see
// every partial); returns the count before it.
__device__ __forceinline__ int arrive(int* counter) {
  int prev;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(prev) : "l"(counter) : "memory");
  return prev;
}

// out[m, n] of a folded total: per-channel scale once, at the output.
__device__ __forceinline__ void store_out(const Operands& op, int m, int n, float v) {
  if (m < op.M && n < op.N) op.out[(size_t)m * op.N + n] = op.group == 0 ? __fmul_rn(v, op.scales[n]) : v;
}

// ---------------------------------------------------------------------------
// split-K: grid (tiles, chunks), one block per (64-column N-tile, chunk)
// ---------------------------------------------------------------------------

// 5 blocks an SM: qwen2's largest split-K grids (532 blocks) in one wave
template <int BITS>
__global__ void __launch_bounds__(SPLIT_THREADS, 5)
split_k_kernel(Operands op) {
  constexpr int PER = 32 / BITS, BN = SPLIT_BN, LDW = BN + 8;
  constexpr int WN = BN / 4, NTW = WN / 8;                // warp w: columns WN w .., n8 tiles
  constexpr int PIECES = BN / PER / 4;                    // 16-byte pieces of a tile row
  constexpr int NLOAD = KC * PIECES / SPLIT_THREADS;      // per thread
  __shared__ __align__(16) bf16 xs[SPLIT_M * LDX];
  __shared__ __align__(16) bf16 ws[KC * LDW];
  __shared__ uint32_t lut[256];
  __shared__ int last;
  const int tile = blockIdx.x, chunk = blockIdx.y, nchunks = gridDim.y;
  const int n0 = tile * BN, k0 = chunk * KC, kend = min(k0 + KC, op.K);
  const int nw = op.Np / PER, lane = threadIdx.x % 32, w = threadIdx.x / 32;
  float acc[1][NTW][4] = {};
  // every first load of the block in flight at once (words, x, the
  // per-channel scales the folding block applies, the table, the mask
  // verdict): one round trip to memory before the decode
  const bool vec = nw % 4 == 0 && (reinterpret_cast<uintptr_t>(op.w) & 15) == 0;
  uint4 raw[NLOAD];
#pragma unroll
  for (int i = 0; i < NLOAD; ++i) {
    const int p = threadIdx.x + i * SPLIT_THREADS, r = p / PIECES;
    raw[i] = load_words(op, k0 + r, n0 / PER + (p % PIECES) * 4, nw, vec);
  }
  stage_x<SPLIT_M, SPLIT_THREADS>(op, xs, 0, k0,
                                  op.K % 8 == 0 && (reinterpret_cast<uintptr_t>(op.x) & 15) == 0);
  cp_async_commit();
  const int fc = n0 + (threadIdx.x % (BN / 4)) * 4;  // the fold's columns of this thread
  float fscale[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) fscale[j] = op.group == 0 && fc + j < op.N ? op.scales[fc + j] : 1.0f;
  Table<SPLIT_THREADS> table;
  table.load(op.table);
  const bool live = chunk_live(op, k0, kend, n0, min(n0 + BN, op.Np));
  table.store(lut);
  if (live) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NLOAD; ++i) {
      const int p = threadIdx.x + i * SPLIT_THREADS, r = p / PIECES, c = (p % PIECES) * 4 * PER;
      decode_words<BITS>(op, lut, raw[i], k0 + r, n0 + c, ws + r * LDW + c);
    }
    cp_async_wait_all();
    __syncthreads();
    chunk_mma<1, NTW, LDW>(xs, ws, 0, WN * w, (kend - k0 + 15) / 16, acc, [](int) {});
  } else {
    cp_async_wait_all();  // a gated chunk: x's copy lands unused
  }
  const int g = lane / 4, t = lane % 4;
  if (nchunks == 1) {  // the partial is the total
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_out(op, g + 8 * (e / 2), n0 + WN * w + 8 * nt + 2 * t + (e & 1), acc[0][nt][e]);
    return;
  }
  const int lds = gridDim.x * BN;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = g + 8 * i;
      if (m < op.M)
        *reinterpret_cast<float2*>(op.scratch + ((size_t)chunk * op.M + m) * lds + n0 +
                                   WN * w + 8 * nt + 2 * t) =
            make_float2(acc[0][nt][2 * i], acc[0][nt][2 * i + 1]);
    }
  // the block's partial is out; the last block of the tile folds (the
  // acq_rel count orders the partials of every earlier block before its reads)
  __syncthreads();
  if (threadIdx.x == 0) last = arrive(op.counters + tile) == nchunks - 1;
  __syncthreads();
  if (!last) return;
  // the last block: fold the tile's partials in chunk order, four columns a
  // thread per step (the same four columns in every step)
  for (int e = threadIdx.x; e < op.M * (BN / 4); e += SPLIT_THREADS) {
    const int m = e / (BN / 4);
    const float* src = op.scratch + (size_t)m * lds + fc;
    const size_t stride = (size_t)op.M * lds;
    float4 tot = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c0 = 0; c0 < nchunks; c0 += FOLD_BATCH) {
      float4 v[FOLD_BATCH];
#pragma unroll
      for (int b = 0; b < FOLD_BATCH; ++b)
        if (c0 + b < nchunks)
          v[b] = __ldcg(reinterpret_cast<const float4*>(src + (c0 + b) * stride));
#pragma unroll
      for (int b = 0; b < FOLD_BATCH; ++b) {
        if (c0 + b >= nchunks) break;
        if (c0 + b == 0) {
          tot = v[b];
        } else {
          tot.x = __fadd_rn(tot.x, v[b].x);
          tot.y = __fadd_rn(tot.y, v[b].y);
          tot.z = __fadd_rn(tot.z, v[b].z);
          tot.w = __fadd_rn(tot.w, v[b].w);
        }
      }
    }
    const float tv[4] = {tot.x, tot.y, tot.z, tot.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (fc + j < op.N)
        op.out[(size_t)m * op.N + fc + j] = op.group == 0 ? __fmul_rn(tv[j], fscale[j]) : tv[j];
  }
  if (threadIdx.x == 0) op.counters[tile] = 0;
}

// ---------------------------------------------------------------------------
// tiles: grid (N tiles, M tiles), one block per BM x BN output tile
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int LDW = BN + 8;
  static constexpr int MT = BM / WARPS_M / 16;  // 16-row MMA tiles of a warp
  static constexpr int NT = BN / WARPS_N / 8;   // 8-column MMA tiles of a warp
  static constexpr int STAGES = 3;              // the cp.async ring of chunks
  static constexpr int FLAGS = 256;             // chunks whose verdicts are kept
  static constexpr int HEAD = 1024 + FLAGS;     // the table and the verdicts
  // shared memory: the head, the ring's x tiles and raw words, two decoded
  // weight tiles
  static constexpr int X_BYTES = BM * LDX * 2;
  static constexpr int W_BYTES = KC * LDW * 2;
  template <int BITS>
  __host__ __device__ static constexpr int raw_bytes() { return KC * (BN / (32 / BITS)) * 4; }
  template <int BITS>
  __host__ __device__ static constexpr int smem() {
    return HEAD + STAGES * (X_BYTES + raw_bytes<BITS>()) + 2 * W_BYTES;
  }
};

// Chunk c's words and x tile arrive in ring slot c % STAGES two chunks ahead
// of its MMAs (their copies issued after the barrier of chunk c - 2); its
// weights are decoded into ws[c % 2] one chunk ahead, a share per k16 step of
// chunk c - 1's MMAs.  So the copies, the decode and the MMAs overlap, and
// one barrier a chunk separates every write from its reads.
template <int BITS, class T>
__global__ void __launch_bounds__(T::THREADS)
tile_kernel(Operands op) {
  constexpr int BM = T::BM, BN = T::BN, WARPS_N = T::WARPS_N, S = T::STAGES;
  constexpr int NTH = T::THREADS, LDW = T::LDW, MT = T::MT, NT = T::NT;
  constexpr int PER = 32 / BITS, WPR = BN / PER, PIECES = WPR / 4;
  constexpr int RAW = T::template raw_bytes<BITS>();
  constexpr int KS = KC / 16;                // k16 steps of a chunk
  constexpr int DP = KC * PIECES / NTH;      // word pieces a thread stages and decodes
  constexpr int STEP = KS / DP;              // k16 steps between two of them
  static_assert(KC * PIECES % NTH == 0 && KS % DP == 0, "whole word pieces a k16 step");
  extern __shared__ __align__(16) uint8_t sm[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(sm);
  uint8_t* live_s = sm + 1024;  // chunk c < T::FLAGS live?
  bf16* xs = reinterpret_cast<bf16*>(sm + T::HEAD);
  uint32_t* raw = reinterpret_cast<uint32_t*>(sm + T::HEAD + S * T::X_BYTES);
  bf16* ws = reinterpret_cast<bf16*>(sm + T::HEAD + S * (T::X_BYTES + RAW));

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nw = op.Np / PER, n1 = min(n0 + BN, op.Np);
  const int nchunks = (op.K + KC - 1) / KC;
  const bool wvec = nw % 4 == 0 && (reinterpret_cast<uintptr_t>(op.w) & 15) == 0;
  const bool xvec = op.K % 8 == 0 && (reinterpret_cast<uintptr_t>(op.x) & 15) == 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  auto live_now = [&](int c) {
    return chunk_live(op, c * KC, min(c * KC + KC, op.K), n0, n1);
  };
  // after the first barrier: the verdicts of the first T::FLAGS chunks
  auto live = [&](int c) { return c < T::FLAGS ? live_s[c] != 0 : live_now(c); };
  // word piece j of chunk c into its ring slot (cp.async where aligned)
  auto stage_words = [&](int c, int j) {
    const int p = threadIdx.x + j * NTH;
    const int r = p / PIECES, wc = n0 / PER + (p % PIECES) * 4, k = c * KC + r;
    uint32_t* d = raw + (c % S) * (RAW / 4) + r * WPR + (p % PIECES) * 4;
    if (wvec && k < op.K && wc < nw)
      cp_async16(d, op.w + (size_t)k * nw + wc);
    else
      *reinterpret_cast<uint4*>(d) = load_words(op, k, wc, nw, false);
  };
  // chunk c's words and x tile into its ring slot; one cp.async group
  auto stage = [&](int c, bool copy) {
    if (copy) {
#pragma unroll
      for (int j = 0; j < DP; ++j) stage_words(c, j);
      stage_x<BM, NTH>(op, xs + (c % S) * (T::X_BYTES / 2), m0, c * KC, xvec);
    }
    cp_async_commit();
  };
  // piece j of chunk c's raw words -> its decoded bf16 tile ws[c % 2]
  auto decode = [&](int c, int j) {
    const int p = threadIdx.x + j * NTH;
    const int r = p / PIECES, col = (p % PIECES) * 4 * PER;
    decode_words<BITS>(op, lut,
                       *reinterpret_cast<const uint4*>(raw + (c % S) * (RAW / 4) + r * WPR +
                                                       (p % PIECES) * 4),
                       c * KC + r, n0 + col, ws + (c % 2) * (T::W_BYTES / 2) + r * LDW + col);
  };

  // the per-channel scales of this thread's output columns, loaded early
  float osc[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + (wn * NT + nt) * 8 + 2 * (lane % 4) + e;
      osc[nt][e] = op.group == 0 && n < op.N ? op.scales[n] : 1.0f;
    }
  // every first load in flight at once: chunks 0 and 1 (copied even where
  // gated, unused then), the table, the mask verdicts
  stage(0, true);
  stage(1, nchunks > 1);
  Table<NTH> table;
  table.load(op.table);
  for (int c = threadIdx.x; c < min(nchunks, T::FLAGS); c += NTH) live_s[c] = live_now(c);
  table.store(lut);
  cp_async_wait_group<1>();
  __syncthreads();  // the table, the verdicts and chunk 0's words
  if (live(0))
#pragma unroll
    for (int j = 0; j < DP; ++j) decode(0, j);

  float tot[MT][NT][4] = {};
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();
    // chunk c decoded, chunk c+1 staged; every warp is done with the MMAs of
    // chunk c-1 (ring slot (c+2) % S, ws[(c+1) % 2])
    __syncthreads();
    stage(c + 2, c + 2 < nchunks && live(c + 2));
    const bool next = c + 1 < nchunks && live(c + 1);
    auto side = [&](int ks) {
      if (next && ks % STEP == 0) decode(c + 1, ks / STEP);
    };
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
    int nks = 0;
    if (live(c)) {
      nks = (min(c * KC + KC, op.K) - c * KC + 15) / 16;
      chunk_mma<MT, NT, LDW>(xs + (c % S) * (T::X_BYTES / 2), ws + (c % 2) * (T::W_BYTES / 2),
                             wm * MT * 16, wn * NT * 8, nks, acc, side);
    }
#pragma unroll 1
    for (int ks = nks; ks < KS; ++ks) side(ks);  // the shares no k16 step took
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tot[mt][nt][e] = c == 0 ? acc[mt][nt][e] : __fadd_rn(tot[mt][nt][e], acc[mt][nt][e]);
  }
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + (wm * MT + mt) * 16 + g + 8 * (e / 2);
        const int n = n0 + (wn * NT + nt) * 8 + 2 * t + (e & 1);
        if (m < op.M && n < op.N)
          op.out[(size_t)m * op.N + n] =
              op.group == 0 ? __fmul_rn(tot[mt][nt][e], osc[nt][e & 1]) : tot[mt][nt][e];
      }
}

using Tile64 = Tile<64, 64, 4, 2>;
using Tile128 = Tile<128, 128, 2, 4>;

template <int BITS, class T>
cudaError_t launch_tile(const Operands& op, cudaStream_t stream) {
  constexpr int smem = T::template smem<BITS>();
  auto kernel = tile_kernel<BITS, T>;
  // once per kernel and process: the attribute call costs the host more
  // than a small launch
  static bool allowed = false;
  if (!allowed && smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  const dim3 grid((op.N + T::BN - 1) / T::BN, (op.M + T::BM - 1) / T::BM);
  kernel<<<grid, T::THREADS, smem, stream>>>(op);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_tensor(const Operands& op, int route, cudaStream_t stream) {
  if (route == ROUTE_SPLIT_K) {
    const dim3 grid((op.N + SPLIT_BN - 1) / SPLIT_BN, (op.K + KC - 1) / KC);
    split_k_kernel<BITS><<<grid, SPLIT_THREADS, 0, stream>>>(op);
    return cudaGetLastError();
  }
  if (route == ROUTE_TILE128) return launch_tile<BITS, Tile128>(op, stream);
  return launch_tile<BITS, Tile64>(op, stream);
}

// ===========================================================================
// streaming route (M <= 16: f32 x with any format, posit16 with any x)
// ===========================================================================

constexpr int STREAM_THREADS = 256;      // threads of a narrow block
constexpr int WARP_COLS = 32;            // columns of a warp strip (stream_kernel)
constexpr int WIDE_THREADS = 256;        // a stream_kernel block: eight warp strips
constexpr int WIDE_LDW = WARP_COLS + 4;  // row stride of a warp's decoded rows
constexpr int WIDE_BN = WIDE_THREADS / 32 * WARP_COLS;
constexpr int NARROW_MAX_BN = 128;       // widest block strip (stream_narrow_kernel)
constexpr int STREAM_FLOATS = 2048;      // decoded weights of a narrow chunk
constexpr int STREAM_MAX_ROWS = 256;     // K rows of a narrow chunk at most
constexpr int STREAM_X = 1024;           // x values of a narrow chunk at most
constexpr int STREAM_PAD = 4;            // floats after each decoded row
constexpr int STREAM_BUF = STREAM_FLOATS + STREAM_PAD * STREAM_MAX_ROWS;
constexpr int LIVE_SLOTS = 8;            // verdicts of a narrow chunk
constexpr int STREAM_SETS = 6;           // ring slots of the narrow kernel

// The decode table in shared memory: the wrapper's entries (stream_table),
// each replicated so that every lane of a phase reads its own copy
// (4-byte entries: 32 copies, 8-byte entries: 16).  posit16: an entry
// (base, mul) per high byte of the code; 8 bits: a value a code; 4 bits: a
// byte's two values, low nibble first.
template <int BITS>
struct StreamTable {
  static constexpr int ENTRIES = 256;
  static constexpr int WORDS = BITS == 8 ? 1 : 2;   // uint32 words an entry
  static constexpr int COPIES = 32 / WORDS;
  static constexpr int BYTES = ENTRIES * COPIES * WORDS * 4;
};

struct StreamOps {
  const void* x;
  const uint32_t* w;
  const float* scales;
  const int* mask;
  float* out;
  const uint32_t* table;
  int M, K, N, Np, group, mk, mn, mask_cols, bn;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Copies the wrapper's table into shared memory, each entry COPIES times,
// with NT threads: eight loads of a thread before their stores.
template <int BITS, int NT>
__device__ __forceinline__ void fill_table(uint32_t* lut, const uint32_t* table) {
  using T = StreamTable<BITS>;
  constexpr int PER4 = 4 / T::WORDS;  // entry copies in 16 bytes
  constexpr int N4 = T::BYTES / 16, BATCH = 8;
  for (int i0 = 0; i0 < N4; i0 += BATCH * NT) {
    uint2 v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + threadIdx.x + j * NT, e = i * PER4 / T::COPIES;
      if (i < N4) {
        if constexpr (T::WORDS == 1) {
          v[j].x = v[j].y = __ldg(table + e);
        } else {
          v[j] = __ldg(reinterpret_cast<const uint2*>(table) + e);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + threadIdx.x + j * NT;
      if (i < N4) {
        reinterpret_cast<uint4*>(lut)[i] = T::WORDS == 1 ? make_uint4(v[j].x, v[j].x, v[j].x, v[j].x)
                                                          : make_uint4(v[j].x, v[j].y, v[j].x, v[j].y);
      }
    }
  }
}

// A posit16 code the table does not cover, decoded in full (out of line: it
// is rare, and eight inlined copies a piece would crowd the instruction
// cache).
__device__ __noinline__ float posit16_full(uint32_t code) { return Posit<16, 1>::decode(code); }

// 8 bytes of shared memory at a shared-space address.
__device__ __forceinline__ uint2 lds_u2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// The values of one 16-byte piece of packed words (128 / BITS codes), from
// the lane's copy `cp` of the table.
template <int BITS>
__device__ __forceinline__ void decode_piece(const uint32_t* lut, int cp, uint4 raw,
                                             float (&v)[128 / BITS]) {
  const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (BITS == 16) {
    // the code's high byte picks (base, mul), the value bits are
    // base + sx * mul with sx the code sign-extended; mul 0 marks a code
    // decoded in full
    const uint32_t base = smem_addr(lut) + cp * 8;  // the lane's copy of entry 0
    int sx[8];
    uint32_t mul[8], low = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t w = w4[j / 2];
      sx[j] = j & 1 ? static_cast<int>(w) >> 16 : static_cast<int>(static_cast<int16_t>(w & 0xffffu));
      const uint2 e = lds_u2(base + ((j & 1 ? w >> 24 : __byte_perm(w, 0u, 0x4441u)) << 7));
      v[j] = __uint_as_float(static_cast<uint32_t>(sx[j]) * e.y + e.x);
      mul[j] = e.y;
      low = min(low, e.y);
    }
    if (low == 0u) {  // zero, NaR or a regime run of 7 or more
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (mul[j] == 0u) v[j] = posit16_full(static_cast<uint32_t>(sx[j]) & 0xffffu);
    }
  } else if constexpr (BITS == 8) {
    const uint32_t* l = lut + cp;
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = __uint_as_float(l[__byte_perm(w4[j / 4], 0u, 0x4440u + j % 4) * 32]);
  } else {
    const uint2* lut2 = reinterpret_cast<const uint2*>(lut) + cp;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const uint2 e = lut2[__byte_perm(w4[b / 4], 0u, 0x4440u + b % 4) * 16];
      v[2 * b] = __uint_as_float(e.x);
      v[2 * b + 1] = __uint_as_float(e.y);
    }
  }
}

// The P values v of columns n .. n + P - 1 (of Np) in row k, times the
// row's group scales (rounded to f32, as simt_kernel's decode).
template <int P>
__device__ __forceinline__ void group_scale(const StreamOps& op, int k, int n, bool svec,
                                            float (&v)[P]) {
  const float* srow = op.scales + (size_t)(k / op.group) * op.Np + n;
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    const int c0 = n + 4 * q;
    float4 s4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (svec) {
      if (c0 < op.Np) s4 = __ldg(reinterpret_cast<const float4*>(srow + 4 * q));
    } else {
      if (c0 < op.Np) s4.x = __ldg(srow + 4 * q);
      if (c0 + 1 < op.Np) s4.y = __ldg(srow + 4 * q + 1);
      if (c0 + 2 < op.Np) s4.z = __ldg(srow + 4 * q + 2);
      if (c0 + 3 < op.Np) s4.w = __ldg(srow + 4 * q + 3);
    }
    v[4 * q] = __fmul_rn(v[4 * q], s4.x);
    v[4 * q + 1] = __fmul_rn(v[4 * q + 1], s4.y);
    v[4 * q + 2] = __fmul_rn(v[4 * q + 2], s4.z);
    v[4 * q + 3] = __fmul_rn(v[4 * q + 3], s4.w);
  }
}

// simt_kernel's verdict on its 32-row step from k0 for its 64-column tile
// from n0: the index of the one mask block they lie in, or -1 (live) / -2
// (gated) from a walk over the blocks they touch.
__device__ __forceinline__ int step_block(const StreamOps& op, int k0, int n0) {
  const int kend = min(k0 + SIMT_BK, op.K), nend = min(n0 + SIMT_BN, op.Np);
  const int kb0 = k0 / op.mk, kb1 = (kend - 1) / op.mk;
  const int nb0 = n0 / op.mn, nb1 = (nend - 1) / op.mn;
  if (kb0 == kb1 && nb0 == nb1) return kb0 * op.mask_cols + nb0;
  for (int kb = kb0; kb <= kb1; ++kb)
    for (int nb = nb0; nb <= nb1; ++nb)
      if (op.mask[kb * op.mask_cols + nb] != 0) return -1;
  return -2;
}

// acc[m] = fmaf(x[m], w, acc[m]) for the MB rows of x staged at xs
template <int MB>
__device__ __forceinline__ void fma_rows(float (&acc)[MB], const float* xs, float w) {
  if constexpr (MB == 1) {
    acc[0] = fmaf(xs[0], w, acc[0]);
  } else if constexpr (MB == 2) {
    const float2 a = *reinterpret_cast<const float2*>(xs);
    acc[0] = fmaf(a.x, w, acc[0]);
    acc[1] = fmaf(a.y, w, acc[1]);
  } else {
#pragma unroll
    for (int q = 0; q < MB / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(xs)[q];
      acc[4 * q] = fmaf(a.x, w, acc[4 * q]);
      acc[4 * q + 1] = fmaf(a.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(a.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(a.w, w, acc[4 * q + 3]);
    }
  }
}

// out[m, n] of column n's sums: the per-channel scale once, at the output
template <int MB>
__device__ __forceinline__ void store_cols(const StreamOps& op, int n, const float (&acc)[MB]) {
  if (n >= op.N) return;
  const float sc = op.group == 0 ? op.scales[n] : 1.0f;
#pragma unroll
  for (int m = 0; m < MB; ++m)
    if (m < op.M) op.out[(size_t)m * op.N + n] = op.group == 0 ? __fmul_rn(acc[m], sc) : acc[m];
}

// ---------------------------------------------------------------------------
// stream_kernel: a warp per strip of 32 columns (wide N), a block of eight
// ---------------------------------------------------------------------------

// A warp's geometry and shared memory: a step is one 16-byte piece a lane,
// LPR lanes across the strip's row, RS rows; two steps' decoded rows (row
// stride WIDE_LDW: a phase of 8 lanes stores to 8 bank groups) and x rows.
template <int BITS, int MB>
struct WideWarp {
  static constexpr int P = 128 / BITS, LPR = WARP_COLS / P, RS = 32 / LPR;
  static constexpr int SETS = 2;  // steps whose loads are in flight
  static constexpr int XW = (RS * MB + 31) / 32;  // x values a lane loads a step
  static constexpr int FLOATS = 2 * RS * WIDE_LDW + 2 * RS * MB;
};

template <int BITS, int MB>
constexpr int wide_smem() {
  return StreamTable<BITS>::BYTES + WIDE_THREADS / 32 * WideWarp<BITS, MB>::FLOATS * 4;
}

// Each warp walks all of K in steps of RS rows: lane l loads and decodes the
// piece (row l / LPR, columns (l % LPR) * P ..) of the step into the warp's
// rows in shared memory, the warp syncs, and lane l sums column l over the
// step's rows for every row of x.  Loads run SETS steps ahead in registers;
// warps never wait on each other.
template <int BITS, typename TX, int MB>
__global__ void __launch_bounds__(WIDE_THREADS, BITS == 16 && MB <= 4 ? 4 : 2)
stream_kernel(StreamOps op) {
  using T = StreamTable<BITS>;
  using W = WideWarp<BITS, MB>;
  constexpr int P = W::P, PERW = 32 / BITS, RS = W::RS, LPR = W::LPR, S = W::SETS, XW = W::XW;
  extern __shared__ __align__(16) uint8_t sm[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(sm);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, cp = lane % T::COPIES;
  float* dw = reinterpret_cast<float*>(sm + T::BYTES) + warp * W::FLOATS;  // [2][RS][LDW]
  float* dx = dw + 2 * RS * WIDE_LDW;                                       // [2][RS][MB]
  fill_table<BITS, WIDE_THREADS>(lut, op.table);
  __syncthreads();
  const int n0 = blockIdx.x * WIDE_BN + warp * WARP_COLS;
  if (n0 >= op.N) return;
  const int r_l = lane / LPR, c_l = (lane % LPR) * P;  // this lane's piece of a step
  const int nw = op.Np / PERW, wc = (n0 + c_l) / PERW, nsteps = (op.K + RS - 1) / RS;
  const bool wvec = nw % 4 == 0 && (reinterpret_cast<uintptr_t>(op.w) & 15) == 0;
  const bool svec = op.Np % 4 == 0 && (reinterpret_cast<uintptr_t>(op.scales) & 15) == 0;
  const bool piece = wc < nw && n0 + c_l < op.Np;
  const TX* x = static_cast<const TX*>(op.x);
  // lane 0: the mask columns of the strip's gating tile (a strip of 32
  // columns lies in one 64-column tile), once; the mask row of the current
  // 32-row step, kept as K is walked
  int nb0 = 0, nb1 = -1, kb = 0, kb_end = op.mk;
  if (lane == 0) {
    const int t = n0 - n0 % SIMT_BN;
    nb0 = t / op.mn;
    nb1 = (min(t + SIMT_BN, op.Np) - 1) / op.mn;
  }
  // steps are fetched in order: the next one's word and x addresses (past
  // K, or past the row's words, valid ones whose loads are never used)
  const int wcl = min(wc, wvec ? nw - 4 : nw - 1);
  const uint32_t* wnext = op.w + (size_t)min(r_l, op.K - 1) * nw + wcl;
  const uint32_t* wlast = op.w + (size_t)(op.K - 1) * nw + wcl;
  const size_t wstep = (size_t)RS * nw;
  const TX* xnext[XW];
#pragma unroll
  for (int i = 0; i < XW; ++i) {
    const int e = lane + 32 * i;
    xnext[i] = x + (size_t)min(e % MB, op.M - 1) * op.K + e / MB;
  }

  // step st's loads into register set j, none of them waited for here: the
  // lane's piece and its x values (zeroed where they lie past K, M or the
  // row's words when the step is staged)
  uint4 raw[S];
  TX xr[S][XW];
  auto fetch = [&](int st, int j) {
    const int k = st * RS + r_l;
    const uint32_t* src = k < op.K ? wnext : wlast;
    if (wvec) {
      raw[j] = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      raw[j].x = __ldg(src);
      raw[j].y = __ldg(src + (wc + 1 < nw));
      raw[j].z = __ldg(src + 2 * (wc + 2 < nw));
      raw[j].w = __ldg(src + 3 * (wc + 3 < nw));
    }
    wnext += wstep;
#pragma unroll
    for (int i = 0; i < XW; ++i) {
      xr[j][i] = *(st * RS + (lane + 32 * i) / MB < op.K ? xnext[i] : x);
      xnext[i] += RS;
    }
  };

  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.0f;
  bool live = false;  // simt_kernel's verdict on the current 32-row step
  // step st from register set j into buffer st & 1, then its sums
  auto step = [&](int st, int j) {
    const int k0 = st * RS, buf = st & 1;
    float* bw = dw + buf * RS * WIDE_LDW;
    float* bx = dx + buf * RS * MB;
    if (piece && k0 + r_l < op.K) {
      uint4 rw = raw[j];
      if (!wvec) {
        if (wc + 1 >= nw) rw.y = 0u;
        if (wc + 2 >= nw) rw.z = 0u;
        if (wc + 3 >= nw) rw.w = 0u;
      }
      float v[P];
      decode_piece<BITS>(lut, cp, rw, v);
      if (op.group > 0) group_scale<P>(op, k0 + r_l, n0 + c_l, svec, v);
      float4* d = reinterpret_cast<float4*>(bw + r_l * WIDE_LDW + c_l);
#pragma unroll
      for (int q = 0; q < P / 4; ++q) d[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
#pragma unroll
    for (int i = 0; i < XW; ++i) {
      const int e = lane + 32 * i;
      if (e < RS * MB)
        bx[e] = e % MB < op.M && k0 + e / MB < op.K ? to_float(xr[j][i]) : 0.0f;
    }
    if (k0 % SIMT_BK == 0) {  // a new 32-row step: lane 0 reads its verdict
      int mv = 0;
      if (nb1 >= 0) {
        while (kb_end <= k0) ++kb, kb_end += op.mk;
        const int klast = min(k0 + SIMT_BK, op.K) - 1;
        for (int b = kb, e = kb_end - op.mk; e <= klast && !mv; ++b, e += op.mk)
          for (int nb = nb0; nb <= nb1; ++nb)
            if (op.mask[b * op.mask_cols + nb] != 0) { mv = 1; break; }
      }
      live = __shfl_sync(0xffffffffu, mv, 0) != 0;
    }
    fetch(st + S, j);
    __syncwarp();
    if (live) {
      const int rows = min(RS, op.K - k0);
      float wv[RS];  // every row's weight before the sums
#pragma unroll
      for (int r = 0; r < RS; ++r) wv[r] = bw[r * WIDE_LDW + lane];
      if (rows == RS) {
#pragma unroll
        for (int r = 0; r < RS; ++r) fma_rows<MB>(acc, bx + r * MB, wv[r]);
      } else {
#pragma unroll
        for (int r = 0; r < RS; ++r)
          if (r < rows) fma_rows<MB>(acc, bx + r * MB, wv[r]);
      }
      if (k0 + rows == op.K && op.K % SIMT_BK != 0) {
#pragma unroll
        for (int m = 0; m < MB; ++m) acc[m] = __fadd_rn(acc[m], 0.0f);  // simt_kernel's zero rows
      }
    }
  };

#pragma unroll
  for (int j = 0; j < S; ++j) fetch(j, j);
  for (int s0 = 0; s0 < nsteps; s0 += S) {
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (s0 + j < nsteps) step(s0 + j, j);
  }
  store_cols<MB>(op, n0 + lane, acc);
}

// ---------------------------------------------------------------------------
// stream_narrow_kernel: a block per strip of 8 .. 128 columns (narrow N)
// ---------------------------------------------------------------------------

// A ring slot: a chunk's packed words (16-byte pieces in piece order), its
// x rows as given ([MB][kch] of TX) and its mask words.
template <int BITS, typename TX>
struct NarrowSlot {
  static constexpr int WORDS = STREAM_FLOATS * BITS / 8;
  static constexpr int X = STREAM_X * static_cast<int>(sizeof(TX));
  static constexpr int BYTES = WORDS + X + LIVE_SLOTS * 4;
};

// shared memory: the table, two decoded chunks (weights, x as f32 rows,
// verdicts), the ring of STREAM_SETS raw chunks
template <int BITS, typename TX>
constexpr int narrow_smem() {
  return StreamTable<BITS>::BYTES + 2 * STREAM_BUF * 4 + 2 * STREAM_X * 4 + 2 * LIVE_SLOTS * 4 +
         STREAM_SETS * NarrowSlot<BITS, TX>::BYTES;
}

// The block's 256 threads load and decode a chunk of kch rows together (a
// ring of STREAM_SETS chunks copied with cp.async), one barrier a chunk:
// chunk ch + 1 is decoded into shared memory while thread c < bn sums column
// c over chunk ch, so the decode of many rows runs beside each column's
// sequential chain.
template <int BITS, typename TX, int MB>
__global__ void __launch_bounds__(STREAM_THREADS, 2)
stream_narrow_kernel(StreamOps op) {
  using T = StreamTable<BITS>;
  using Slot = NarrowSlot<BITS, TX>;
  constexpr int P = 128 / BITS;   // codes of a 16-byte piece
  constexpr int PERW = 32 / BITS;  // codes of a word
  constexpr int DP = STREAM_FLOATS / P >= STREAM_THREADS ? STREAM_FLOATS / P / STREAM_THREADS : 1;
  constexpr int XV = 16 / static_cast<int>(sizeof(TX));  // x values of a 16-byte piece
  constexpr int XPER = STREAM_X / STREAM_THREADS;
  extern __shared__ __align__(16) uint8_t sm[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(sm);
  float* dw = reinterpret_cast<float*>(sm + T::BYTES);  // [2][STREAM_BUF] decoded rows
  float* dx = dw + 2 * STREAM_BUF;                        // [2][rows][MB] x as f32
  int* lv = reinterpret_cast<int*>(dx + 2 * STREAM_X);   // [2][LIVE_SLOTS]
  uint8_t* ring = reinterpret_cast<uint8_t*>(lv + 2 * LIVE_SLOTS);  // [SETS][Slot::BYTES]

  const int tid = threadIdx.x, cp = tid % T::COPIES;
  const int bn = op.bn, n0 = blockIdx.x * bn, ldw = bn + STREAM_PAD;
  // a power of two >= 16
  const int kch = min(min(STREAM_MAX_ROWS, STREAM_FLOATS / bn), STREAM_X / MB);
  const int gbits = __ffs(bn / P) - 1;  // log2 of the pieces of a row
  const int pieces = kch * (bn / P);
  const int nw = op.Np / PERW, nchunks = (op.K + kch - 1) / kch;
  const int tn0 = n0 - n0 % SIMT_BN;    // first gating tile of the strip
  const int ntiles = (n0 % SIMT_BN + bn + SIMT_BN - 1) / SIMT_BN;
  const int nseg = (kch + SIMT_BK - 1) / SIMT_BK;
  const bool wvec = nw % 4 == 0 && (reinterpret_cast<uintptr_t>(op.w) & 15) == 0;
  const bool xvec = op.K % XV == 0 && (reinterpret_cast<uintptr_t>(op.x) & 15) == 0;
  const bool svec = op.Np % 4 == 0 && (reinterpret_cast<uintptr_t>(op.scales) & 15) == 0;
  const TX* x = static_cast<const TX*>(op.x);

  // piece p of a chunk: rows in groups of 8 (a phase of 8 lanes, 8 rows),
  // then the row's pieces, then the groups; thread t takes pieces from
  // (t - bn) mod 256 on, so that the summing threads (t < bn) decode last
  auto piece_row = [&](int p) { return (p >> (3 + gbits)) * 8 + (p & 7); };
  auto piece_col = [&](int p) { return ((p >> 3) & ((1 << gbits) - 1)) * P; };
  const int pt = (tid + STREAM_THREADS - bn) % STREAM_THREADS;

  // chunk ch into ring slot ch % SETS, one cp.async group (copies where
  // aligned and whole, plain loads otherwise): this thread's pieces, 16-byte
  // pieces of x's rows, the mask words of the verdicts
  auto fetch = [&](int ch) {
    uint8_t* slot = ring + (ch % STREAM_SETS) * Slot::BYTES;
    const int k0 = ch * kch;
    if (ch < nchunks) {
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        const int p = pt + i * STREAM_THREADS;
        const int k = k0 + piece_row(p), wc = (n0 + piece_col(p)) / PERW;
        if (p < pieces && k < op.K && wc < nw) {
          const uint32_t* src = op.w + (size_t)k * nw + wc;
          uint4* dst = reinterpret_cast<uint4*>(slot) + p;
          if (wvec) {
            cp_async16(dst, src);
          } else {
            uint4 v = make_uint4(__ldg(src), 0u, 0u, 0u);
            if (wc + 1 < nw) v.y = __ldg(src + 1);
            if (wc + 2 < nw) v.z = __ldg(src + 2);
            if (wc + 3 < nw) v.w = __ldg(src + 3);
            *dst = v;
          }
        }
      }
      TX* xs = reinterpret_cast<TX*>(slot + Slot::WORDS);  // [MB][kch]
      const int xp = kch / XV;                              // pieces of a row
      for (int e = tid; e < MB * xp; e += STREAM_THREADS) {
        const int m = e / xp, r = (e % xp) * XV, k = k0 + r;
        if (m < op.M && k < op.K) {
          const TX* src = x + (size_t)m * op.K + k;
          if (xvec && k + XV <= op.K) {
            cp_async16(xs + m * kch + r, src);
          } else {
#pragma unroll
            for (int j = 0; j < XV; ++j)
              if (k + j < op.K) xs[m * kch + r + j] = src[j];
          }
        }
      }
      if (tid < nseg * ntiles) {
        int* vw = reinterpret_cast<int*>(slot + Slot::WORDS + Slot::X);
        const int k = (k0 & ~(SIMT_BK - 1)) + (tid / ntiles) * SIMT_BK;
        const int b = k < op.K ? step_block(op, k, tn0 + (tid % ntiles) * SIMT_BN) : -2;
        if (b >= 0)
          cp_async4(vw + tid, op.mask + b);
        else
          vw[tid] = b == -1;
      }
    }
    cp_async_commit();
  };

  // chunk ch from its ring slot into buffer buf: decoded weights (times the
  // group scale), x rows as f32 (k-major), verdicts
  auto stage = [&](int ch, int buf) {
    const uint8_t* slot = ring + (ch % STREAM_SETS) * Slot::BYTES;
    const int k0 = ch * kch, rows = min(kch, op.K - k0);
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      const int p = pt + i * STREAM_THREADS;
      const int r = piece_row(p), col = piece_col(p);
      if (p < pieces && r < rows && n0 + col < op.Np) {
        float v[P];
        decode_piece<BITS>(lut, cp, reinterpret_cast<const uint4*>(slot)[p], v);
        if (op.group > 0) group_scale<P>(op, k0 + r, n0 + col, svec, v);
        float4* dst = reinterpret_cast<float4*>(dw + buf * STREAM_BUF + r * ldw + col);
#pragma unroll
        for (int q = 0; q < P / 4; ++q)
          dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
    }
    // x: rows m of the slot to rows k of dx (only m < M, r < rows are read)
    const TX* xs = reinterpret_cast<const TX*>(slot + Slot::WORDS);
#pragma unroll
    for (int i = 0; i < XPER; ++i) {
      const int e = tid + i * STREAM_THREADS, m = e / kch, r = e % kch;
      if (m < MB) dx[buf * STREAM_X + r * MB + m] = to_float(xs[m * kch + r]);
    }
    if (tid < nseg * ntiles)
      lv[buf * LIVE_SLOTS + tid] = reinterpret_cast<const int*>(slot + Slot::WORDS + Slot::X)[tid];
  };

  // column c's chain over chunk ch's rows, for every row of x
  const int c = tid, ctile = (n0 % SIMT_BN + c) / SIMT_BN;
  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.0f;
  auto chain = [&](int ch, int buf) {
    if (c >= bn) return;
    const int k0 = ch * kch, rows = min(kch, op.K - k0);
    const float* wcol = dw + buf * STREAM_BUF + c;
    const float* xr = dx + buf * STREAM_X;
    for (int s0 = 0; s0 < rows; s0 += SIMT_BK) {
      if (lv[buf * LIVE_SLOTS + (s0 / SIMT_BK) * ntiles + ctile] == 0) continue;
      const int s1 = min(s0 + SIMT_BK, rows);
      int r = s0;
      for (; r + 8 <= s1; r += 8) {  // eight rows' loads before their sums
        float wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) wv[i] = wcol[(r + i) * ldw];
#pragma unroll
        for (int i = 0; i < 8; ++i) fma_rows<MB>(acc, xr + (r + i) * MB, wv[i]);
      }
      for (; r < s1; ++r) fma_rows<MB>(acc, xr + r * MB, wcol[r * ldw]);
      if (k0 + s1 == op.K && op.K % SIMT_BK != 0) {
#pragma unroll
        for (int m = 0; m < MB; ++m) acc[m] = __fadd_rn(acc[m], 0.0f);  // simt_kernel's zero rows
      }
    }
  };

  // STREAM_SETS chunks in flight: chunk ch + SETS is copied while chunk
  // ch + 1 is staged and chunk ch summed
#pragma unroll
  for (int j = 0; j < STREAM_SETS; ++j) fetch(j);
  fill_table<BITS, STREAM_THREADS>(lut, op.table);
  cp_async_wait_group<STREAM_SETS - 1>();
  __syncthreads();
  stage(0, 0);
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait_group<STREAM_SETS - 2>();
    // chunk ch + 1 landed and chunk ch staged; every thread is done with
    // chunk ch - 1's buffer and with the slot of chunk ch
    __syncthreads();
    fetch(ch + STREAM_SETS);
    if (ch + 1 < nchunks) stage(ch + 1, (ch + 1) & 1);
    chain(ch, ch & 1);
  }
  cp_async_wait_all();
  if (c < bn) store_cols<MB>(op, n0 + c, acc);
}

// Once per kernel and process: the dynamic shared memory it needs.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool& allowed) {
  if (allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  allowed = err == cudaSuccess;
  return err;
}

template <int BITS, typename TX, int MB>
cudaError_t launch_stream_rows(const StreamOps& op, cudaStream_t stream) {
  if (op.bn == WIDE_BN) {
    constexpr int smem = wide_smem<BITS, MB>();
    static bool allowed = false;
    const cudaError_t err = allow_smem(stream_kernel<BITS, TX, MB>, smem, allowed);
    if (err != cudaSuccess) return err;
    stream_kernel<BITS, TX, MB><<<(op.N + WIDE_BN - 1) / WIDE_BN, WIDE_THREADS, smem, stream>>>(op);
  } else {
    constexpr int smem = narrow_smem<BITS, TX>();
    static bool allowed = false;
    const cudaError_t err = allow_smem(stream_narrow_kernel<BITS, TX, MB>, smem, allowed);
    if (err != cudaSuccess) return err;
    stream_narrow_kernel<BITS, TX, MB><<<(op.N + op.bn - 1) / op.bn, STREAM_THREADS, smem, stream>>>(op);
  }
  return cudaGetLastError();
}

template <int BITS, typename TX>
cudaError_t launch_stream(const StreamOps& op, cudaStream_t stream) {
  if (op.M <= 1) return launch_stream_rows<BITS, TX, 1>(op, stream);
  if (op.M <= 2) return launch_stream_rows<BITS, TX, 2>(op, stream);
  if (op.M <= 4) return launch_stream_rows<BITS, TX, 4>(op, stream);
  if (op.M <= 8) return launch_stream_rows<BITS, TX, 8>(op, stream);
  return launch_stream_rows<BITS, TX, 16>(op, stream);
}

// ---------------------------------------------------------------------------
// wgmma: a persistent, warp-specialised grid over 128 x 64 output tiles
// ---------------------------------------------------------------------------
//
// Replaces the same TPU kernel as the tiles above (rmmec_matmul.py:127,
// rmmec_matmul_pallas) for bf16 x with codes of <= 8 bits at M > 16 where
// TMA can address both operands (K a multiple of 64, the words' rows a
// multiple of 16 bytes, both bases 16-byte aligned) and its persistent grid
// ends before the tiles' (launch_plan decides, from the waves each grid
// takes on the card's SMs).
//
// What bounds it on this card: bf16 operations at prefill shapes (qwen2's
// seven projections at M = 1024: 30.5 GFLOP, 31 us at 989 TFLOP/s; a
// 12288-wide layer at M = 256: ~0.8 ms), the words' and x's bytes at small
// M x N.  mma.sync (tile_kernel) feeds the tensor cores through registers
// loaded from shared memory; wgmma is Hopper's way to their full rate, and
// its asynchrony lets the code -> bf16 decode run on the CUDA cores while
// the tensor cores multiply.  What the design does about it:
//   - Block: two consumer warpgroups (64 rows of x each, m64n64k16 chains)
//     and a producer warp whose first lane issues every load.  A consumer
//     thread holds the chunk partial and the running total (32 + 32 f32).
//   - Persistent grid: one block an SM walks the output tiles N-fastest, so
//     the blocks in flight share x's rows in L2; the producer runs ahead
//     across tiles, so one tile's stores overlap the next one's loads.
//   - Two TMA rings of WG_STAGES chunks each, a full and an empty mbarrier
//     a stage: x's 128 x KC tile in one 3-D load (two 64-column boxes,
//     128-byte swizzle, zeros past M and K), and the chunk's packed words
//     (KC rows x 64 columns of codes, zeros past K, swizzled so that the
//     decode's reads meet no bank twice).  In this design's card runs a
//     block's TMA loads were served one after another, at much the same
//     time for 8 KB as for 32 KB, and the thread issuing one waited while
//     the unit was busy: so a chunk costs two loads, and a warp of its own
//     issues them.  The words run ahead of x (each ring as soon as a stage
//     frees).
//   - The consumers decode chunk c+1's codes through the format's table
//     (interleaved copies, one a lane or two lanes; times
//     the power-of-two group scale: exact) into one of two B slots in
//     wgmma's N-major 128-byte-swizzled layout (wg_b_offset) while chunk c's
//     wgmma chain is in flight; fence.proxy.async and a named barrier among
//     the consumers then hand the slot to the tensor cores.
//   - 64-column tiles: twice the blocks of 128-column ones at qwen2's
//     narrow projections (896 columns: 14 N-tiles), and 64 registers of
//     fragments a thread, so no spills under the 168 registers ptxas gives
//     a block of 288 threads.
//
// Why the fold stays chunk-ordered: a row's bits must not depend on M or on
// the route (continuous serving's chunk tails below 17 rows run split-K).
// So, as in tile_kernel: chunks of KC rows with bounds from K alone; a
// chunk's partial is its k16 chain from zero (the first wgmma with scale-d
// 0); the partials fold in chunk order with __fadd_rn, then the per-channel
// scale with __fmul_rn; a gated chunk runs no decode and no MMA and folds as
// an exact zero.  Each output row sees the k16 products and sums of
// split_k_kernel's mma.sync (rmmec_ablation's probe holds the two bitwise).

constexpr int WG_CONSUMERS = 2;                // consumer warpgroups, 64 rows of x each
constexpr int WG_BM = 64 * WG_CONSUMERS;       // rows of a block tile
constexpr int WG_BN = 64;                      // columns of a block tile
constexpr int WG_STAGES = 4;                   // chunks in each TMA ring
constexpr int WG_THREADS = 128 * WG_CONSUMERS + 32;  // the consumers, then the producer warp
constexpr int WG_MASK_BYTES = 4096;            // block masks up to this many blocks in shared memory

// Shared memory of wgmma_kernel<BITS>, in bytes from a 1024-byte boundary:
// the x ring, the words' ring, two decoded B slots, the decode table in
// 1 << LS interleaved copies (entry e of copy r at e << LS | r; lane l reads
// copy l % (1 << LS): 32 copies for 4-bit codes, no bank conflicts; 16 for
// 8-bit ones, whose words take more room), the block mask as bytes, the
// rings' barriers.
template <int BITS>
struct WgSmem {
  static constexpr int LS = BITS == 4 ? 5 : 4;
  static constexpr int X_BOX = WG_BM * 64 * 2;        // one 64-column box of x
  static constexpr int X_BYTES = 2 * X_BOX;           // x's WG_BM x KC tile
  static constexpr int RAW_BYTES = KC * WG_BN * BITS / 8;
  static constexpr int RAW = WG_STAGES * X_BYTES;     // the words' ring
  static constexpr int B_BYTES = KC * 128;            // a decoded KC x 64 slot
  static constexpr int SLOTS = RAW + WG_STAGES * RAW_BYTES;
  static constexpr int LUT = SLOTS + 2 * B_BYTES;
  static constexpr int MASK = LUT + (1024 << LS);
  static constexpr int BARS = MASK + WG_MASK_BYTES;   // x full, x empty, words full, words empty
  static constexpr int BYTES = BARS + 4 * WG_STAGES * 8 + 1024;  // + alignment slack
  static_assert(X_BYTES % 1024 == 0 && RAW_BYTES % 1024 == 0 && BYTES <= 232448,
                "swizzle atoms on 1024 bytes, within a block's shared memory");
};

// Byte offset of weight (k, n) in a B slot: wgmma's N-major layout with the
// 128-byte swizzle.  Columns 64 h .. 64 h + 63 form half h (KC * 128
// bytes), row k of a half is 128 bytes at 128 k, and the 16-byte chunk of 8
// columns n / 8 % 8 sits at chunk (n / 8 % 8) ^ (k % 8) of its row.  So the
// 8-row x 64-column atoms lie 1024 bytes apart along K (the descriptor's
// stride byte offset) and KC * 128 apart along N.
__host__ __device__ constexpr int wg_b_offset(int k, int n) {
  return (n / 64) * (KC * 128) + k * 128 + (((n / 8) % 8) ^ (k % 8)) * 16 + (n % 8) * 2;
}

// A stage's x tile as TMA writes it with the 128-byte swizzle: element
// (r, k) in box k / 64, row r at 128 r, 16-byte chunk (k / 8 % 8) ^ (r % 8)
// (the ablation's probe writes it so, wg_x_offset in wgmma_probe.cu).  A
// warpgroup's A descriptor starts at its 64 rows (8192 bytes a
// warpgroup), 8-row groups 1024 bytes apart; a k16 step moves the start by
// 32 bytes within the box.

// One chunk partial of a consumer warpgroup: acc = its 64 rows of the x
// tile at `xs` times the decoded slot at `bs`, a chain of nks k16 steps from
// zero; issued and committed, not waited for.
__device__ __forceinline__ void wg_chunk_mma(float (&acc)[32], uint32_t xs, uint32_t bs,
                                             int x_box, int wg, int nks) {
  const uint32_t a0 = xs + wg * 64 * 128;
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
  wgmma_fence();
  if (nks == KC / 16) {
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      wgmma_m64n64k16(acc, gmma_desc_sw128(a0 + (ks / 4) * x_box + (ks % 4) * 32, 16, 1024),
                      gmma_desc_sw128(bs + ks * 16 * 128, KC * 128, 1024), ks > 0);
  } else {
#pragma unroll 1
    for (int ks = 0; ks < nks; ++ks)
      wgmma_m64n64k16(acc, gmma_desc_sw128(a0 + (ks / 4) * x_box + (ks % 4) * 32, 16, 1024),
                      gmma_desc_sw128(bs + ks * 16 * 128, KC * 128, 1024), ks > 0);
  }
  wgmma_commit();
}

// The 16-byte pieces of a chunk's words (KC rows x WG_BN / PER words) a
// consumer thread decodes: piece j of thread tid is row
// wg_piece_row(tid, j), piece column (tid / 8) % PIECES, so that eight
// consecutive threads take one piece column of eight consecutive rows and
// their 16-byte stores into the B slot (its swizzle) meet no bank twice.
template <int BITS>
__device__ __forceinline__ int wg_piece_row(int tid, int j) {
  constexpr int PIECES = WG_BN / (32 / BITS) / 4, NC = 128 * WG_CONSUMERS;
  const int s = tid + j * NC;
  return s / (8 * PIECES) * 8 + s % 8;
}

// Where TMA puts 16-byte piece pc of row r of a chunk's raw words: rows of
// WG_BN / PER words (64 bytes, 8-bit codes, 64-byte swizzle; 32 bytes,
// 4-bit codes, 32-byte swizzle), so that piece pc of eight consecutive rows
// fills all 32 banks.
template <int BITS>
__host__ __device__ constexpr int wg_raw_piece(int r, int pc) {
  return BITS == 8 ? r * 4 + (pc ^ ((r / 2) % 4)) : r * 2 + (pc ^ ((r / 4) % 2));
}

// The consumers' decode of one chunk: the raw words at `raw` (as TMA wrote
// them) -> bf16 into the B slot `bs` (wg_b_offset), rows k0 .., columns
// n0 ..; `lut` at the lane's copy of the table (WgSmem::LS).  A thread's loads first,
// then its decodes and 16-byte stores.
template <int BITS>
__device__ __forceinline__ void wg_decode(const Operands& op, const uint32_t* lut,
                                          const uint8_t* raw, uint8_t* bs, int k0, int n0) {
  constexpr int PER = 32 / BITS, PIECES = WG_BN / PER / 4, NC = 128 * WG_CONSUMERS;
  constexpr int DP = KC * PIECES / NC;  // 16-byte pieces of words a thread
  static_assert(KC * PIECES % NC == 0 && NC % (8 * PIECES) == 0, "whole row groups");
  const int pc = (threadIdx.x / 8) % PIECES;
  uint4 w[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j)
    w[j] = reinterpret_cast<const uint4*>(raw)[wg_raw_piece<BITS>(
        wg_piece_row<BITS>(threadIdx.x, j), pc)];
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    const int r = wg_piece_row<BITS>(threadIdx.x, j);
    uint32_t pairs[2 * PER];
    decode_pairs<BITS, WgSmem<BITS>::LS>(op, lut, w[j], k0 + r, n0 + pc * 4 * PER, pairs);
#pragma unroll
    for (int i = 0; i < PER / 2; ++i)  // 8 columns a 16-byte chunk
      *reinterpret_cast<uint4*>(bs + wg_b_offset(r, (pc * (PER / 2) + i) * 8)) =
          make_uint4(pairs[4 * i], pairs[4 * i + 1], pairs[4 * i + 2], pairs[4 * i + 3]);
  }
}

// Does chunk c of tile t (tiles N-fastest, ntn of them along N) touch a
// live mask block?  The same verdict in every thread.  `smask`: the mask's
// rows as bytes in shared memory (null: read the mask itself).
__device__ __forceinline__ bool wg_live(const Operands& op, const uint8_t* smask, int ntn, int t,
                                        int c) {
  if (smask && op.mk % KC == 0 && op.mn % WG_BN == 0)  // one mask block a chunk and tile
    return smask[(c * KC / op.mk) * op.mask_cols + (t % ntn) * WG_BN / op.mn] != 0;
  const int n0 = (t % ntn) * WG_BN, k0 = c * KC;
  const int kend = min(k0 + KC, op.K), n1 = min(n0 + WG_BN, op.Np);
  for (int kb = k0 / op.mk; kb <= (kend - 1) / op.mk; ++kb)
    for (int nb = n0 / op.mn; nb <= (n1 - 1) / op.mn; ++nb)
      if (smask ? smask[kb * op.mask_cols + nb] != 0 : op.mask[kb * op.mask_cols + nb] != 0)
        return true;
  return false;
}

// Moves (t, c) to the block's next live chunk: chunks in order, then the
// block's next tile (t >= ntiles: none left).
__device__ __forceinline__ void wg_next(const Operands& op, const uint8_t* smask, int ntn,
                                        int ntiles, int nchunks, int& t, int& c) {
  do {
    if (++c == nchunks) {
      c = 0;
      t += gridDim.x;
    }
  } while (t < ntiles && !wg_live(op, smask, ntn, t, c));
}

// Grid: min(tiles, SMs) blocks of WG_THREADS; WgSmem<BITS>::BYTES of
// dynamic shared memory.  xmap: x (M, K) bf16 as (64, M, K / 64), box 64 x
// WG_BM x 2 (a chunk: zeros past M and past K), 128-byte swizzle; wmap: the
// words (K rows, Np / PER), box WG_BN / PER x KC, swizzled as wg_raw_piece
// says.
template <int BITS>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_kernel(const Operands op, const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap) {
  using L = WgSmem<BITS>;
  constexpr int PER = 32 / BITS, NC = 128 * WG_CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint32_t* lut = reinterpret_cast<uint32_t*>(sm + L::LUT);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* xempty = xfull + WG_STAGES;
  uint64_t* wfull = xempty + WG_STAGES;
  uint64_t* wempty = wfull + WG_STAGES;
  uint8_t* raw = sm + L::RAW;
  uint8_t* slots = sm + L::SLOTS;
  const int ntn = (op.N + WG_BN - 1) / WG_BN;
  const int ntiles = ntn * ((op.M + WG_BM - 1) / WG_BM);
  const int nchunks = (op.K + KC - 1) / KC;
  const int lane = threadIdx.x % 32;

  // the block mask where it fits, for every liveness verdict; the table
  const int mblocks = ((op.K - 1) / op.mk + 1) * op.mask_cols;
  uint8_t* smask_rw = mblocks <= WG_MASK_BYTES ? sm + L::MASK : nullptr;
  const uint8_t* smask = smask_rw;
  if (smask_rw)
    for (int i = threadIdx.x; i < mblocks; i += WG_THREADS) smask_rw[i] = op.mask[i] != 0;
  for (int i = threadIdx.x; i < 256 << L::LS; i += WG_THREADS)
    lut[i] = __ldg(op.table + (i >> L::LS));
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(xfull + s, 1);
      mbar_init(wfull + s, 1);
      mbar_init(xempty + s, NC / 32);  // one arrival a consumer warp
      mbar_init(wempty + s, NC / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NC) {
    // the producer warp: its first lane keeps both rings full with the
    // block's live chunks in order, across tiles, each ring as soon as a
    // stage of it frees, the words first
    if (lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      int xt = blockIdx.x, xc = -1, wt = blockIdx.x, wc = -1, xs = 0, ws = 0;
      uint32_t xph = 0, wph = 0;
      wg_next(op, smask, ntn, ntiles, nchunks, xt, xc);
      wg_next(op, smask, ntn, ntiles, nchunks, wt, wc);
      while (xt < ntiles) {
        if (wt < ntiles && mbar_test(wempty + ws, wph ^ 1)) {
          mbar_arrive_expect_tx(wfull + ws, L::RAW_BYTES);
          tma_load_2d(raw + ws * L::RAW_BYTES, &wmap, wfull + ws, (wt % ntn) * WG_BN / PER,
                      wc * KC);
          if (++ws == WG_STAGES) {
            ws = 0;
            wph ^= 1;
          }
          wg_next(op, smask, ntn, ntiles, nchunks, wt, wc);
        }
        if (mbar_test(xempty + xs, xph ^ 1)) {
          mbar_arrive_expect_tx(xfull + xs, L::X_BYTES);
          tma_load_3d(sm + xs * L::X_BYTES, &xmap, xfull + xs, 0, (xt / ntn) * WG_BM,
                      xc * KC / 64);
          if (++xs == WG_STAGES) {
            xs = 0;
            xph ^= 1;
          }
          wg_next(op, smask, ntn, ntiles, nchunks, xt, xc);
        }
      }
    }
    return;
  }

  // the consumers
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const uint32_t* lutp = lut + lane % (1 << L::LS);  // the lane's copy of the table
  // the next live chunk to decode (tile dt, chunk dc), its words' stage and
  // its B slot; the x stage and B slot of the next live chunk's MMAs
  int dt = blockIdx.x, dc = -1, dstage = 0, bslot = 0, mstage = 0, mslot = 0;
  uint32_t dphase = 0, mphase = 0;
  auto decode = [&]() {  // the next live chunk's words: wait, decode, release
    mbar_wait(wfull + dstage, dphase);
    wg_decode<BITS>(op, lutp, raw + dstage * L::RAW_BYTES, slots + bslot * L::B_BYTES,
                    dc * KC, (dt % ntn) * WG_BN);
    __syncwarp();
    if (lane == 0) mbar_arrive(wempty + dstage);
    if (++dstage == WG_STAGES) {
      dstage = 0;
      dphase ^= 1;
    }
    bslot ^= 1;
    wg_next(op, smask, ntn, ntiles, nchunks, dt, dc);
  };
  wg_next(op, smask, ntn, ntiles, nchunks, dt, dc);
  if (dt < ntiles) decode();
  fence_proxy_async();
  bar_sync(1, NC);

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int m0 = (t / ntn) * WG_BM, n0 = (t % ntn) * WG_BN;
    const bool rows = m0 + 64 * wg < op.M;  // this warpgroup's rows hold some of x's
    float tot[32];
    for (int c = 0; c < nchunks; ++c) {
      if (!wg_live(op, smask, ntn, t, c)) {  // a gated chunk folds an exact zero
#pragma unroll
        for (int i = 0; i < 32; ++i) tot[i] = c == 0 ? 0.0f : __fadd_rn(tot[i], 0.0f);
        continue;
      }
      float acc[32];
      const int nks = (min(c * KC + KC, op.K) - c * KC + 15) / 16;
      mbar_wait(xfull + mstage, mphase);
      if (rows)
        wg_chunk_mma(acc, smem_addr(sm + mstage * L::X_BYTES),
                     smem_addr(slots + mslot * L::B_BYTES), L::X_BOX, wg, nks);
      if (dt < ntiles) decode();  // the next live chunk's, beside the MMAs in flight
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
      if (lane == 0) mbar_arrive(xempty + mstage);  // this stage's x consumed
      if (++mstage == WG_STAGES) {
        mstage = 0;
        mphase ^= 1;
      }
      mslot ^= 1;
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[i] = c == 0 ? acc[i] : __fadd_rn(tot[i], acc[i]);
      fence_proxy_async();  // the decoded slot, to the tensor cores
      bar_sync(1, NC);
    }
    // the tile's outputs from the fragments: n8 block i, rows g and g + 8 of
    // the warp's 16, columns 2 (lane % 4) and the next
    const int row = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + 8 * i + 2 * (lane % 4);
      float s0 = 1.0f, s1 = 1.0f;
      if (op.group == 0) {
        s0 = n < op.N ? op.scales[n] : 0.0f;
        s1 = n + 1 < op.N ? op.scales[n + 1] : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + 8 * h;
        if (m >= op.M) continue;
        float v0 = tot[4 * i + 2 * h], v1 = tot[4 * i + 2 * h + 1];
        if (op.group == 0) {
          v0 = __fmul_rn(v0, s0);
          v1 = __fmul_rn(v1, s1);
        }
        float* o = op.out + (size_t)m * op.N + n;
        if (n + 1 < op.N && op.N % 2 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (n < op.N) o[0] = v0;
          if (n + 1 < op.N) o[1] = v1;
        }
      }
    }
  }
}

// ---- host side of the wgmma route: tensor maps ----------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (the library links cudart only).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map of rows x cols elements of `esize` bytes, row stride
// `stride` bytes, a `swizzle`-byte swizzle.  esize 2 (bf16 x): 3-D (64
// columns, rows, cols / 64 blocks of 64 columns), box 64 x bh x 2, so one
// load brings a chunk's two 64-column boxes.  esize 4 (the words): 2-D, box
// bw x bh.  Cached: the encoding is a pure function of these, and x's and
// the words' pointers repeat from call to call.
struct MapKey {
  const void* ptr;
  uint64_t rows, cols, stride;
  uint32_t bw, bh, esize, swizzle;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && stride == o.stride &&
           bw == o.bw && bh == o.bh && esize == o.esize && swizzle == o.swizzle;
  }
};
constexpr int MAP_SLOTS = 256;  // direct-mapped

bool tensor_map(CUtensorMap* map, const MapKey& key) {
  static MapKey keys[MAP_SLOTS];
  static CUtensorMap maps[MAP_SLOTS];
  static bool used[MAP_SLOTS] = {};
  static std::mutex mu;
  uint64_t h = (reinterpret_cast<uintptr_t>(key.ptr) >> 4) ^ (key.rows * 0x9E3779B97F4A7C15ull) ^
               (key.cols * 0xC2B2AE3D27D4EB4Full) ^ key.stride ^ (uint64_t(key.bw) << 20) ^
               key.bh ^ (uint64_t(key.esize) << 32) ^ (uint64_t(key.swizzle) << 40);
  h ^= h >> 29;
  const int slot = static_cast<int>(h % MAP_SLOTS);
  std::lock_guard<std::mutex> lock(mu);
  if (used[slot] && keys[slot] == key) {
    *map = maps[slot];
    return true;
  }
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const bool x = key.esize == 2;
  const cuuint64_t dims[3] = {x ? 64 : key.cols, key.rows, key.cols / 64};
  const cuuint64_t strides[2] = {key.stride, 128};
  const cuuint32_t box[3] = {x ? 64 : key.bw, key.bh, key.bw / 64};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (enc(map, x ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT32, x ? 3 : 2,
          const_cast<void*>(key.ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
          key.swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
          : key.swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[slot] = key;
  maps[slot] = *map;
  used[slot] = true;
  return true;
}

// SMs of the current device, read once per device.
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// Can TMA address x (M, K) bf16 in blocks of 64 columns and the words (K
// rows of Np / PER int32)?
bool tma_aligned(const Operands& op, int per) {
  return op.K % 64 == 0 && (op.Np / per) % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(op.x) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(op.w) & 15) == 0;
}

template <int BITS>
cudaError_t launch_wgmma(const Operands& op, cudaStream_t stream) {
  constexpr int PER = 32 / BITS, smem = WgSmem<BITS>::BYTES;
  if (!tma_aligned(op, PER)) return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  if (!tensor_map(&xmap, MapKey{op.x, (uint64_t)op.M, (uint64_t)op.K, (uint64_t)op.K * 2, KC,
                                (uint32_t)WG_BM, 2, 128}) ||
      !tensor_map(&wmap, MapKey{op.w, (uint64_t)op.K, (uint64_t)(op.Np / PER),
                                (uint64_t)(op.Np / PER) * 4, (uint32_t)(WG_BN / PER),
                                (uint32_t)KC, 4, (uint32_t)(WG_BN / PER * 4)}))
    return cudaErrorInvalidValue;
  static bool allowed = false;
  const cudaError_t err = allow_smem(wgmma_kernel<BITS>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int tiles = ((op.N + WG_BN - 1) / WG_BN) * ((op.M + WG_BM - 1) / WG_BM);
  const int grid = std::min(tiles, sm_count());
  if (grid < 1) return cudaErrorInvalidValue;
  wgmma_kernel<BITS><<<grid, WG_THREADS, smem, stream>>>(op, xmap, wmap);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a format this library has no decoder for or a route that cannot take the
// call (the tensor routes: bf16 x, <= 8 bits and the format's decode table;
// split-K: M <= 16, with scratch and counters when K > KC; wgmma: operands
// TMA can address (K % 64 == 0, Np / per % 4 == 0, x and the words 16-byte
// aligned) and a driver that encodes their tensor maps; the streaming
// route: M <= 16, the format's stream table, a strip of WIDE_BN (warp
// strips, stream_kernel) or a power-of-two multiple of a 16-byte piece's
// codes up to NARROW_MAX_BN (stream_narrow_kernel), f32 x with a format of
// <= 8 bits or posit16 with any x).  `strip` is read by the streaming route
// only.
extern "C" int rmmec_matmul(const void* x, int x_bf16, const void* words,
                            const void* scales, const void* mask, void* out,
                            void* scratch, void* counters, const void* table, int M,
                            int K, int N, int Np, int group, int mk, int mn,
                            int mask_cols, int route, int strip, int kind, int bits,
                            int es, int ebits, int mbits, int has_nan, int frac_bits,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (route == ROUTE_STREAM) {
    const bool p16 = bits == 16 && kind == KIND_POSIT && es == 1;
    if (!table || M < 1 || M > SPLIT_M || (!p16 && (x_bf16 || (bits != 4 && bits != 8))) ||
        (strip != WIDE_BN &&
         (strip < 128 / bits || strip > NARROW_MAX_BN || (strip & (strip - 1)))))
      return invalid;
    const StreamOps op{x, static_cast<const uint32_t*>(words), static_cast<const float*>(scales),
                       static_cast<const int*>(mask), static_cast<float*>(out),
                       static_cast<const uint32_t*>(table), M, K, N, Np, group, mk, mn,
                       mask_cols, strip};
    if (p16) return static_cast<int>(x_bf16 ? launch_stream<16, bf16>(op, st)
                                            : launch_stream<16, float>(op, st));
    return static_cast<int>(bits == 4 ? launch_stream<4, float>(op, st)
                                      : launch_stream<8, float>(op, st));
  }
  if (route != ROUTE_SIMT) {
    if (!x_bf16 || !table || (bits != 4 && bits != 8) || route > ROUTE_WGMMA ||
        (route == ROUTE_SPLIT_K && (M > SPLIT_M || (K > KC && (!scratch || !counters)))))
      return invalid;
    const Operands op{static_cast<const bf16*>(x), static_cast<const uint32_t*>(words),
                      static_cast<const float*>(scales), static_cast<const int*>(mask),
                      static_cast<float*>(out), static_cast<float*>(scratch),
                      static_cast<int*>(counters), static_cast<const uint32_t*>(table), M,
                      K, N, Np, group, mk, mn, mask_cols};
    if (route == ROUTE_WGMMA)
      return static_cast<int>(bits == 4 ? launch_wgmma<4>(op, st) : launch_wgmma<8>(op, st));
    return static_cast<int>(bits == 4 ? launch_tensor<4>(op, route, st)
                                      : launch_tensor<8>(op, route, st));
  }
  Args a{x, static_cast<const uint32_t*>(words), static_cast<const float*>(scales),
         static_cast<const int*>(mask), static_cast<float*>(out),
         M, K, N, Np, group, mk, mn, mask_cols, st};
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
  return invalid;
}
