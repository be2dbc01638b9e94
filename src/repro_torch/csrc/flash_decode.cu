// GQA attention straight from a posit8 KV cache, for Hopper (sm_90a):
// one-token decode over a paged pool or a contiguous cache, and chunk
// prefill over a paged pool.
//
// Replaces, in src/repro/kernels/flash_decode.py:
//   decode_page_kernel + decode_fold_kernel (entry paged_flash_decode)
//       <- paged_flash_decode_pallas (the continuous engine's decode) and,
//          with contiguous addressing, flash_decode_pallas (static decode);
//   prefill_kernel (entry paged_flash_prefill)
//       <- paged_flash_prefill_pallas (its pages-context chunk prefill).
//
// Addressing.  A pool is codes (P, page, Kh, Dh) uint8 and scales
// (P, page, Kh, Gs) bf16 with a page table (B, NP) int32 mapping request
// b's logical page t to a pool page.  A contiguous cache (B, T, Kh, Dh)
// with blk | T *is* such a pool of B*T/blk pages of blk slots: logical page
// t of row b is page b*(T/blk) + t, so the decode entry takes a null page
// table to mean that.  Row r of a (b, kv-head) has the horizon
// hz = start + r / G (decode: start = the position, r < G; prefill: rows
// r = qi*G + gi of a chunk at start .. start+C-1) and sees the slots
// pad_lo <= kpos <= hz.  A walk visits the live pages t <= hz / page only,
// from pad_lo / page on, and stops at the table's last column.
//
// What bounds them on this card.  Decode: bytes -- one byte per cached
// element and its share of a scale, read once, a few flops a byte; at B=8
// the whole live prefix is ~0.3 MB, so what is left is latency: one wave
// of blocks, each a chain of dependent loads and MMAs.  Prefill:
// operations -- a 256-token chunk with G = 7 is 1792 query rows per kv
// head against the live prefix; in f32 outside the tensor cores that is
// ~9 us of the card, on the bf16 tensor cores with the three-term split
// below ~2 us, against ~0.2 MB of codes.  A lone warp per SM sub-partition
// walking its pages in series is the latency to beat in both.
//
// The design both kernels share: one page partial, one fold.
//   - Page partial (page_partial): a team of four warps, 16 query rows,
//     one KV page dequantized in shared memory: s = (q.k)*scale, the
//     optional tanh softcap, the mask kpos > hz || kpos < pad_lo -> -1e30;
//     m_p = max s, p = exp(s - m_p), l_p = sum p, acc_p = p.V.  Warp w
//     computes the scores of the page's slots 32w .. 32w+31 and, after the
//     team has shared p through shared memory, acc_p for its quarter of
//     the Dh columns over the whole page; the row max and the row sum
//     combine across the team in warp order.  Each element of S and acc_p
//     is the same MMA chain whichever warp holds it.
//   - Fold (fold_stats + fold_value): the partials of a row's pages merge
//     in page order into (M, L, ACC), from (-1e30, 0, 0):
//     M' = max(M, m_p), ACC = ACC*exp(M - M') + acc_p*exp(m_p - M'), L
//     the same, with explicit fma/mul intrinsics so no contraction differs.
//   - A page wholly past a row's horizon has m_p = -1e30 and weight
//     exp(-1e30 - M) = 0, while M, L, ACC pass through times exp(0) = 1:
//     folding it changes no bit.  So a prefill row that walks its tile's
//     extra masked pages (or skips them) equals, bit for bit, a decode row
//     that stops at its own last page.  And partials written to device
//     memory by other blocks and folded in page order give the same bits as
//     partials folded in registers.  No row's arithmetic depends on the
//     block, team or tile that holds it: a row keeps its place in its
//     16-row group (row r at group row r % 16).  Hence, bitwise: paged
//     decode == contiguous decode when page == blk (one kernel), and a
//     C = 1 prefill chunk == paged decode.
//   - Decode is split-KV: one block (one team) per (b, kv-head, page)
//     writes the page partial of the G rows to scratch; a second kernel in
//     the same entry folds each (b, kv-head)'s partials in page order and
//     divides.  Prefill keeps the page: one block per (b, kv-head, tile of
//     32 rows, two teams; 16 rows at widths 128 and 256), heaviest tile first; the
//     block dequantizes each live page once into shared memory, every team
//     takes its partials from that copy and folds them in registers, and
//     the next page's codes arrive by cp.async (16 bytes a thread) while
//     the current page computes.
//
// f32-faithful on bf16 tensor cores (mma.sync m16n8k16, f32 accumulate).
// K and V dequantize exactly into bf16: a posit(8,0) value has at most 6
// significant bits (a 256-entry bf16 table built per block from
// Posit<8,0>::decode) and the scales are powers of two.  q (f32) splits
// into hi + mid + lo, three bf16 terms whose sum is q exactly (for normal
// f32), and p the same; every bf16 x bf16 product is exact in f32, and the
// three MMAs accumulate in a fixed order (hi, mid, lo).  A team skips a q
// term that is zero in all its rows (q from bf16 activations: mid = lo =
// 0), which changes no bit.  No TF32, no bf16 rounding of q or p.
//
// Sub-pages.  A pool (P, page, Kh, Dh) is, byte for byte, a pool
// (P*s, page/s, Kh, Dh) of sub-pages for any divisor s of the page:
// logical sub-page u of row b is pool sub-page table[b, u / s] * s + u % s
// (sub_page).  The kernels walk sub-pages of `page` = sub slots and take
// s (`nsub`) and the row's sub-page count NP = s * the table's columns.
// The wrapper takes sub as the largest divisor of the page that fits a
// kernel: at most 128 slots (MAXP), or 64 at a head width above 128
// (MAXP_WIDE: a 128-slot sub-page at Dh = 256 would need ~300 KB of
// shared memory in the prefill, smem_bytes).  Sub-page partials fold in
// order like page partials, so decode at page 256 gives, bit for bit,
// decode at page 128 (or over a contiguous cache at blk 128) over the same
// slots.  A prime page above 128 slots (131) walks 1-slot sub-pages: slow,
// and right.  s = 1 is the page itself.
//
// Head widths.  The kernels are instantiated at widths 32, 64, 128 and
// 256; any other Dh <= 256 runs on the next width (40 on 64, 112 on 128):
// the q terms and the staged K and V hold zeros past Dh, which change no
// sum, and only Dh columns are written.  A Dh that is not a multiple of 16
// stages its codes with plain loads, and a 16-column chunk finds its scale
// groups of Dh / Gs columns with one division.  These are the NARROW
// instantiations; a head of the full width compiles to the kernels as
// they were.
//
// Wide heads.  A head of more than 256 columns takes its own route
// (wide_kernel): SIMT, one block of 8 warps per (b, kv-head, query row),
// with the row's q and its O accumulator in shared memory (8 bytes a
// column, so Dh up to WIDE_MAX_DH = 4096 within the default 48 KB).  It
// walks the row's live slots in position order, 16 at a time: each warp
// scores two slots (lane-strided fma over the columns, a fixed
// xor-shuffle tree, so a score's bits do not depend on its warp), then
// every thread folds the 16 slots, one after the other, into its own
// columns of O with fold_stats / fold_value (m_p = the score, l_p = 1,
// acc_p = the dequantized V row).  K and V dequantize exactly (the posit
// table times the po2 scale of the column's group).  The slot order is
// the same whatever the page size or addressing, and a C = 1 prefill row
// runs the decode row's code, so on this route too paged == contiguous
// decode (any page, any blk) and C = 1 prefill == decode, bitwise.  What
// bounds it is latency, not bytes or operations: a block walks its slots
// in series, each batch a chain of dependent loads (codes, then the table,
// then the fold).  No config of the repo has such a head: this route is
// right, not fast.
//
// Limits: Dh in 1 .. 4096 (above 256 on the wide route); a page of any
// size >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "formats.cuh"
#include "mma.cuh"

namespace {

using namespace xrnpe;
using bf16 = __nv_bfloat16;

constexpr int TEAM = 128;              // threads of a team: 4 warps, 16 rows
constexpr int TEAM_WARPS = TEAM / 32;
constexpr int ROWS = 16;               // query rows of a team (the MMA's M)
constexpr int MAXP = 128;              // most slots of a sub-page
constexpr int MAXP_WIDE = 64;          // most slots of a sub-page at width 256
constexpr int LUT_BYTES = 512;         // the posit table: 256 bf16
constexpr float NEG = -1e30f;

// The instantiated width a head of Dh columns runs on.
__host__ __device__ constexpr int width_of(int Dh) {
  return Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 128 ? 128 : 256;
}
// Most slots of a sub-page at width DH, and the row stride of a team's
// shared p terms (that many slots plus 8).
__host__ __device__ constexpr int max_sub(int DH) { return DH <= 128 ? MAXP : MAXP_WIDE; }
__host__ __device__ constexpr int ldp(int DH) { return max_sub(DH) + 8; }

// Teams of a prefill block: two (32-row tiles), one at widths 128 and 256.
// Two measured faster than four and than one at qwen2-0.5b's shapes (more
// blocks on the card against fewer dequantized copies of each page).
template <int DH>
struct Prefill {
  static constexpr int TEAMS = DH >= 128 ? 1 : 2;
  static constexpr int THREADS = TEAMS * TEAM;
  static constexpr int TILE = TEAMS * ROWS;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// ---------------------------------------------------------------------------
// shared memory of one block
// ---------------------------------------------------------------------------

// A page's staged codes and scales: K codes (page, Dh), V codes, then the
// page's K and V scale blocks for ALL kv heads (page*Kh*Gs bf16 each, one
// contiguous run in the pool, so whole 16-byte copies).
__host__ __device__ inline int scale_block_bytes(int page, int Kh, int Gs) {
  return page * Kh * Gs * 2;
}
__host__ __device__ inline int stage_bytes(int page, int Kh, int Gs, int Dh) {
  return 2 * page * Dh + 2 * align16(scale_block_bytes(page, Kh, Gs));
}

// A team's own: the q terms (3, 16, Dh + 8) bf16, the p terms (3, 16, ldp(Dh))
// bf16, and floats for the per-warp row maxima (4, 16), row sums (4, 16)
// and the warps' nonzero-term flags.
struct Team {
  bf16* qs;
  bf16* ps;
  float* red;
};
__host__ __device__ inline int team_bytes(int Dh) {
  return 3 * ROWS * (Dh + 8) * 2 + 3 * ROWS * ldp(Dh) * 2 + (2 * TEAM_WARPS * ROWS + 16) * 4;
}

struct Smem {
  bf16* lut;        // 256 posit(8,0) values
  uint8_t* stage;   // nbuf staging buffers
  bf16* kp;         // (align16(page), Dh + 8) dequantized K
  bf16* vp;         // (align16(page), Dh + 8) dequantized V
  uint8_t* teams;   // the teams' own parts
};

__host__ __device__ inline int smem_bytes(int page, int Kh, int Gs, int Dh, int nbuf,
                                          int teams) {
  return LUT_BYTES + nbuf * stage_bytes(page, Kh, Gs, Dh) +
         2 * align16(page) * (Dh + 8) * 2 + teams * team_bytes(Dh);
}

__device__ __forceinline__ Smem carve(uint8_t* sm, int page, int Kh, int Gs, int Dh,
                                      int nbuf) {
  const int ld = Dh + 8;
  Smem s;
  s.lut = reinterpret_cast<bf16*>(sm);
  s.stage = sm + LUT_BYTES;
  s.kp = reinterpret_cast<bf16*>(s.stage + nbuf * stage_bytes(page, Kh, Gs, Dh));
  s.vp = s.kp + align16(page) * ld;
  s.teams = reinterpret_cast<uint8_t*>(s.vp + align16(page) * ld);
  return s;
}

__device__ __forceinline__ Team team_of(const Smem& s, int team, int Dh) {
  uint8_t* base = s.teams + team * team_bytes(Dh);
  Team tm;
  tm.qs = reinterpret_cast<bf16*>(base);
  tm.ps = tm.qs + 3 * ROWS * (Dh + 8);
  tm.red = reinterpret_cast<float*>(tm.ps + 3 * ROWS * ldp(Dh));
  return tm;
}

// The posit table, and zeros in the K/V rows past the page up to a
// multiple of 16 (read by the MMAs' last k-step, never written after).
__device__ __forceinline__ void init_block(const Smem& s, int page, int Dh) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s.lut[i] = __float2bfloat16_rn(Posit<8, 0>::decode(i));
  const int ld = Dh + 8;
  const int n = (align16(page) - page) * ld;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s.kp[page * ld + i] = __float2bfloat16_rn(0.0f);
    s.vp[page * ld + i] = __float2bfloat16_rn(0.0f);
  }
}

// The four warps of a team meet (named barrier `bar`, 1 + the team).
__device__ __forceinline__ void team_sync(int bar) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(TEAM) : "memory");
}

// x == hi + mid + lo exactly, each a bf16 (x a normal f32).
__device__ __forceinline__ void split3(float x, bf16& hi, bf16& mid, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// Stores the three bf16 terms of (x, y) at `dst` in each of the three
// planes `plane` elements apart; notes whether a mid / lo term is nonzero.
__device__ __forceinline__ void store_terms(bf16* dst, int plane, float x, float y,
                                            bool& any_mid, bool& any_lo) {
  bf16 h0, m0, l0, h1, m1, l1;
  split3(x, h0, m0, l0);
  split3(y, h1, m1, l1);
  *reinterpret_cast<uint32_t*>(dst) = pack2(h0, h1);
  *reinterpret_cast<uint32_t*>(dst + plane) = pack2(m0, m1);
  *reinterpret_cast<uint32_t*>(dst + 2 * plane) = pack2(l0, l1);
  any_mid |= __bfloat162float(m0) != 0.0f || __bfloat162float(m1) != 0.0f;
  any_lo |= __bfloat162float(l0) != 0.0f || __bfloat162float(l1) != 0.0f;
}

// ---------------------------------------------------------------------------
// one page: stage, dequantize (every thread of the block)
// ---------------------------------------------------------------------------

// A narrower head's code rows (dh bytes each) into `st` at a 16-byte
// stride, with plain loads of T.
template <class T, int Dh, int NT>
__device__ __forceinline__ void stage_rows(uint8_t* st, const uint8_t* __restrict__ kc,
                                           const uint8_t* __restrict__ vc, size_t pid,
                                           int page, int Kh, int h, int dh) {
  const int per_row = dh / static_cast<int>(sizeof(T)), ds = align16(dh), n = page * per_row;
  for (int i = threadIdx.x; i < 2 * n; i += NT) {
    const int which = i >= n, c = i - which * n, j = c / per_row, e = c % per_row;
    const uint8_t* src = (which ? vc : kc) + ((pid * page + j) * Kh + h) * dh;
    *reinterpret_cast<T*>(st + which * page * Dh + j * ds + e * sizeof(T)) =
        reinterpret_cast<const T*>(src)[e];
  }
}

// Starts the copy of pool page `pid`'s codes for kv head h and its scale
// blocks into `st` and commits it: cp.async of 16 bytes a thread per step
// where the source allows (a pool whose codes or scale blocks do not start
// on 16-byte boundaries, as small pages' scale blocks of page*Kh*Gs*2
// bytes may not, takes plain loads instead, which the same barrier
// publishes).  A head narrower than the width (dh < Dh) stages its rows of
// dh codes at a stride of align16(dh) bytes, by cp.async when dh is a
// multiple of 16, else with plain 8-, 4- or 1-byte loads; the bytes past dh
// are never read as codes (dequant_narrow writes zeros there).
template <int Dh, int NT, bool NARROW>
__device__ __forceinline__ void stage_page(uint8_t* st, const uint8_t* __restrict__ kc,
                                           const bf16* __restrict__ ks,
                                           const uint8_t* __restrict__ vc,
                                           const bf16* __restrict__ vs, size_t pid,
                                           int page, int Kh, int h, int Gs, int dh) {
  const bool codes16 = ((reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc)) & 15) == 0;
  if constexpr (!NARROW) {
    constexpr int cps = Dh / 16;
    const int nc = page * cps;
    for (int i = threadIdx.x; i < 2 * nc; i += NT) {
      const int which = i >= nc, c = i - which * nc, j = c / cps, part = c % cps;
      const uint8_t* src = (which ? vc : kc) + ((pid * page + j) * Kh + h) * Dh + part * 16;
      uint8_t* dst = st + which * page * Dh + c * 16;
      if (codes16) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = src[e];
      }
    }
  } else if (codes16 && dh % 16 == 0) {
    const int cps = dh / 16, nc = page * cps;
    for (int i = threadIdx.x; i < 2 * nc; i += NT) {
      const int which = i >= nc, c = i - which * nc, j = c / cps, part = c % cps;
      cp_async16(st + which * page * Dh + c * 16,
                 (which ? vc : kc) + ((pid * page + j) * Kh + h) * dh + part * 16);
    }
  } else {  // plain loads of the widest unit dh and the pool's alignment allow
    const uintptr_t a = reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc);
    if (dh % 8 == 0 && a % 8 == 0)
      stage_rows<uint2, Dh, NT>(st, kc, vc, pid, page, Kh, h, dh);
    else if (dh % 4 == 0 && a % 4 == 0)
      stage_rows<uint32_t, Dh, NT>(st, kc, vc, pid, page, Kh, h, dh);
    else
      stage_rows<uint8_t, Dh, NT>(st, kc, vc, pid, page, Kh, h, dh);
  }
  const int sb = scale_block_bytes(page, Kh, Gs);
  uint8_t* sdst = st + 2 * page * Dh;
  const bool scales16 =
      sb % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(vs)) & 15) == 0;
  if (scales16) {
    const int ns = sb / 16;
    for (int i = threadIdx.x; i < 2 * ns; i += NT) {
      const int which = i >= ns, c = i - which * ns;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(which ? vs : ks) + pid * sb + c * 16;
      cp_async16(sdst + which * align16(sb) + c * 16, src);
    }
  } else {
    const int ns = sb / 2;  // one bf16 a step
    for (int i = threadIdx.x; i < 2 * ns; i += NT) {
      const int which = i >= ns, c = i - which * ns;
      reinterpret_cast<bf16*>(sdst + which * align16(sb))[c] = (which ? vs : ks)[pid * ns + c];
    }
  }
  cp_async_commit();
}

// Staged codes -> exact bf16 K and V rows (the table value times the
// scale; exact for power-of-two scales).  dequant_narrow: the same for a
// head narrower than the width (dh < Dh), zeros past dh.
template <int Dh, int NT>
__device__ __forceinline__ void dequant_narrow(const Smem& s, const uint8_t* st, int page,
                                               int Kh, int h, int Gs, int dh) {
  constexpr int cpr = Dh / 16, ld = Dh + 8;  // 16-column chunks of a padded row
  const int nc = page * cpr, ds = align16(dh), gw = dh / Gs;  // gw: a scale group's columns
  const int sb = align16(scale_block_bytes(page, Kh, Gs));
  const bf16* ksc = reinterpret_cast<const bf16*>(st + 2 * page * Dh);
  const bf16* vsc = reinterpret_cast<const bf16*>(st + 2 * page * Dh + sb);
  for (int i = threadIdx.x; i < 2 * nc; i += NT) {
    const int which = i >= nc, c = i - which * nc, j = c / cpr, d0 = (c % cpr) * 16;
    uint32_t out[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (d0 < dh) {
      const uint4 raw = *reinterpret_cast<const uint4*>(st + which * page * Dh + j * ds + d0);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      const bf16* sc = (which ? vsc : ksc) + (j * Kh + h) * Gs;
      // the scale group of column d0 and where it ends: one division a chunk
      int gi = d0 / gw, gend = (gi + 1) * gw;
      float sv = __bfloat162float(sc[gi]);
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int d = d0 + e;
        if (d < dh && d >= gend) {
          ++gi;
          gend += gw;
          sv = __bfloat162float(sc[gi]);
        }
        const uint32_t code = (w[e / 4] >> (8 * (e % 4))) & 0xffu;
        v[e] = d < dh ? __bfloat162float(s.lut[code]) * sv : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = pack2(__float2bfloat16_rn(v[2 * e]), __float2bfloat16_rn(v[2 * e + 1]));
    }
    uint4* dst = reinterpret_cast<uint4*>((which ? s.vp : s.kp) + j * ld + d0);
    dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
    dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
}

template <int Dh, int NT>
__device__ __forceinline__ void dequant_page(const Smem& s, const uint8_t* st, int page,
                                             int Kh, int h, int Gs) {
  constexpr int cps = Dh / 16, ld = Dh + 8;
  const int nc = page * cps;
  const int gshift = __ffs(Dh / Gs) - 1;  // a scale group is 2^gshift columns
  const int sb = align16(scale_block_bytes(page, Kh, Gs));
  const bf16* ksc = reinterpret_cast<const bf16*>(st + 2 * page * Dh);
  const bf16* vsc = reinterpret_cast<const bf16*>(st + 2 * page * Dh + sb);
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * nc; i += NT) {
    const int which = i >= nc, c = i - which * nc, j = c / cps, part = c % cps;
    const uint4 raw = *reinterpret_cast<const uint4*>(st + which * page * Dh + c * 16);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    const bf16* sc = (which ? vsc : ksc) + (j * Kh + h) * Gs;
    const bool one = gshift >= 4;  // one scale for the 16 codes
    const float sv = __bfloat162float(sc[(part * 16) >> gshift]);
    uint32_t out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t word = w[e / 2] >> (16 * (e % 2));
      const int d = part * 16 + 2 * e;
      const float s0 = one ? sv : __bfloat162float(sc[d >> gshift]);
      const float s1 = one ? sv : __bfloat162float(sc[(d + 1) >> gshift]);
      out[e] = pack2(__float2bfloat16_rn(__bfloat162float(s.lut[word & 0xffu]) * s0),
                     __float2bfloat16_rn(__bfloat162float(s.lut[(word >> 8) & 0xffu]) * s1));
    }
    uint4* dst = reinterpret_cast<uint4*>((which ? s.vp : s.kp) + j * ld + part * 16);
    dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
    dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// ---------------------------------------------------------------------------
// query rows of a team
// ---------------------------------------------------------------------------

// q and out are (B, C, Kh, G, Dh) (decode: C = 1): row r = qi*G + gi of
// (b, h) lies at ((b*C + qi)*Kh + h)*G + gi.
__device__ __forceinline__ size_t row_index(int b, int h, int row, int C, int Kh, int G) {
  const int qi = row / G, gi = row % G;
  return (((size_t)b * C + qi) * Kh + h) * G + gi;
}

// Splits the team's 16 rows row0 .. row0+15 (those below `rows`; the rest
// zero) into the three bf16 terms in tm.qs; returns how many leading terms
// are nonzero in some row (1, 2 or 3).  Every thread of the team calls it.
// q rows hold dh columns; the terms of columns dh .. DH-1 are zero.
template <int DH, bool NARROW>
__device__ __forceinline__ int split_q(const Team& tm, int bar, const float* __restrict__ q,
                                       int b, int h, int row0, int rows, int C, int Kh,
                                       int G, int dh) {
  constexpr int LD = DH + 8, NV = ROWS * DH / 2 / TEAM;  // float2 loads per thread
  const int tid = threadIdx.x % TEAM;
  float2 x[NV];  // all loads first: one round trip, not NV
  if constexpr (!NARROW) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = tid + TEAM * k, r = i / (DH / 2), d = (i % (DH / 2)) * 2;
      x[k] = row0 + r < rows ? *reinterpret_cast<const float2*>(
                                   q + row_index(b, h, row0 + r, C, Kh, G) * DH + d)
                             : make_float2(0.0f, 0.0f);
    }
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = tid + TEAM * k, r = i / (DH / 2), d = (i % (DH / 2)) * 2;
      const float* src = q + row_index(b, h, row0 + r, C, Kh, G) * dh + d;
      const bool live = row0 + r < rows;
      x[k] = make_float2(live && d < dh ? src[0] : 0.0f, live && d + 1 < dh ? src[1] : 0.0f);
    }
  }
  bool any_mid = false, any_lo = false;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = tid + TEAM * k, r = i / (DH / 2), d = (i % (DH / 2)) * 2;
    store_terms(tm.qs + r * LD + d, ROWS * LD, x[k].x, x[k].y, any_mid, any_lo);
  }
  int* flags = reinterpret_cast<int*>(tm.red + 2 * TEAM_WARPS * ROWS);
  const int f = (__any_sync(0xffffffffu, any_lo) ? 2 : 0) |
                (__any_sync(0xffffffffu, any_mid) ? 1 : 0);
  if (threadIdx.x % 32 == 0) flags[tid / 32] = f;
  team_sync(bar);
  int all = 0;
#pragma unroll
  for (int w = 0; w < TEAM_WARPS; ++w) all |= flags[w];
  return (all & 2) ? 3 : (all & 1) ? 2 : 1;
}

// ---------------------------------------------------------------------------
// the page partial and the fold: the single copy of the math
// ---------------------------------------------------------------------------

// A team's page partial over `width` slots (1 .. max_sub(DH)) at logical slots
// kpos0 .. kpos0+width-1, for the 16 rows split in tm.qs.  S is computed in
// tiles of 8 slots; a last tile that reaches past the page masks its extra
// slots like dead ones (their K and V rows are the zeros of init_block).
// Lane L of team warp w holds rows g = L/4 (index 0) and g + 8 (index 1):
// m[i] and l[i] for its rows (the same in every warp of the team) and, in
// the MMA's C layout, acc[n][0..1] (row g) and acc[n][2..3] (row g+8) at
// columns 8*(w*DH/32 + n) + 2*(L%4) + {0, 1}.  hz[i] is the row's horizon.
// Every thread of the team calls it; it ends with the team met.  FULL:
// width == max_sub(DH), known when compiled, so the width tests fold away.
// Warp w scores the tiles TPW*w .. TPW*w + TPW-1 of 8 slots.
template <int DH, bool FULL>
__device__ __forceinline__ void page_partial(const Smem& s, const Team& tm, int bar, int nq,
                                             int width, int kpos0, const int (&hz)[2],
                                             int pad_lo, float softcap, float scale,
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[DH / 32][4]) {
  constexpr int LD = DH + 8, NKS = DH / 16, NW = DH / 32;
  constexpr int MAXS = max_sub(DH), LDP = ldp(DH), TPW = MAXS / 8 / TEAM_WARPS;
  const int lane = threadIdx.x % 32, t = lane % 4, g = lane / 4;
  const int w = (threadIdx.x / 32) % TEAM_WARPS;
  const int ntile = FULL ? MAXS / 8 : (width + 7) / 8, n0 = TPW * w;  // this warp's S tiles
  const uint32_t qb = smem_addr(tm.qs), kb = smem_addr(s.kp), vb = smem_addr(s.vp),
                 pb = smem_addr(tm.ps);
  float* red_m = tm.red;
  float* red_l = tm.red + TEAM_WARPS * ROWS;

  // scores of this warp's slots: the nq terms of q in the order hi, mid,
  // lo, each over all k-steps (a runtime loop around straight-line MMAs)
  float sc[TPW][4];
#pragma unroll
  for (int j = 0; j < TPW; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll 1
  for (int term = 0; term < nq; ++term) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, qb + ((term * ROWS + lane % 16) * LD + ks * 16 + (lane / 16) * 8) * 2);
#pragma unroll
      for (int j = 0; j < TPW; j += 2) {
        const int n = n0 + j;
        if (n < ntile) {
          uint32_t b[4];
          ldmatrix_x4(b, kb + ((n * 8 + (lane / 16) * 8 + lane % 8) * LD + ks * 16 +
                               ((lane / 8) % 2) * 8) * 2);
          mma_bf16(sc[j], a, b[0], b[1]);
          if (n + 1 < ntile) mma_bf16(sc[j + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // scale, softcap, mask; the rows' maxima over the page, in warp order
  float mw[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    if (n0 + j < ntile) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = sc[j][e] * scale;
        if (softcap > 0.0f) v = tanhf(v / softcap) * softcap;
        const int slot = (n0 + j) * 8 + 2 * t + (e & 1), kpos = kpos0 + slot;
        if (kpos > hz[e / 2] || kpos < pad_lo || (!FULL && slot >= width)) v = NEG;
        sc[j][e] = v;
        mw[e / 2] = fmaxf(mw[e / 2], v);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mw[i] = fmaxf(mw[i], __shfl_xor_sync(0xffffffffu, mw[i], 1));
    mw[i] = fmaxf(mw[i], __shfl_xor_sync(0xffffffffu, mw[i], 2));
    if (t == 0) red_m[w * ROWS + g + 8 * i] = mw[i];
  }
  team_sync(bar);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = NEG;
#pragma unroll
    for (int v = 0; v < TEAM_WARPS; ++v) m[i] = fmaxf(m[i], red_m[v * ROWS + g + 8 * i]);
  }

  // p = exp(s - m_p) into the team's p terms (zeros past the page up to
  // the last k-step); l_p = the warps' row sums added in warp order
  float lw[2] = {0.0f, 0.0f};
  bool unused_mid = false, unused_lo = false;
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int n = n0 + j;
    if (n < ntile) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - m[e / 2]);
        sc[j][e] = p;
        lw[e / 2] += p;
      }
    }
    if (n < 2 * ((ntile + 1) / 2)) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        store_terms(tm.ps + (g + 8 * i) * LDP + n * 8 + 2 * t, ROWS * LDP, sc[j][2 * i],
                    sc[j][2 * i + 1], unused_mid, unused_lo);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lw[i] += __shfl_xor_sync(0xffffffffu, lw[i], 1);
    lw[i] += __shfl_xor_sync(0xffffffffu, lw[i], 2);
    if (t == 0) red_l[w * ROWS + g + 8 * i] = lw[i];
  }
  team_sync(bar);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = 0.0f;
#pragma unroll
    for (int v = 0; v < TEAM_WARPS; ++v) l[i] += red_l[v * ROWS + g + 8 * i];
  }

  // acc_p = p . V for this warp's DH/4 columns over the whole page, per
  // k-step the three terms of p in the order hi, mid, lo
#pragma unroll
  for (int n = 0; n < NW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const int vrow = ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
  for (int ks = 0; ks < MAXS / 16; ++ks) {
    if (2 * ks < ntile) {
      uint32_t pa[3][4];
#pragma unroll
      for (int term = 0; term < 3; ++term)
        ldmatrix_x4(pa[term],
                    pb + ((term * ROWS + lane % 16) * LDP + ks * 16 + (lane / 16) * 8) * 2);
      if constexpr (NW == 1) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, vb + ((ks * 16 + vrow) * LD + w * 8) * 2);
#pragma unroll
        for (int term = 0; term < 3; ++term) mma_bf16(acc[0], pa[term], b[0], b[1]);
      } else {
#pragma unroll
        for (int n = 0; n < NW; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vb + ((ks * 16 + vrow) * LD + (w * NW + n) * 8 +
                                     (lane / 16) * 8) * 2);
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            mma_bf16(acc[n], pa[term], b[0], b[1]);
            mma_bf16(acc[n + 1], pa[term], b[2], b[3]);
          }
        }
      }
    }
  }
  team_sync(bar);  // the team's p terms and sums are free again
}

struct FoldWeights {
  float old_w, new_w;
};

// Folds a partial's (m_p, l_p) into a row's running (M, L); returns the
// weights of the old ACC and of acc_p for fold_value.
__device__ __forceinline__ FoldWeights fold_stats(float& M, float& L, float m_p, float l_p) {
  const float mn = fmaxf(M, m_p);
  const FoldWeights w{expf(M - mn), expf(m_p - mn)};
  L = __fmaf_rn(L, w.old_w, __fmul_rn(l_p, w.new_w));
  M = mn;
  return w;
}

__device__ __forceinline__ float fold_value(float acc, float acc_p, FoldWeights w) {
  return __fmaf_rn(acc, w.old_w, __fmul_rn(acc_p, w.new_w));
}

// ---------------------------------------------------------------------------
// decode: page partials to scratch, then the ordered fold
// ---------------------------------------------------------------------------

// Scratch of the decode: acc (B, Kh, NP, G, DH) then (m, l) (B, Kh, NP, G, 2),
// NP the row's sub-pages, DH the width.
struct Partials {
  float* acc;
  float* ml;
};

// The pool sub-page of logical sub-page t of a page-table row (s sub-pages
// a page).
__device__ __forceinline__ size_t sub_page(const int* __restrict__ row, int t, int s) {
  return s == 1 ? (size_t)row[t] : (size_t)row[t / s] * s + t % s;
}

__device__ __forceinline__ void live_pages(int b, const int* positions, const int* pad,
                                           int pos, int page, int NP, int& hz, int& pad_lo,
                                           int& t0, int& t1) {
  hz = positions != nullptr ? positions[b] : pos;
  pad_lo = pad != nullptr ? pad[b] : 0;
  t0 = pad_lo / page;
  t1 = min(hz / page, NP - 1);
}

// grid (NP, Kh, B), one team: block (t, h, b) takes logical sub-page t of
// row b (`page` slots, `nsub` of them a page of the table).
template <int DH, bool FULL, bool NARROW>
__global__ void __launch_bounds__(TEAM)
decode_page_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kc,
                   const bf16* __restrict__ ks, const uint8_t* __restrict__ vc,
                   const bf16* __restrict__ vs, const int* __restrict__ page_table,
                   const int* __restrict__ positions, const int* __restrict__ pad,
                   Partials part, int NP, int page, int nsub, int Kh, int G, int Gs, int dh,
                   int pos, float softcap, float scale) {
  if constexpr (!NARROW) dh = DH;
  extern __shared__ __align__(16) uint8_t sm[];
  constexpr int MAXS = max_sub(DH);
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const Smem s = carve(sm, page, Kh, Gs, DH, 1);
  const Team tm = team_of(s, 0, DH);
  // the page id, the position and the first rows of q load in one round trip
  const size_t pid = page_table != nullptr
                         ? sub_page(page_table + (size_t)b * (nsub == 1 ? NP : NP / nsub), t, nsub)
                         : (size_t)b * NP + t;
  int hz, pad_lo, t0, t1;
  live_pages(b, positions, pad, pos, page, NP, hz, pad_lo, t0, t1);
  int nq = split_q<DH, NARROW>(tm, 1, q, b, h, 0, G, 1, Kh, G, dh);
  if (t < t0 || t > t1) return;
  stage_page<DH, TEAM, NARROW>(s.stage, kc, ks, vc, vs, pid, FULL ? MAXS : page, Kh, h, Gs, dh);
  init_block(s, page, DH);
  const int lane = threadIdx.x % 32, g = lane / 4, w = threadIdx.x / 32;
  cp_async_wait_all();
  __syncthreads();
  if constexpr (NARROW)
    dequant_narrow<DH, TEAM>(s, s.stage, page, Kh, h, Gs, dh);
  else
    dequant_page<DH, TEAM>(s, s.stage, FULL ? MAXS : page, Kh, h, Gs);
  __syncthreads();
  const int hzr[2] = {hz, hz};
  const size_t slot = ((size_t)b * Kh + h) * NP + t;
  for (int row0 = 0; row0 < G; row0 += ROWS) {
    if (row0 > 0) nq = split_q<DH, NARROW>(tm, 1, q, b, h, row0, G, 1, Kh, G, dh);
    float m[2], l[2], acc[DH / 32][4];
    page_partial<DH, FULL>(s, tm, 1, nq, page, t * page, hzr, pad_lo, softcap, scale, m, l,
                           acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      if (r >= G) continue;
      const size_t base = slot * G + r;
      if (w == 0 && lane % 4 == 0) {
        part.ml[base * 2] = m[i];
        part.ml[base * 2 + 1] = l[i];
      }
#pragma unroll
      for (int n = 0; n < DH / 32; ++n)
        *reinterpret_cast<float2*>(part.acc + base * DH + (w * DH / 32 + n) * 8 +
                                   2 * (lane % 4)) = make_float2(acc[n][2 * i],
                                                                 acc[n][2 * i + 1]);
    }
  }
}

constexpr int FOLD_THREADS = 128;
constexpr int FOLD_BATCH = 8;  // pages whose partials load in one round trip

// grid (ceil(G*Dh/128), Kh, B), one output element a thread: folds the live
// sub-pages' partials of (b, h) in order and divides.  Partials are DH
// (the width) floats a row, outputs Dh.
__global__ void __launch_bounds__(FOLD_THREADS)
decode_fold_kernel(Partials part, const int* __restrict__ positions,
                   const int* __restrict__ pad, float* __restrict__ out, int NP, int page,
                   int Kh, int G, int Dh, int DH, int pos) {
  const int i = blockIdx.x * FOLD_THREADS + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (i >= G * Dh) return;
  int hz, pad_lo, t0, t1;
  live_pages(b, positions, pad, pos, page, NP, hz, pad_lo, t0, t1);
  const int r = i / Dh, d = i % Dh;
  const size_t row = ((size_t)b * Kh + h) * NP * G + r;  // page t's partial: row + t*G
  float M = NEG, L = 0.0f, A = 0.0f;
  for (int t = t0; t <= t1; t += FOLD_BATCH) {
    float2 ml[FOLD_BATCH];
    float a[FOLD_BATCH];
#pragma unroll
    for (int k = 0; k < FOLD_BATCH; ++k) {
      if (t + k <= t1) {
        const size_t idx = row + (size_t)(t + k) * G;
        ml[k] = reinterpret_cast<const float2*>(part.ml)[idx];
        a[k] = part.acc[idx * DH + d];
      }
    }
#pragma unroll
    for (int k = 0; k < FOLD_BATCH; ++k)
      if (t + k <= t1) {
        const FoldWeights w = fold_stats(M, L, ml[k].x, ml[k].y);
        A = fold_value(A, a[k], w);
      }
  }
  out[(((size_t)b * Kh + h) * G + r) * Dh + d] = __fdiv_rn(A, L);
}

// ---------------------------------------------------------------------------
// prefill: tiles that keep the page
// ---------------------------------------------------------------------------

// grid (tiles, Kh, B), tile = tiles - 1 - blockIdx.x (the heaviest first);
// team k of the block holds rows tile*TILE + 16k .. +15.  It walks the
// row's NP sub-pages of `page` slots (`nsub` a page of the table).
template <int DH, bool FULL, bool NARROW>
__global__ void __launch_bounds__(Prefill<DH>::THREADS)
prefill_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kc,
               const bf16* __restrict__ ks, const uint8_t* __restrict__ vc,
               const bf16* __restrict__ vs, const int* __restrict__ page_table,
               const int* __restrict__ start, float* __restrict__ out, int C, int NP,
               int page, int nsub, int Kh, int G, int Gs, int dh, float softcap,
               float scale) {
  if constexpr (!NARROW) dh = DH;
  constexpr int TILE = Prefill<DH>::TILE, NT = Prefill<DH>::THREADS;
  extern __shared__ __align__(16) uint8_t sm[];
  const int pg = FULL ? max_sub(DH) : page;  // known when compiled for full sub-pages
  const int tile = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const Smem s = carve(sm, page, Kh, Gs, DH, 2);
  const int sbytes = stage_bytes(page, Kh, Gs, DH);
  const int rows = C * G, st = start[b];
  const int last = st + (min((tile + 1) * TILE, rows) - 1) / G;  // the tile's last horizon
  const int npages = min(last / page, NP - 1) + 1;
  const int* pt = page_table + (size_t)b * (nsub == 1 ? NP : NP / nsub);
  stage_page<DH, NT, NARROW>(s.stage, kc, ks, vc, vs, sub_page(pt, 0, nsub), pg, Kh, h, Gs, dh);
  size_t next_pid = npages > 1 ? sub_page(pt, 1, nsub) : 0;  // loaded a page ahead of its use
  init_block(s, page, DH);

  const int team = threadIdx.x / TEAM, bar = 1 + team;
  const int lane = threadIdx.x % 32, g = lane / 4, w = (threadIdx.x / 32) % TEAM_WARPS;
  const Team tm = team_of(s, team, DH);
  const int row0 = tile * TILE + team * ROWS;
  const bool active = row0 < rows;
  const int tlast = st + (min(row0 + ROWS, rows) - 1) / G;  // the team's last horizon
  const int nq = active ? split_q<DH, NARROW>(tm, bar, q, b, h, row0, rows, C, Kh, G, dh) : 0;
  const int hz[2] = {st + (row0 + g) / G, st + (row0 + g + 8) / G};

  float M[2] = {NEG, NEG}, L[2] = {0.0f, 0.0f}, acc[DH / 32][4];
#pragma unroll
  for (int n = 0; n < DH / 32; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int t = 0; t < npages; ++t) {
    cp_async_wait_all();
    __syncthreads();  // page t staged; every team is done with page t-1
    if (t + 1 < npages) {
      stage_page<DH, NT, NARROW>(s.stage + ((t + 1) % 2) * sbytes, kc, ks, vc, vs, next_pid,
                                 pg, Kh, h, Gs, dh);
      if (t + 2 < npages) next_pid = sub_page(pt, t + 2, nsub);
    }
    if constexpr (NARROW)
      dequant_narrow<DH, NT>(s, s.stage + (t % 2) * sbytes, page, Kh, h, Gs, dh);
    else
      dequant_page<DH, NT>(s, s.stage + (t % 2) * sbytes, pg, Kh, h, Gs);
    __syncthreads();
    // a page wholly past the team's rows would fold with weight 0: skip it
    if (!active || t * page > tlast) continue;
    float mp[2], lp[2], accp[DH / 32][4];
    page_partial<DH, FULL>(s, tm, bar, nq, page, t * page, hz, 0, softcap, scale, mp, lp,
                           accp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const FoldWeights fw = fold_stats(M[i], L[i], mp[i], lp[i]);
#pragma unroll
      for (int n = 0; n < DH / 32; ++n) {
        acc[n][2 * i] = fold_value(acc[n][2 * i], accp[n][2 * i], fw);
        acc[n][2 * i + 1] = fold_value(acc[n][2 * i + 1], accp[n][2 * i + 1], fw);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= rows) continue;
    const int d = w * DH / 4 + 2 * (lane % 4);
    float* o = out + row_index(b, h, r, C, Kh, G) * dh + d;
#pragma unroll
    for (int n = 0; n < DH / 32; ++n) {
      const float x = __fdiv_rn(acc[n][2 * i], L[i]), y = __fdiv_rn(acc[n][2 * i + 1], L[i]);
      if constexpr (!NARROW) {
        *reinterpret_cast<float2*>(o + n * 8) = make_float2(x, y);
      } else {  // a narrower head: its own columns only, one float at a time
        if (d + n * 8 < dh) o[n * 8] = x;
        if (d + n * 8 + 1 < dh) o[n * 8 + 1] = y;
      }
    }
  }
}

// Allows `smem` bytes of dynamic shared memory for `kernel` when above the
// default 48 KB and above what an earlier call allowed (the attribute call
// costs the host more than a small launch); returns the CUDA error code.
template <auto Kernel>
int allow_smem(int smem) {
  static int allowed = 48 * 1024;  // one per kernel
  if (smem <= allowed) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// the wide route: heads of more than 256 columns
// ---------------------------------------------------------------------------

constexpr int WIDE_THREADS = 256;
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int WIDE_SLOTS = 2 * WIDE_WARPS;     // slots scored at once, two a warp
constexpr int WIDE_MAX_DH = 4096;              // q and O in 48 KB of shared memory

__host__ __device__ inline int wide_smem_bytes(int Dh) { return (256 + 2 * Dh + WIDE_SLOTS) * 4; }

// The (pool slot, kv head) row of logical slot kpos: pool sub-page
// table[u / nsub] * nsub + u % nsub of `page` slots, or sub-page b*NP + u
// of a contiguous cache when `row` is null.
__device__ __forceinline__ size_t wide_slot(const int* __restrict__ row, int b, int kpos,
                                            int NP, int page, int nsub, int Kh, int h) {
  const int u = kpos / page;
  const size_t pid = row != nullptr ? sub_page(row, u, nsub) : (size_t)b * NP + u;
  return (pid * page + kpos % page) * Kh + h;
}

// grid (rows, Kh, B): block (r, h, b) takes query row r of (b, h).  Decode
// (start null): rows r < G at the position (positions[b], or pos), slots
// from pad[b] on.  Prefill: rows r = qi*G + gi of a chunk at start[b],
// horizon start[b] + qi.  Slots stop at the table's last column.  A batch
// of WIDE_SLOTS slots: warp w scores slots k0 + w and k0 + w + 8; then each
// thread loads the batch's V values of one of its columns at once and folds
// them in slot order (the fold weights of a slot are the same in every
// thread: fold_stats on the same scores in the same order).
__global__ void __launch_bounds__(WIDE_THREADS)
wide_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kc,
            const bf16* __restrict__ ks, const uint8_t* __restrict__ vc,
            const bf16* __restrict__ vs, const int* __restrict__ page_table,
            const int* __restrict__ positions, const int* __restrict__ pad,
            const int* __restrict__ start, float* __restrict__ out, int C, int NP, int page,
            int nsub, int Kh, int G, int Dh, int Gs, int pos, float softcap, float scale) {
  extern __shared__ __align__(16) float wsm[];
  float* lut = wsm;
  float* qs = lut + 256;
  float* os = qs + Dh;
  float* sc = os + Dh;
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  int hz, pad_lo = 0;
  if (start != nullptr) {
    hz = start[b] + r / G;
  } else {
    hz = positions != nullptr ? positions[b] : pos;
    if (pad != nullptr) pad_lo = pad[b];
  }
  const int last = min(hz, NP * page - 1);
  const size_t qr = row_index(b, h, r, C, Kh, G) * Dh;
  for (int i = threadIdx.x; i < 256; i += WIDE_THREADS) lut[i] = Posit<8, 0>::decode(i);
  for (int d = threadIdx.x; d < Dh; d += WIDE_THREADS) {
    qs[d] = q[qr + d];
    os[d] = 0.0f;
  }
  __syncthreads();
  const int* row = page_table != nullptr ? page_table + (size_t)b * (NP / nsub) : nullptr;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, gw = Dh / Gs;
  float M = NEG, L = 0.0f;
  for (int k0 = pad_lo; k0 <= last; k0 += WIDE_SLOTS) {
    const int n = min(WIDE_SLOTS, last - k0 + 1);
    // scores: lane-strided fma over the columns, then a fixed xor tree
    const int j0 = w, j1 = w + WIDE_WARPS;
    const size_t s0 = wide_slot(row, b, k0 + min(j0, n - 1), NP, page, nsub, Kh, h);
    const size_t s1 = wide_slot(row, b, k0 + min(j1, n - 1), NP, page, nsub, Kh, h);
    float dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll 4
    for (int d = lane; d < Dh; d += 32) {
      const float k0v = __fmul_rn(lut[kc[s0 * Dh + d]], __bfloat162float(ks[s0 * Gs + d / gw]));
      const float k1v = __fmul_rn(lut[kc[s1 * Dh + d]], __bfloat162float(ks[s1 * Gs + d / gw]));
      dot0 = __fmaf_rn(qs[d], k0v, dot0);
      dot1 = __fmaf_rn(qs[d], k1v, dot1);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      dot0 = __fadd_rn(dot0, __shfl_xor_sync(0xffffffffu, dot0, o));
      dot1 = __fadd_rn(dot1, __shfl_xor_sync(0xffffffffu, dot1, o));
    }
    if (lane == 0) {
      float v0 = __fmul_rn(dot0, scale), v1 = __fmul_rn(dot1, scale);
      if (softcap > 0.0f) {
        v0 = tanhf(v0 / softcap) * softcap;
        v1 = tanhf(v1 / softcap) * softcap;
      }
      sc[j0] = v0;
      sc[j1] = v1;
    }
    __syncthreads();
    FoldWeights fw[WIDE_SLOTS];
    size_t sl[WIDE_SLOTS];
#pragma unroll
    for (int j = 0; j < WIDE_SLOTS; ++j) {
      if (j < n) {
        fw[j] = fold_stats(M, L, sc[j], 1.0f);
        sl[j] = wide_slot(row, b, k0 + j, NP, page, nsub, Kh, h);
      }
    }
    for (int d = threadIdx.x; d < Dh; d += WIDE_THREADS) {
      const int gi = d / gw;
      float v[WIDE_SLOTS];
#pragma unroll
      for (int j = 0; j < WIDE_SLOTS; ++j)
        v[j] = j < n ? __fmul_rn(lut[vc[sl[j] * Dh + d]], __bfloat162float(vs[sl[j] * Gs + gi]))
                     : 0.0f;
      float o = os[d];
#pragma unroll
      for (int j = 0; j < WIDE_SLOTS; ++j)
        if (j < n) o = fold_value(o, v[j], fw[j]);
      os[d] = o;
    }
    __syncthreads();  // sc is free again
  }
  for (int d = threadIdx.x; d < Dh; d += WIDE_THREADS) out[qr + d] = __fdiv_rn(os[d], L);
}

int launch_wide(const void* q, const void* kc, const void* ks, const void* vc, const void* vs,
                const void* page_table, const void* positions, const void* pad,
                const void* start, void* out, int B, int C, int NP, int page, int nsub, int Kh,
                int G, int Dh, int Gs, int pos, float softcap, float scale,
                cudaStream_t stream) {
  wide_kernel<<<dim3(C * G, Kh, B), WIDE_THREADS, wide_smem_bytes(Dh), stream>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const bf16*>(ks), static_cast<const uint8_t*>(vc),
      static_cast<const bf16*>(vs), static_cast<const int*>(page_table),
      static_cast<const int*>(positions), static_cast<const int*>(pad),
      static_cast<const int*>(start), static_cast<float*>(out), C, NP, page, nsub, Kh, G, Dh,
      Gs, pos, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// Dh in 1 .. 256 (the tensor-core kernels: a sub-page of 1 ..
// max_sub(width) slots) or 257 .. WIDE_MAX_DH (the wide route: any
// sub-page), nsub sub-pages a page of the table (NP, the row's sub-pages,
// a multiple of nsub).
bool supported(int Dh, int page, int nsub, int NP) {
  return Dh >= 1 && Dh <= WIDE_MAX_DH && page >= 1 &&
         (Dh > 256 || page <= max_sub(width_of(Dh))) && nsub >= 1 && NP % nsub == 0;
}

template <int DH, bool FULL, bool NARROW>
int launch_decode(const void* q, const void* kc, const void* ks, const void* vc,
                  const void* vs, const void* page_table, const void* positions,
                  const void* pad, void* scratch, void* out, int B, int NP, int page, int nsub,
                  int Kh, int G, int Dh, int Gs, int pos, float softcap, float scale,
                  cudaStream_t stream) {
  const int smem = smem_bytes(page, Kh, Gs, DH, 1, 1);
  if (const int err = allow_smem<decode_page_kernel<DH, FULL, NARROW>>(smem)) return err;
  float* acc = static_cast<float*>(scratch);
  const Partials part{acc, acc + (size_t)B * Kh * NP * G * DH};
  decode_page_kernel<DH, FULL, NARROW><<<dim3(NP, Kh, B), TEAM, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const bf16*>(ks), static_cast<const uint8_t*>(vc),
      static_cast<const bf16*>(vs), static_cast<const int*>(page_table),
      static_cast<const int*>(positions), static_cast<const int*>(pad), part, NP, page, nsub,
      Kh, G, Gs, Dh, pos, softcap, scale);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  const dim3 grid((G * Dh + FOLD_THREADS - 1) / FOLD_THREADS, Kh, B);
  decode_fold_kernel<<<grid, FOLD_THREADS, 0, stream>>>(
      part, static_cast<const int*>(positions), static_cast<const int*>(pad),
      static_cast<float*>(out), NP, page, Kh, G, Dh, DH, pos);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool FULL, bool NARROW>
int launch_prefill(const void* q, const void* kc, const void* ks, const void* vc,
                   const void* vs, const void* page_table, const void* start, void* out,
                   int B, int C, int NP, int page, int nsub, int Kh, int G, int Dh, int Gs,
                   float softcap, float scale, cudaStream_t stream) {
  using P = Prefill<DH>;
  const int smem = smem_bytes(page, Kh, Gs, DH, 2, P::TEAMS);
  if (const int err = allow_smem<prefill_kernel<DH, FULL, NARROW>>(smem)) return err;
  const dim3 grid((C * G + P::TILE - 1) / P::TILE, Kh, B);
  prefill_kernel<DH, FULL, NARROW><<<grid, P::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const bf16*>(ks), static_cast<const uint8_t*>(vc),
      static_cast<const bf16*>(vs), static_cast<const int*>(page_table),
      static_cast<const int*>(start), static_cast<float*>(out), C, NP, page, nsub, Kh, G, Gs,
      Dh, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for a shape it does not take (supported).

// The instantiations: at each width 32, 64, 128, 256, a head of that
// width on full sub-pages (page == max_sub(width), known when compiled)
// and on any other, and a narrower head (on any sub-page: the full-page
// path only drops tests that hold anyway).
#define XRNPE_DISPATCH(LAUNCH)                                                        \
  const int W = width_of(Dh);                                                         \
  if (Dh != W)                                                                        \
    return W == 32 ? LAUNCH(32, false, true)                                          \
           : W == 64 ? LAUNCH(64, false, true)                                        \
           : W == 128 ? LAUNCH(128, false, true) : LAUNCH(256, false, true);          \
  if (page == max_sub(W))                                                             \
    return W == 32 ? LAUNCH(32, true, false)                                          \
           : W == 64 ? LAUNCH(64, true, false)                                        \
           : W == 128 ? LAUNCH(128, true, false) : LAUNCH(256, true, false);          \
  return W == 32 ? LAUNCH(32, false, false)                                           \
         : W == 64 ? LAUNCH(64, false, false)                                         \
         : W == 128 ? LAUNCH(128, false, false) : LAUNCH(256, false, false)

// One-token decode over a pool, or over a contiguous cache (B, NP*page, Kh,
// Dh) when `page_table` is null.  `page` is the sub-page the kernels walk,
// `nsub` of them a page of the table (B, NP / nsub); NP counts a row's
// sub-pages.  `positions` (B,) may be null: every row at `pos`.  `pad`
// (B,) may be null: no left pad.  `scratch` holds B*Kh*NP*G*(width(Dh) + 2)
// floats.  Two kernels: the sub-page partials, the fold; above 256 columns
// one, the wide route, which needs no scratch.
extern "C" int paged_flash_decode(const void* q, const void* k_codes, const void* k_scale,
                                  const void* v_codes, const void* v_scale,
                                  const void* page_table, const void* positions,
                                  const void* pad, void* scratch, void* out, int B, int NP,
                                  int page, int nsub, int Kh, int G, int Dh, int Gs, int pos,
                                  float softcap, float scale, void* stream) {
  if (!supported(Dh, page, nsub, NP)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh > 256)
    return launch_wide(q, k_codes, k_scale, v_codes, v_scale, page_table, positions, pad,
                       nullptr, out, B, 1, NP, page, nsub, Kh, G, Dh, Gs, pos, softcap, scale,
                       st);
#define XRNPE_DECODE(DH, FULL, NARROW)                                                     \
  launch_decode<DH, FULL, NARROW>(q, k_codes, k_scale, v_codes, v_scale, page_table, positions,   \
                          pad, scratch, out, B, NP, page, nsub, Kh, G, Dh, Gs, pos, softcap, \
                          scale, st)
  XRNPE_DISPATCH(XRNPE_DECODE);
#undef XRNPE_DECODE
}

// Chunk prefill over a pool: q (B, C, Kh, G, Dh), page table (B, NP / nsub),
// sub-pages as in paged_flash_decode.
extern "C" int paged_flash_prefill(const void* q, const void* k_codes, const void* k_scale,
                                   const void* v_codes, const void* v_scale,
                                   const void* page_table, const void* start, void* out,
                                   int B, int C, int NP, int page, int nsub, int Kh, int G,
                                   int Dh, int Gs, float softcap, float scale, void* stream) {
  if (!supported(Dh, page, nsub, NP)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh > 256)
    return launch_wide(q, k_codes, k_scale, v_codes, v_scale, page_table, nullptr, nullptr,
                       start, out, B, C, NP, page, nsub, Kh, G, Dh, Gs, 0, softcap, scale, st);
#define XRNPE_PREFILL(DH, FULL, NARROW)                                                    \
  launch_prefill<DH, FULL, NARROW>(q, k_codes, k_scale, v_codes, v_scale, page_table, start, out,  \
                           B, C, NP, page, nsub, Kh, G, Dh, Gs, softcap, scale, st)
  XRNPE_DISPATCH(XRNPE_PREFILL);
#undef XRNPE_PREFILL
}
