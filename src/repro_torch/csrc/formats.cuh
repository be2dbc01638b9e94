// Branch-free decoders of the XR-NPE number formats, for use inside
// kernels: the device twins of repro_torch/core/formats.py
// (decode_posit_bits, decode_minifloat_bits and the fixed-point decode),
// and the posit encoder (encode_posit_bits).
// Each format is a type with a compile-time bit width, so a kernel
// templated on it unpacks and decodes in registers with no table.
// NaR and NaN codes decode to 0, as on the Python side.
#pragma once

#include <stdint.h>

namespace xrnpe {

// Exact 2^e as a float for -126 <= e <= 127.
__device__ __forceinline__ float pow2i(int e) {
  return __int_as_float((e + 127) << 23);
}

template <int N, int ES>
struct Posit {
  static constexpr int BITS = N;
  __device__ __forceinline__ static float decode(uint32_t code) {
    constexpr int B = N - 1;
    const int c = static_cast<int>(code & ((1u << N) - 1u));
    if (c == 0 || c == (1 << B)) return 0.0f;  // zero and NaR
    const int neg = (c >> B) & 1;
    const int mag = neg ? (1 << N) - c : c;
    const int body = mag & ((1 << B) - 1);
    const int r0 = (body >> (B - 1)) & 1;
    const int t = (r0 ? ~body : body) & ((1 << B) - 1);
    // regime run length: leading zeros of t seen as a B-bit integer
    const int m = min(max(__clz(t) - (32 - B), 0), B);
    const int k = r0 ? m - 1 : -m;
    const int rem = B - min(m + 1, B);
    const int eb = min(ES, rem);
    int e = 0;
    if constexpr (ES > 0) {
      if (eb > 0) e = ((body >> max(rem - eb, 0)) & ((1 << ES) - 1)) << (ES - eb);
    }
    const int fbits = rem - eb;
    const int frac = body & ((1 << fbits) - 1);
    const float val = (1.0f + static_cast<float>(frac) * pow2i(-fbits)) *
                      pow2i(k * (1 << ES) + e);
    return neg ? -val : val;
  }

  // Branch-free encode with exact round-to-nearest-even, the twin of
  // encode_posit_bits: regime | exponent | the top 13 mantissa bits in
  // one int, rounded once at the final width with a guard bit and a
  // sticky bit (the 10 mantissa bits below count as sticky).  Saturates
  // to +-maxpos (also +-Inf); a nonzero value never rounds to zero
  // (+-minpos); zero, -0 and float32 subnormals encode as 0; NaN as NaR.
  __device__ __forceinline__ static uint32_t encode(float x) {
    constexpr int B = N - 1;
    constexpr int MAXSCALE = (N - 2) << ES;
    const uint32_t bits = __float_as_uint(x);
    const uint32_t mag = bits & 0x7fffffffu;
    if (mag > 0x7f800000u) return 1u << B;   // NaN -> NaR
    if (mag < 0x00800000u) return 0u;        // zero and subnormals
    const int raw = static_cast<int>(mag >> 23) - 127;   // Inf: above MAXSCALE
    const int m23 = static_cast<int>(mag & 0x7fffffu);
    const int scale = min(max(raw, -MAXSCALE), MAXSCALE);
    const int k = scale >> ES;
    const int e = scale - (k << ES);
    const int r = k >= 0 ? k + 2 : 1 - k;
    const int pattern = k >= 0 ? ((1 << (k + 1)) - 1) << 1 : 1;
    const int v = (pattern << (ES + 13)) | (e << 13) | (m23 >> 10);
    const int drop = r + ES + 13 - B;
    const int keep = v >> drop;
    const int guard = (v >> (drop - 1)) & 1;
    const int sticky = ((v & ((1 << (drop - 1)) - 1)) != 0) | ((m23 & 1023) != 0);
    int body = min(max(keep + (guard & (sticky | (keep & 1))), 1), (1 << B) - 1);
    if (raw < -MAXSCALE) body = 1;
    if (raw > MAXSCALE) body = (1 << B) - 1;
    const uint32_t u = static_cast<uint32_t>(body);
    return (bits >> 31) ? ((1u << N) - u) & ((1u << N) - 1u) : u;
  }
};

template <int EB, int MB, bool HAS_NAN>
struct Minifloat {
  static constexpr int BITS = 1 + EB + MB;
  __device__ __forceinline__ static float decode(uint32_t code) {
    constexpr int BIAS = (1 << (EB - 1)) - 1;
    const int c = static_cast<int>(code & ((1u << BITS) - 1u));
    const int e = (c >> MB) & ((1 << EB) - 1);
    const int m = c & ((1 << MB) - 1);
    if (HAS_NAN && e == (1 << EB) - 1 && m == (1 << MB) - 1) return 0.0f;
    const float fm = static_cast<float>(m) * pow2i(-MB);
    const float val = e == 0 ? fm * pow2i(1 - BIAS) : (1.0f + fm) * pow2i(e - BIAS);
    return ((c >> (EB + MB)) & 1) ? -val : val;
  }
};

template <int BITS_, int FRAC>
struct Fixed {
  static constexpr int BITS = BITS_;
  __device__ __forceinline__ static float decode(uint32_t code) {
    int c = static_cast<int>(code & ((1u << BITS) - 1u));
    if (c >= (1 << (BITS - 1))) c -= 1 << BITS;
    return static_cast<float>(c) * pow2i(-FRAC);
  }
};

// FormatSpec.kind codes shared with the Python wrappers.
enum Kind { KIND_POSIT = 0, KIND_MINIFLOAT = 1, KIND_FIXED = 2 };

}  // namespace xrnpe
