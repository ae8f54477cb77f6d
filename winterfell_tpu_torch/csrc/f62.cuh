// f62 field arithmetic on the device: p = 2^62 - 111·2^39 + 1, an element
// one u64 holding its canonical value (the port's layout: the element's 8
// little-endian bytes). Shared by the kernels of f62.cu and rp62.cu.
//
// The functions take canonical operands and return canonical results, so
// they agree with the JAX engine (winterfell_tpu/ops/f62.py base_add :132,
// base_sub :140, base_mul :188, which compute on two 32-bit limbs) and with
// the plain versions of ops/f62.py on every canonical input:
//
// - add: a + b < 2^63 never overflows; one conditional subtract of p;
// - sub: a - b, plus p on a borrow;
// - mul: the 124-bit product (a·b and __umul64hi), reduced by folding
//   x = (x >> 62)·E + (x mod 2^62) with 2^62 ≡ E = 111·2^39 - 1 (mod p) four
//   times (124 -> 108 -> 92 -> 76 -> below 2^62 + 2^60 bits), then one
//   conditional subtract: the JAX base_mul's schedule (:155-206), in 64-bit
//   words. E is 46 bits, so a fold is one 64×46-bit product.
//
// The Rescue body of rp62.cu computes in Montgomery form instead (the
// mont_* functions below): an element x is held as any u64 congruent to
// x·R (R = 2^64) mod p, not necessarily below p (lazy). p - 1 = K·2^32 with
// K = 2^30 - 14208, so -p^-1 ≡ -1 (mod 2^32): a reduction step clears the
// low 32-bit word of a wide value v by adding m·p with m = -v mod 2^32,
// which is m + m·K·2^32 — one 32×32-bit multiply-add pair with the
// constant K and no multiply to find m. Two steps take a 128-bit value v
// below 2^126 to (v + M·p) / 2^64 ≡ v·2^-64, below 2^62 + p < 2^63; so
// lazy values below 2^63 multiply without any compare or select. The
// products are 32-bit partial products with carry chains in PTX (a square
// takes three). Values are brought below p (or below 2^62, a bound the
// caller needs) only where the caller reads them (canon_below).

#pragma once

#include <cstdint>

namespace f62 {

constexpr uint64_t P = 0x3FFFC88000000001ull;   // 2^62 - 111·2^39 + 1
constexpr uint64_t E = 0x377FFFFFFFFFull;       // 2^62 mod p = 111·2^39 - 1
constexpr uint64_t M62 = (1ull << 62) - 1;

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d + P : d;
}

// One fold of the value hi·2^64 + lo (hi < 2^62): (value >> 62)·E +
// (value mod 2^62), as the new (hi, lo).
__device__ __forceinline__ void fold(uint64_t& hi, uint64_t& lo) {
  const uint64_t h = (hi << 2) | (lo >> 62);  // value >> 62
  const uint64_t l = lo & M62;
  const uint64_t plo = h * E;
  const uint64_t phi = __umul64hi(h, E);
  lo = plo + l;
  hi = phi + (lo < plo);
}

// hi·2^64 + lo mod p for any 128-bit value, canonical: one fold with
// 2^64 ≡ 4·E (below 2^113), then the four of mul.
__device__ __forceinline__ uint64_t reduce_wide(uint64_t hi, uint64_t lo) {
  constexpr uint64_t C64 = 4 * E;  // 2^64 mod p
  const uint64_t plo = hi * C64;
  lo += plo;
  hi = __umul64hi(hi, C64) + (lo < plo);
  fold(hi, lo);  // < 2^97
  fold(hi, lo);  // < 2^81
  fold(hi, lo);  // < 2^65 + 2^62
  fold(hi, lo);  // < 2^62 + 2^50: hi is 0
  return lo >= P ? lo - P : lo;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  uint64_t lo = a * b;
  uint64_t hi = __umul64hi(a, b);
  fold(hi, lo);  // < 2^108
  fold(hi, lo);  // < 2^92
  fold(hi, lo);  // < 2^76
  fold(hi, lo);  // < 2^62 + 2^60 < 2p: hi is 0
  return lo >= P ? lo - P : lo;
}

// ---- Montgomery form, lazy (see the header note) -------------------------

constexpr uint64_t R2 = 0x08BFC9FCFDED6444ull;  // 2^128 mod p

// x - q if x >= q, else x
__device__ __forceinline__ uint64_t canon_below(uint64_t x, uint64_t q) {
  return x >= q ? x - q : x;
}

// The two reduction steps on the 128-bit value n3·2^96 + ... + n0 held in
// the asm registers n0..n3 (k = K, m and c scratch); the result,
// (v + M·p) / 2^64, is left in {n2, n3}. The carry of n0 + m is 1 exactly
// when n0 != 0, the carry that clearing the low word sends up.
#define F62_MONT_STEPS                 \
  "neg.s32 m, n0;\n\t"                 \
  "add.cc.u32 c, n0, m;\n\t"           \
  "madc.lo.cc.u32 n1, m, k, n1;\n\t"   \
  "madc.hi.cc.u32 n2, m, k, n2;\n\t"   \
  "addc.u32 n3, n3, 0;\n\t"            \
  "neg.s32 m, n1;\n\t"                 \
  "add.cc.u32 c, n1, m;\n\t"           \
  "madc.lo.cc.u32 n2, m, k, n2;\n\t"   \
  "madc.hi.u32 n3, m, k, n3;\n\t"

// v·2^-64 mod p for the 128-bit v = n3·2^96 + n2·2^64 + n1·2^32 + n0 <
// 2^128 whose result fits: below v/2^64 + p (below 2^62 + p for v < 2^126).
__device__ __forceinline__ uint64_t mont_reduce(uint32_t n0_, uint32_t n1_,
                                                uint32_t n2_, uint32_t n3_) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 n0, n1, n2, n3, m, c, k;\n\t"
      "mov.u32 n0, %1;\n\t"
      "mov.u32 n1, %2;\n\t"
      "mov.u32 n2, %3;\n\t"
      "mov.u32 n3, %4;\n\t"
      "mov.u32 k, 0x3FFFC880;\n\t"
      F62_MONT_STEPS
      "mov.b64 %0, {n2, n3};\n\t"
      "}"
      : "=l"(r)
      : "r"(n0_), "r"(n1_), "r"(n2_), "r"(n3_));
  return r;
}

// a·b·2^-64 mod p for a, b < 2^63: four partial products, below 2^62 + p.
__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, n0, n1, n2, n3, m, c, k;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "mov.u32 k, 0x3FFFC880;\n\t"
      "mul.lo.u32 n0, a0, b0;\n\t"
      "mul.hi.u32 n1, a0, b0;\n\t"
      "mul.lo.u32 n2, a1, b1;\n\t"
      "mul.hi.u32 n3, a1, b1;\n\t"
      "mad.lo.cc.u32 n1, a0, b1, n1;\n\t"
      "madc.hi.cc.u32 n2, a0, b1, n2;\n\t"
      "addc.u32 n3, n3, 0;\n\t"
      "mad.lo.cc.u32 n1, a1, b0, n1;\n\t"
      "madc.hi.cc.u32 n2, a1, b0, n2;\n\t"
      "addc.u32 n3, n3, 0;\n\t"
      F62_MONT_STEPS
      "mov.b64 %0, {n2, n3};\n\t"
      "}"
      : "=l"(r)
      : "l"(a), "l"(b));
  return r;
}

// a²·2^-64 mod p for a < 2^63: three partial products (a0², a1², and a0
// times 2·a1, which fits 32 bits as a1 < 2^31), below 2^62 + p.
__device__ __forceinline__ uint64_t mont_sqr(uint64_t a) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, d1, n0, n1, n2, n3, m, c, k;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.u32 k, 0x3FFFC880;\n\t"
      "shl.b32 d1, a1, 1;\n\t"
      "mul.lo.u32 n0, a0, a0;\n\t"
      "mul.hi.u32 n1, a0, a0;\n\t"
      "mul.lo.u32 n2, a1, a1;\n\t"
      "mul.hi.u32 n3, a1, a1;\n\t"
      "mad.lo.cc.u32 n1, a0, d1, n1;\n\t"
      "madc.hi.cc.u32 n2, a0, d1, n2;\n\t"
      "addc.u32 n3, n3, 0;\n\t"
      F62_MONT_STEPS
      "mov.b64 %0, {n2, n3};\n\t"
      "}"
      : "=l"(r)
      : "l"(a));
  return r;
}

#undef F62_MONT_STEPS

// acc += a·b over a 128-bit accumulator of four words; the caller keeps
// the sum below 2^128.
__device__ __forceinline__ void mont_mac(uint32_t (&acc)[4], uint64_t a,
                                         uint64_t b) {
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1;\n\t"
      "mov.b64 {a0, a1}, %4;\n\t"
      "mov.b64 {b0, b1}, %5;\n\t"
      "mad.lo.cc.u32 %0, a0, b0, %0;\n\t"
      "madc.hi.cc.u32 %1, a0, b0, %1;\n\t"
      "madc.lo.cc.u32 %2, a1, b1, %2;\n\t"
      "madc.hi.u32 %3, a1, b1, %3;\n\t"
      "mad.lo.cc.u32 %1, a0, b1, %1;\n\t"
      "madc.hi.cc.u32 %2, a0, b1, %2;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "mad.lo.cc.u32 %1, a1, b0, %1;\n\t"
      "madc.hi.cc.u32 %2, a1, b0, %2;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "}"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "l"(a), "l"(b));
}

// A canonical (or any u64 below 2^63) x into Montgomery form: x·R, below
// 2^62 + p.
__device__ __forceinline__ uint64_t to_mont(uint64_t x) {
  return mont_mul(x, R2);
}

// Montgomery form (any x below 2^63) back to the canonical element.
__device__ __forceinline__ uint64_t from_mont(uint64_t x) {
  return canon_below(mont_reduce(static_cast<uint32_t>(x),
                                 static_cast<uint32_t>(x >> 32), 0, 0),
                     P);
}

}  // namespace f62
