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

}  // namespace f62
