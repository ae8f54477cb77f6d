// f128 field arithmetic on the device: p = 2^128 - 45·2^40 + 1, an element a
// pair of little-endian u64 words (lo, hi), the port's layout (the element's
// 16 bytes). Shared by the kernels of f128.cu.
//
// The functions follow the JAX engine's steps (winterfell_tpu/ops/f128.py
// f128_add / f128_sub / f128_mul, :161-249), so that they agree with the
// plain versions of ops/f128.py bit for bit on every 128-bit input, not only
// on canonical ones:
//
// - add: the 128-bit sum; a carry out of bit 128 adds φ = 2^128 mod p =
//   45·2^40 - 1 (mod 2^128); then one conditional subtract of p;
// - sub: the 128-bit difference; a borrow adds p (mod 2^128);
// - mul: the 256-bit product from four 64×64→128 partial products
//   (mul.lo / mul.hi), folded twice with 2^128 ≡ φ, then one conditional
//   subtract: the canonical product for every pair of inputs < 2^128
//   (the same schedule as native/f128.c f128_mul).

#pragma once

#include <cstdint>

namespace f128 {

constexpr uint64_t P_LO = 0xFFFFD30000000001ull;
constexpr uint64_t P_HI = 0xFFFFFFFFFFFFFFFFull;
constexpr uint64_t PHI = (45ull << 40) - 1;  // 2^128 mod p, < 2^46

typedef unsigned __int128 u128;

struct E {
  uint64_t lo, hi;
};

// a >= p: p's high word is all ones
__device__ __forceinline__ E cond_sub_p(E a) {
  if (a.hi == P_HI && a.lo >= P_LO) {
    a.lo -= P_LO;
    a.hi = 0;
  }
  return a;
}

__device__ __forceinline__ E add(E a, E b) {
  E r;
  r.lo = a.lo + b.lo;
  const uint64_t c0 = r.lo < a.lo;
  const uint64_t h = a.hi + b.hi;
  r.hi = h + c0;
  const bool carry = h < a.hi || r.hi < h;
  if (carry) {  // 2^128 + r ≡ r + φ, mod 2^128
    const uint64_t lo = r.lo + PHI;
    r.hi += lo < r.lo;
    r.lo = lo;
  }
  return cond_sub_p(r);
}

__device__ __forceinline__ E sub(E a, E b) {
  E r;
  const uint64_t b0 = a.lo < b.lo;
  r.lo = a.lo - b.lo;
  r.hi = a.hi - b.hi - b0;
  const bool borrow = a.hi < b.hi || (a.hi == b.hi && b0);
  if (borrow) {  // + p, mod 2^128
    const uint64_t lo = r.lo + P_LO;
    r.hi += P_HI + (lo < r.lo);
    r.lo = lo;
  }
  return r;
}

__device__ __forceinline__ E mul(E a, E b) {
  const u128 p00 = static_cast<u128>(a.lo) * b.lo;
  const u128 p01 = static_cast<u128>(a.lo) * b.hi;
  const u128 p10 = static_cast<u128>(a.hi) * b.lo;
  const u128 p11 = static_cast<u128>(a.hi) * b.hi;
  // the product r3·2^192 + r2·2^128 + r1·2^64 + r0
  const uint64_t r0 = static_cast<uint64_t>(p00);
  const u128 mid = (p00 >> 64) + static_cast<uint64_t>(p01) +
                   static_cast<uint64_t>(p10);
  const uint64_t r1 = static_cast<uint64_t>(mid);
  const u128 top = (mid >> 64) + (p01 >> 64) + (p10 >> 64) +
                   static_cast<uint64_t>(p11);
  const uint64_t r2 = static_cast<uint64_t>(top);
  const uint64_t r3 = static_cast<uint64_t>(top >> 64) +
                      static_cast<uint64_t>(p11 >> 64);
  // fold 1: (r3·2^64 + r2)·φ + r1·2^64 + r0 < 2^175
  const u128 t0 = static_cast<u128>(r2) * PHI + r0;
  const u128 t1 = static_cast<u128>(r3) * PHI + r1 + (t0 >> 64);
  const uint64_t s0 = static_cast<uint64_t>(t0);
  const uint64_t s1 = static_cast<uint64_t>(t1);
  const uint64_t s2 = static_cast<uint64_t>(t1 >> 64);  // < 2^47
  // fold 2: s2·φ + s1·2^64 + s0; a wrap past 2^128 adds φ once more
  const u128 u0 = static_cast<u128>(s2) * PHI + s0;
  E r;
  r.lo = static_cast<uint64_t>(u0);
  const u128 u1 = static_cast<u128>(s1) + static_cast<uint64_t>(u0 >> 64);
  r.hi = static_cast<uint64_t>(u1);
  if (static_cast<uint64_t>(u1 >> 64)) {
    const uint64_t lo = r.lo + PHI;
    r.hi += lo < r.lo;
    r.lo = lo;
  }
  return cond_sub_p(r);
}

__device__ __forceinline__ E load(const uint64_t* p) {
  return E{__ldg(p), __ldg(p + 1)};
}

__device__ __forceinline__ void store(uint64_t* p, E v) {
  p[0] = v.lo;
  p[1] = v.hi;
}

}  // namespace f128
