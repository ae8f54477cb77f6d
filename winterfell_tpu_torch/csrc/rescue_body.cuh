// Goldilocks arithmetic with lazy values and the Rescue-XLIX permutation
// body, shared by the Rescue-Prime kernels of this directory: Rp64_256
// (rescue.cu, width 12) and RpJive64_256 (jive.cu, width 8). Both hashers
// use the S-box x^7, its inverse x^INV_ALPHA by the same addition chain,
// and a circulant MDS matrix with small entries, so only the width and the
// MDS row differ. rescue.cu explains each choice of this body (lazy
// values, PTX carry chains, 3-product squarings, the MDS as immediate
// multiply-adds, lanes across a group of threads).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int RESCUE_ROUNDS = 7;

__device__ __forceinline__ uint64_t canon(uint64_t s) {
  return s >= P ? s - P : s;
}

// a + b for canonical a, b; canonical.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  s += (s < a) ? EPS : 0;  // 2^64 ≡ 2^32 - 1; cannot wrap again for a, b < p
  return canon(s);
}

// The 128-bit value n3·2^96 + n2·2^64 + n1·2^32 + n0 mod p as a lazy value
// (< 2^64, not necessarily < p). With 2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 it is
// (n0 + (n1 + n2)·2^32) - (n2 + n3) = r + t·2^64 with t in {-1, 0, 1} from
// the carries, and t·2^64 ≡ t·(2^32 - 1), which cannot wrap r again. Carry
// chains only: no compare, no select.
__device__ __forceinline__ uint64_t reduce_lazy(uint32_t n0, uint32_t n1,
                                                uint32_t n2, uint32_t n3) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 x1, c, y0, y1, r0, r1, t, u, v;\n\t"
      "add.cc.u32 x1, %2, %3;\n\t"   // x = n0 + (n1 + n2)·2^32, carry c
      "addc.u32 c, 0, 0;\n\t"
      "add.cc.u32 y0, %3, %4;\n\t"   // y = n2 + n3
      "addc.u32 y1, 0, 0;\n\t"
      "sub.cc.u32 r0, %1, y0;\n\t"   // r = x - y; t = c - borrow
      "subc.cc.u32 r1, x1, y1;\n\t"
      "subc.u32 t, c, 0;\n\t"
      "neg.s32 u, t;\n\t"            // t·(2^32 - 1) = (t >> 31 : -t)
      "shr.s32 v, t, 31;\n\t"
      "add.cc.u32 r0, r0, u;\n\t"
      "addc.u32 r1, r1, v;\n\t"
      "mov.b64 %0, {r0, r1};\n\t"
      "}"
      : "=l"(r)
      : "r"(n0), "r"(n1), "r"(n2), "r"(n3));
  return r;
}

// a·b mod p, lazy, for any u64 a, b: four 32×32→64 partial products
// accumulated with carries.
__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  uint32_t n0, n1, n2, n3;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, m0, m1, m2, m3;\n\t"
      "mov.b64 {a0, a1}, %4;\n\t"
      "mov.b64 {b0, b1}, %5;\n\t"
      "mul.lo.u32 m0, a0, b0;\n\t"
      "mul.hi.u32 m1, a0, b0;\n\t"
      "mul.lo.u32 m2, a1, b1;\n\t"
      "mul.hi.u32 m3, a1, b1;\n\t"
      "mad.lo.cc.u32 m1, a0, b1, m1;\n\t"
      "madc.hi.cc.u32 m2, a0, b1, m2;\n\t"
      "addc.u32 m3, m3, 0;\n\t"
      "mad.lo.cc.u32 m1, a1, b0, m1;\n\t"
      "madc.hi.cc.u32 m2, a1, b0, m2;\n\t"
      "addc.u32 m3, m3, 0;\n\t"
      "mov.u32 %0, m0;\n\t"
      "mov.u32 %1, m1;\n\t"
      "mov.u32 %2, m2;\n\t"
      "mov.u32 %3, m3;\n\t"
      "}"
      : "=r"(n0), "=r"(n1), "=r"(n2), "=r"(n3)
      : "l"(a), "l"(b));
  return reduce_lazy(n0, n1, n2, n3);
}

// a² mod p, lazy: three partial products, a0·a1 added twice at 2^32.
__device__ __forceinline__ uint64_t sqr_lazy(uint64_t a) {
  uint32_t n0, n1, n2, n3;
  asm("{\n\t"
      ".reg .u32 a0, a1, l, h, m0, m1, m2, m3;\n\t"
      "mov.b64 {a0, a1}, %4;\n\t"
      "mul.lo.u32 m0, a0, a0;\n\t"
      "mul.hi.u32 m1, a0, a0;\n\t"
      "mul.lo.u32 m2, a1, a1;\n\t"
      "mul.hi.u32 m3, a1, a1;\n\t"
      "mul.lo.u32 l, a0, a1;\n\t"
      "mul.hi.u32 h, a0, a1;\n\t"
      "add.cc.u32 m1, m1, l;\n\t"
      "addc.cc.u32 m2, m2, h;\n\t"
      "addc.u32 m3, m3, 0;\n\t"
      "add.cc.u32 m1, m1, l;\n\t"
      "addc.cc.u32 m2, m2, h;\n\t"
      "addc.u32 m3, m3, 0;\n\t"
      "mov.u32 %0, m0;\n\t"
      "mov.u32 %1, m1;\n\t"
      "mov.u32 %2, m2;\n\t"
      "mov.u32 %3, m3;\n\t"
      "}"
      : "=r"(n0), "=r"(n1), "=r"(n2), "=r"(n3)
      : "l"(a));
  return reduce_lazy(n0, n1, n2, n3);
}

// acc + x·c for 32-bit x and c: one IMAD.WIDE.U32 (c a constant after
// unrolling, so an immediate).
__device__ __forceinline__ uint64_t mad_wide(uint32_t x, uint32_t c,
                                             uint64_t acc) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(x), "r"(c), "l"(acc));
  return r;
}

// s <- MDS · s + ark over a state of W lanes, for the L = W / G lanes t·L ..
// t·L + L - 1 that this thread holds (t = its place in its group of G
// neighbouring threads); ark points at this thread's first lane's constant.
// The MDS matrix is circulant: output i is sum_d Mds::coef(d)·s[(i + d) mod
// W], every coefficient small (their sum below 2^8). Inputs lazy, outputs
// lazy. With G > 1 every thread of the warp must call it together
// (full-warp shuffles).
template <int W, int G, class Mds>
__device__ __forceinline__ void mds_ark(uint64_t (&s)[W / G],
                                        const uint64_t* ark, int t) {
  constexpr int L = W / G;
  // v[q] = lane (t·L + q) mod W: this thread's lanes, then the next
  // threads' of the group in turn
  uint64_t v[W];
#pragma unroll
  for (int e = 0; e < G; ++e)
#pragma unroll
    for (int f = 0; f < L; ++f)
      v[e * L + f] = e == 0 ? s[f]
                            : __shfl_sync(0xFFFFFFFFu, s[f], (t + e) & (G - 1), G);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    // the exact sums over the 32-bit halves: each < 2^8·2^32 = 2^40
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int d = 0; d < W; ++d) {
      const uint64_t x = v[(j + d) % W];
      acc_lo = mad_wide(static_cast<uint32_t>(x), Mds::coef(d), acc_lo);
      acc_hi = mad_wide(static_cast<uint32_t>(x >> 32), Mds::coef(d), acc_hi);
    }
    // acc_lo + acc_hi·2^32 + ark = n2·2^64 + n1·2^32 + n0, n2 < 2^9
    const uint64_t c = ark[j];
    uint32_t n0, n1, n2;
    asm("{\n\t"
        ".reg .u32 l0, l1, h0, h1, k0, k1;\n\t"
        "mov.b64 {l0, l1}, %3;\n\t"
        "mov.b64 {h0, h1}, %4;\n\t"
        "mov.b64 {k0, k1}, %5;\n\t"
        "add.cc.u32 l1, l1, h0;\n\t"
        "addc.u32 h1, h1, 0;\n\t"
        "add.cc.u32 l0, l0, k0;\n\t"
        "addc.cc.u32 l1, l1, k1;\n\t"
        "addc.u32 h1, h1, 0;\n\t"
        "mov.u32 %0, l0;\n\t"
        "mov.u32 %1, l1;\n\t"
        "mov.u32 %2, h1;\n\t"
        "}"
        : "=r"(n0), "=r"(n1), "=r"(n2)
        : "l"(acc_lo), "l"(acc_hi), "l"(c));
    s[j] = reduce_lazy(n0, n1, n2, 0);
  }
}

template <int L>
__device__ __forceinline__ void sbox(uint64_t (&s)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t x2 = sqr_lazy(s[j]);
    const uint64_t x4 = sqr_lazy(x2);
    s[j] = mul_lazy(mul_lazy(x4, x2), s[j]);
  }
}

template <int L>
__device__ __forceinline__ void sqr_all(uint64_t (&x)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = sqr_lazy(x[j]);
}

// x <- x^(2^k) on every lane, k >= 3, as a loop; the lanes interleave
// inside each step.
template <int L>
__device__ __forceinline__ void squares(uint64_t (&x)[L], int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) sqr_all<L>(x);
}

template <int L>
__device__ __forceinline__ void mul_into(uint64_t (&x)[L], const uint64_t (&y)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = mul_lazy(x[j], y[j]);
}

// x^INV_ALPHA by the reference's 72-multiplication addition chain
// (rp64_256/mod.rs apply_inv_sbox; INV_ALPHA = 10540996611094048183).
template <int L>
__device__ __forceinline__ void inv_sbox(uint64_t (&s)[L]) {
  uint64_t b[L], t3[L], t4[L], w[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t t1 = sqr_lazy(s[j]);
    w[j] = sqr_lazy(t1);                          // t2
    b[j] = mul_lazy(mul_lazy(t1, w[j]), s[j]);    // t1·t2·x
    t3[j] = w[j];
  }
  squares<L>(t3, 3);
  mul_into<L>(t3, w);                             // t3 = t2^(2^3)·t2
#pragma unroll
  for (int j = 0; j < L; ++j) t4[j] = t3[j];
  squares<L>(t4, 6);
  mul_into<L>(t4, t3);                            // t4 = t3^(2^6)·t3
#pragma unroll
  for (int j = 0; j < L; ++j) w[j] = t4[j];
  squares<L>(w, 12);
  mul_into<L>(w, t4);                             // t5 = t4^(2^12)·t4
  squares<L>(w, 6);
  mul_into<L>(w, t3);                             // t6 = t5^(2^6)·t3
#pragma unroll
  for (int j = 0; j < L; ++j) t4[j] = w[j];       // t4 now holds t6
  squares<L>(w, 31);
  mul_into<L>(w, t4);                             // t7 = t6^(2^31)·t6
  sqr_all<L>(w);
  mul_into<L>(w, t4);                             // t7²·t6
  sqr_all<L>(w);
  sqr_all<L>(w);
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = mul_lazy(w[j], b[j]);
}

// The Rescue-XLIX permutation (7 rounds of S-box x^7, MDS, ARK1, inverse
// S-box x^(1/7), MDS, ARK2) of the lanes this thread holds (see mds_ark);
// ark_s is the (2, 7, W) round-constant table in shared memory. Any u64
// inputs; canonical outputs. With G > 1 every thread of the warp calls it
// together.
template <int W, int G, class Mds>
__device__ __forceinline__ void rescue_permute(uint64_t (&s)[W / G],
                                               const uint64_t* ark_s, int t) {
  constexpr int L = W / G;
#pragma unroll 1
  for (int r = 0; r < RESCUE_ROUNDS; ++r) {
    sbox<L>(s);
    mds_ark<W, G, Mds>(s, ark_s + r * W + t * L, t);
    inv_sbox<L>(s);
    mds_ark<W, G, Mds>(s, ark_s + (RESCUE_ROUNDS + r) * W + t * L, t);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = canon(s[j]);
}

// Every thread of the block copies part of the n round constants into shared
// memory; returns after the block's barrier.
__device__ __forceinline__ void load_ark(uint64_t* ark_s,
                                         const uint64_t* __restrict__ ark,
                                         int n) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) ark_s[q] = ark[q];
  __syncthreads();
}

}  // namespace
