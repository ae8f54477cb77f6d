// The draw loop of the device coin for the byte hashers (BLAKE3, SHA3),
// shared by blake3.cu and keccak.cu. It has no TPU kernel behind it: the
// JAX package runs it as a lax.while_loop (winterfell_tpu/ops/
// device_coin.py make_draw over byte_coin_ops, with u64_ext_decoder for f64
// and limb_ext_decoder for f128).
//
// k draws of a degree-d element under the counter semantics of the
// reference's DefaultRandomCoin::draw (crypto/src/random/default.rs:120-139):
// the counter increments before each candidate; candidate counter c is
// hash(seed ‖ LE64(c)), a digest of dw little-endian u32 words; it is
// accepted when each of its first d base elements, read little-endian from
// EW words each (EW = 2 for f64 and f62, 4 for f128; zero past the digest,
// as the reference pads a truncated digest), is < p (the field's modulus,
// Mod: an f62 element is two words as f64's, but its p is its own); draw i takes the first
// accepted candidate after draw i-1's. cands holds the candidates for
// counters counter0 + 1 .. counter0 + t (one row hash launch); past those the
// kernel hashes further counters itself with Hash::candidate, so a
// rejection needs no host read. One thread does the scan, so the result is
// the serial loop's; where Hash::WARP is true, the whole warp runs the loop
// in step (the same reads and branches in every thread) so that a group of
// threads can compute a candidate together, and thread 0 writes. A draw
// that finds nothing in 1000 candidates (the host coin's limit) stops the
// kernel with the counter set to 2^64 - 1. Bound:
// latency (one thread, k digest reads); it runs once per Fiat-Shamir draw.
// elems takes EW / 2 u64 words per element: (k, d) for f64 and f62,
// (k, d, 2) (lo, hi) for f128. The Rp62_248 coin (rp62.cu) draws with the
// same loop: its digests travel as packed words, whose bytes are what the
// reference's draw reads.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The fields' moduli p as little-endian u64 words: EW u32 words per element
struct CoinF64 {
  static constexpr int EW = 2;
  __device__ static constexpr uint64_t word(int) {
    return 0xFFFFFFFF00000001ull;
  }
};
struct CoinF62 {
  static constexpr int EW = 2;
  __device__ static constexpr uint64_t word(int) {
    return 0x3FFFC88000000001ull;
  }
};
struct CoinF128 {
  static constexpr int EW = 4;
  __device__ static constexpr uint64_t word(int l) {
    return l == 0 ? 0xFFFFD30000000001ull : 0xFFFFFFFFFFFFFFFFull;
  }
};

template <class Hash, class Mod>
__global__ void byte_coin_draw_kernel(const uint32_t* __restrict__ cands,
                                      const uint32_t* __restrict__ seed,
                                      uint64_t* __restrict__ elems,
                                      uint64_t* __restrict__ counter_out,
                                      uint64_t counter0, int64_t t, int64_t k,
                                      int d, int dw) {
  if (blockIdx.x != 0 || (!Hash::WARP && threadIdx.x != 0)) return;
  const bool writer = threadIdx.x == 0;
  uint64_t ctr = counter0;
  int64_t j = 0;
  for (int64_t got = 0; got < k; ++got) {
    bool ok = false;
    for (int tries = 0; tries < 1000 && !ok; ++tries, ++j) {
      ++ctr;
      uint32_t w[8];
      if (j < t) {
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = q < dw ? cands[j * dw + q] : 0;
      } else {
        Hash::candidate(seed, dw, ctr, w);
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = q < dw ? w[q] : 0;
      }
      constexpr int EW = Mod::EW;
      constexpr int L = EW / 2;  // u64 words per element
      constexpr int E = 8 / EW;  // elements a digest can hold
      uint64_t v[E][L];
      ok = true;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        bool lt = false, eq = true;  // v[e] < p, from the top word down
#pragma unroll
        for (int l = L - 1; l >= 0; --l) {
          v[e][l] = static_cast<uint64_t>(w[EW * e + 2 * l]) |
                    (static_cast<uint64_t>(w[EW * e + 2 * l + 1]) << 32);
          lt = lt || (eq && v[e][l] < Mod::word(l));
          eq = eq && v[e][l] == Mod::word(l);
        }
        if (e < d) ok = ok && lt;
      }
      if (ok && writer) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (e < d) {
#pragma unroll
            for (int l = 0; l < L; ++l) elems[(got * d + e) * L + l] = v[e][l];
          }
      }
    }
    if (!ok) {
      if (writer) counter_out[0] = ~0ull;
      return;
    }
  }
  if (writer) counter_out[0] = ctr;
}

// One launch of the draw loop (one thread, or one warp, does the scan); d
// at most the elements a 32-byte digest holds. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a d or dw the loop does not take.
template <class Hash, class Mod>
int launch_byte_coin_draw(const void* cands, const void* seed, void* elems,
                          void* counter_out, uint64_t counter0, int64_t t,
                          int64_t k, int d, int dw, void* stream) {
  if (d < 1 || d > 8 / Mod::EW || dw < 1 || dw > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  byte_coin_draw_kernel<Hash, Mod><<<1, 32, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cands), static_cast<const uint32_t*>(seed),
      static_cast<uint64_t*>(elems), static_cast<uint64_t*>(counter_out),
      counter0, t, k, d, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
