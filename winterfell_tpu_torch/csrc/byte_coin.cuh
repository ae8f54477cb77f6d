// The draw loop of the device coin for the byte hashers (BLAKE3, SHA3),
// shared by blake3.cu and keccak.cu. It has no TPU kernel behind it: the
// JAX package runs it as a lax.while_loop (winterfell_tpu/ops/
// device_coin.py make_draw over byte_coin_ops and u64_ext_decoder).
//
// k draws of a degree-d element under the counter semantics of the
// reference's DefaultRandomCoin::draw (crypto/src/random/default.rs:120-139):
// the counter increments before each candidate; candidate counter c is
// hash(seed ‖ LE64(c)), a digest of dw little-endian u32 words; it is
// accepted when each of its first d little-endian u64 words (words 2e and
// 2e + 1, zero past the digest, as the reference pads a truncated digest) is
// < p; draw i takes the first accepted candidate after draw i-1's. cands
// holds the candidates for counters counter0 + 1 .. counter0 + t (one row
// hash launch); past those the kernel hashes further counters itself with
// Hash::candidate, so a rejection needs no host read. One thread does the
// scan, so the result is the serial loop's. A draw that finds nothing in
// 1000 candidates (the host coin's limit) stops the kernel with the counter
// set to 2^64 - 1. Bound: latency (one thread, k digest reads); it runs once
// per Fiat-Shamir draw.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t COIN_P = 0xFFFFFFFF00000001ull;

template <class Hash>
__global__ void byte_coin_draw_kernel(const uint32_t* __restrict__ cands,
                                      const uint32_t* __restrict__ seed,
                                      uint64_t* __restrict__ elems,
                                      uint64_t* __restrict__ counter_out,
                                      uint64_t counter0, int64_t t, int64_t k,
                                      int d, int dw) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
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
      uint64_t v[4];
      ok = true;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = static_cast<uint64_t>(w[2 * e]) |
               (static_cast<uint64_t>(w[2 * e + 1]) << 32);
        if (e < d) ok = ok && v[e] < COIN_P;
      }
      if (ok) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < d) elems[got * d + e] = v[e];
      }
    }
    if (!ok) {
      counter_out[0] = ~0ull;
      return;
    }
  }
  counter_out[0] = ctr;
}

}  // namespace
