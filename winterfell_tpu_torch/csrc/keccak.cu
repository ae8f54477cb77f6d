// SHA3-256 for Hopper (B11): Keccak-f[1600] row hashing, the 2-to-1 merge
// per level and over whole Merkle trees, and the device coin's draw loop.
//
// Replaces the jnp programs of winterfell_tpu/ops/sha3_device.py
// (_keccak_f, sha3_hash_words, sha3_merge_rows, merkle_levels_sha3); the
// JAX package has no Pallas kernel for them. SHA3-256 (FIPS 202; the
// reference wraps the sha3 crate, crypto/src/hash/mod.rs:122-158) absorbs
// the message in 136-byte rate blocks into a state of 25 u64 lanes, with
// the padding 0x06 after the message and 0x80 in the last byte of the last
// block, and one Keccak-f (24 rounds of θ, ρ+π, χ, ι) per block; the digest
// is the first 32 bytes of the state. A row is the little-endian bytes of
// its field elements, which are the u32 words of its int64 elements as they
// lie in memory.
//
// Bound on this card: the integer ALU pipe. On 32-bit halves with
// three-input logic ops (LOP3) a round needs at least: θ's 5 column
// parities (2 LOP3 a half: 20), their rotations by 1 (2 funnel shifts, SHF,
// each: 10) and the update of the 25 lanes (one LOP3 a half: 50); ρ's 24
// rotations (48 SHF); χ's 25 lanes, a ^ (~b & c) one LOP3 a half (50); ι
// (2): 180 ALU instructions a round, 4,320 per permutation, and no
// multiply; the bytes (a row read and 32 written) take a few percent of
// that time. So everything stays in registers: one thread per message, the
// 25 lanes as 50 registers, ρ and π resolved at compile time inside a
// round; the round loop stays rolled (24 trips, the constant from a
// table).
//
// Built with nvcc into a plain-C shared library (see ops/_build.py); the
// wrappers in ops/sha3.py and ops/device_coin.py pass device pointers, sizes
// and the current stream, and raise when an entry point returns a CUDA
// error.

#include <cstdint>
#include <cuda_runtime.h>

#include "byte_coin.cuh"

namespace {

constexpr int RATE_LANES = 17;  // 136 bytes
constexpr int BLOCK = 128;         // threads of the row kernels
constexpr int TREE_THREADS = 512;  // most threads of a tree block

__constant__ uint64_t RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

// ρ and π as one chain over the lanes: step i moves the lane it holds to
// lane pi_lane(i), rotated left by rho_rot(i) (the lane index is x + 5y).
__host__ __device__ constexpr int pi_lane(int i) {
  constexpr int t[24] = {10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
                         15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1};
  return t[i];
}

__host__ __device__ constexpr int rho_rot(int i) {
  constexpr int t[24] = {1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
                         27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44};
  return t[i];
}

// x rotated left by n (a constant after unrolling) on its 32-bit halves.
__device__ __forceinline__ uint64_t rotl(uint64_t x, int n) {
  uint32_t lo = static_cast<uint32_t>(x), hi = static_cast<uint32_t>(x >> 32);
  if (n >= 32) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
    n -= 32;
  }
  if (n == 0) return (static_cast<uint64_t>(hi) << 32) | lo;
  const uint32_t nhi = __funnelshift_l(lo, hi, n);
  const uint32_t nlo = __funnelshift_l(hi, lo, n);
  return (static_cast<uint64_t>(nhi) << 32) | nlo;
}

__device__ __forceinline__ void keccak_f(uint64_t (&a)[25]) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r) {
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[y + x] ^= d;
    }
    uint64_t t = a[1];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const uint64_t next = a[pi_lane(i)];
      a[pi_lane(i)] = rotl(t, rho_rot(i));
      t = next;
    }
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
      uint64_t b[5];
#pragma unroll
      for (int x = 0; x < 5; ++x) b[x] = a[y + x];
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[y + x] = b[x] ^ (~b[(x + 1) % 5] & b[(x + 2) % 5]);
    }
    a[0] ^= RC[r];
  }
}

// Lane L of the padded message of byte_len bytes held as `need` u32 words at
// w (zero past them): 0x06 after the message, 0x80 in the top byte of the
// last lane of the last block (last_lane).
__device__ __forceinline__ uint64_t message_lane(const uint32_t* w, int need,
                                                 int byte_len, int L,
                                                 int last_lane) {
  uint64_t v = (2 * L < need ? static_cast<uint64_t>(w[2 * L]) : 0) |
               (2 * L + 1 < need ? static_cast<uint64_t>(w[2 * L + 1]) << 32
                                 : 0);
  if (L == byte_len / 8) v ^= 0x06ull << (8 * (byte_len % 8));
  if (L == last_lane) v ^= 0x80ull << 56;
  return v;
}

// SHA3-256 of a message of byte_len bytes, at most one rate block less one
// byte, held in 16 words (zero past the message): the digest as 8 words.
__device__ __forceinline__ void hash_short(const uint32_t (&m)[16],
                                           int byte_len, uint32_t (&out)[8]) {
  uint64_t a[25];
#pragma unroll
  for (int j = 0; j < 25; ++j) a[j] = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    a[j] = static_cast<uint64_t>(m[2 * j]) |
           (static_cast<uint64_t>(m[2 * j + 1]) << 32);
  a[byte_len / 8] ^= 0x06ull << (8 * (byte_len % 8));
  a[RATE_LANES - 1] ^= 0x80ull << 56;
  keccak_f(a);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = static_cast<uint32_t>(a[j]);
    out[2 * j + 1] = static_cast<uint32_t>(a[j] >> 32);
  }
}

// merge(d0, d1) = SHA3-256(d0 ‖ d1) of two 8-word digests: 64 bytes.
__device__ __forceinline__ void merge(const uint32_t* left,
                                      const uint32_t* right,
                                      uint32_t (&out)[8]) {
  uint32_t m[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) m[q] = q < 8 ? left[q] : right[q - 8];
  hash_short(m, 64, out);
}

// The coin's candidate hash(seed ‖ LE64(ctr)) of a dw-word seed.
struct Sha3Coin {
  static constexpr bool WARP = false;  // one thread hashes a candidate
  __device__ static void candidate(const uint32_t* seed, int dw, uint64_t ctr,
                                   uint32_t (&out)[8]) {
    uint32_t m[16];
#pragma unroll
    for (int q = 0; q < 16; ++q)
      m[q] = q < dw ? seed[q] : q == dw ? static_cast<uint32_t>(ctr)
           : q == dw + 1 ? static_cast<uint32_t>(ctr >> 32) : 0;
    hash_short(m, 4 * dw + 8, out);
  }
};

// SHA3-256 of each row of byte_len bytes: row i is the words at
// words + i·stride. One thread per row, any number of rate blocks.
__global__ void __launch_bounds__(BLOCK)
sha3_hash_rows_kernel(const uint32_t* __restrict__ words, int64_t stride,
                      uint32_t* __restrict__ out, int64_t m, int byte_len) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= m) return;
  const uint32_t* row = words + i * stride;
  const int need = (byte_len + 3) / 4;
  const int n_blocks = byte_len / 136 + 1;  // room for the 0x06 pad
  const int last_lane = n_blocks * RATE_LANES - 1;
  uint64_t a[25];
#pragma unroll
  for (int j = 0; j < 25; ++j) a[j] = 0;
  for (int b = 0; b < n_blocks; ++b) {
#pragma unroll
    for (int j = 0; j < RATE_LANES; ++j)
      a[j] ^= message_lane(row, need, byte_len, b * RATE_LANES + j, last_lane);
    keccak_f(a);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[i * 8 + 2 * j] = static_cast<uint32_t>(a[j]);
    out[i * 8 + 2 * j + 1] = static_cast<uint32_t>(a[j] >> 32);
  }
}

// One level: merge(left[i], right[i]) of 8-word digests at left + i·stride
// and right + i·stride (stride 16 merges a level's sibling pairs in place).
__global__ void __launch_bounds__(BLOCK)
sha3_merge_rows_kernel(const uint32_t* __restrict__ left,
                       const uint32_t* __restrict__ right,
                       uint32_t* __restrict__ out, int64_t m, int64_t stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= m) return;
  uint32_t d[8];
  merge(left + i * stride, right + i * stride, d);
#pragma unroll
  for (int q = 0; q < 8; ++q) out[i * 8 + q] = d[q];
}

// Whole trees, as blake3.cu's: each block merges the 2^b nodes
// [blockIdx·2^b, ..) of the level `in` into b levels through shared memory.
__global__ void __launch_bounds__(TREE_THREADS)
sha3_merkle_levels_kernel(const uint32_t* __restrict__ in,
                          uint32_t* __restrict__ out, int64_t n_in, int b) {
  extern __shared__ __align__(16) uint32_t level_s[];
  const int64_t chunk = int64_t{1} << b;
  const uint32_t* src = in + static_cast<int64_t>(blockIdx.x) * chunk * 8;
  int64_t out_row = 0, size = n_in / 2;  // this level's first row and size
  for (int l = 1; l <= b; ++l) {
    const int merges = static_cast<int>(chunk >> l);
    uint32_t* dst = level_s + ((l - 1) & 1) * (chunk / 2) * 8;
    uint32_t* dst_g = out + (out_row + static_cast<int64_t>(blockIdx.x) * merges) * 8;
    for (int j = threadIdx.x; j < merges; j += blockDim.x) {
      uint32_t d[8];
      merge(src + j * 16, src + j * 16 + 8, d);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        dst_g[j * 8 + q] = d[q];
        if (l < b) dst[j * 8 + q] = d[q];
      }
    }
    __syncthreads();
    src = dst;
    out_row += size;
    size /= 2;
  }
}

inline unsigned int grid_for(int64_t m) {
  return static_cast<unsigned int>((m + BLOCK - 1) / BLOCK);
}

}  // namespace

extern "C" {

// words: rows of u32 words at a row stride of `stride` words; out (m, 8).
// Returns cudaGetLastError().
int wt_sha3_hash_rows(const void* words, int64_t stride, void* out, int64_t m,
                      int byte_len, void* stream) {
  if (byte_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  sha3_hash_rows_kernel<<<grid_for(m), BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), stride, static_cast<uint32_t*>(out),
      m, byte_len);
  return static_cast<int>(cudaGetLastError());
}

// left/right 8-word digests at a row stride of `stride` words, out (m, 8).
int wt_sha3_merge_rows(const void* left, const void* right, void* out,
                       int64_t m, int64_t stride, void* stream) {
  sha3_merge_rows_kernel<<<grid_for(m), BLOCK, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(left), static_cast<const uint32_t*>(right),
      static_cast<uint32_t*>(out), m, stride);
  return static_cast<int>(cudaGetLastError());
}

// `levels` Merkle levels over the 2^log_n 8-word nodes of `in` (levels in
// 1..10), as wt_blake3_merkle_levels.
int wt_sha3_merkle_levels(const void* in, void* out, int log_n, int levels,
                          void* stream) {
  if (levels < 1 || levels > 10 || levels > log_n || log_n > 40)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk = int64_t{1} << levels;
  int64_t threads = chunk / 2;
  threads = threads < 32 ? 32 : threads > TREE_THREADS ? TREE_THREADS : threads;
  sha3_merkle_levels_kernel<<<
      static_cast<unsigned int>(int64_t{1} << (log_n - levels)),
      static_cast<unsigned int>(threads),
      static_cast<size_t>(chunk / 2 + chunk / 4) * 32,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      int64_t{1} << log_n, levels);
  return static_cast<int>(cudaGetLastError());
}

// The coin's draw loop, as wt_blake3_coin_draw (dw = 8).
int wt_sha3_coin_draw(const void* cands, const void* seed, void* elems,
                      void* counter_out, uint64_t counter0, int64_t t,
                      int64_t k, int d, int dw, void* stream) {
  return launch_byte_coin_draw<Sha3Coin, CoinF64>(
      cands, seed, elems, counter_out, counter0, t, k, d, dw, stream);
}

// The f128 draw: elems (k, d, 2) (lo, hi) out, d <= 2 (a candidate's 32
// bytes hold two 16-byte elements).
int wt_sha3_coin_draw_f128(const void* cands, const void* seed, void* elems,
                           void* counter_out, uint64_t counter0, int64_t t,
                           int64_t k, int d, int dw, void* stream) {
  return launch_byte_coin_draw<Sha3Coin, CoinF128>(
      cands, seed, elems, counter_out, counter0, t, k, d, dw, stream);
}

// The f62 draw: elems (k, d) out, each element < the f62 modulus.
int wt_sha3_coin_draw_f62(const void* cands, const void* seed, void* elems,
                          void* counter_out, uint64_t counter0, int64_t t,
                          int64_t k, int d, int dw, void* stream) {
  return launch_byte_coin_draw<Sha3Coin, CoinF62>(
      cands, seed, elems, counter_out, counter0, t, k, d, dw, stream);
}

}  // extern "C"
