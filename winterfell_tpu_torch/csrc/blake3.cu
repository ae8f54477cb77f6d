// BLAKE3 for Hopper (B10): the row hash of one chunk, the 2-to-1 merge per
// level and over whole Merkle trees, for Blake3_256 (8 digest words) and
// the truncated Blake3_192 (6), and the device coin's draw loop.
//
// Replaces the jnp programs of winterfell_tpu/ops/blake3_device.py
// (_compress_rows, blake3_hash_words, blake3_merge_rows,
// merkle_levels_blake3); the JAX package has no Pallas kernel for them.
// BLAKE3 (the public specification; the reference wraps the blake3 crate,
// crypto/src/hash/blake/mod.rs) hashes a message of at most one 1024-byte
// chunk as a chain of compressions over its 64-byte blocks, with the flags
// CHUNK_START on the first, CHUNK_END and ROOT on the last, and block
// counter 0. A row is the little-endian bytes of its field elements, which
// are the u32 words of its int64 elements as they lie in memory.
//
// Bound on this card: the integer ALU pipe. A compression is 7 rounds of 8
// G functions of 4 three-input adds, 4 xors (LOP3) and 4 rotations (one
// funnel shift, SHF, each), then 8 xors, and no multiply. The adds can issue
// on the IMAD pipe too (IMAD.IADD), the xors and rotations only on the ALU
// pipe: 456 of its instructions per compression at least; the bytes (at
// most 1024 read, 32 written per row) take a fraction of that time. So everything stays in registers: one thread per
// message, the message schedule resolved at compile time (each round reads
// the 16 message registers in its own order), the 7 rounds unrolled.
//
// Built with nvcc into a plain-C shared library (see ops/_build.py); the
// wrappers in ops/blake3.py and ops/device_coin.py pass device pointers,
// sizes and the current stream, and raise when an entry point returns a CUDA
// error.

#include <cstdint>
#include <cuda_runtime.h>

#include "byte_coin.cuh"

namespace {

constexpr uint32_t CHUNK_START = 1;
constexpr uint32_t CHUNK_END = 2;
constexpr uint32_t ROOT = 8;
constexpr int BLOCK = 128;         // threads of the row kernels
constexpr int TREE_THREADS = 512;  // most threads of a tree block

__host__ __device__ constexpr uint32_t iv(int i) {
  return i == 0 ? 0x6A09E667u : i == 1 ? 0xBB67AE85u : i == 2 ? 0x3C6EF372u
       : i == 3 ? 0xA54FF53Au : i == 4 ? 0x510E527Fu : i == 5 ? 0x9B05688Cu
       : i == 6 ? 0x1F83D9ABu : 0x5BE0CD19u;
}

// The message word that round r reads at position i: the permutation
// (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8) applied r times.
__host__ __device__ constexpr int msg_perm(int i) {
  return i == 0 ? 2 : i == 1 ? 6 : i == 2 ? 3 : i == 3 ? 10 : i == 4 ? 7
       : i == 5 ? 0 : i == 6 ? 4 : i == 7 ? 13 : i == 8 ? 1 : i == 9 ? 11
       : i == 10 ? 12 : i == 11 ? 5 : i == 12 ? 9 : i == 13 ? 14
       : i == 14 ? 15 : 8;
}

// As a template, so that the compiler resolves each index (a recursive
// constexpr function called in a loop was left to run time: the message
// went to local memory and the kernels branched on the indices).
template <int R, int I>
struct MsgIndex {
  static constexpr int value = MsgIndex<R - 1, msg_perm(I)>::value;
};
template <int I>
struct MsgIndex<0, I> {
  static constexpr int value = I;
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c,
                                  uint32_t& d, uint32_t mx, uint32_t my) {
  a = a + b + mx;
  d = rotr(d ^ a, 16);
  c = c + d;
  b = rotr(b ^ c, 12);
  a = a + b + my;
  d = rotr(d ^ a, 8);
  c = c + d;
  b = rotr(b ^ c, 7);
}

// Round R: the column step, then the diagonal step.
template <int R>
__device__ __forceinline__ void round_r(uint32_t (&s)[16],
                                        const uint32_t (&m)[16]) {
  g(s[0], s[4], s[8], s[12], m[MsgIndex<R, 0>::value],
    m[MsgIndex<R, 1>::value]);
  g(s[1], s[5], s[9], s[13], m[MsgIndex<R, 2>::value],
    m[MsgIndex<R, 3>::value]);
  g(s[2], s[6], s[10], s[14], m[MsgIndex<R, 4>::value],
    m[MsgIndex<R, 5>::value]);
  g(s[3], s[7], s[11], s[15], m[MsgIndex<R, 6>::value],
    m[MsgIndex<R, 7>::value]);
  g(s[0], s[5], s[10], s[15], m[MsgIndex<R, 8>::value],
    m[MsgIndex<R, 9>::value]);
  g(s[1], s[6], s[11], s[12], m[MsgIndex<R, 10>::value],
    m[MsgIndex<R, 11>::value]);
  g(s[2], s[7], s[8], s[13], m[MsgIndex<R, 12>::value],
    m[MsgIndex<R, 13>::value]);
  g(s[3], s[4], s[9], s[14], m[MsgIndex<R, 14>::value],
    m[MsgIndex<R, 15>::value]);
}

// cv <- the first 8 words of compress(cv, m, counter 0, block_len, flags).
__device__ __forceinline__ void compress(uint32_t (&cv)[8],
                                         const uint32_t (&m)[16],
                                         uint32_t block_len, uint32_t flags) {
  uint32_t s[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = cv[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[8 + i] = iv(i);
  s[12] = 0;
  s[13] = 0;
  s[14] = block_len;
  s[15] = flags;
  round_r<0>(s, m);
  round_r<1>(s, m);
  round_r<2>(s, m);
  round_r<3>(s, m);
  round_r<4>(s, m);
  round_r<5>(s, m);
  round_r<6>(s, m);
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = s[i] ^ s[8 + i];
}

// BLAKE3 of one message of byte_len <= 64 bytes given as 16 words (zero past
// the message): a single block, CHUNK_START | CHUNK_END | ROOT.
__device__ __forceinline__ void hash_block(const uint32_t (&m)[16],
                                           uint32_t byte_len,
                                           uint32_t (&out)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = iv(i);
  compress(out, m, byte_len, CHUNK_START | CHUNK_END | ROOT);
}

// merge(d0, d1) = BLAKE3(d0 ‖ d1) of two W-word digests: one block of 8W
// bytes.
template <int W>
__device__ __forceinline__ void merge(const uint32_t* left,
                                      const uint32_t* right,
                                      uint32_t (&out)[8]) {
  uint32_t m[16];
#pragma unroll
  for (int q = 0; q < 16; ++q)
    m[q] = q < W ? left[q] : q < 2 * W ? right[q - W] : 0;
  hash_block(m, 8 * W, out);
}

// The coin's candidate hash(seed ‖ LE64(ctr)) of a dw-word seed.
struct Blake3Coin {
  static constexpr bool WARP = false;  // one thread hashes a candidate
  __device__ static void candidate(const uint32_t* seed, int dw, uint64_t ctr,
                                   uint32_t (&out)[8]) {
    uint32_t m[16];
#pragma unroll
    for (int q = 0; q < 16; ++q)
      m[q] = q < dw ? seed[q] : q == dw ? static_cast<uint32_t>(ctr)
           : q == dw + 1 ? static_cast<uint32_t>(ctr >> 32) : 0;
    hash_block(m, 4 * dw + 8, out);
  }
};

// BLAKE3 of each row of byte_len bytes (<= 1024: one chunk): row i is the
// words at words + i·stride. One thread per row; dw digest words out.
__global__ void __launch_bounds__(BLOCK)
blake3_hash_rows_kernel(const uint32_t* __restrict__ words, int64_t stride,
                        uint32_t* __restrict__ out, int64_t m, int byte_len,
                        int dw) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= m) return;
  const uint32_t* row = words + i * stride;
  const int need = (byte_len + 3) / 4;
  const int n_blocks = byte_len > 64 ? (byte_len + 63) / 64 : 1;
  uint32_t cv[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) cv[q] = iv(q);
  for (int b = 0; b < n_blocks; ++b) {
    uint32_t msg[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int w = b * 16 + q;
      msg[q] = w < need ? row[w] : 0;
    }
    const bool last = b == n_blocks - 1;
    const uint32_t flags =
        (b == 0 ? CHUNK_START : 0) | (last ? CHUNK_END | ROOT : 0);
    compress(cv, msg, last ? byte_len - 64 * b : 64, flags);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (q < dw) out[i * dw + q] = cv[q];
}

// One level: merge(left[i], right[i]) of W-word digests at left + i·stride
// and right + i·stride (stride 2W merges a level's sibling pairs in place).
template <int W>
__global__ void __launch_bounds__(BLOCK)
blake3_merge_rows_kernel(const uint32_t* __restrict__ left,
                         const uint32_t* __restrict__ right,
                         uint32_t* __restrict__ out, int64_t m,
                         int64_t stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= m) return;
  uint32_t d[8];
  merge<W>(left + i * stride, right + i * stride, d);
#pragma unroll
  for (int q = 0; q < W; ++q) out[i * W + q] = d[q];
}

// Whole trees, as rescue.cu's merkle_levels_kernel with one thread per
// merge: each block merges the 2^b nodes [blockIdx·2^b, ..) of the level
// `in` into b levels, level l starting (size of in − 2·its size) rows after
// `out`; a level's nodes stay in shared memory for the next (two buffers in
// turn) and are written out.
template <int W>
__global__ void __launch_bounds__(TREE_THREADS)
blake3_merkle_levels_kernel(const uint32_t* __restrict__ in,
                            uint32_t* __restrict__ out, int64_t n_in, int b) {
  extern __shared__ __align__(16) uint32_t level_s[];
  const int64_t chunk = int64_t{1} << b;
  const uint32_t* src = in + static_cast<int64_t>(blockIdx.x) * chunk * W;
  int64_t out_row = 0, size = n_in / 2;  // this level's first row and size
  for (int l = 1; l <= b; ++l) {
    const int merges = static_cast<int>(chunk >> l);
    uint32_t* dst = level_s + ((l - 1) & 1) * (chunk / 2) * W;
    uint32_t* dst_g = out + (out_row + static_cast<int64_t>(blockIdx.x) * merges) * W;
    for (int j = threadIdx.x; j < merges; j += blockDim.x) {
      uint32_t d[8];
      merge<W>(src + j * 2 * W, src + j * 2 * W + W, d);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        dst_g[j * W + q] = d[q];
        if (l < b) dst[j * W + q] = d[q];
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

template <int W>
int merkle_levels(const void* in, void* out, int log_n, int levels,
                  cudaStream_t stream) {
  const int64_t chunk = int64_t{1} << levels;
  int64_t threads = chunk / 2;
  threads = threads < 32 ? 32 : threads > TREE_THREADS ? TREE_THREADS : threads;
  blake3_merkle_levels_kernel<W><<<
      static_cast<unsigned int>(int64_t{1} << (log_n - levels)),
      static_cast<unsigned int>(threads),
      static_cast<size_t>(chunk / 2 + chunk / 4) * W * 4, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      int64_t{1} << log_n, levels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// words: rows of u32 words at a row stride of `stride` words; out (m, dw);
// byte_len in 0..1024, dw in 1..8. Returns cudaGetLastError().
int wt_blake3_hash_rows(const void* words, int64_t stride, void* out, int64_t m,
                        int byte_len, int dw, void* stream) {
  if (byte_len < 0 || byte_len > 1024 || dw < 1 || dw > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  blake3_hash_rows_kernel<<<grid_for(m), BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), stride, static_cast<uint32_t*>(out),
      m, byte_len, dw);
  return static_cast<int>(cudaGetLastError());
}

// left/right digests of dw (6 or 8) words at a row stride of `stride` words,
// out (m, dw).
int wt_blake3_merge_rows(const void* left, const void* right, void* out,
                         int64_t m, int64_t stride, int dw, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto l = static_cast<const uint32_t*>(left);
  const auto r = static_cast<const uint32_t*>(right);
  const auto o = static_cast<uint32_t*>(out);
  if (dw == 8)
    blake3_merge_rows_kernel<8><<<grid_for(m), BLOCK, 0, s>>>(l, r, o, m, stride);
  else if (dw == 6)
    blake3_merge_rows_kernel<6><<<grid_for(m), BLOCK, 0, s>>>(l, r, o, m, stride);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// `levels` Merkle levels over the 2^log_n dw-word nodes of `in`, written to
// `out` largest first, one level after another (levels in 1..10: the level
// buffers of a block, 3·dw·2^levels bytes, stay within 24 KiB).
int wt_blake3_merkle_levels(const void* in, void* out, int log_n, int levels,
                            int dw, void* stream) {
  if (levels < 1 || levels > 10 || levels > log_n || log_n > 40)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dw == 8) return merkle_levels<8>(in, out, log_n, levels, s);
  if (dw == 6) return merkle_levels<6>(in, out, log_n, levels, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The coin's draw loop: cands (t, dw) candidate digests for counters
// counter0 + 1 .., seed (dw,), elems (k, d) out, counter_out (1,) out.
int wt_blake3_coin_draw(const void* cands, const void* seed, void* elems,
                        void* counter_out, uint64_t counter0, int64_t t,
                        int64_t k, int d, int dw, void* stream) {
  return launch_byte_coin_draw<Blake3Coin, CoinF64>(
      cands, seed, elems, counter_out, counter0, t, k, d, dw, stream);
}

// The f128 draw: elems (k, d, 2) (lo, hi) out, d <= 2 (a candidate's 32
// bytes hold two 16-byte elements).
int wt_blake3_coin_draw_f128(const void* cands, const void* seed, void* elems,
                             void* counter_out, uint64_t counter0, int64_t t,
                             int64_t k, int d, int dw, void* stream) {
  return launch_byte_coin_draw<Blake3Coin, CoinF128>(
      cands, seed, elems, counter_out, counter0, t, k, d, dw, stream);
}

// The f62 draw: elems (k, d) out, each element < the f62 modulus.
int wt_blake3_coin_draw_f62(const void* cands, const void* seed, void* elems,
                            void* counter_out, uint64_t counter0, int64_t t,
                            int64_t k, int d, int dw, void* stream) {
  return launch_byte_coin_draw<Blake3Coin, CoinF62>(
      cands, seed, elems, counter_out, counter0, t, k, d, dw, stream);
}

}  // extern "C"
