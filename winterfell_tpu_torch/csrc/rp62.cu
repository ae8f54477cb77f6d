// Rescue-Prime Rp62_248 for Hopper (B15): row hashing, the 2-to-1 merge per
// level and over whole Merkle trees, and the two kernels of the device coin
// (ops/device_coin.py): the merge_with_int candidates and the rejection-
// sampling draw.
//
// Replaces the jnp programs of winterfell_tpu/ops/rp62_device.py
// (rp62_permutation_rows :100 under _sponge_elem_rows :169,
// rp62_merge_rows :213 and merkle_levels_rp62 :261), which XLA fuses on the
// TPU; the JAX package has no Pallas kernel for them. The permutation is the
// reference's Rescue-XLIX over f62 (crypto/src/hash/rescue/rp62_248/
// mod.rs): 7 rounds of S-box x^3, a dense 12×12 MDS, ARK1, the inverse
// S-box x^INV_ALPHA (INV_ALPHA = (2p - 1)/3, 62 bits), MDS, ARK2 over a
// 12-element state (rate 0..8, capacity 8..12 with the element count in
// lane 11, digest = state[0..4)). It is not Rp64's body: the field, the MDS
// (62-bit entries, not a small circulant) and the constants differ.
//
// Digests travel as 8 u32 words, the 4 digest elements packed as 4×62 bits
// into 31 bytes and a zero pad byte (rp62_248/digest.rs:36-50, JAX
// _pack_digest :123): the words' little-endian bytes are the digest bytes,
// so proofs, the coin's seed and its draws read them as the byte hashers'.
//
// Bound on this card: operations. A permutation is 7·12·(2 + 73) = 6,300
// field products (the inverse S-box is the addition chain below: 62
// squarings and 11 multiplies) and 14 MDS products of 144 64×64→128-bit
// multiply-adds, against at most 160 bytes moved. One thread holds one
// 12-lane state in registers; the MDS accumulates each output's 12
// products in 128 bits and reduces once (f62::reduce_wide). The round
// constants and the MDS matrix are in constant memory (every thread reads
// the same entry at the same time: the constant cache broadcasts it), set
// once per device by wt_rp62_init. The S-boxes are one out-of-line function
// called per lane, so the round loop's code stays a few thousand
// instructions.
//
// Built with nvcc into a plain-C shared library (see ops/_build.py); the
// wrappers in ops/rp62.py and ops/device_coin.py pass device pointers, sizes
// and the current stream, and raise when an entry point returns a CUDA
// error.

#include <cstdint>
#include <cuda_runtime.h>

#include "byte_coin.cuh"
#include "f62.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int ROUNDS = 7;
constexpr int BLOCK = 128;         // threads of the row kernels
constexpr int TREE_THREADS = 256;  // most threads of a tree block

__constant__ uint64_t c_mds[WIDTH * WIDTH];     // row-major
__constant__ uint64_t c_ark[2 * ROUNDS * WIDTH];  // ARK1 then ARK2, (2, 7, 12)

// x^(2^k) · y
__device__ __forceinline__ uint64_t sq_mul(uint64_t x, int k, uint64_t y) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) x = f62::mul(x, x);
  return f62::mul(x, y);
}

// x^3 (inv == false) or x^INV_ALPHA (inv == true). INV_ALPHA's bits are
// (10)^8 ‖ 0001011 ‖ (01)^19 ‖ 1; with Q_k = x^((4^k - 1)/3), whose
// exponent is (01)^k, the chain builds Q_2, Q_4, Q_8 and x^3 and then
// appends the bits: 62 squarings and 11 multiplies.
__device__ __noinline__ uint64_t sbox(uint64_t x, bool inv) {
  const uint64_t x3 = sq_mul(x, 1, x);
  if (!inv) return x3;
  const uint64_t q2 = sq_mul(x, 2, x);    // x^5
  const uint64_t q4 = sq_mul(q2, 4, q2);  // x^85
  const uint64_t q8 = sq_mul(q4, 8, q4);
  uint64_t r = sq_mul(q8, 5, x);          // (10)^8 ‖ 0001
  r = sq_mul(r, 3, x3);                   // ‖ 011
  r = sq_mul(r, 16, q8);                  // ‖ (01)^8
  r = sq_mul(r, 16, q8);                  // ‖ (01)^8
  r = sq_mul(r, 4, q2);                   // ‖ (01)^2
  r = sq_mul(r, 2, x);                    // ‖ 01
  return sq_mul(r, 1, x);                 // ‖ 1
}

// The Rp62_248 permutation of a 12-lane state in registers.
__device__ __forceinline__ void permute(uint64_t (&s)[WIDTH]) {
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < WIDTH; ++j) s[j] = sbox(s[j], h == 1);
      // t = MDS·s + ARK_h[r], each output's sum of 12 products in 128 bits
      const uint64_t* ark = c_ark + (h * ROUNDS + r) * WIDTH;
      uint64_t t[WIDTH];
#pragma unroll
      for (int i = 0; i < WIDTH; ++i) {
        uint64_t lo = ark[i], hi = 0;
#pragma unroll
        for (int k = 0; k < WIDTH; ++k) {
          const uint64_t m = c_mds[i * WIDTH + k];
          const uint64_t plo = m * s[k];
          lo += plo;
          hi += __umul64hi(m, s[k]) + (lo < plo);
        }
        t[i] = f62::reduce_wide(hi, lo);
      }
#pragma unroll
      for (int j = 0; j < WIDTH; ++j) s[j] = t[j];
    }
  }
}

constexpr uint64_t M62 = (1ull << 62) - 1;

// 8 packed digest words -> the 4 digest elements
__device__ __forceinline__ void unpack(const uint32_t* w, uint64_t* v) {
  uint64_t q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = static_cast<uint64_t>(w[2 * j]) |
           (static_cast<uint64_t>(w[2 * j + 1]) << 32);
  v[0] = q[0] & M62;
  v[1] = ((q[0] >> 62) | (q[1] << 2)) & M62;
  v[2] = ((q[1] >> 60) | (q[2] << 4)) & M62;
  v[3] = ((q[2] >> 58) | (q[3] << 6)) & M62;
}

// the 4 digest elements (canonical, < 2^62) -> 8 packed digest words
__device__ __forceinline__ void pack(const uint64_t* v, uint32_t* w) {
  const uint64_t q[4] = {v[0] | (v[1] << 62), (v[1] >> 2) | (v[2] << 60),
                         (v[2] >> 4) | (v[3] << 58), v[3] >> 6};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[2 * j] = static_cast<uint32_t>(q[j]);
    w[2 * j + 1] = static_cast<uint32_t>(q[j] >> 32);
  }
}

// merge(left, right): the two digests' elements in lanes 0..8, count 8
__device__ __forceinline__ void merge(const uint32_t* left,
                                      const uint32_t* right, uint32_t* out) {
  uint64_t s[WIDTH];
  unpack(left, s);
  unpack(right, s + 4);
  s[8] = s[9] = s[10] = 0;
  s[11] = RATE;
  permute(s);
  pack(s, out);
}

// merge_with_int(seed, c) (rp62_248/mod.rs): the seed's elements in lanes
// 0..4, c mod p in lane 4, c div p in lane 5, count 5 (6 when c >= p)
__device__ __forceinline__ void merge_with_int(const uint32_t* seed,
                                               uint64_t c, uint32_t* out) {
  uint64_t s[WIDTH];
  unpack(seed, s);
  const uint64_t hi = c / f62::P;
  s[4] = c - hi * f62::P;
  s[5] = hi;
  s[6] = s[7] = s[8] = s[9] = s[10] = 0;
  s[11] = hi > 0 ? 6 : 5;
  permute(s);
  pack(s, out);
}

// hash_elements of each row of k elements: lane 11 = k, the first rate
// chunk written and zero-padded, later chunks added into lanes 0..; one
// permutation per chunk (JAX _sponge_elem_rows :169-201).
__global__ void __launch_bounds__(BLOCK)
hash_rows_kernel(const uint64_t* __restrict__ rows, uint32_t* __restrict__ out,
                 int64_t m, int64_t k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= m) return;
  const uint64_t* row = rows + i * k;
  uint64_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = 0;
  s[11] = static_cast<uint64_t>(k) % f62::P;
  for (int64_t c = 0; c < k; c += RATE) {
#pragma unroll
    for (int j = 0; j < RATE; ++j)
      if (c + j < k) s[j] = c == 0 ? row[j] : f62::add(s[j], row[c + j]);
    permute(s);
  }
  pack(s, out + i * 8);
}

// One level: merge(left[i], right[i]); row i of each starts at
// left + i·stride and right + i·stride (words), so a Merkle level merges
// its sibling pairs in place (stride 16). The coin's reseed is this kernel
// on one row.
__global__ void __launch_bounds__(BLOCK)
merge_rows_kernel(const uint32_t* __restrict__ left,
                  const uint32_t* __restrict__ right,
                  uint32_t* __restrict__ out, int64_t m, int64_t stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= m) return;
  merge(left + i * stride, right + i * stride, out + i * 8);
}

// Whole trees: each block merges the 2^b nodes [blockIdx·2^b, ..) of the
// level `in` (contiguous rows of 8 words) into b levels, level l of the
// tree starting (size of in − 2·its size) rows after `out` (the layout of
// ops/rescue.py levels_by_plan); a level's nodes stay in shared memory for
// the next (two buffers in turn) and are written out. One thread per merge.
__global__ void __launch_bounds__(TREE_THREADS)
merkle_levels_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, int64_t n_in, int b) {
  extern __shared__ __align__(16) uint32_t level_s[];
  const int64_t chunk = int64_t{1} << b;
  const uint32_t* src = in + static_cast<int64_t>(blockIdx.x) * chunk * 8;
  int64_t out_row = 0, size = n_in / 2;  // this level's first row and size
  for (int l = 1; l <= b; ++l) {
    const int merges = static_cast<int>(chunk >> l);
    uint32_t* dst = level_s + ((l - 1) & 1) * (chunk / 2) * 8;
    uint32_t* dst_g =
        out + (out_row + static_cast<int64_t>(blockIdx.x) * merges) * 8;
    for (int j = threadIdx.x; j < merges; j += blockDim.x) {
      uint32_t w[8];
      merge(src + j * 16, src + j * 16 + 8, w);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        dst_g[j * 8 + q] = w[q];
        if (l < b) dst[j * 8 + q] = w[q];
      }
    }
    __syncthreads();
    src = dst;
    out_row += size;
    size /= 2;
  }
}

// The device coin's candidates: merge_with_int(seed, c) for c = counter0 +
// 1 .. counter0 + t, one thread each.
__global__ void __launch_bounds__(BLOCK)
candidates_kernel(const uint32_t* __restrict__ seed, uint32_t* __restrict__ out,
                  uint64_t counter0, int64_t t) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= t) return;
  merge_with_int(seed, counter0 + 1 + static_cast<uint64_t>(i), out + i * 8);
}

// The draw loop's hash of a further counter (byte_coin.cuh): the Rp62_248
// coin's candidate is merge_with_int(seed, ctr), read as packed words.
struct Rp62Coin {
  __device__ static void candidate(const uint32_t* seed, int, uint64_t ctr,
                                   uint32_t (&out)[8]) {
    merge_with_int(seed, ctr, out);
  }
};

inline unsigned int grid_for(int64_t m) {
  return static_cast<unsigned int>((m + BLOCK - 1) / BLOCK);
}

}  // namespace

extern "C" {

// Sets the MDS matrix (144 row-major values) and the round constants (ARK1
// then ARK2, 168 values), read from host memory at `tables`, on the current
// device. Call once per device before any other entry point.
int wt_rp62_init(const void* tables) {
  const auto* t = static_cast<const uint64_t*>(tables);
  cudaError_t err = cudaMemcpyToSymbol(c_mds, t, sizeof(c_mds));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(c_ark, t + WIDTH * WIDTH, sizeof(c_ark));
  return static_cast<int>(err);
}

// rows (m, k) row-major f62 elements, out (m, 8) packed digest words.
int wt_rp62_hash_rows(const void* rows, void* out, int64_t m, int64_t k,
                      void* stream) {
  if (m < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  hash_rows_kernel<<<grid_for(m), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(rows), static_cast<uint32_t*>(out), m, k);
  return static_cast<int>(cudaGetLastError());
}

// left/right rows of 8 words at a row stride of `stride` words, out (m, 8).
int wt_rp62_merge_rows(const void* left, const void* right, void* out,
                       int64_t m, int64_t stride, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  merge_rows_kernel<<<grid_for(m), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(left), static_cast<const uint32_t*>(right),
      static_cast<uint32_t*>(out), m, stride);
  return static_cast<int>(cudaGetLastError());
}

// `levels` Merkle levels over the 2^log_n nodes of `in` (rows of 8 words),
// written to `out` largest first; each block takes 2^levels nodes (levels in
// 1..10: its two level buffers, 24·2^levels bytes, stay within 24 KiB).
int wt_rp62_merkle_levels(const void* in, void* out, int log_n, int levels,
                          void* stream) {
  if (levels < 1 || levels > 10 || levels > log_n || log_n > 40)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk = int64_t{1} << levels;
  int64_t threads = chunk / 2;
  threads = threads < 32 ? 32 : threads > TREE_THREADS ? TREE_THREADS : threads;
  merkle_levels_kernel<<<static_cast<unsigned int>(int64_t{1} << (log_n - levels)),
                         static_cast<unsigned int>(threads),
                         static_cast<size_t>(chunk / 2 + chunk / 4) * 32,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      int64_t{1} << log_n, levels);
  return static_cast<int>(cudaGetLastError());
}

// seed (8,) packed words, out (t, 8): merge_with_int(seed, counter0 + 1 + i).
int wt_rp62_coin_candidates(const void* seed, void* out, uint64_t counter0,
                            int64_t t, void* stream) {
  if (t < 1) return static_cast<int>(cudaErrorInvalidValue);
  candidates_kernel<<<grid_for(t), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(seed), static_cast<uint32_t*>(out),
      counter0, t);
  return static_cast<int>(cudaGetLastError());
}

// The coin's draw loop (byte_coin.cuh) over the f62 modulus: cands (t, 8)
// candidate digests for counters counter0 + 1 .., seed (8,), elems (k, d)
// out, counter_out (1,) out; past the candidates the kernel computes
// merge_with_int itself.
int wt_rp62_coin_draw_f62(const void* cands, const void* seed, void* elems,
                          void* counter_out, uint64_t counter0, int64_t t,
                          int64_t k, int d, int dw, void* stream) {
  return launch_byte_coin_draw<Rp62Coin, CoinF62>(
      cands, seed, elems, counter_out, counter0, t, k, d, dw, stream);
}

}  // extern "C"
