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
// Bound on this card: 32-bit integer multiply-adds (IMAD). A permutation is
// 7·12·(63 + 12) = 6,300 field products (the S-box x^3 is a square and a
// multiply; the inverse S-box the addition chain below, 62 squares and 11
// multiplies) and 14 MDS products of 144 64×64→128-bit multiply-adds,
// against at most 160 bytes moved. The IMAD pipe and the ALU pipe each take
// a warp instruction every other cycle, so the instructions of both count.
// What each choice of the one permutation body below does about it (the
// arithmetic is in f62.cuh):
//
// - Montgomery form, lazy. Lanes hold x·2^64 mod p as any u64 below 2^63.
//   p - 1 is a multiple of 2^32, so a reduction step needs no multiply to
//   find its factor: the 128-bit product becomes a lane in two steps of one
//   multiply-add pair each by the constant (p - 1)/2^32, with no compare
//   and no select, and a square takes three partial products. The MDS
//   matrix is held as M·R and the round constants as ARK·R² (R = 2^64), set
//   so by wt_rp62_init; inputs enter with one product by R² mod p and the
//   digest leaves with one reduction and a canonical fix.
// - Bounds. A lazy lane below 2^63 squares below 2^126, which the
//   reduction takes. The MDS sums 12 products in 128 bits: lanes below 2^63
//   would overflow it (12·2^125 > 2^128), so each lane is first brought
//   below 2^62 (one conditional subtract of p), and an output (below 4p) is
//   brought below 2p. Lanes read by the sponge are brought lower where it
//   reads them: below p before a later rate chunk is added in, canonical
//   before pack and so before the draw's < p test (the
//   pallas_rescue.py:399-411 trap).
// - Lanes across threads. Each of GROUP = 4 neighbouring threads of a warp
//   holds 3 lanes: the S-boxes run lane-parallel, the lane loop innermost
//   in each step of the addition chain, and the MDS fetches the lanes a
//   thread lacks with __shfl_sync. A lone permutation (the coin's reseed
//   and candidates, the OOD row's hash, the upper levels of a tree) then
//   waits on a quarter of the instructions. The threads of a group read
//   different MDS rows and round constants, which constant memory would
//   serialise, so each block copies them into shared memory, each thread's
//   MDS rows rotated to the order in which the shuffles hand it the lanes.
//   PERF.md records the layouts tried: one thread per state, reading the
//   tables from constant memory, spilled and was slowest; two threads per
//   state were slower than four at every shape. The draw kernel's rare own
//   permutations take the same group body.
// - Whole trees in a few launches (merkle_levels_kernel): a block merges
//   2^b consecutive nodes of a level into b levels, keeping each level in
//   shared memory for the next and writing it out, one group of threads per
//   merge, so a level of a few merges costs one short permutation.
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
constexpr int MDS_SIZE = WIDTH * WIDTH;
constexpr int ARK_SIZE = 2 * ROUNDS * WIDTH;  // ARK1 then ARK2, (2, 7, 12)
constexpr int GROUP = 4;                      // threads per permutation
constexpr int L = WIDTH / GROUP;              // lanes per thread
constexpr int BLOCK = 128;                    // threads of the row kernels
constexpr int TREE_THREADS = 512;             // most threads of a tree block

constexpr uint64_t P = f62::P;
constexpr uint64_t M62 = (1ull << 62) - 1;

__constant__ uint64_t c_mds[MDS_SIZE];  // M·R mod p, row-major
__constant__ uint64_t c_ark[ARK_SIZE];  // ARK·R² mod p, (2, 7, 12)

// Where a thread of a group reads the MDS matrix and round constants:
// m(j, q) is the entry of the row of its lane j at the q-th lane the
// shuffles of mds_ark hand it; a(hr, j) is ARK_h[r] (hr = h·7 + r) at its
// lane j.
struct Tables {
  const uint64_t* mds;  // this thread's rows of the rotated copy
  const uint64_t* ark;  // from this thread's first lane
  __device__ uint64_t m(int j, int q) const { return mds[j * WIDTH + q]; }
  __device__ uint64_t a(int hr, int j) const { return ark[hr * WIDTH + j]; }
};

// The block's shared copies (row i of the MDS rotated left by the first
// lane of the thread that holds lane i), after the block's barrier; thread
// t of its group reads from its own rows.
__device__ __forceinline__ Tables block_tables(uint64_t* mds_s,
                                               uint64_t* ark_s, int t) {
  for (int q = threadIdx.x; q < MDS_SIZE; q += blockDim.x) {
    const int i = q / WIDTH;
    mds_s[q] = c_mds[i * WIDTH + ((i / L) * L + q % WIDTH) % WIDTH];
  }
  for (int q = threadIdx.x; q < ARK_SIZE; q += blockDim.x) ark_s[q] = c_ark[q];
  __syncthreads();
  return Tables{mds_s + t * L * WIDTH, ark_s + t * L};
}

// lane `src` of this thread's group (every thread of the warp calls it)
__device__ __forceinline__ uint64_t from_group(uint64_t v, int src) {
  return __shfl_sync(0xFFFFFFFFu, v, src, GROUP);
}

__device__ __forceinline__ void sqr_all(uint64_t (&x)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = f62::mont_sqr(x[j]);
}

// x <- x^(2^k) on every lane, the lanes interleaved inside each step
__device__ __forceinline__ void squares(uint64_t (&x)[L], int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) sqr_all(x);
}

// x <- x^(2^k)·y on every lane
__device__ __forceinline__ void sq_mul(uint64_t (&x)[L], int k,
                                       const uint64_t (&y)[L]) {
  squares(x, k);
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = f62::mont_mul(x[j], y[j]);
}

__device__ __forceinline__ void sbox(uint64_t (&x)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = f62::mont_mul(f62::mont_sqr(x[j]), x[j]);
}

// x^INV_ALPHA. INV_ALPHA's bits are (10)^8 ‖ 0001011 ‖ (01)^19 ‖ 1; with
// Q_k = x^((4^k - 1)/3), whose exponent is (01)^k, the chain builds Q_2,
// Q_4, Q_8 and x^3 and then appends the bits: 62 squares and 11
// multiplies.
__device__ __forceinline__ void inv_sbox(uint64_t (&x)[L]) {
  uint64_t x3[L], q2[L], q8[L], r[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t x2 = f62::mont_sqr(x[j]);
    x3[j] = f62::mont_mul(x2, x[j]);
    q2[j] = f62::mont_mul(f62::mont_sqr(x2), x[j]);  // x^5
    r[j] = q2[j];
  }
  sq_mul(r, 4, q2);  // Q_4 = x^85
#pragma unroll
  for (int j = 0; j < L; ++j) q8[j] = r[j];
  sq_mul(q8, 8, r);  // Q_8
#pragma unroll
  for (int j = 0; j < L; ++j) r[j] = q8[j];
  sq_mul(r, 5, x);    // (10)^8 ‖ 0001
  sq_mul(r, 3, x3);   // ‖ 011
  sq_mul(r, 16, q8);  // ‖ (01)^8
  sq_mul(r, 16, q8);  // ‖ (01)^8
  sq_mul(r, 4, q2);   // ‖ (01)^2
  sq_mul(r, 2, x);    // ‖ 01
  sq_mul(r, 1, x);    // ‖ 1
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = r[j];
}

// s <- MDS·s + ARK_h[r] (hr = h·7 + r) for the L = 3 lanes t·L .. t·L + L - 1
// that this thread holds. Lanes in below 2^63, out below 2p. Every thread
// of the warp calls it together.
__device__ __forceinline__ void mds_ark(uint64_t (&s)[L],
                                        const Tables& tb, int hr, int t) {
#pragma unroll
  for (int j = 0; j < L; ++j) s[j] = f62::canon_below(s[j], P);  // < 2^62
  // v[q] = lane (t·L + q) mod 12: this thread's lanes, then the next
  // threads' of the group in turn
  uint64_t v[WIDTH];
#pragma unroll
  for (int e = 0; e < GROUP; ++e)
#pragma unroll
    for (int f = 0; f < L; ++f)
      v[e * L + f] = e == 0 ? s[f] : from_group(s[f], (t + e) & (GROUP - 1));
#pragma unroll
  for (int j = 0; j < L; ++j) {
    // ARK·R² + sum of 12 products below p·2^62: below 12·2^124 + p < 2^128
    const uint64_t c = tb.a(hr, j);
    uint32_t acc[4] = {static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32),
                       0, 0};
#pragma unroll
    for (int q = 0; q < WIDTH; ++q) f62::mont_mac(acc, v[q], tb.m(j, q));
    // below 12·p·2^62 / 2^64 + p = 4p
    s[j] = f62::canon_below(f62::mont_reduce(acc[0], acc[1], acc[2], acc[3]),
                            2 * P);
  }
}

// The Rp62_248 permutation of the lanes this thread holds (Montgomery form,
// lazy: in below 2^63, out below 2p). Every thread of the warp calls it
// together.
__device__ __forceinline__ void permute(uint64_t (&s)[L],
                                        const Tables& tb, int t) {
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    sbox(s);
    mds_ark(s, tb, r, t);
    inv_sbox(s);
    mds_ark(s, tb, ROUNDS + r, t);
  }
}

__device__ __forceinline__ uint64_t load64(const uint32_t* w) {
  return static_cast<uint64_t>(w[0]) | (static_cast<uint64_t>(w[1]) << 32);
}

// Digest element j (0..3, known at run time or not) of 8 packed words.
__device__ __forceinline__ uint64_t unpack_one(const uint32_t* w, int j) {
  const uint64_t hi = load64(w + 2 * j);
  if (j == 0) return hi & M62;
  return ((load64(w + 2 * j - 2) >> (64 - 2 * j)) | (hi << (2 * j))) & M62;
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

// The digest of a permuted state (lanes 0..3, canonical) as 8 packed words,
// in every thread of the group.
__device__ __forceinline__ void digest(const uint64_t (&s)[L],
                                       uint32_t (&w)[8]) {
  uint64_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = f62::from_mont(from_group(s[q % L], q / L));
  pack(v, w);
}

__device__ __forceinline__ void store8(uint32_t* dst, const uint32_t (&w)[8]) {
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// merge(left, right): the two digests' elements in lanes 0..8, count 8
__device__ __forceinline__ void merge_state(uint64_t (&s)[L],
                                            const uint32_t* left,
                                            const uint32_t* right, int t) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int lane = t * L + j;
    const uint64_t x = lane < 4 ? unpack_one(left, lane)
                     : lane < 8 ? unpack_one(right, lane - 4)
                     : lane == 11 ? RATE : 0;
    s[j] = f62::to_mont(x);
  }
}

// merge_with_int(seed, c) (rp62_248/mod.rs): the seed's elements in lanes
// 0..4, c mod p in lane 4, c div p in lane 5, count 5 (6 when c >= p)
__device__ __forceinline__ void int_state(uint64_t (&s)[L],
                                          const uint32_t* seed, uint64_t c,
                                          int t) {
  const uint64_t hi = c / P;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int lane = t * L + j;
    const uint64_t x = lane < 4 ? unpack_one(seed, lane)
                     : lane == 4 ? c - hi * P
                     : lane == 5 ? hi
                     : lane == 11 ? (hi > 0 ? 6 : 5) : 0;
    s[j] = f62::to_mont(x);
  }
}

// The row kernels give GROUP threads to each row, BLOCK / GROUP rows from
// row0 on. The MDS shuffles need every thread of a warp, so a warp whose
// rows all lie at or past m returns, and in the others a group past m
// repeats row m - 1 without storing it. This is the warp's first row.
__device__ __forceinline__ int64_t first_row_of_warp(int64_t row0) {
  return row0 + (threadIdx.x & ~31) / GROUP;
}

// hash_elements of each row of k elements: lane 11 = k, the first rate
// chunk written and zero-padded, later chunks added into lanes 0..; one
// permutation per chunk (JAX _sponge_elem_rows :169-201). Each thread reads
// the row elements of its own lanes.
__global__ void __launch_bounds__(BLOCK)
hash_rows_kernel(const uint64_t* __restrict__ rows, uint32_t* __restrict__ out,
                 int64_t m, int64_t k) {
  __shared__ uint64_t mds_s[MDS_SIZE], ark_s[ARK_SIZE];
  const int t = threadIdx.x % GROUP;
  const Tables tb = block_tables(mds_s, ark_s, t);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (BLOCK / GROUP);
  if (first_row_of_warp(row0) >= m) return;
  const int64_t i_raw = row0 + threadIdx.x / GROUP;
  const bool store = i_raw < m;
  const int64_t i = store ? i_raw : m - 1;
  const uint64_t* row = rows + i * k;
  uint64_t s[L];
  for (int64_t c = 0; c < k; c += RATE) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int lane = t * L + j;
      const uint64_t x = lane < RATE && c + lane < k ? row[c + lane] : 0;
      if (c == 0) {
        s[j] = f62::to_mont(lane == 11 ? static_cast<uint64_t>(k) % P : x);
      } else {
        // below p + 2^62: a lane of a permuted state is below 2p
        s[j] = f62::canon_below(s[j], P) +
               f62::canon_below(f62::to_mont(x), P);
      }
    }
    permute(s, tb, t);
  }
  uint32_t w[8];
  digest(s, w);
  if (store && t == 0) store8(out + i * 8, w);
}

// One level: merge(left[i], right[i]); row i of each starts at
// left + i·stride and right + i·stride (words), so a Merkle level merges
// its sibling pairs in place (stride 16). The coin's reseed is this kernel
// on one row.
__global__ void __launch_bounds__(BLOCK)
merge_rows_kernel(const uint32_t* __restrict__ left,
                  const uint32_t* __restrict__ right,
                  uint32_t* __restrict__ out, int64_t m, int64_t stride) {
  __shared__ uint64_t mds_s[MDS_SIZE], ark_s[ARK_SIZE];
  const int t = threadIdx.x % GROUP;
  const Tables tb = block_tables(mds_s, ark_s, t);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (BLOCK / GROUP);
  if (first_row_of_warp(row0) >= m) return;
  const int64_t i_raw = row0 + threadIdx.x / GROUP;
  const bool store = i_raw < m;
  const int64_t i = store ? i_raw : m - 1;
  uint64_t s[L];
  merge_state(s, left + i * stride, right + i * stride, t);
  permute(s, tb, t);
  uint32_t w[8];
  digest(s, w);
  if (store && t == 0) store8(out + i * 8, w);
}

// Whole trees: each block merges the 2^b nodes [blockIdx·2^b, ..) of the
// level `in` (contiguous rows of 8 words) into b levels, level l of the
// tree starting (size of in − 2·its size) rows after `out` (the layout of
// ops/rescue.py levels_by_plan); a level's nodes stay in shared memory for
// the next (two buffers in turn) and are written out. The block steps over
// a level's merges one slot (a group of GROUP threads) per merge, warps
// with no merge left skip the step, and a barrier ends each level.
__global__ void __launch_bounds__(TREE_THREADS)
merkle_levels_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, int64_t n_in, int b) {
  __shared__ uint64_t mds_s[MDS_SIZE], ark_s[ARK_SIZE];
  extern __shared__ __align__(16) uint32_t level_s[];
  const int t = threadIdx.x % GROUP;
  const Tables tb = block_tables(mds_s, ark_s, t);
  const int slots = blockDim.x / GROUP;
  const int slot = threadIdx.x / GROUP;
  const int warp_slot = (threadIdx.x & ~31) / GROUP;  // the warp's first slot
  const int64_t chunk = int64_t{1} << b;
  const uint32_t* src = in + static_cast<int64_t>(blockIdx.x) * chunk * 8;
  int64_t out_row = 0, size = n_in / 2;  // this level's first row and size
  for (int l = 1; l <= b; ++l) {
    const int merges = static_cast<int>(chunk >> l);
    // odd levels in the first buffer, even ones in the second
    uint32_t* dst = level_s + ((l - 1) & 1) * (chunk / 2) * 8;
    uint32_t* dst_g =
        out + (out_row + static_cast<int64_t>(blockIdx.x) * merges) * 8;
    for (int j0 = 0; j0 < merges; j0 += slots) {
      if (j0 + warp_slot >= merges) continue;  // uniform across the warp
      const bool store = j0 + slot < merges;
      const int j = store ? j0 + slot : merges - 1;
      uint64_t s[L];
      merge_state(s, src + j * 16, src + j * 16 + 8, t);
      permute(s, tb, t);
      uint32_t w[8];
      digest(s, w);
      if (store && t == 0) {
        store8(dst_g + j * 8, w);
        if (l < b) store8(dst + j * 8, w);
      }
    }
    __syncthreads();
    src = dst;
    out_row += size;
    size /= 2;
  }
}

// The device coin's candidates: merge_with_int(seed, c) for c = counter0 +
// 1 .. counter0 + t, one group of threads each.
__global__ void __launch_bounds__(BLOCK)
candidates_kernel(const uint32_t* __restrict__ seed, uint32_t* __restrict__ out,
                  uint64_t counter0, int64_t n) {
  __shared__ uint64_t mds_s[MDS_SIZE], ark_s[ARK_SIZE];
  const int t = threadIdx.x % GROUP;
  const Tables tb = block_tables(mds_s, ark_s, t);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (BLOCK / GROUP);
  if (first_row_of_warp(row0) >= n) return;
  const int64_t i_raw = row0 + threadIdx.x / GROUP;
  const bool store = i_raw < n;
  const int64_t i = store ? i_raw : n - 1;
  uint64_t s[L];
  int_state(s, seed, counter0 + 1 + static_cast<uint64_t>(i), t);
  permute(s, tb, t);
  uint32_t w[8];
  digest(s, w);
  if (store && t == 0) store8(out + i * 8, w);
}

// The draw loop's hash of a further counter (byte_coin.cuh): the Rp62_248
// coin's candidate is merge_with_int(seed, ctr), read as packed words. The
// draw kernel's warp (its one block) runs the loop together, each group of
// GROUP threads computing the same permutation, so a candidate costs one
// short permutation (the whole state in one thread would take a GROUP-fold
// longer chain, and spills).
struct Rp62Coin {
  static constexpr bool WARP = true;
  __device__ static void candidate(const uint32_t* seed, int, uint64_t ctr,
                                   uint32_t (&out)[8]) {
    __shared__ uint64_t mds_s[MDS_SIZE], ark_s[ARK_SIZE];
    const int t = threadIdx.x % GROUP;
    const Tables tb = block_tables(mds_s, ark_s, t);
    uint64_t s[L];
    int_state(s, seed, ctr, t);
    permute(s, tb, t);
    digest(s, out);
  }
};

inline unsigned int grid_for(int64_t m) {
  constexpr int64_t per_block = BLOCK / GROUP;
  return static_cast<unsigned int>((m + per_block - 1) / per_block);
}

// v·R^e mod p on the host (R = 2^64)
uint64_t to_mont_host(uint64_t v, int e) {
  unsigned __int128 x = v % P;
  for (int i = 0; i < e; ++i) x = (x << 64) % P;
  return static_cast<uint64_t>(x);
}

}  // namespace

extern "C" {

// Sets the MDS matrix (144 row-major values) and the round constants (ARK1
// then ARK2, 168 values), read from host memory at `tables`, on the current
// device, in the forms the kernels read (M·R, ARK·R²). Call once per device
// before any other entry point.
int wt_rp62_init(const void* tables) {
  const auto* t = static_cast<const uint64_t*>(tables);
  uint64_t mds[MDS_SIZE], ark[ARK_SIZE];
  for (int q = 0; q < MDS_SIZE; ++q) mds[q] = to_mont_host(t[q], 1);
  for (int q = 0; q < ARK_SIZE; ++q) ark[q] = to_mont_host(t[MDS_SIZE + q], 2);
  cudaError_t err = cudaMemcpyToSymbol(c_mds, mds, sizeof(c_mds));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_ark, ark, sizeof(c_ark));
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
// written to `out` largest first; each block takes 2^levels nodes, with one
// group of threads per merge of its first level (whole warps, at most
// TREE_THREADS); levels in 1..10: its two level buffers, 24·2^levels bytes,
// stay within 24 KiB.
int wt_rp62_merkle_levels(const void* in, void* out, int log_n, int levels,
                          void* stream) {
  if (levels < 1 || levels > 10 || levels > log_n || log_n > 40)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk = int64_t{1} << levels;
  int64_t threads = (chunk / 2) * GROUP;
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
