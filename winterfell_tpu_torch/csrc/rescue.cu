// Rescue-Prime Rp64_256 for Hopper: row hashing (K1), the 2-to-1 merge (K2)
// per level and over whole Merkle trees, and the two kernels of the device
// coin (ops/device_coin.py): the bare permutation of given states and the
// rejection-sampling draw.
//
// Replaces the TPU kernels of winterfell_tpu/ops/pallas_rescue.py
// (_hash_rows_call and _merge_rows_call, bodies _hash_rows_kernel[_loop] and
// _merge_rows_kernel[_loop]). The permutation is the reference's
// Rescue-XLIX (crypto/src/hash/rescue/rp64_256/mod.rs:299-319): 7 rounds of
// S-box x^7, MDS, ARK1, inverse S-box x^(1/7), MDS, ARK2 over a 12-element
// state (capacity 0..4, rate 4..12, digest = state[4..8]).
//
// Bound on this card: 32-bit integer multiply-adds (IMAD). A permutation
// needs 7·12·76 = 6,384 field multiplies (65 of every 76 are squarings) and
// 14 MDS products, about 48k IMADs, against at most 192 bytes moved: the
// bytes take a few percent of the IMAD time at every shape of the main path.
// In SASS the IMAD pipe and the ALU pipe (adds, compares, selects, shifts)
// each take a warp instruction every other cycle, so the instructions of
// both pipes count. What each choice of the one permutation body below does
// about it:
//
// - Lazy values. Between operations a value is any u64 congruent to the
//   field element (as the TPU kernel's values, pallas_rescue.py:15); the
//   128-bit reduction (reduce_lazy) ends without the compare-and-subtract of
//   a canonical result. One canon per lane ends each permutation, which is
//   where the sponge needs canonical values: before the absorb adds of a
//   later rate chunk, before digest and state writes, and before the draw
//   kernel's < p test (the pallas_rescue.py:399-411 trap).
// - Carry chains in PTX. Written in C++ on u64, the carries of the products
//   and the reduction compile to 64-bit shifts, compares and selects on the
//   ALU pipe. Here the products are 32-bit multiply-adds with carry
//   (mad.lo.cc / madc.hi.cc, the IMAD pipe) and the reduction add/sub with
//   carry: 22 SASS instructions per squaring, about half on each pipe.
// - Squarings take 3 partial products, not 4 (sqr_lazy; the TPU kernel's
//   _gl_sqr): a0², a1², and a0·a1 added twice.
// - The MDS is the circulant product written out with compile-time
//   coefficients (Rp64Mds::coef, all <= 26): per output 24 IMAD.WIDE.U32 with an
//   immediate multiplier on the 32-bit halves of the inputs. The
//   frequency-domain form (_mds12_freq, goldilocks.py:777) trades 288 of
//   those for about 90 constant products and 400 64-bit adds and subtracts
//   of the two halves, each two ALU instructions: more instructions, most
//   on the ALU pipe. The round constant is added in the same recombine.
// - The round constants are copied into shared memory once per block; a
//   round reads its 12 from there.
// - Four threads per permutation (GROUP). Each of 4 neighbouring threads of
//   a warp holds 3 lanes of the state: the S-boxes run lane-parallel and the
//   MDS fetches the 9 lanes it lacks with __shfl_sync. A lone permutation
//   then waits on about a quarter of the instructions (the coin's serial
//   steps, the one-row hashes, the small levels of a tree), and with 48
//   registers a thread leaves room for many warps on an SM. The whole state
//   in one thread needs 128 registers and measured slower at every shape of
//   the main path, the largest included (PERF.md), so every kernel but the
//   draw kernel's rare own permutations takes 4.
// - Whole trees in a few launches (merkle_levels_kernel): a block merges
//   2^b consecutive nodes of a level into b levels, keeping each level in
//   shared memory for the next and writing it out; one block finishes the
//   tree once few nodes are left.
//
// The arithmetic and the permutation body are in rescue_body.cuh, shared
// with jive.cu. Built with nvcc into a plain-C shared library (see
// ops/_build.py); the wrappers in ops/rescue.py and ops/device_coin.py pass
// device pointers, sizes and the current stream, and raise when an entry
// point returns a CUDA error.

#include "rescue_body.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int ROUNDS = RESCUE_ROUNDS;
constexpr int ARK_SIZE = 2 * ROUNDS * WIDTH;  // ARK1 then ARK2, (2, 7, 12)
constexpr int GROUP = 4;                      // threads per permutation
constexpr int LANES = WIDTH / GROUP;          // state lanes per thread
constexpr int BLOCK = 128;                    // threads of the row kernels
constexpr int TREE_THREADS = 512;             // most threads of a tree block

// The circulant MDS matrix's first row (rescue_constants.py RP64_256_MDS[0]);
// output i is sum_d coef(d) · state[(i + d) mod 12].
struct Rp64Mds {
  __host__ __device__ static constexpr uint32_t coef(int d) {
    return d == 0 ? 7 : d == 1 ? 23 : d == 2 ? 8 : d == 3 ? 26 : d == 4 ? 13
         : d == 5 ? 10 : d == 6 ? 9 : d == 7 ? 7 : d == 8 ? 6 : d == 9 ? 22
         : d == 10 ? 21 : 8;
  }
};

// The Rp64_256 permutation (see rescue_body.cuh) of the lanes this thread
// holds, one of a group of G; with G > 1 every thread of the warp calls it
// together.
template <int G>
__device__ __forceinline__ void permute(uint64_t (&s)[WIDTH / G],
                                        const uint64_t* ark_s, int t) {
  rescue_permute<WIDTH, G, Rp64Mds>(s, ark_s, t);
}

// The row kernels give GROUP threads to each row, BLOCK / GROUP rows from
// row0 on. The MDS shuffles need every thread of a warp, so a warp whose rows
// all lie at or past m returns, and in the others a group past m repeats row
// m - 1 without storing it. This is the warp's first row.
__device__ __forceinline__ int64_t first_row_of_warp(int64_t row0) {
  return row0 + (threadIdx.x & ~31) / GROUP;
}

// Rp64_256 merge(d0, d1) state: capacity[0] = 8, then d0 ‖ d1 in the rate.
__device__ __forceinline__ void merge_state(uint64_t (&s)[LANES],
                                            const uint64_t* left,
                                            const uint64_t* right, int t) {
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
    const int lane = t * LANES + j;
    s[j] = lane == 0 ? RATE : lane < 4 ? 0 : lane < 8 ? left[lane - 4]
                                                      : right[lane - 8];
  }
}

__device__ __forceinline__ void store_digest(const uint64_t (&s)[LANES],
                                             uint64_t* out, int t) {
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
    const int lane = t * LANES + j;
    if (lane >= 4 && lane < 8) out[lane - 4] = s[j];
  }
}

// K1. Rp64_256 hash_elements of each row: capacity[0] = k mod p, the first
// rate chunk written and zero-padded, later chunks added into lanes 4..,
// one permutation per chunk, digest = state[4..8]. Each thread reads the
// row elements of its own lanes.
__global__ void __launch_bounds__(BLOCK)
hash_rows_kernel(const uint64_t* __restrict__ rows, uint64_t* __restrict__ out,
                 const uint64_t* __restrict__ ark, int64_t m, int64_t k) {
  __shared__ uint64_t ark_s[ARK_SIZE];
  load_ark(ark_s, ark, ARK_SIZE);
  const int t = threadIdx.x % GROUP;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (BLOCK / GROUP);
  if (first_row_of_warp(row0) >= m) return;
  const int64_t i_raw = row0 + threadIdx.x / GROUP;
  const bool store = i_raw < m;
  const int64_t i = store ? i_raw : m - 1;
  const uint64_t* row = rows + i * k;
  uint64_t s[LANES];
#pragma unroll
  for (int j = 0; j < LANES; ++j)
    s[j] = t * LANES + j == 0 ? static_cast<uint64_t>(k) % P : 0;
  for (int64_t c = 0; c < k; c += RATE) {
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      const int lane = t * LANES + j;
      if (lane >= 4 && c + lane - 4 < k) {
        const uint64_t x = row[c + lane - 4];
        s[j] = c == 0 ? x : gl_add(s[j], x);
      }
    }
    permute<GROUP>(s, ark_s, t);
  }
  if (store) store_digest(s, out + i * 4, t);
}

// K2, one level. Rp64_256 merge(left[i], right[i]); row i of d0 and d1
// starts at left + i·stride and right + i·stride, so a Merkle level merges
// its sibling pairs in place (stride 8 over the level below). The device
// coin's reseed is this kernel on one row.
__global__ void __launch_bounds__(BLOCK)
merge_rows_kernel(const uint64_t* __restrict__ left,
                  const uint64_t* __restrict__ right, uint64_t* __restrict__ out,
                  const uint64_t* __restrict__ ark, int64_t m, int64_t stride) {
  __shared__ uint64_t ark_s[ARK_SIZE];
  load_ark(ark_s, ark, ARK_SIZE);
  const int t = threadIdx.x % GROUP;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (BLOCK / GROUP);
  if (first_row_of_warp(row0) >= m) return;
  const int64_t i_raw = row0 + threadIdx.x / GROUP;
  const bool store = i_raw < m;
  const int64_t i = store ? i_raw : m - 1;
  uint64_t s[LANES];
  merge_state(s, left + i * stride, right + i * stride, t);
  permute<GROUP>(s, ark_s, t);
  if (store) store_digest(s, out + i * 4, t);
}

// K2, whole trees. Each block merges the 2^b nodes [blockIdx·2^b, ..) of the
// level `in` (contiguous rows of 4) into b levels: level l (1..b) of the
// tree, 2^-l the size of `in`, starts (size of in − 2·its size) rows after
// `out`, the layout of merkle levels that follow each other, largest first.
// A level's nodes stay in shared memory for the next (two buffers in turn:
// 2^(b-1) and 2^(b-2) nodes) and are written out. The block steps over a
// level's merges one slot (a group of GROUP threads) per merge, warps with no
// merge left skip the step, and a barrier ends each level.
__global__ void __launch_bounds__(TREE_THREADS)
merkle_levels_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                     const uint64_t* __restrict__ ark, int64_t n_in, int b) {
  __shared__ uint64_t ark_s[ARK_SIZE];
  extern __shared__ __align__(16) uint64_t level_s[];
  load_ark(ark_s, ark, ARK_SIZE);
  const int t = threadIdx.x % GROUP;
  const int slots = blockDim.x / GROUP;
  const int slot = threadIdx.x / GROUP;
  const int warp_slot = (threadIdx.x & ~31) / GROUP;  // the warp's first slot
  const int64_t chunk = int64_t{1} << b;
  const uint64_t* src = in + static_cast<int64_t>(blockIdx.x) * chunk * 4;
  int64_t out_row = 0, size = n_in / 2;  // this level's first row and size
  for (int l = 1; l <= b; ++l) {
    const int merges = static_cast<int>(chunk >> l);
    // odd levels in the first buffer, even ones in the second
    uint64_t* dst = level_s + ((l - 1) & 1) * (chunk / 2) * 4;
    uint64_t* dst_g = out + (out_row + static_cast<int64_t>(blockIdx.x) * merges) * 4;
    for (int j0 = 0; j0 < merges; j0 += slots) {
      if (j0 + warp_slot >= merges) continue;  // uniform across the warp
      const bool store = j0 + slot < merges;
      const int j = store ? j0 + slot : merges - 1;
      uint64_t s[LANES];
      merge_state(s, src + j * 8, src + j * 8 + 4, t);
      permute<GROUP>(s, ark_s, t);
      if (store) {
        store_digest(s, dst_g + j * 4, t);
        if (l < b) store_digest(s, dst + j * 4, t);
      }
    }
    __syncthreads();
    src = dst;
    out_row += size;
    size /= 2;
  }
}

// The permutation of each given 12-lane state: the device coin's
// merge_with_int (candidate states, rp64_256/mod.rs:235-254) runs through it.
__global__ void __launch_bounds__(BLOCK)
permute_rows_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                    const uint64_t* __restrict__ ark, int64_t m) {
  __shared__ uint64_t ark_s[ARK_SIZE];
  load_ark(ark_s, ark, ARK_SIZE);
  const int t = threadIdx.x % GROUP;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (BLOCK / GROUP);
  if (first_row_of_warp(row0) >= m) return;
  const int64_t i_raw = row0 + threadIdx.x / GROUP;
  const bool store = i_raw < m;
  const int64_t i = store ? i_raw : m - 1;
  uint64_t s[LANES];
#pragma unroll
  for (int j = 0; j < LANES; ++j) s[j] = in[i * WIDTH + t * LANES + j];
  permute<GROUP>(s, ark_s, t);
  if (store) {
#pragma unroll
    for (int j = 0; j < LANES; ++j) out[i * WIDTH + t * LANES + j] = s[j];
  }
}

// The draw loop of the device coin, with no TPU kernel behind it (the JAX
// package runs it as a lax.while_loop, winterfell_tpu/ops/device_coin.py
// make_draw): k draws of a degree-d element under the counter semantics of
// the reference's DefaultRandomCoin::draw (crypto/src/random/default.rs:
// 120-139). The counter increments before each candidate; candidate
// merge_with_int(seed, counter) is accepted when its first d digest elements
// are all < p; draw i takes the first accepted candidate after draw i-1's.
// cands holds the permuted candidate states for counters counter0 + 1 ..
// counter0 + t (rp64_permute_rows, all at once); past those the kernel
// permutes further candidates itself, one after another. One thread does
// the scan, so the result is the serial loop's. Rp64_256 digests are
// canonical, so every candidate is accepted and the scan reads k states.
// A draw that finds nothing in 1000 candidates (the host coin's limit)
// stops the kernel with the counter set to 2^64 - 1. Bound: latency (one
// thread, k reads); it runs once per Fiat-Shamir draw.
__global__ void coin_draw_kernel(const uint64_t* __restrict__ cands,
                                 const uint64_t* __restrict__ seed,
                                 const uint64_t* __restrict__ ark,
                                 uint64_t* __restrict__ elems,
                                 uint64_t* __restrict__ counter_out,
                                 uint64_t counter0, int64_t t, int64_t k,
                                 int64_t d) {
  __shared__ uint64_t ark_s[ARK_SIZE];
  load_ark(ark_s, ark, ARK_SIZE);
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  uint64_t ctr = counter0;
  int64_t j = 0;
  for (int64_t got = 0; got < k; ++got) {
    bool ok = false;
    for (int tries = 0; tries < 1000 && !ok; ++tries, ++j) {
      ++ctr;
      uint64_t s[WIDTH];
      if (j < t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 + e] = cands[j * WIDTH + 4 + e];
      } else {
        // merge_with_int(seed, ctr): state[0] = 5 (6 when ctr >= p),
        // state[4..8] = seed, state[8] = ctr mod p, state[9] = ctr div p
        const uint64_t hi = ctr >= P ? 1 : 0;
        s[0] = 5 + hi;
        s[1] = s[2] = s[3] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 + e] = seed[e];
        s[8] = ctr - hi * P;
        s[9] = hi;
        s[10] = s[11] = 0;
        permute<1>(s, ark_s, 0);
      }
      ok = true;
      for (int64_t e = 0; e < d; ++e) ok = ok && s[4 + e] < P;
      if (ok)
        for (int64_t e = 0; e < d; ++e) elems[got * d + e] = s[4 + e];
    }
    if (!ok) {
      counter_out[0] = ~0ull;
      return;
    }
  }
  counter_out[0] = ctr;
}

inline unsigned int grid_for(int64_t m) {
  constexpr int64_t per_block = BLOCK / GROUP;
  return static_cast<unsigned int>((m + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// rows (m, k) row-major, out (m, 4), ark (2, 7, 12); returns
// cudaGetLastError().
int wt_rp64_hash_rows(const void* rows, void* out, const void* ark, int64_t m,
                      int64_t k, void* stream) {
  hash_rows_kernel<<<grid_for(m), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(rows), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(ark), m, k);
  return static_cast<int>(cudaGetLastError());
}

// left/right rows of 4 at a row stride of `stride` elements, out (m, 4).
int wt_rp64_merge_rows(const void* left, const void* right, void* out,
                       const void* ark, int64_t m, int64_t stride,
                       void* stream) {
  merge_rows_kernel<<<grid_for(m), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(left), static_cast<const uint64_t*>(right),
      static_cast<uint64_t*>(out), static_cast<const uint64_t*>(ark), m, stride);
  return static_cast<int>(cudaGetLastError());
}

// `levels` Merkle levels over the 2^log_n nodes of `in` (contiguous rows of
// 4), written to `out` largest first, one level after another; each block
// takes 2^levels nodes, so 2^(log_n - levels) blocks, with one group of
// threads per merge of its first level (whole warps, at most TREE_THREADS).
// levels in 1..10: the two level buffers of a block, 24·2^levels bytes, stay
// within 24 KiB. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// other levels.
int wt_rp64_merkle_levels(const void* in, void* out, const void* ark,
                          int log_n, int levels, void* stream) {
  if (levels < 1 || levels > 10 || levels > log_n || log_n > 40)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk = int64_t{1} << levels;
  int64_t threads = (chunk / 2) * GROUP;
  threads = threads < 32 ? 32 : threads > TREE_THREADS ? TREE_THREADS : threads;
  merkle_levels_kernel<<<static_cast<unsigned int>(int64_t{1} << (log_n - levels)),
                         static_cast<unsigned int>(threads),
                         static_cast<size_t>(chunk / 2 + chunk / 4) * 32,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(ark), int64_t{1} << log_n, levels);
  return static_cast<int>(cudaGetLastError());
}

// states (m, 12) row-major -> out (m, 12).
int wt_rp64_permute_rows(const void* states, void* out, const void* ark,
                         int64_t m, void* stream) {
  permute_rows_kernel<<<grid_for(m), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(states), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(ark), m);
  return static_cast<int>(cudaGetLastError());
}

// cands (t, 12) permuted candidate states for counters counter0 + 1.., seed
// (4,), elems (k, d) out, counter_out (1,) out.
int wt_rp64_coin_draw(const void* cands, const void* seed, const void* ark,
                      void* elems, void* counter_out, uint64_t counter0,
                      int64_t t, int64_t k, int64_t d, void* stream) {
  coin_draw_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(cands), static_cast<const uint64_t*>(seed),
      static_cast<const uint64_t*>(ark), static_cast<uint64_t*>(elems),
      static_cast<uint64_t*>(counter_out), counter0, t, k, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
