// Rescue-Prime Rp64_256 row hashing (K1) and 2-to-1 merge (K2) for Hopper,
// and the two kernels of the device coin (ops/device_coin.py): the bare
// permutation of given states and the rejection-sampling draw.
//
// Field elements are canonical Goldilocks values (p = 2^64 - 2^32 + 1) held
// as native uint64_t. The permutation is the reference's Rescue-XLIX
// (crypto/src/hash/rescue/rp64_256/mod.rs:299-319): 7 rounds of
// S-box x^7, MDS, ARK1, inverse S-box x^(1/7), MDS, ARK2 over a 12-element
// state (capacity 0..4, rate 4..12, digest = state[4..8]).
//
// Built with nvcc into a plain-C shared library (see ops/_build.py); the
// wrappers in ops/rescue.py pass device pointers, sizes and the current
// stream, and raise when an entry point returns a CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int ROUNDS = 7;
constexpr int BLOCK = 256;

// The circulant MDS matrix's first row (rescue_constants.py RP64_256_MDS[0]);
// row i is this row rotated right by i.
__constant__ uint64_t MDS_ROW[WIDTH] = {7, 23, 8, 26, 13, 10, 9, 7, 6, 22, 21, 8};

__device__ __forceinline__ uint64_t canon(uint64_t s) {
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  s += (s < a) ? EPS : 0;  // 2^64 ≡ 2^32 - 1; cannot wrap again for a, b < p
  return canon(s);
}

// hi·2^64 + lo mod p, with 2^64 ≡ 2^32 - 1 and 2^96 ≡ -1.
__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  const uint64_t hi_hi = hi >> 32;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  const uint64_t t1 = (hi & EPS) * EPS;
  uint64_t t2 = t0 + t1;
  if (t2 < t0) t2 += EPS;
  return canon(t2);
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return reduce128(__umul64hi(a, b), a * b);
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl_mul(x, x);
  const uint64_t x4 = gl_mul(x2, x2);
  return gl_mul(gl_mul(x4, x2), x);
}

__device__ __forceinline__ uint64_t squares(uint64_t x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) x = gl_mul(x, x);
  return x;
}

// x^INV_ALPHA by the reference's 72-multiplication addition chain
// (rp64_256/mod.rs apply_inv_sbox; INV_ALPHA = 10540996611094048183).
__device__ __forceinline__ uint64_t inv_sbox(uint64_t x) {
  const uint64_t t1 = gl_mul(x, x);
  const uint64_t t2 = gl_mul(t1, t1);
  const uint64_t t3 = gl_mul(squares(t2, 3), t2);
  const uint64_t t4 = gl_mul(squares(t3, 6), t3);
  const uint64_t t5 = gl_mul(squares(t4, 12), t4);
  const uint64_t t6 = gl_mul(squares(t5, 6), t3);
  const uint64_t t7 = gl_mul(squares(t6, 31), t6);
  uint64_t a = gl_mul(gl_mul(t7, t7), t6);
  a = gl_mul(a, a);
  a = gl_mul(a, a);
  const uint64_t b = gl_mul(gl_mul(t1, t2), x);
  return gl_mul(a, b);
}

// state <- MDS · state. The entries are <= 26, so each output is an exact
// integer sum below 2^74: accumulate the 32-bit halves of the inputs
// separately (each sum < 2^41), recombine to 128 bits, reduce once.
__device__ __forceinline__ void mds(uint64_t s[WIDTH]) {
  uint64_t lo[WIDTH], hi[WIDTH];
#pragma unroll
  for (int k = 0; k < WIDTH; ++k) {
    lo[k] = s[k] & EPS;
    hi[k] = s[k] >> 32;
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
      const uint64_t m = MDS_ROW[(k - i + WIDTH) % WIDTH];
      acc_lo += m * lo[k];
      acc_hi += m * hi[k];
    }
    // value = acc_lo + acc_hi·2^32 = r_hi·2^64 + r_lo
    const uint64_t shifted = acc_hi << 32;
    const uint64_t r_lo = acc_lo + shifted;
    const uint64_t r_hi = (acc_hi >> 32) + (r_lo < shifted ? 1 : 0);
    s[i] = reduce128(r_hi, r_lo);
  }
}

// ark: ARK1 (7 × 12) followed by ARK2 (7 × 12), canonical.
__device__ void permute(uint64_t s[WIDTH], const uint64_t* __restrict__ ark) {
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = sbox(s[j]);
    mds(s);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = gl_add(s[j], __ldg(ark + r * WIDTH + j));
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = inv_sbox(s[j]);
    mds(s);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j)
      s[j] = gl_add(s[j], __ldg(ark + (ROUNDS + r) * WIDTH + j));
  }
}

// K1. Replaces the TPU kernel winterfell_tpu/ops/pallas_rescue.py
// _hash_rows_kernel_loop / _hash_rows_kernel (entry rp64_hash_rows_pallas).
// Rp64_256 hash_elements of each row: capacity[0] = k mod p, the first rate
// chunk written and zero-padded, later chunks added into lanes 4.., one
// permutation per chunk, digest = state[4..8].
// Bound on this card: operations, not bytes. A permutation is about 8.4k
// field multiplies (7 rounds × (12·4 S-box + 12·72 inverse S-box + 2·144
// small-constant MDS products)), each several 32-bit integer multiply-adds,
// against 8·k bytes read and 32 written per row (48 bytes for k = 2). The
// simple design (one thread per row, the 12-lane state in registers,
// canonical values after every op) does nothing about that yet: no lazy
// reduction, no cheaper MDS, no work split across the 12 lanes. That is
// later work.
__global__ void __launch_bounds__(BLOCK)
hash_rows_kernel(const uint64_t* __restrict__ rows, uint64_t* __restrict__ out,
                 const uint64_t* __restrict__ ark, int64_t m, int64_t k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= m) return;
  const uint64_t* row = rows + i * k;
  uint64_t s[WIDTH];
  s[0] = static_cast<uint64_t>(k) % P;
  s[1] = s[2] = s[3] = 0;
#pragma unroll
  for (int j = 0; j < RATE; ++j) s[4 + j] = j < k ? row[j] : 0;
  permute(s, ark);
  for (int64_t c = RATE; c < k; c += RATE) {
#pragma unroll
    for (int j = 0; j < RATE; ++j)
      if (c + j < k) s[4 + j] = gl_add(s[4 + j], row[c + j]);
    permute(s, ark);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[i * 4 + j] = s[4 + j];
}

// K2. Replaces the TPU kernel winterfell_tpu/ops/pallas_rescue.py
// _merge_rows_kernel_loop / _merge_rows_kernel (entry
// rp64_merge_rows_pallas). Rp64_256 merge(d0, d1): capacity[0] = 8,
// state = cap ‖ d0 ‖ d1, one permutation, digest = state[4..8]. Row i of d0
// and d1 starts at left + i·stride and right + i·stride, so one Merkle level
// merges its sibling pairs in place (stride 8 over the level below).
// Bound on this card: operations (one permutation, ~8.4k field multiplies,
// per 64 bytes read and 32 written); the simple design does nothing about it
// yet.
__global__ void __launch_bounds__(BLOCK)
merge_rows_kernel(const uint64_t* __restrict__ left,
                  const uint64_t* __restrict__ right, uint64_t* __restrict__ out,
                  const uint64_t* __restrict__ ark, int64_t m, int64_t stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= m) return;
  uint64_t s[WIDTH];
  s[0] = RATE;
  s[1] = s[2] = s[3] = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[4 + j] = left[i * stride + j];
    s[8 + j] = right[i * stride + j];
  }
  permute(s, ark);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[i * 4 + j] = s[4 + j];
}

// The permutation of each given 12-lane state: the device coin's
// merge_with_int (candidate states, rp64_256/mod.rs:235-254) runs through it.
// Same bound and design as K2: one thread per state, one permutation.
__global__ void __launch_bounds__(BLOCK)
permute_rows_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                    const uint64_t* __restrict__ ark, int64_t m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= m) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = in[i * WIDTH + j];
  permute(s, ark);
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) out[i * WIDTH + j] = s[j];
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
        permute(s, ark);
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
  return static_cast<unsigned int>((m + BLOCK - 1) / BLOCK);
}

}  // namespace

extern "C" {

// rows (m, k) row-major, out (m, 4), ark (2, 7, 12); returns cudaGetLastError().
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
