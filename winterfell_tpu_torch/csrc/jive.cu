// RpJive64_256 for Hopper (B12): the sponge row hash and whole Merkle
// trees, whose nodes are the Jive 2-to-1 compression.
//
// Replaces the jnp programs of winterfell_tpu/ops/jive_device.py
// (jive_permutation_rows, jive_hash_rows, jive_merge_rows,
// merkle_levels_jive); the JAX package has no Pallas kernel for them. The
// permutation is the reference's Rescue-XLIX at width 8
// (crypto/src/hash/rescue/rp64_256_jive/mod.rs:259-296): the S-box x^7 and
// its inverse of Rp64_256 and a circulant 8×8 MDS with entries <= 23
// (mds_f64_8x8.rs). Capacity = lanes 0..4, rate = lanes 4..8.
//
// Bound on this card: 32-bit integer multiply-adds (IMAD), as for Rp64_256.
// A permutation needs 7·8·76 field multiplies (65 of every 76 squarings)
// and 14 MDS products of 64 small-constant products, against at most 128
// bytes moved. The permutation body is rescue.cu's (rescue_body.cuh: lazy
// values, PTX carry chains, the MDS as immediate multiply-adds) at width 8,
// with four threads per permutation, two lanes each.
//
// Built with nvcc into a plain-C shared library (see ops/_build.py); the
// wrappers in ops/jive.py pass device pointers, sizes and the current
// stream, and raise when an entry point returns a CUDA error.

#include "rescue_body.cuh"

namespace {

constexpr int WIDTH = 8;
constexpr int RATE = 4;
constexpr int ARK_SIZE = 2 * RESCUE_ROUNDS * WIDTH;  // ARK1 then ARK2, (2, 7, 8)
constexpr int GROUP = 4;                             // threads per permutation
constexpr int LANES = WIDTH / GROUP;                 // state lanes per thread
constexpr int BLOCK = 128;                           // threads of the row kernels
constexpr int TREE_THREADS = 512;                    // most threads of a tree block

// The circulant MDS matrix's first row (rescue_jive_constants.py
// JIVE_MDS[0]); output i is sum_d coef(d) · state[(i + d) mod 8].
struct JiveMds {
  __host__ __device__ static constexpr uint32_t coef(int d) {
    return d == 0 ? 23 : d == 1 ? 8 : d == 2 ? 13 : d == 3 ? 10 : d == 4 ? 7
         : d == 5 ? 6 : d == 6 ? 21 : 8;
  }
};

__device__ __forceinline__ void permute(uint64_t (&s)[LANES],
                                        const uint64_t* ark_s, int t) {
  rescue_permute<WIDTH, GROUP, JiveMds>(s, ark_s, t);
}

// The row kernels give GROUP threads to each row; a warp whose rows all lie
// at or past m returns, and in the others a group past m repeats row m - 1
// without storing it (the shuffles need the whole warp).
__device__ __forceinline__ int64_t first_row_of_warp(int64_t row0) {
  return row0 + (threadIdx.x & ~31) / GROUP;
}

// Jive compression of the digests at left and right (4 elements each):
// initial = left ‖ right, final = permute(initial), digest element i =
// initial[i] + initial[4 + i] + final[i] + final[4 + i]. Thread t of the
// group holds lanes 2t, 2t + 1; threads 0 and 1 end with the 4 digest
// elements (2t + j in out[j]) and return true. Every thread of the warp
// calls it together.
__device__ __forceinline__ bool jive_merge(const uint64_t* left,
                                           const uint64_t* right,
                                           const uint64_t* ark_s, int t,
                                           uint64_t (&out)[LANES]) {
  uint64_t init[LANES], s[LANES];
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
    const int lane = t * LANES + j;
    init[j] = lane < 4 ? left[lane] : right[lane - 4];
    s[j] = init[j];
  }
  permute(s, ark_s, t);
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
    const int src = (t + 2) & (GROUP - 1);
    const uint64_t init_hi = __shfl_sync(0xFFFFFFFFu, init[j], src, GROUP);
    const uint64_t fin_hi = __shfl_sync(0xFFFFFFFFu, s[j], src, GROUP);
    out[j] = gl_add(gl_add(init[j], init_hi), gl_add(s[j], fin_hi));
  }
  return t < 2;
}

// hash_elements of each row (mod.rs:183-206): capacity[0] = 1 iff k is not
// a multiple of 4; chunks of 4 are added into the rate, one permutation per
// chunk; a partial last chunk sets the rate lane after it to ONE. Digest =
// the rate after the last permutation.
__global__ void __launch_bounds__(BLOCK)
jive_hash_rows_kernel(const uint64_t* __restrict__ rows,
                      uint64_t* __restrict__ out,
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
    s[j] = t * LANES + j == 0 && k % RATE != 0 ? 1 : 0;
  for (int64_t c = 0; c < k; c += RATE) {
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      const int lane = t * LANES + j;
      if (lane >= 4) {
        const int64_t e = c + lane - 4;
        if (e < k)
          s[j] = c == 0 ? row[e] : gl_add(s[j], row[e]);
        else if (e == k)
          s[j] = 1;  // the padding ONE
      }
    }
    permute(s, ark_s, t);
  }
  if (store) {
#pragma unroll
    for (int j = 0; j < LANES; ++j) {
      const int lane = t * LANES + j;
      if (lane >= 4) out[i * 4 + lane - 4] = s[j];
    }
  }
}

// Whole trees, as rescue.cu's merkle_levels_kernel: each block merges the
// 2^b nodes [blockIdx·2^b, ..) of the level `in` into b levels, level l
// starting (size of in − 2·its size) rows after `out`; a level's nodes stay
// in shared memory for the next (two buffers in turn) and are written out.
__global__ void __launch_bounds__(TREE_THREADS)
jive_merkle_levels_kernel(const uint64_t* __restrict__ in,
                          uint64_t* __restrict__ out,
                          const uint64_t* __restrict__ ark, int64_t n_in,
                          int b) {
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
    uint64_t* dst = level_s + ((l - 1) & 1) * (chunk / 2) * 4;
    uint64_t* dst_g = out + (out_row + static_cast<int64_t>(blockIdx.x) * merges) * 4;
    for (int j0 = 0; j0 < merges; j0 += slots) {
      if (j0 + warp_slot >= merges) continue;  // uniform across the warp
      const bool store = j0 + slot < merges;
      const int j = store ? j0 + slot : merges - 1;
      uint64_t d[LANES];
      if (jive_merge(src + j * 8, src + j * 8 + 4, ark_s, t, d) && store) {
#pragma unroll
        for (int e = 0; e < LANES; ++e) {
          dst_g[j * 4 + t * LANES + e] = d[e];
          if (l < b) dst[j * 4 + t * LANES + e] = d[e];
        }
      }
    }
    __syncthreads();
    src = dst;
    out_row += size;
    size /= 2;
  }
}

inline unsigned int grid_for(int64_t m) {
  constexpr int64_t per_block = BLOCK / GROUP;
  return static_cast<unsigned int>((m + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// rows (m, k) row-major, out (m, 4), ark (2, 7, 8); returns
// cudaGetLastError().
int wt_jive_hash_rows(const void* rows, void* out, const void* ark, int64_t m,
                      int64_t k, void* stream) {
  jive_hash_rows_kernel<<<grid_for(m), BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(rows), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(ark), m, k);
  return static_cast<int>(cudaGetLastError());
}

// `levels` Merkle levels over the 2^log_n nodes of `in`, as
// wt_rp64_merkle_levels (levels in 1..10).
int wt_jive_merkle_levels(const void* in, void* out, const void* ark,
                          int log_n, int levels, void* stream) {
  if (levels < 1 || levels > 10 || levels > log_n || log_n > 40)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunk = int64_t{1} << levels;
  int64_t threads = (chunk / 2) * GROUP;
  threads = threads < 32 ? 32 : threads > TREE_THREADS ? TREE_THREADS : threads;
  jive_merkle_levels_kernel<<<
      static_cast<unsigned int>(int64_t{1} << (log_n - levels)),
      static_cast<unsigned int>(threads),
      static_cast<size_t>(chunk / 2 + chunk / 4) * 32,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(ark), int64_t{1} << log_n, levels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
