// B16 for Hopper: the f128 NTT's leaf DFTs (n <= 128 points) as int8 digit
// matrix products on the tensor cores, and the recombine of their diagonal
// sums into canonical elements.
//
// Replaces winterfell_tpu/ops/ntt_mxu.py _leaf_dft_jit (:162) under leaf_dft
// (:189), with _digitize (:93) and _recombine (:108): the JAX package's
// leaf DFT on the TPU's MXU, taken under WINTER_MXU_NTT=1. Each leaf level
// of the six-step NTT (ops/f128.py _ntt_mxu) is one digit product and one
// recombine per chunk of columns (ops/ntt_mxu.py leaf_dft_kernel).
//
// The product (product_kernel): D = WT · X, with WT the (37n × 19n) s8
// block-Toeplitz digit matrix of the DFT matrix (zero-padded to whole MMA
// tiles by the wrapper) and X the (19n × B) base-2^7 digits (0..127) of the
// input column by column, row j·n + c the j-th digit of x[c]. A block takes
// BN columns: its threads read their elements as (lo, hi) words and write
// their 19 digits into shared memory, column by column with k contiguous
// (the .col B operand; a column's stride k_pad + 16 bytes puts the eight
// columns and four k offsets of a B fragment on 32 distinct banks). Each
// warp then takes units of 16 rows × 32 columns and runs
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 over the k range where WT's rows
// are non-zero: rows (l, r) meet digits j in [l − 18, l] only, so 361 of
// the 703 (l, j) blocks are read. A fragments come from WT in global memory
// (it stays in the L2: 0.7 MB at n = 32, 11.5 MB at n = 128). Accumulators:
// a digit pair's product is at most 127², a leaf row adds n of them and a
// diagonal at most 19 rows, so every sum stays below 127²·19·128 < 2^26:
// s32 is exact.
//
// The recombine (recombine_kernel): one thread per output element reads
// its 37 sums D_l (coalesced along the columns), adds D_l·2^{7l} into four
// 128-bit words and normalises them to the 288-bit value; then
// (w0, w1) + (w2, w3)·2^128 + w4·2^256 ≡ (w0, w1) + (w2, w3)·φ + w4·φ²
// (mod p), φ = 2^128 mod p, through f128.cuh's canonical mul and add.
// A canonical result is the same bits whatever the schedule, so it need not
// follow the JAX limb schedule.
//
// Bound: a leaf DFT of n points over B columns is 2·361·n²·B int8
// operations on the tensor cores and 32 bytes per element read and written;
// split in two kernels, the product writes and the recombine reads 148
// bytes of sums per element, so each of them is bound by bytes. Fusing the
// recombine into the product's epilogue, wgmma and TMA are later work.
//
// Built with nvcc into a plain-C shared library (see ops/_build.py); the
// wrappers in ops/ntt_mxu.py pass device pointers, sizes and the current
// stream, and raise when an entry point returns a CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

#include "f128.cuh"

namespace {

constexpr int DIGITS = 19;
constexpr int DIAGS = 2 * DIGITS - 1;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNIT_COLS = 32;  // columns of a warp's unit: four n8 tiles
constexpr int NT = UNIT_COLS / 8;
constexpr int SMEM_MAX = 80 * 1024;  // BN · (k_pad + 16) at n = 64, 128
constexpr int BLOCK = 256;
constexpr unsigned int MAX_GRID = 132 * 32;
// φ² = (45·2^40 − 1)² < 2^91 < p: 2^256 mod p
constexpr uint64_t PHI2_LO = 0xFFFFA60000000001ull;
constexpr uint64_t PHI2_HI = 0x7E8FFFFull;

__host__ __device__ __forceinline__ int pad_to(int v, int m) {
  return (v + m - 1) / m * m;
}

// columns per block: the digits of BN columns fit SMEM_MAX
int block_cols(int n) { return n >= 128 ? 32 : 64; }

// digit k (bits 7k .. 7k + 6) of the 128-bit value (lo, hi)
__device__ __forceinline__ uint32_t digit(uint64_t lo, uint64_t hi, int k) {
  const int bit = 7 * k;
  uint64_t v;
  if (bit < 64) {
    v = lo >> bit;
    if (bit + 7 > 64) v |= hi << (64 - bit);
  } else {
    v = hi >> (bit - 64);
  }
  return static_cast<uint32_t>(v & 0x7F);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (37n, bc) int32, row l·n + r, = WT · digits of x's columns [col0,
// col0 + bc) (x: (n, ld) elements of two words). wt: (m_pad, k_pad) s8,
// zero beyond (37n, 19n).
__global__ void __launch_bounds__(THREADS)
product_kernel(const int8_t* __restrict__ wt, const uint64_t* __restrict__ x,
               int32_t* __restrict__ d, int n, int64_t ld, int64_t col0,
               int64_t bc, int bn, int k_pad) {
  extern __shared__ __align__(16) unsigned char digits[];
  const int stride = k_pad + 16;
  const int k = DIGITS * n;
  const int m = DIAGS * n;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * bn;

  // 1. digits of the block's columns; columns past bc are zeros
  if (n % 4 == 0) {  // four rows per thread: one 32-bit store per digit
    for (int e = threadIdx.x; e < n / 4 * bn; e += THREADS) {
      const int c = e / bn * 4, b = e % bn;
      uint32_t word[DIGITS] = {};
      if (b0 + b < bc) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint64_t* p = x + 2 * ((c + q) * ld + col0 + b0 + b);
          const uint64_t lo = __ldg(p), hi = __ldg(p + 1);
#pragma unroll
          for (int j = 0; j < DIGITS; ++j) word[j] |= digit(lo, hi, j) << (8 * q);
        }
      }
      unsigned char* col = digits + b * stride + c;
#pragma unroll
      for (int j = 0; j < DIGITS; ++j)
        *reinterpret_cast<uint32_t*>(col + j * n) = word[j];
    }
  } else {
    for (int e = threadIdx.x; e < n * bn; e += THREADS) {
      const int c = e / bn, b = e % bn;
      uint64_t lo = 0, hi = 0;
      if (b0 + b < bc) {
        const uint64_t* p = x + 2 * (c * ld + col0 + b0 + b);
        lo = __ldg(p);
        hi = __ldg(p + 1);
      }
      unsigned char* col = digits + b * stride + c;
#pragma unroll
      for (int j = 0; j < DIGITS; ++j)
        col[j * n] = static_cast<unsigned char>(digit(lo, hi, j));
    }
  }
  const int tail = k_pad - k;  // zero digits up to the last k tile
  for (int e = threadIdx.x; e < bn * tail; e += THREADS)
    digits[e / tail * stride + k + e % tail] = 0;
  __syncthreads();

  // 2. units of 16 rows × 32 columns, one warp each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m_tiles = (m + 15) >> 4;
  const int col_units = bn / UNIT_COLS;
  for (int unit = warp; unit < m_tiles * col_units; unit += WARPS) {
    const int mt = unit / col_units, cu = unit % col_units;
    const int r0 = 16 * mt;
    // the rows' diagonals l meet digits j in [l - 18, l] only
    const int l_lo = r0 / n, l_hi = min(r0 + 15, m - 1) / n;
    const int j_lo = max(0, l_lo - (DIGITS - 1)), j_hi = min(DIGITS - 1, l_hi);
    const int k_lo = j_lo * n / 32 * 32;
    const int k_hi = min(k_pad, pad_to((j_hi + 1) * n, 32));
    int acc[NT][4] = {};
    const int8_t* a0 = wt + static_cast<size_t>(r0 + g) * k_pad + 4 * t;
    const int8_t* a1 = a0 + 8 * static_cast<size_t>(k_pad);
    const unsigned char* bp = digits + (cu * UNIT_COLS + g) * stride + 4 * t;
    for (int k0 = k_lo; k0 < k_hi; k0 += 32) {
      const uint32_t a[4] = {
          __ldg(reinterpret_cast<const uint32_t*>(a0 + k0)),
          __ldg(reinterpret_cast<const uint32_t*>(a1 + k0)),
          __ldg(reinterpret_cast<const uint32_t*>(a0 + k0 + 16)),
          __ldg(reinterpret_cast<const uint32_t*>(a1 + k0 + 16))};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned char* b = bp + nt * 8 * stride + k0;
        mma_s8(acc[nt], a, *reinterpret_cast<const uint32_t*>(b),
               *reinterpret_cast<const uint32_t*>(b + 16));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int64_t col = b0 + cu * UNIT_COLS + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h;
        if (row >= m) continue;
        int32_t* out = d + static_cast<int64_t>(row) * bc + col;
        if (col < bc) out[0] = acc[nt][2 * h];
        if (col + 1 < bc) out[1] = acc[nt][2 * h + 1];
      }
    }
  }
}

// y's columns [col0, col0 + bc) (y: (n, ld) elements) from d (37n, bc).
__global__ void __launch_bounds__(BLOCK)
recombine_kernel(const int32_t* __restrict__ d, uint64_t* __restrict__ y,
                 int n, int64_t ld, int64_t col0, int64_t bc) {
  typedef unsigned __int128 u128;
  const int64_t total = n * bc;
  const int64_t step = static_cast<int64_t>(gridDim.x) * BLOCK;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
       i < total; i += step) {
    const int64_t r = i / bc, b = i - r * bc;
    const int32_t* p = d + r * bc + b;
    u128 acc[4] = {0, 0, 0, 0};  // each < 10 · 2^(31 + 63)
#pragma unroll
    for (int l = 0; l < DIAGS; ++l) {
      const uint64_t v = static_cast<uint32_t>(__ldg(p + l * n * bc));
      acc[(7 * l) >> 6] += static_cast<u128>(v) << ((7 * l) & 63);
    }
    const uint64_t w0 = static_cast<uint64_t>(acc[0]);
    u128 c = (acc[0] >> 64) + acc[1];
    const uint64_t w1 = static_cast<uint64_t>(c);
    c = (c >> 64) + acc[2];
    const uint64_t w2 = static_cast<uint64_t>(c);
    c = (c >> 64) + acc[3];
    const uint64_t w3 = static_cast<uint64_t>(c);
    const uint64_t w4 = static_cast<uint64_t>(c >> 64);
    const f128::E low = f128::cond_sub_p(f128::E{w0, w1});
    const f128::E mid = f128::mul(f128::E{w2, w3}, f128::E{f128::PHI, 0});
    const f128::E top = f128::mul(f128::E{w4, 0}, f128::E{PHI2_LO, PHI2_HI});
    f128::store(y + 2 * (r * ld + col0 + b),
                f128::add(f128::add(low, mid), top));
  }
}

bool ok_leaf(int64_t n) { return n >= 1 && n <= 128 && (n & (n - 1)) == 0; }

}  // namespace

extern "C" {

// d (37n, bc) int32 = WT · digits of x's columns [col0, col0 + bc): wt the
// (m_pad, k_pad) padded leaf matrix, x (n, ld, 2) contiguous. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for sizes it does not take.
int wt_ntt_mxu_product(const void* wt, const void* x, void* d, int64_t n,
                       int64_t ld, int64_t col0, int64_t bc, void* stream) {
  if (!ok_leaf(n) || bc < 1 || col0 < 0 || col0 + bc > ld ||
      bc > INT32_MAX / 64 * 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = block_cols(static_cast<int>(n));
  const int k_pad = pad_to(DIGITS * static_cast<int>(n), 32);
  const int smem = bn * (k_pad + 16);
  static bool attribute_set = false;  // once per process, outside captures
  if (!attribute_set) {
    cudaFuncSetAttribute(product_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    attribute_set = true;
  }
  const int64_t blocks = (bc + bn - 1) / bn;
  product_kernel<<<static_cast<unsigned int>(blocks), THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(wt), static_cast<const uint64_t*>(x),
      static_cast<int32_t*>(d), static_cast<int>(n), ld, col0, bc, bn, k_pad);
  return static_cast<int>(cudaGetLastError());
}

// y's columns [col0, col0 + bc) of (n, ld, 2) from d (37n, bc) int32.
int wt_ntt_mxu_recombine(const void* d, void* y, int64_t n, int64_t ld,
                         int64_t col0, int64_t bc, void* stream) {
  if (!ok_leaf(n) || bc < 1 || col0 < 0 || col0 + bc > ld)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n * bc + BLOCK - 1) / BLOCK;
  const unsigned int grid =
      static_cast<unsigned int>(blocks < MAX_GRID ? blocks : MAX_GRID);
  recombine_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(d), static_cast<uint64_t*>(y),
      static_cast<int>(n), ld, col0, bc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
