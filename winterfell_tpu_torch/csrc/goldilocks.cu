// Goldilocks (f64) field kernels for Hopper: K3, the elementwise multiply,
// and the kernels of the f64 engine's tensor programs: B0, the elementwise
// add and subtract; B0x, the quadratic and cubic extension product; B4, one
// radix-2 NTT stage; B5, the FRI fold.
//
// K3 replaces the TPU kernel winterfell_tpu/ops/pallas_kernels.py
// gl_mul_pallas (body _gl_mul_kernel / _gl_mul_limbs): out = a·b mod p,
// p = 2^64 - 2^32 + 1. The TPU kernel works on (lo, hi) u32 planes with
// 16-bit half-word products, because its vector unit has no 64-bit
// multiply. Here an element is a native uint64_t: the 128-bit product is a*b
// and __umul64hi(a, b), reduced with 2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 (mod p).
// B0, B0x, B4 and B5 replace jnp programs of winterfell_tpu/ops/goldilocks.py
// that XLA fuses on the TPU (the JAX package has no Pallas kernel for them):
// gl_add :81 and gl_sub :88; ext_mul :191; the stages of _ntt_small :386
// under _ntt_core :340; fri_fold_body :625.
//
// Every function computes the JAX formula step for step on u64 bit
// patterns, so the results are equal bit for bit for every input, patterns
// >= p included: add keeps the conditional subtract of p after the wrapped
// sum's fix (which can wrap again for inputs >= p, as the reference's u64
// sum does), sub keeps the borrow form, and the extension products keep the
// reference's order of additions.
//
// K3 and B0 (gl_op_kernel<MUL / ADD / SUB>): one element per thread in a
// grid-stride loop, neighbouring threads on neighbouring output elements.
// Bound: bytes. An element of a contiguous operation reads 16 bytes and
// writes 8, against 8 32-bit integer multiply-adds for a product (one
// 64×64→128-bit product; the product by 2^32 - 1 is a shift and a subtract):
// at 3.35 TB/s and 16.7 T IMAD/s the bytes take about 15 times as long. One
// kernel takes every layout the wrapper passes: contiguous operands,
// broadcast dims (stride 0) and strided views, read in place, and a scalar
// for b. Offsets are 32-bit (the wrapper splits layouts that reach 2^31
// elements); the outermost coordinate needs no division, so a contiguous
// operation (one dim after the wrapper merges dims) does none.
//
// B0x (gl_ext_mul_kernel<D>): one extension element per thread over the
// same layout of the leading dims, each operand's D components at its own
// stride; the result is contiguous (..., D). Bound: bytes (48 read and 24
// written per cubic element, against 9 products of 8 IMADs).
//
// B4 (gl_ntt_stage_kernel): one stage of the radix-2 DIT NTT in place over
// a contiguous (n, cols) matrix of rows in bit-reversed order: for each
// block of 2·half rows, u = x[i], v = x[i + half]·w^j, x[i] = u + v,
// x[i + half] = u - v, with w^j the twiddle tw[j·tw_step] of a table of
// n/2 powers of the n-th root. One thread per butterfly and column. The
// first stage (half 1) reads its rows from a natural-order source through
// the bit reversal (__brev) and writes the destination, so the transform
// needs no gather. Bound: bytes, 32 per butterfly.
//
// B5 (gl_fri_fold_kernel<N, D>): one thread per output row i < n/N. It reads
// the row's N extension values evaluations[i + k·rows], runs the N-point
// inverse NTT in registers (the same stages, twiddles passed by value),
// scales by 1/N and by inv_pows[k][i], and runs Horner at α, read from
// device memory. Bound: bytes (the evaluations and the offset powers read
// once, the folded row written once) at about the IMAD time of its
// products: the larger is counted (chip_smoke.py).
//
// Built with nvcc into a plain-C shared library (see ops/_build.py); the
// wrappers in ops/field_kernels.py and ops/goldilocks.py pass device
// pointers, sizes, strides and the current stream, and raise when an entry
// point returns a CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int BLOCK = 256;
constexpr int MAX_DIMS = 8;
constexpr unsigned int MAX_GRID = 132 * 32;  // 32 blocks of 256 on each SM

enum Op { ADD = 0, SUB = 1, MUL = 2 };

__device__ __forceinline__ uint64_t canon(uint64_t s) {
  return s >= P ? s - P : s;
}

// hi·2^64 + lo mod p for any 128-bit value, with 2^64 ≡ 2^32 - 1 and
// 2^96 ≡ -1: x ≡ lo - hi_hi + hi_lo·(2^32 - 1).
__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  const uint64_t hi_hi = hi >> 32;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;  // borrow: -2^64 ≡ -(2^32 - 1)
  const uint64_t t1 = ((hi & EPS) << 32) - (hi & EPS);  // hi_lo·(2^32 - 1)
  uint64_t t2 = t0 + t1;
  if (t2 < t0) t2 += EPS;  // carry: 2^64 ≡ 2^32 - 1; cannot wrap again
  return canon(t2);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(__umul64hi(a, b), a * b);
}

// the reference's gl_add: on a wrapped sum add 2^32 - 1, then subtract p
// once if the sum is >= p
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;
  return canon(s);
}

// the reference's gl_sub: on a borrow subtract 2^32 - 1
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d - EPS : d;
}

template <int OP>
__device__ __forceinline__ uint64_t apply(uint64_t a, uint64_t b) {
  if (OP == ADD) return add(a, b);
  if (OP == SUB) return sub(a, b);
  return mul(a, b);
}

// c = a·b in the quadratic (x² = x - 2) or cubic (x³ = x + 1) extension,
// the reference's ext_mul (winterfell_tpu/ops/goldilocks.py:191) step for
// step; D = 1 is the base product
template <int D>
__device__ __forceinline__ void ext_mul(const uint64_t* a, const uint64_t* b,
                                        uint64_t* c) {
  if (D == 1) {
    c[0] = mul(a[0], b[0]);
  } else if (D == 2) {
    const uint64_t t2 = mul(a[1], b[1]);
    c[0] = sub(mul(a[0], b[0]), add(t2, t2));
    c[1] = add(add(mul(a[0], b[1]), mul(a[1], b[0])), t2);
  } else {
    const uint64_t t0 = mul(a[0], b[0]);
    const uint64_t t1 = add(mul(a[0], b[1]), mul(a[1], b[0]));
    const uint64_t t2 =
        add(add(mul(a[0], b[2]), mul(a[1], b[1])), mul(a[2], b[0]));
    const uint64_t t3 = add(mul(a[1], b[2]), mul(a[2], b[1]));
    const uint64_t t4 = mul(a[2], b[2]);
    c[0] = add(t0, t3);
    c[1] = add(t1, add(t3, t4));
    c[2] = add(t2, t4);
  }
}

struct Layout {
  uint32_t size[MAX_DIMS];  // outermost first
  uint32_t sa[MAX_DIMS];    // element strides of a
  uint32_t sb[MAX_DIMS];    // element strides of b (0 where broadcast)
  uint32_t ca, cb;          // component strides of a and b (B0x)
  int ndim;
};

// The element offsets of output element i in a and b. The loop is
// unrolled, so every field of L is read at a fixed index: a run-time index
// puts L on the stack (local memory), about 3x slower.
__device__ __forceinline__ void offsets(uint32_t i, const Layout& L,
                                        uint32_t& oa, uint32_t& ob) {
  uint32_t rest = i;
  oa = 0;
  ob = 0;
#pragma unroll
  for (int d = MAX_DIMS - 1; d > 0; --d) {
    if (d < L.ndim) {
      const uint32_t c = rest % L.size[d];
      rest /= L.size[d];
      oa += c * L.sa[d];
      ob += c * L.sb[d];
    }
  }
  oa += rest * L.sa[0];
  ob += rest * L.sb[0];
}

// Any strides, broadcast dims at stride 0; b_value for every element when
// B_SCALAR. The output is contiguous in the broadcast shape.
template <int OP, bool B_SCALAR>
__global__ void __launch_bounds__(BLOCK)
gl_op_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
             uint64_t b_value, uint64_t* __restrict__ out, uint32_t n,
             Layout L) {
  const uint32_t step = gridDim.x * BLOCK;
  for (uint32_t i = blockIdx.x * BLOCK + threadIdx.x; i < n; i += step) {
    uint32_t oa, ob;
    offsets(i, L, oa, ob);
    out[i] = apply<OP>(__ldg(a + oa), B_SCALAR ? b_value : __ldg(b + ob));
  }
}

template <int D>
__global__ void __launch_bounds__(BLOCK)
gl_ext_mul_kernel(const uint64_t* __restrict__ a,
                  const uint64_t* __restrict__ b, uint64_t* __restrict__ out,
                  uint32_t n, Layout L) {
  const uint32_t step = gridDim.x * BLOCK;
  for (uint32_t i = blockIdx.x * BLOCK + threadIdx.x; i < n; i += step) {
    uint32_t oa, ob;
    offsets(i, L, oa, ob);
    uint64_t x[D], y[D], z[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      x[c] = __ldg(a + oa + c * L.ca);
      y[c] = __ldg(b + ob + c * L.cb);
    }
    ext_mul<D>(x, y, z);
#pragma unroll
    for (int c = 0; c < D; ++c) out[static_cast<size_t>(i) * D + c] = z[c];
  }
}

// One stage over x (n, cols); with BITREV the first stage (half 1, its
// twiddle w^0), reading the rows of src (n, cols) in bit-reversed order.
template <bool BITREV>
__global__ void __launch_bounds__(BLOCK)
gl_ntt_stage_kernel(uint64_t* __restrict__ x, const uint64_t* __restrict__ src,
                    const uint64_t* __restrict__ tw, uint32_t cols,
                    int log_half, int log_n, uint32_t tw_step,
                    uint32_t butterflies) {
  const uint32_t step = gridDim.x * BLOCK;
  const uint32_t half = 1u << log_half;
  for (uint32_t t = blockIdx.x * BLOCK + threadIdx.x; t < butterflies;
       t += step) {
    const uint32_t c = t % cols;
    const uint32_t r = t / cols;
    const uint32_t j = r & (half - 1);
    const uint32_t i0 = ((r >> log_half) << (log_half + 1)) + j;
    uint64_t* p0 = x + static_cast<size_t>(i0) * cols + c;
    uint64_t* p1 = p0 + static_cast<size_t>(half) * cols;
    uint64_t u, v;
    if (BITREV) {
      const uint32_t s0 = __brev(i0) >> (32 - log_n);
      const uint32_t s1 = __brev(i0 + 1) >> (32 - log_n);
      u = __ldg(src + static_cast<size_t>(s0) * cols + c);
      v = __ldg(src + static_cast<size_t>(s1) * cols + c);
    } else {
      u = *p0;
      v = *p1;
    }
    v = mul(v, __ldg(tw + static_cast<size_t>(j) * tw_step));
    *p0 = add(u, v);
    *p1 = sub(u, v);
  }
}

__host__ __device__ constexpr int bitrev(int k, int log_n) {
  int r = 0;
  for (int b = 0; b < log_n; ++b) r |= ((k >> b) & 1) << (log_n - 1 - b);
  return r;
}

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

struct FoldConsts {
  uint64_t tw[8];  // powers of the inverse N-th root, N/2 of them
  uint64_t inv_n;  // 1/N
};

// The reference's fri_fold_body for one row: the N-point iNTT of
// _ntt_small (bit-reversed input, stages of half 1 ... N/2), the 1/N
// scale, the inverse-offset powers, Horner from the top coefficient (the
// reference's first Horner step, 0·α + c_{N-1}, is c_{N-1} itself: the
// product of 0 by any α is 0 and c_{N-1} is canonical).
template <int N, int D>
__global__ void __launch_bounds__(BLOCK)
gl_fri_fold_kernel(const uint64_t* __restrict__ ev,
                   const uint64_t* __restrict__ inv_pows,
                   const uint64_t* __restrict__ alpha,
                   uint64_t* __restrict__ out, uint32_t rows, FoldConsts K) {
  constexpr int LOG_N = log2_of(N);
  uint64_t al[D];
#pragma unroll
  for (int c = 0; c < D; ++c) al[c] = __ldg(alpha + c);
  const uint32_t step = gridDim.x * BLOCK;
  for (uint32_t i = blockIdx.x * BLOCK + threadIdx.x; i < rows; i += step) {
    uint64_t w[N][D];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const size_t at = (static_cast<size_t>(bitrev(k, LOG_N)) * rows + i) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) w[k][c] = __ldg(ev + at + c);
    }
    // every loop counts a constant number of times (the butterfly t of
    // stage s), so that all of them unroll and w and K stay in registers
#pragma unroll
    for (int s = 0; s < LOG_N; ++s) {
#pragma unroll
      for (int t = 0; t < N / 2; ++t) {
        const int j = t & ((1 << s) - 1);
        const int i0 = ((t >> s) << (s + 1)) + j;
        const uint64_t tw = K.tw[j << (LOG_N - 1 - s)];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const uint64_t u = w[i0][c];
          const uint64_t v = mul(w[i0 + (1 << s)][c], tw);
          w[i0][c] = add(u, v);
          w[i0 + (1 << s)][c] = sub(u, v);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint64_t s = __ldg(inv_pows + static_cast<size_t>(k) * rows + i);
#pragma unroll
      for (int c = 0; c < D; ++c) w[k][c] = mul(mul(w[k][c], K.inv_n), s);
    }
    uint64_t r[D];
#pragma unroll
    for (int c = 0; c < D; ++c) r[c] = w[N - 1][c];
#pragma unroll
    for (int j = 2; j <= N; ++j) {  // k = N - j
      uint64_t m[D];
      ext_mul<D>(r, al, m);
#pragma unroll
      for (int c = 0; c < D; ++c) r[c] = add(m[c], w[N - j][c]);
    }
#pragma unroll
    for (int c = 0; c < D; ++c) out[static_cast<size_t>(i) * D + c] = r[c];
  }
}

// The largest element offset the layout reaches, plus one.
inline int64_t extent(const int64_t* size, const int64_t* stride, int ndim) {
  int64_t e = 1;
  for (int d = 0; d < ndim; ++d) e += (size[d] - 1) * stride[d];
  return e;
}

unsigned int grid_for(int64_t n) {
  const int64_t blocks = (n + BLOCK - 1) / BLOCK;
  return static_cast<unsigned int>(blocks < MAX_GRID ? blocks : MAX_GRID);
}

// The layout of ndim <= 8 dims, or false for one the kernels do not take
// (n, or an operand's extent, above INT32_MAX).
bool make_layout(Layout& L, int64_t n, int ndim, const int64_t* sizes,
                 const int64_t* a_strides, const int64_t* b_strides,
                 int64_t a_last, int64_t b_last) {
  if (ndim < 1 || ndim > MAX_DIMS || n < 1 || n > INT32_MAX ||
      extent(sizes, a_strides, ndim) + a_last > INT32_MAX ||
      (b_strides != nullptr &&
       extent(sizes, b_strides, ndim) + b_last > INT32_MAX))
    return false;
  L.ndim = ndim;
  L.ca = L.cb = 0;
  for (int d = 0; d < ndim; ++d) {
    L.size[d] = static_cast<uint32_t>(sizes[d]);
    L.sa[d] = static_cast<uint32_t>(a_strides[d]);
    L.sb[d] = b_strides == nullptr ? 0 : static_cast<uint32_t>(b_strides[d]);
  }
  return true;
}

template <int OP>
void launch_op(const uint64_t* a, const uint64_t* b, uint64_t b_value,
               uint64_t* out, uint32_t n, const Layout& L, cudaStream_t s) {
  if (b == nullptr)
    gl_op_kernel<OP, true><<<grid_for(n), BLOCK, 0, s>>>(a, nullptr, b_value,
                                                         out, n, L);
  else
    gl_op_kernel<OP, false><<<grid_for(n), BLOCK, 0, s>>>(a, b, 0, out, n, L);
}

template <int N>
void launch_fold(int d, const uint64_t* ev, const uint64_t* inv_pows,
                 const uint64_t* alpha, uint64_t* out, uint32_t rows,
                 const FoldConsts& K, cudaStream_t s) {
  const unsigned int grid = grid_for(rows);
  if (d == 1)
    gl_fri_fold_kernel<N, 1><<<grid, BLOCK, 0, s>>>(ev, inv_pows, alpha, out,
                                                    rows, K);
  else if (d == 2)
    gl_fri_fold_kernel<N, 2><<<grid, BLOCK, 0, s>>>(ev, inv_pows, alpha, out,
                                                    rows, K);
  else
    gl_fri_fold_kernel<N, 3><<<grid, BLOCK, 0, s>>>(ev, inv_pows, alpha, out,
                                                    rows, K);
}

}  // namespace

extern "C" {

// out (n,) contiguous = a ∘ b (op 0 add, 1 subtract, 2 multiply: B0, K3)
// over a layout of ndim <= 8 dims (sizes, then the element strides of a and
// of b). b == nullptr takes b_value for every element instead. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a layout the kernel does
// not take (n, or an operand's extent, above INT32_MAX).
int wt_gl_op(int op, const void* a, const void* b, uint64_t b_value,
             void* out, int64_t n, int ndim, const int64_t* sizes,
             const int64_t* a_strides, const int64_t* b_strides,
             void* stream) {
  Layout L;
  if (op < ADD || op > MUL ||
      !make_layout(L, n, ndim, sizes, a_strides,
                   b == nullptr ? nullptr : b_strides, 0, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint64_t*>(a);
  const auto* pb = static_cast<const uint64_t*>(b);
  auto* po = static_cast<uint64_t*>(out);
  const auto count = static_cast<uint32_t>(n);
  if (op == ADD)
    launch_op<ADD>(pa, pb, b_value, po, count, L, s);
  else if (op == SUB)
    launch_op<SUB>(pa, pb, b_value, po, count, L, s);
  else
    launch_op<MUL>(pa, pb, b_value, po, count, L, s);
  return static_cast<int>(cudaGetLastError());
}

// out (n, d) contiguous = a·b in the degree-d extension (d 2 or 3: B0x)
// over n leading elements in a layout of ndim <= 8 dims, each operand's d
// components at its component stride (a_comp, b_comp). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what the kernel does not
// take (n·d, or an operand's extent, above INT32_MAX).
int wt_gl_ext_mul(int d, const void* a, const void* b, void* out, int64_t n,
                  int ndim, const int64_t* sizes, const int64_t* a_strides,
                  const int64_t* b_strides, int64_t a_comp, int64_t b_comp,
                  void* stream) {
  Layout L;
  if ((d != 2 && d != 3) || n > INT32_MAX / d || a_comp < 0 || b_comp < 0 ||
      !make_layout(L, n, ndim, sizes, a_strides, b_strides, (d - 1) * a_comp,
                   (d - 1) * b_comp))
    return static_cast<int>(cudaErrorInvalidValue);
  L.ca = static_cast<uint32_t>(a_comp);
  L.cb = static_cast<uint32_t>(b_comp);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint64_t*>(a);
  const auto* pb = static_cast<const uint64_t*>(b);
  auto* po = static_cast<uint64_t*>(out);
  const auto count = static_cast<uint32_t>(n);
  if (d == 2)
    gl_ext_mul_kernel<2><<<grid_for(n), BLOCK, 0, s>>>(pa, pb, po, count, L);
  else
    gl_ext_mul_kernel<3><<<grid_for(n), BLOCK, 0, s>>>(pa, pb, po, count, L);
  return static_cast<int>(cudaGetLastError());
}

// One radix-2 stage (B4) over x (n, cols) contiguous: butterflies of half
// 2^log_half, twiddles tw[j·tw_step] of a (n/2,) table; in place, or, with
// src != nullptr, the first stage (log_half 0) reading the rows of src (n,
// cols, contiguous) in bit-reversed order and writing x. Needs
// n/2·cols <= INT32_MAX.
int wt_gl_ntt_stage(void* x, const void* src, const void* tw, int64_t n,
                    int64_t cols, int log_half, int64_t tw_step,
                    void* stream) {
  const int64_t butterflies = n / 2 * cols;
  if (n < 2 || (n & (n - 1)) || n > (int64_t{1} << 31) || cols < 1 ||
      butterflies > INT32_MAX || log_half < 0 ||
      (int64_t{2} << log_half) > n || tw_step < 1 ||
      tw_step * ((int64_t{1} << log_half) - 1) >= n / 2 ||
      (src != nullptr && log_half != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int log_n = 0;
  while ((int64_t{1} << log_n) < n) ++log_n;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* px = static_cast<uint64_t*>(x);
  const auto* ps = static_cast<const uint64_t*>(src);
  const auto* pt = static_cast<const uint64_t*>(tw);
  const auto c = static_cast<uint32_t>(cols);
  const auto step = static_cast<uint32_t>(tw_step);
  const auto count = static_cast<uint32_t>(butterflies);
  if (src != nullptr)
    gl_ntt_stage_kernel<true><<<grid_for(butterflies), BLOCK, 0, s>>>(
        px, ps, pt, c, log_half, log_n, step, count);
  else
    gl_ntt_stage_kernel<false><<<grid_for(butterflies), BLOCK, 0, s>>>(
        px, nullptr, pt, c, log_half, log_n, step, count);
  return static_cast<int>(cudaGetLastError());
}

// The FRI fold (B5): ev (n_fold·rows, d) contiguous, inv_pows (n_fold,
// rows) contiguous, alpha (d,) on the device → out (rows, d). tw holds the
// n_fold/2 powers of the inverse n_fold-th root, inv_n 1/n_fold (host
// values). n_fold in {2, 4, 8, 16}, d in {1, 2, 3}, rows <= INT32_MAX
// (element offsets are 64-bit).
int wt_gl_fri_fold(const void* ev, const void* inv_pows, const void* alpha,
                   void* out, int64_t rows, int n_fold, int d,
                   const uint64_t* tw, uint64_t inv_n, void* stream) {
  if (rows < 1 || rows > INT32_MAX || d < 1 || d > 3 ||
      (n_fold != 2 && n_fold != 4 && n_fold != 8 && n_fold != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  FoldConsts K;
  for (int k = 0; k < 8; ++k) K.tw[k] = k < n_fold / 2 ? tw[k] : 0;
  K.inv_n = inv_n;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pe = static_cast<const uint64_t*>(ev);
  const auto* pi = static_cast<const uint64_t*>(inv_pows);
  const auto* pa = static_cast<const uint64_t*>(alpha);
  auto* po = static_cast<uint64_t*>(out);
  const auto r = static_cast<uint32_t>(rows);
  if (n_fold == 2)
    launch_fold<2>(d, pe, pi, pa, po, r, K, s);
  else if (n_fold == 4)
    launch_fold<4>(d, pe, pi, pa, po, r, K, s);
  else if (n_fold == 8)
    launch_fold<8>(d, pe, pi, pa, po, r, K, s);
  else
    launch_fold<16>(d, pe, pi, pa, po, r, K, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
