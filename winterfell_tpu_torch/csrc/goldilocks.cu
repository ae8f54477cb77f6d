// Elementwise Goldilocks multiply (K3) for Hopper.
//
// Replaces the TPU kernel winterfell_tpu/ops/pallas_kernels.py gl_mul_pallas
// (body _gl_mul_kernel / _gl_mul_limbs): out = a·b mod p, p = 2^64 - 2^32 + 1.
// The TPU kernel works on (lo, hi) u32 planes with 16-bit half-word products,
// because its vector unit has no 64-bit multiply. Here an element is a native
// uint64_t: the 128-bit product is a*b and __umul64hi(a, b), reduced with
// 2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 (mod p). The result is canonical and exact
// for every pair of u64 bit patterns, inputs >= p included.
//
// Bound on this card: bytes. An element of a contiguous product reads 16
// bytes and writes 8, against 8 32-bit integer multiply-adds (one 64×64→128
// product; the product by 2^32 - 1 is a shift and a subtract): at 3.35 TB/s
// and 16.7 T IMAD/s the bytes take about 15 times as long. One grid-stride
// kernel with neighbouring threads on neighbouring output elements takes
// every layout the wrapper passes: contiguous operands, broadcast dims
// (stride 0) and strided views, read in place, and a scalar for b. Offsets
// are 32-bit (the wrapper refuses layouts that reach 2^31 elements); the
// outermost coordinate needs no division, so a contiguous product (one dim
// after the wrapper merges dims) does none.
//
// Built with nvcc into a plain-C shared library (see ops/_build.py); the
// wrapper in ops/field_kernels.py passes device pointers, the coalesced
// sizes and strides, and the current stream, and raises when the entry point
// returns a CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int BLOCK = 256;
constexpr int MAX_DIMS = 8;
constexpr unsigned int MAX_GRID = 132 * 32;  // 32 blocks of 256 on each SM

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

struct Layout {
  uint32_t size[MAX_DIMS];  // outermost first
  uint32_t sa[MAX_DIMS];    // element strides of a
  uint32_t sb[MAX_DIMS];    // element strides of b (0 where broadcast)
  int ndim;
};

// Any strides, broadcast dims at stride 0; b_value for every element when
// B_SCALAR. The output is contiguous in the broadcast shape; each element's
// coordinates come from its linear index, the outermost without a division.
template <bool B_SCALAR>
__global__ void __launch_bounds__(BLOCK)
gl_mul_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
              uint64_t b_value, uint64_t* __restrict__ out, uint32_t n,
              Layout L) {
  const uint32_t step = gridDim.x * BLOCK;
  for (uint32_t i = blockIdx.x * BLOCK + threadIdx.x; i < n; i += step) {
    uint32_t rest = i, oa = 0, ob = 0;
    // unrolled, so every field of L is read at a fixed index: a run-time
    // index puts L on the stack (local memory), about 3x slower
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
    out[i] = mul(__ldg(a + oa), B_SCALAR ? b_value : __ldg(b + ob));
  }
}

// The largest element offset the layout reaches, plus one.
inline int64_t extent(const int64_t* size, const int64_t* stride, int ndim) {
  int64_t e = 1;
  for (int d = 0; d < ndim; ++d) e += (size[d] - 1) * stride[d];
  return e;
}

}  // namespace

extern "C" {

// out (n,) contiguous = a·b mod p over a layout of ndim <= 8 dims (sizes,
// then the element strides of a and of b). b == nullptr multiplies every
// element by b_value instead. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a layout the kernel does not take (n, or an
// operand's extent, above INT32_MAX).
int wt_gl_mul(const void* a, const void* b, uint64_t b_value, void* out,
              int64_t n, int ndim, const int64_t* sizes,
              const int64_t* a_strides, const int64_t* b_strides,
              void* stream) {
  if (ndim < 1 || ndim > MAX_DIMS || n < 1 || n > INT32_MAX ||
      extent(sizes, a_strides, ndim) > INT32_MAX ||
      (b != nullptr && extent(sizes, b_strides, ndim) > INT32_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  Layout L;
  L.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    L.size[d] = static_cast<uint32_t>(sizes[d]);
    L.sa[d] = static_cast<uint32_t>(a_strides[d]);
    L.sb[d] = b == nullptr ? 0 : static_cast<uint32_t>(b_strides[d]);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint64_t*>(a);
  auto* po = static_cast<uint64_t*>(out);
  const int64_t blocks = (n + BLOCK - 1) / BLOCK;
  const unsigned int grid =
      static_cast<unsigned int>(blocks < MAX_GRID ? blocks : MAX_GRID);
  const auto count = static_cast<uint32_t>(n);
  if (b == nullptr)
    gl_mul_kernel<true><<<grid, BLOCK, 0, s>>>(pa, nullptr, b_value, po,
                                               count, L);
  else
    gl_mul_kernel<false><<<grid, BLOCK, 0, s>>>(
        pa, static_cast<const uint64_t*>(b), 0, po, count, L);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
