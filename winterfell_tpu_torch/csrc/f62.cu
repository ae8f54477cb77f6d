// f62 field kernels for Hopper: B14, the elementwise add, subtract and
// multiply, and B14n, one radix-2 NTT butterfly stage over every column.
//
// Replace the jnp programs of winterfell_tpu/ops/f62.py (base_add :132,
// base_sub :140 and base_mul :188 over two 32-bit limbs in u64 lanes, and
// the stages of _ntt_small :512 / _ntt_core :528), which XLA fuses on the
// TPU; the JAX package has no Pallas kernel for them. Here an element is one
// u64 holding its canonical value and the arithmetic is the device functions
// of f62.cuh.
//
// B14 (f62_op_kernel): out = a ∘ b for ∘ in {+, -, ·}, one element per
// thread in a grid-stride loop, neighbouring threads on neighbouring output
// elements. As K3 (goldilocks.cu) and B13 (f128.cu), it reads every layout
// the wrapper passes in place: contiguous operands, broadcast dims (stride
// 0), strided views, and b as one element for every output. Strides and
// offsets count elements and are 32-bit; the wrapper (ops/f62.py) splits a
// larger product (field_kernels.mul_into). Bound: bytes for add and sub (16
// read, 8 written per element); the multiply is one 64×64→128-bit product
// and four 64×46-bit folds, about 40 IMADs per element against 24 bytes:
// bound by operations at full rate, by bytes once the product's operands
// are read from memory slower than the IMAD pipe consumes them (PERF.md).
//
// B14n (ntt_stage_kernel): one in-place stage of the radix-2 DIT NTT over
// an (n, cols) element matrix in bit-reversed order: for each block of
// 2·half rows, u = x[i], v = x[i + half]·w^j, x[i] = u + v, x[i + half] =
// u - v, with w^j the twiddle tw[j·tw_step] of a table of n/2 powers of the
// n-th root. One thread per butterfly and column; log2 n launches make the
// transform. Bound: bytes, 32 per butterfly (two elements read and
// written); the twiddle read is shared by the columns.
//
// Built with nvcc into a plain-C shared library (see ops/_build.py); the
// wrappers in ops/f62.py pass device pointers, sizes, strides and the
// current stream, and raise when an entry point returns a CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

#include "f62.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_DIMS = 8;
constexpr unsigned int MAX_GRID = 132 * 32;  // 32 blocks of 256 on each SM

enum Op { ADD = 0, SUB = 1, MUL = 2 };

struct Layout {
  uint32_t size[MAX_DIMS];  // outermost first, in elements
  uint32_t sa[MAX_DIMS];    // element strides of a
  uint32_t sb[MAX_DIMS];    // element strides of b (0 where broadcast)
  int ndim;
};

template <int OP>
__device__ __forceinline__ uint64_t apply(uint64_t a, uint64_t b) {
  if (OP == ADD) return f62::add(a, b);
  if (OP == SUB) return f62::sub(a, b);
  return f62::mul(a, b);
}

template <int OP, bool B_SCALAR>
__global__ void __launch_bounds__(BLOCK)
f62_op_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
              uint64_t b_value, uint64_t* __restrict__ out, uint32_t n,
              Layout L) {
  const uint32_t step = gridDim.x * BLOCK;
  for (uint32_t i = blockIdx.x * BLOCK + threadIdx.x; i < n; i += step) {
    uint32_t rest = i, oa = 0, ob = 0;
    // unrolled, so every field of L is read at a fixed index (a run-time
    // index puts L on the stack, as K3 found)
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
    const uint64_t y = B_SCALAR ? b_value : b[ob];
    out[i] = apply<OP>(a[oa], y);
  }
}

template <int OP>
int launch_op(const uint64_t* a, const uint64_t* b, uint64_t b_value,
              uint64_t* out, uint32_t n, const Layout& L, cudaStream_t s) {
  const int64_t blocks = (static_cast<int64_t>(n) + BLOCK - 1) / BLOCK;
  const unsigned int grid =
      static_cast<unsigned int>(blocks < MAX_GRID ? blocks : MAX_GRID);
  if (b == nullptr)
    f62_op_kernel<OP, true><<<grid, BLOCK, 0, s>>>(a, nullptr, b_value, out,
                                                    n, L);
  else
    f62_op_kernel<OP, false><<<grid, BLOCK, 0, s>>>(a, b, b_value, out, n,
                                                     L);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(BLOCK)
ntt_stage_kernel(uint64_t* __restrict__ x, const uint64_t* __restrict__ tw,
                 uint32_t cols, int log_half, uint32_t tw_step,
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
    const uint64_t u = *p0;
    const uint64_t v = f62::mul(*p1, tw[static_cast<size_t>(j) * tw_step]);
    *p0 = f62::add(u, v);
    *p1 = f62::sub(u, v);
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

// out (n,) contiguous = a ∘ b (op 0 add, 1 subtract, 2 multiply) over a
// layout of ndim <= 8 dims (sizes, then the element strides of a and of b).
// b == nullptr takes b_value for every element instead. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a layout the kernel does
// not take (n, or an operand's extent, above INT32_MAX).
int wt_f62_op(int op, const void* a, const void* b, uint64_t b_value,
              void* out, int64_t n, int ndim, const int64_t* sizes,
              const int64_t* a_strides, const int64_t* b_strides,
              void* stream) {
  if (op < ADD || op > MUL || ndim < 1 || ndim > MAX_DIMS || n < 1 ||
      n > INT32_MAX || extent(sizes, a_strides, ndim) > INT32_MAX ||
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
  const auto* pb = static_cast<const uint64_t*>(b);
  auto* po = static_cast<uint64_t*>(out);
  const auto count = static_cast<uint32_t>(n);
  if (op == ADD) return launch_op<ADD>(pa, pb, b_value, po, count, L, s);
  if (op == SUB) return launch_op<SUB>(pa, pb, b_value, po, count, L, s);
  return launch_op<MUL>(pa, pb, b_value, po, count, L, s);
}

// One radix-2 stage, in place, over x (n, cols) contiguous: butterflies of
// half 2^log_half, twiddles tw[j·tw_step] of a (n/2,) table. Needs
// n/2·cols <= INT32_MAX.
int wt_f62_ntt_stage(void* x, const void* tw, int64_t n, int64_t cols,
                     int log_half, int64_t tw_step, void* stream) {
  const int64_t butterflies = n / 2 * cols;
  if (n < 2 || (n & (n - 1)) || cols < 1 || butterflies > INT32_MAX ||
      log_half < 0 || (int64_t{2} << log_half) > n || tw_step < 1 ||
      tw_step * ((int64_t{1} << log_half) - 1) >= n / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (butterflies + BLOCK - 1) / BLOCK;
  const unsigned int grid =
      static_cast<unsigned int>(blocks < MAX_GRID ? blocks : MAX_GRID);
  ntt_stage_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(x), static_cast<const uint64_t*>(tw),
      static_cast<uint32_t>(cols), log_half, static_cast<uint32_t>(tw_step),
      static_cast<uint32_t>(butterflies));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
