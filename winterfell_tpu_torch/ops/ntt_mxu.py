"""B16: the f128 NTT's leaf DFTs as int8 digit matrix products on Hopper's
tensor cores, the port of winterfell_tpu/ops/ntt_mxu.py (``_leaf_dft_jit``
under ``leaf_dft``), which runs them on the TPU's MXU. The f128 engine takes
this path under ``WINTER_MXU_NTT=1`` (``ops/f128.py`` ``_USE_MXU``): a
six-step decomposition down to leaves of at most 128 points, each leaf level
one digit product and one recombine.

The arithmetic, as the JAX module has it:

- An element is split into 19 unsigned base-2^7 digits (0..127, exact in
  s8). The n-point DFT matrix W = ω^{rc} is expanded into the (37n × 19n)
  block-Toeplitz digit matrix WT[(l, r), (j, c)] = digit_{l−j}(W[r, c])
  (``_leaf_matrix_np``; its inverse uses ω^{-1}).
- One s8 × s8 → s32 product WT · digits gives, per output row r and column,
  the 37 diagonal sums D_l = Σ_{i+j=l} W_i·x_j. A digit pair's product is at
  most 127², a leaf row adds n of them and a diagonal at most 19 rows:
  D_l <= 127²·19·128 < 2^26.
- The recombine folds Σ_l D_l·2^{7l} < 2^279 to the canonical element:
  2^128 ≡ φ = 45·2^40 − 1 (mod p).

Layout: the caller's elements are (n, B, 2) int64 (lo, hi) words, the f128
engine's; digits are (19n, B) int8 with row j·n + c the j-th digit of
x[c]; diagonal sums are (37n, B) int32 with row l·n + r. The device table
is WT zero-padded to (16·⌈37n/16⌉, 32·⌈19n/32⌉) so the kernel reads whole
MMA tiles; the plain versions read its (37n, 19n) corner.

Kernels (``csrc/ntt_mxu.cu``): the digit product
(``digit_product_kernel``, which digitises its operand while it loads it:
``_digitize`` is fused into it; plain ``digitize_plain`` and
``digit_product_plain``) and the recombine (``recombine_kernel``,
``recombine_plain``). Each launch goes on the current stream and adds one
to its count in ``LAUNCHES``; the ``*_kernel`` entry points raise on CPU
tensors. ``leaf_dft`` runs the two kernels on a CUDA tensor, over chunks of
at most ``_CHUNK_ELEMS`` elements so the (37n, chunk) int32 temp stays
bounded (310 MB), and the plain version on a CPU tensor, in chunks of
``_CHUNK`` columns as the JAX module scans its batch. The plain product
multiplies in float64, exact here (every partial sum is an integer below
2^26 < 2^53), since CUDA has no integer matmul.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from . import f128

P = f128.P
I64 = torch.int64
NUM_DIGITS = 19  # ceil(128 / 7) base-2^7 digits per element
NUM_DIAGS = 2 * NUM_DIGITS - 1  # 37
_M32 = 0xFFFFFFFF

# the plain versions' batch chunk (columns), the JAX module's _CHUNK
_CHUNK = 1 << 15
# the kernels' chunk (elements): a (37n, 2^21 / n) int32 temp, 310 MB
_CHUNK_ELEMS = 1 << 21

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"ntt_mxu_product": 0, "ntt_mxu_recombine": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _digits_of_int(v: int) -> list:
    return [(v >> (7 * k)) & 0x7F for k in range(NUM_DIGITS)]


@lru_cache(maxsize=None)
def _leaf_matrix_np(n: int, inverse: bool) -> np.ndarray:
    """(37n, 19n) int8 block-Toeplitz digit matrix of the n-point DFT matrix
    ω^{rc} (ω^{-1} for the inverse), built once per (n, inverse). W[r, c] =
    ω^{rc mod n} takes its digits from the n powers of ω, so the host does
    n modular products and numpy the rest."""
    root = f128._root(n, inverse)
    powers = [1] * n
    for k in range(1, n):
        powers[k] = powers[k - 1] * root % P
    pow_digits = np.array([_digits_of_int(v) for v in powers],
                          dtype=np.int8).T  # (19, n)
    rc = np.arange(n)[:, None] * np.arange(n)[None, :] % n
    wd = pow_digits[:, rc]  # (19, n, n): digit planes of W
    out = np.zeros((NUM_DIAGS * n, NUM_DIGITS * n), dtype=np.int8)
    for l in range(NUM_DIAGS):
        for j in range(max(0, l - NUM_DIGITS + 1), min(NUM_DIGITS - 1, l) + 1):
            out[l * n : (l + 1) * n, j * n : (j + 1) * n] = wd[l - j]
    return out


def padded_shape(n: int):
    """(rows, columns) of the device table: 37n and 19n rounded up to the
    MMA's m = 16 and k = 32."""
    return -(-NUM_DIAGS * n // 16) * 16, -(-NUM_DIGITS * n // 32) * 32


def leaf_matrix_dev(n: int, inverse: bool, device) -> torch.Tensor:
    """The zero-padded leaf matrix on ``device`` (``padded_shape(n)`` int8,
    WT in its top-left corner), built once per process."""
    def build():
        out = np.zeros(padded_shape(n), dtype=np.int8)
        out[: NUM_DIAGS * n, : NUM_DIGITS * n] = _leaf_matrix_np(n, inverse)
        return torch.from_numpy(out).to(device)

    return f128._cached(("mxu_leaf", n, bool(inverse), str(device)), build)


# ================================================================================
# Plain versions (the JAX module's functions, ntt_mxu.py:93-186)
# ================================================================================


def digitize_plain(x):
    """(L, B, 2) int64 (lo, hi) words → (19L, B) int8 digits; digit 9 (bits
    63-69) takes bit 63 of lo and bits 0-5 of hi, digit 18 the top two bits
    of hi (JAX _digitize, for every 128-bit pattern)."""
    lo, hi = x[..., 0], x[..., 1]
    digs = []
    for k in range(NUM_DIGITS):
        bit = 7 * k
        if bit + 7 <= 64:
            d = (lo >> bit) & 0x7F
        elif bit < 64:  # straddles the words
            d = ((lo >> 63) & 1) | ((hi & (0x7F >> (64 - bit))) << (64 - bit))
        else:  # an arithmetic shift: mask to the word's own bits
            d = (hi >> (bit - 64)) & (0x7F >> max(0, bit + 7 - 128))
        digs.append(d)
    return torch.stack(digs).to(torch.int8).reshape(
        NUM_DIGITS * x.shape[0], x.shape[1])


def _check(x, wt, n: int, name: str) -> None:
    """What the kernels read: x a contiguous (n, B, 2) int64 tensor, wt the
    padded int8 table of n on x's device, n a power of two up to 128."""
    if n < 1 or n & (n - 1) or n > 128:
        raise ValueError(f"{name}: leaf size {n} is not a power of two <= 128")
    if x.dtype != I64 or x.dim() != 3 or x.shape[0] != n or \
            x.shape[2] != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({n}, B, 2) int64 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if wt.dtype != torch.int8 or tuple(wt.shape) != padded_shape(n) or \
            not wt.is_contiguous() or wt.device != x.device:
        raise ValueError(f"{name}: expected the contiguous "
                         f"{padded_shape(n)} int8 leaf matrix on {x.device}")


def _check_diags(d, n: int, name: str) -> None:
    if d.dtype != torch.int32 or d.dim() != 2 or \
            d.shape[0] != NUM_DIAGS * n or not d.is_contiguous():
        raise ValueError(f"{name}: expected contiguous ({NUM_DIAGS * n}, B) "
                         f"int32 diagonal sums, got {d.dtype} "
                         f"{tuple(d.shape)}")


def digit_product_plain(wt, x):
    """(37n, B) int32 diagonal sums WT · digits(x), in float64 (exact)."""
    n, cols = x.shape[0], x.shape[1]
    a = wt[: NUM_DIAGS * n, : NUM_DIGITS * n].to(torch.float64)
    out = torch.empty((NUM_DIAGS * n, cols), dtype=torch.int32,
                      device=x.device)
    for c0 in range(0, cols, _CHUNK):
        digs = digitize_plain(x[:, c0 : c0 + _CHUNK]).to(torch.float64)
        out[:, c0 : c0 + _CHUNK] = (a @ digs).to(torch.int32)
    return out


def recombine_plain(d, n: int):
    """(37n, B) int32 diagonal sums (any values >= 0) → (n, B, 2) canonical
    elements Σ_l D_l·2^{7l} mod p: nine 32-bit columns swept with carries
    (< 2^288), then two folds by 2^128 ≡ 45·2^40 − 1 and a conditional
    subtract, in ops/f128.py mul_plain's steps."""
    diags = d.to(I64).reshape(NUM_DIAGS, n, -1)
    cols = [0] * 9
    for l in range(NUM_DIAGS):
        w, off = divmod(7 * l, 32)
        v = diags[l] << off  # < 2^62
        cols[w] = cols[w] + (v & _M32)
        cols[w + 1] = cols[w + 1] + (v >> 32)
    r, _ = f128._sweep(cols)
    lo, hi = r[:4], r[4:]

    def h45(h):  # h·45·2^40, a digit further up
        return (h * 45) << 8

    # fold 1: hi (five digits)·2^128 ≡ hi·45·2^40 − hi; < 2^197 + 2^128
    t, _ = f128._sweep([lo[0] - hi[0], lo[1] - hi[1] + h45(hi[0]),
                        lo[2] - hi[2] + h45(hi[1]),
                        lo[3] - hi[3] + h45(hi[2]), h45(hi[3]) - hi[4],
                        h45(hi[4]), 0])
    # fold 2: the top three digits (< 2^69) the same way; a carry past
    # 2^128 (the value stays below 2^128 + 2^116) is one more φ
    t, carry = f128._sweep([t[0] - t[4], t[1] - t[5] + h45(t[4]),
                            t[2] - t[6] + h45(t[5]), t[3] + h45(t[6])])
    lo64, hi64 = t[0] | (t[1] << 32), t[2] | (t[3] << 32)
    return f128._pair(*f128._cond_sub_p(*f128._add_phi_if(carry != 0, lo64,
                                                         hi64)))


def leaf_dft_plain(x, wt, n: int):
    """The batched n-point DFT of x (n, B, 2) along axis 0: digit product and
    recombine per chunk of ``_CHUNK`` columns."""
    _check(x, wt, n, "leaf_dft")
    out = torch.empty_like(x)
    for c0 in range(0, x.shape[1], _CHUNK):
        part = x[:, c0 : c0 + _CHUNK]
        out[:, c0 : c0 + _CHUNK] = recombine_plain(
            digit_product_plain(wt, part), n)
    return out


# ================================================================================
# The kernels and their entry points
# ================================================================================

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("ntt_mxu")
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.wt_ntt_mxu_product.argtypes = [vp, vp, vp, i64, i64, i64, i64,
                                           vp]
        lib.wt_ntt_mxu_product.restype = ctypes.c_int
        lib.wt_ntt_mxu_recombine.argtypes = [vp, vp, i64, i64, i64, i64, vp]
        lib.wt_ntt_mxu_recombine.restype = ctypes.c_int
        _lib = lib
    return _lib


def _on_cuda(t, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{t.device}")


def _launch_product(wt, x, d, col0: int, cols: int) -> None:
    """One product launch: d (37n, cols) = WT · digits of x's columns
    [col0, col0 + cols)."""
    lib = _kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_ntt_mxu_product(wt.data_ptr(), x.data_ptr(),
                                     d.data_ptr(), x.shape[0], x.shape[1],
                                     col0, cols, stream)
    f128._raise_on(err, "ntt_mxu_product")
    LAUNCHES["ntt_mxu_product"] += 1


def _launch_recombine(d, y, col0: int, cols: int) -> None:
    """One recombine launch: y's columns [col0, col0 + cols) from d (37n,
    cols)."""
    lib = _kernels()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_ntt_mxu_recombine(d.data_ptr(), y.data_ptr(), y.shape[0],
                                       y.shape[1], col0, cols, stream)
    f128._raise_on(err, "ntt_mxu_recombine")
    LAUNCHES["ntt_mxu_recombine"] += 1


def digit_product_kernel(wt, x):
    """The product kernel on CUDA tensors: (37n, B) int32 diagonal sums."""
    n = x.shape[0] if x.dim() == 3 else 0
    _check(x, wt, n, "ntt_mxu_product")
    _on_cuda(x, "ntt_mxu_product")
    d = torch.empty((NUM_DIAGS * n, x.shape[1]), dtype=torch.int32,
                    device=x.device)
    if x.shape[1]:
        _launch_product(wt, x, d, 0, x.shape[1])
    return d


def recombine_kernel(d, n: int):
    """The recombine kernel on CUDA tensors: (n, B, 2) canonical elements."""
    _check_diags(d, n, "ntt_mxu_recombine")
    _on_cuda(d, "ntt_mxu_recombine")
    y = torch.empty((n, d.shape[1], 2), dtype=I64, device=d.device)
    if d.shape[1]:
        _launch_recombine(d, y, 0, d.shape[1])
    return y


def leaf_dft_kernel(x, wt, n: int):
    """Both kernels on CUDA tensors, per chunk of at most ``_CHUNK_ELEMS``
    elements: the (37n, chunk) temp is made once per call."""
    _check(x, wt, n, "leaf_dft")
    _on_cuda(x, "leaf_dft")
    cols = x.shape[1]
    chunk = max(1, min(cols, _CHUNK_ELEMS // n))
    y = torch.empty_like(x)
    temp = torch.empty(NUM_DIAGS * n * chunk, dtype=torch.int32,
                       device=x.device)
    for c0 in range(0, cols, chunk):
        bc = min(chunk, cols - c0)
        d = temp[: NUM_DIAGS * n * bc].view(NUM_DIAGS * n, bc)
        _launch_product(wt, x, d, c0, bc)
        _launch_recombine(d, y, c0, bc)
    return y


def leaf_dft(x, wt, n: int):
    """Batched n-point DFT (n <= 128) of x (n, B, 2) along axis 0 with the
    padded leaf matrix wt (``leaf_matrix_dev``): the kernels on a CUDA
    tensor, the plain version on a CPU one."""
    _check(x, wt, n, "leaf_dft")
    if x.device.type == "cpu":
        return leaf_dft_plain(x, wt, n)
    if x.device.type != "cuda":
        raise ValueError(f"leaf_dft runs on cpu or cuda, not {x.device}")
    return leaf_dft_kernel(x, wt, n)
