"""f128 field arithmetic, NTT and FRI folding on torch tensors: the port of
winterfell_tpu/ops/f128.py, the engine of the f128 prover
(``prover/device_limb.py``).

p = 2^128 − 45·2^40 + 1 (math/src/field/f128/mod.rs), TWO_ADICITY 40,
GENERATOR 3, quadratic extension x² = x + 1, no cubic.

Layout: an element is two int64 words ``(lo, hi)`` on a trailing axis of 2,
the u64 bit patterns of its low and high halves, so an (n, w, 2) tensor is
the elements' little-endian bytes (what BLAKE3 and SHA3 ``hash_elements``
hash, read in place as u32 words) and what native/f128.c writes. Extension
elements are (..., d, 2). The JAX engine holds four 32-bit digits instead
(trailing axis 4); ``interop.py`` converts.

Every field op of the prover goes through three entry points, ``f128_add``,
``f128_sub`` and ``f128_mul`` (B13, csrc/f128.cu), and every NTT stage
through ``ntt_stage`` (B13n): for a CUDA tensor the hand-written kernel on
the current stream, without synchronising, adding one to its count in
``LAUNCHES``; for a CPU tensor the plain version. The plain versions compute
the JAX engine's functions in plain PyTorch (the product on 32-bit digits
inside int64 tensors), so kernel, plain version and JAX engine agree bit for
bit on every 128-bit input, not only on canonical ones. The second operand of a
binary op may be a tensor that broadcasts against the first or a Python int
(one element for every output, passed to the kernel by value: constants
never become host-to-device copies). Operands are checked on every device,
so the CPU tests hold every caller to what the kernel reads.

Everything else here (extension ops, powers, inversion, NTT plans, coset
LDE, FRI folding) is torch code over those entry points.

Under ``WINTER_MXU_NTT=1`` (``_USE_MXU``, the JAX engine's switch, off by
default) every NTT is the six-step decomposition down to leaves of at most
``_MXU_LEAF`` points, each leaf level one B16 digit product and recombine on
the tensor cores (``ops/ntt_mxu.py``), the levels joined by the mid
twiddles (one B13 multiply) and a transpose: no B13n stage and no
bit-reversal gather runs, the FRI fold's N-point iNTT included.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from ..math.fields import F128, Field
from . import field_kernels

P = F128.p
PHI = (45 << 40) - 1  # 2^128 mod p
I64 = torch.int64
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1

# the MXU leaf mode of winterfell_tpu/ops/f128.py (:506): read at import,
# tests and chip_smoke.py set the flag itself (plans of the two modes are
# cached under different keys)
_USE_MXU = os.environ.get("WINTER_MXU_NTT", "0") not in ("", "0")
_MXU_LEAF = 1 << 7

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"f128_add": 0, "f128_sub": 0, "f128_mul": 0,
                            "f128_ntt_stage": 0}
_OPS = {"add": 0, "sub": 1, "mul": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _s64(v: int) -> int:
    """u64 python int -> the int64 with the same bit pattern."""
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def words(v: int):
    """An element (any int, reduced mod p) as its (lo, hi) int64 words."""
    v %= P
    return _s64(v), _s64(v >> 64)


def const(v: int) -> int:
    """The element v as the Python int the ops take as a second operand."""
    return v % P


def fill(v: int, shape, device) -> torch.Tensor:
    """A (*shape, 2) tensor of the element v, made on ``device`` (fills, no
    host copy)."""
    lo, hi = words(v)
    return torch.stack([torch.full(tuple(shape), lo, dtype=I64, device=device),
                        torch.full(tuple(shape), hi, dtype=I64, device=device)],
                       dim=-1)


# ================================================================================
# Plain versions (the JAX engine's function, ops/f128.py:120-249)
# ================================================================================
#
# add and sub work on the two 64-bit words with unsigned compares (sign bit
# flipped, as ops/goldilocks.py compares), mul on 32-bit digits inside int64
# (every partial product < 2^64, every column sum < 2^63), as
# ops/goldilocks.py:_mul_128 forms its product from 32-bit halves.

_SIGN = -(1 << 63)


def _ult(a, b):
    """Unsigned a < b of int64 bit patterns (b may be a Python int)."""
    return torch.lt(a ^ _SIGN, b ^ _SIGN)


def _split(x):
    """(..., 2) tensor or Python int (< 2^128) -> (lo, hi) int64 patterns."""
    if isinstance(x, int):
        return _s64(x), _s64(x >> 64)
    return x[..., 0], x[..., 1]


def _pair(lo, hi):
    lo, hi = torch.broadcast_tensors(torch.as_tensor(lo), torch.as_tensor(hi))
    return torch.stack([lo, hi], dim=-1)


_P_LO, _P_HI = P_WORDS = (_s64(P), _s64(P >> 64))  # the high word: all ones


def _cond_sub_p(lo, hi):
    """(lo, hi) < 2^128: subtract p once if it is >= p."""
    ge = (hi == _P_HI) & ~_ult(lo, _P_LO)
    return (torch.where(ge, lo - _P_LO, lo),
            torch.where(ge, torch.zeros_like(hi), hi))


def _add_phi_if(cond, lo, hi):
    """(lo, hi) + φ (mod 2^128) where cond holds."""
    lo2 = lo + PHI
    hi2 = hi + _ult(lo2, lo).to(I64)
    return torch.where(cond, lo2, lo), torch.where(cond, hi2, hi)


def add_plain(a, b):
    """The 128-bit sum; a carry out of bit 128 adds φ = 2^128 mod p (mod
    2^128); then one conditional subtract of p (JAX f128_add)."""
    (a0, a1), (b0, b1) = _split(a), _split(b)
    lo = a0 + b0
    c0 = _ult(lo, a0).to(I64)
    h = a1 + b1
    hi = h + c0
    carry = _ult(h, a1) | _ult(hi, h)
    return _pair(*_cond_sub_p(*_add_phi_if(carry, lo, hi)))


def sub_plain(a, b):
    """The 128-bit difference; a borrow adds p (mod 2^128) (JAX f128_sub)."""
    (a0, a1), (b0, b1) = _split(a), _split(b)
    b0_lt = _ult(a0, b0)
    lo = a0 - b0
    hi = a1 - b1 - b0_lt.to(I64)
    borrow = _ult(a1, b1) | ((a1 == b1) & b0_lt)
    lo2 = lo + _P_LO
    hi2 = hi + _P_HI + _ult(lo2, lo).to(I64)
    return _pair(torch.where(borrow, lo2, lo), torch.where(borrow, hi2, hi))


def _digits(x):
    """(..., 2) tensor or Python int -> its four 32-bit digits, low first."""
    if isinstance(x, int):
        return [(x >> (32 * k)) & _M32 for k in range(4)]
    lo, hi = x[..., 0], x[..., 1]
    return [lo & _M32, (lo >> 32) & _M32, hi & _M32, (hi >> 32) & _M32]


def _sweep(cols):
    """Signed column sums -> 32-bit digits and the final carry (arithmetic
    shifts: floor division, so negative columns borrow exactly)."""
    out, carry = [], 0
    for c in cols:
        t = c + carry
        out.append(t & _M32)
        carry = t >> 32
    return out, carry


_COLUMNS: Dict[str, tuple] = {}


def _column_index(device):
    """The columns i + j (low halves) and i + j + 1 (high halves) of the
    sixteen digit products of a 4×4 schoolbook product, on ``device``."""
    key = str(device)
    if key not in _COLUMNS:
        i0 = torch.tensor([i + j for i in range(4) for j in range(4)],
                          device=device)
        _COLUMNS[key] = (i0, i0 + 1)
    return _COLUMNS[key]


def mul_plain(a, b):
    """The canonical product: the 256-bit product from the sixteen 32×32
    digit products, then two folds with 2^128 ≡ φ = 45·2^40 − 1 and one
    conditional subtract (the JAX _fold_256 schedule)."""
    dev = a.device
    da = torch.stack(_digits(a), dim=-1)
    db = (torch.tensor(_digits(b), dtype=I64, device=dev) if isinstance(b, int)
          else torch.stack(_digits(b), dim=-1))
    prod = (da[..., :, None] * db[..., None, :]).flatten(-2)  # < 2^64 each
    i0, i1 = _column_index(dev)
    cols = torch.zeros(prod.shape[:-1] + (8,), dtype=I64, device=dev)
    cols.index_add_(-1, i0, prod & _M32).index_add_(-1, i1,
                                                    (prod >> 32) & _M32)
    r, _ = _sweep(cols.unbind(-1))
    lo, hi = r[:4], r[4:]
    # fold 1: hi·2^128 + lo ≡ hi·45·2^40 − hi + lo (< 2^176: six digits)
    h45 = [(h * 45) << 8 for h in hi]  # hi·45·2^40, a digit further up
    t, _ = _sweep([lo[0] - hi[0], lo[1] - hi[1] + h45[0],
                   lo[2] - hi[2] + h45[1], lo[3] - hi[3] + h45[2], h45[3],
                   0])
    # fold 2: the top two digits (< 2^48) times φ, plus the low four; a
    # carry past 2^128 (the value stays below 2^128 + 2^94) is one more φ
    t, carry = _sweep([t[0] - t[4], t[1] - t[5] + ((t[4] * 45) << 8),
                       t[2] + ((t[5] * 45) << 8), t[3]])
    lo64, hi64 = t[0] | (t[1] << 32), t[2] | (t[3] << 32)
    return _pair(*_cond_sub_p(*_add_phi_if(carry != 0, lo64, hi64)))


_PLAIN = {"add": add_plain, "sub": sub_plain, "mul": mul_plain}


# ================================================================================
# B13: the elementwise kernel and its entry points
# ================================================================================


def _check_elems(t, name: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: the first operand must be a tensor")
    if t.dtype != I64 or t.dim() < 1 or t.shape[-1] != 2:
        raise TypeError(f"{name}: expected (..., 2) int64 elements, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: an element's two words must be adjacent "
                         f"(strides {t.stride()})")


def op_layout(name: str, a, b) -> field_kernels.MulLayout:
    """The checked layout of a ∘ b over the elements (word strides, as K3's
    layout over int64 values); raises on operands the kernel cannot take."""
    _check_elems(a, name)
    if isinstance(b, int):
        return field_kernels.mul_layout(a[..., 0], b)
    if not isinstance(b, torch.Tensor):
        raise TypeError(f"{name}: the second operand must be a tensor or an "
                        f"int, got {type(b).__name__}")
    _check_elems(b, name)
    return field_kernels.mul_layout(a[..., 0], b[..., 0])


_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("f128")
        vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        lib.wt_f128_op.argtypes = [ctypes.c_int, vp, vp, u64, u64, vp, i64,
                                   ctypes.c_int, vp, vp, vp, vp]
        lib.wt_f128_op.restype = ctypes.c_int
        lib.wt_f128_ntt_stage.argtypes = [vp, vp, i64, i64, ctypes.c_int, i64,
                                          vp]
        lib.wt_f128_ntt_stage.restype = ctypes.c_int
        _lib = lib
    return _lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _launcher(name: str):
    code = _OPS[name]

    def launch(a0, b0, out0, layout) -> None:
        """One B13 launch writing a ∘ b into the contiguous pairs at out0
        (a0, b0, out0: the lo-word views of the operands)."""
        nd = len(layout.sizes)
        arr = ctypes.c_int64 * nd
        scalar = isinstance(b0, int)
        lo, hi = (b0 & _M64, b0 >> 64) if scalar else (0, 0)
        lib = _kernels()
        with torch.cuda.device(a0.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.wt_f128_op(
                code, a0.data_ptr(), None if scalar else b0.data_ptr(), lo,
                hi, out0.data_ptr(), layout.numel, nd, arr(*layout.sizes),
                arr(*layout.a_strides),
                None if scalar else arr(*layout.b_strides), stream)
        _raise_on(err, f"f128_{name}")
        LAUNCHES[f"f128_{name}"] += 1

    return launch


_LAUNCH = {name: _launcher(name) for name in _OPS}


def op_kernel(name: str, a, b, layout=None):
    """B13 on CUDA tensors: a ∘ b (name "add", "sub" or "mul"), a new
    contiguous (..., 2) tensor of the broadcast shape. A product beyond the
    kernel's 32-bit offsets is split into launches that fit, as K3 splits."""
    if layout is None:
        layout = op_layout(f"f128_{name}", a, b)
    if a.device.type != "cuda":
        raise ValueError(f"f128_{name}: the kernel takes CUDA tensors, got "
                         f"{a.device}")
    if isinstance(b, int):
        b = b % P
    out = torch.empty(layout.shape + (2,), dtype=I64, device=a.device)
    field_kernels.mul_into(a[..., 0], b if isinstance(b, int) else b[..., 0],
                           out[..., 0], _LAUNCH[name], layout)
    return out


def _op(name: str, a, b):
    layout = op_layout(f"f128_{name}", a, b)
    if a.device.type == "cpu":
        if isinstance(b, int):
            b = b % P
        return _PLAIN[name](a, b)
    return op_kernel(name, a, b, layout)


def f128_add(a, b):
    return _op("add", a, b)


def f128_sub(a, b):
    return _op("sub", a, b)


def f128_mul(a, b):
    return _op("mul", a, b)


def f128_neg(a):
    """−a: 0 − a (for every 128-bit input what the JAX f128_neg gives)."""
    return f128_sub(torch.zeros_like(a), a)


# ================================================================================
# Powers and inversion
# ================================================================================


def f128_pow_const(a, e: int):
    """a ** e for a Python-int exponent (square and multiply)."""
    if e == 0:
        return fill(1, a.shape[:-1], a.device)
    result = a
    for bit in bin(e)[3:]:
        result = f128_mul(result, result)
        if bit == "1":
            result = f128_mul(result, a)
    return result


# p − 2 = [82 ones][010010][40 ones] in binary
assert P - 2 == ((2**82 - 1) * 64 + 0b010010) * 2**40 + 2**40 - 1


def f128_inv(a):
    """a^(p−2) (Fermat; inv(0) = 0) by an addition chain over the runs of
    ones of p − 2: 127 squarings and 12 multiplies, where square and
    multiply takes about 250 (the JAX f128_inv's value, fewer launches)."""
    def ones(x, k: int, y):  # x^(2^k) · y
        for _ in range(k):
            x = f128_mul(x, x)
        return f128_mul(x, y)

    e2 = ones(a, 1, a)        # a^(2^k − 1) as e_k
    e4 = ones(e2, 2, e2)
    e5 = ones(e4, 1, a)
    e10 = ones(e5, 5, e5)
    e20 = ones(e10, 10, e10)
    e40 = ones(e20, 20, e20)
    e80 = ones(e40, 40, e40)
    r = ones(ones(e80, 1, a), 1, a)  # e82
    for bit in "010010":
        r = f128_mul(r, r)
        if bit == "1":
            r = f128_mul(r, a)
    return ones(r, 40, e40)


_BATCH_INV_G = 128  # scan-block width, as the JAX engine's


def _scan_mul(x):
    """Inclusive prefix products along axis -2 (Hillis–Steele)."""
    step = 1
    while step < x.shape[-2]:
        y = x.clone()
        y[..., step:, :] = f128_mul(x[..., step:, :], x[..., :-step, :])
        x = y
        step *= 2
    return x


def _is_zero(a):
    return (a == 0).all(dim=-1)


def f128_batch_inv(a):
    """Montgomery batch inversion over blocks of 128 and one Fermat chain on
    the block totals (winterfell_tpu/ops/f128.py:309). Value-identical to
    f128_inv for every input, zeros included (masked to 1 for the scans)."""
    shape = a.shape
    flat = a.reshape(-1, 2)
    n = flat.shape[0]
    if n < 2 * _BATCH_INV_G:
        return f128_inv(a)
    pad = (-n) % _BATCH_INV_G
    if pad:
        flat = torch.cat([flat, fill(1, (pad,), a.device)])
    zero = _is_zero(flat)
    one = fill(1, (1,), a.device)
    az = torch.where(zero[:, None], one, flat).reshape(-1, _BATCH_INV_G, 2)
    pref = _scan_mul(az)
    suff = _scan_mul(az.flip(-2)).flip(-2)
    tinv = f128_batch_inv(pref[:, -1])
    ones_col = fill(1, (az.shape[0], 1), a.device)
    pprev = torch.cat([ones_col, pref[:, :-1]], dim=1)
    snext = torch.cat([suff[:, 1:], ones_col], dim=1)
    inv = f128_mul(f128_mul(pprev, snext), tinv[:, None]).reshape(-1, 2)
    inv = torch.where(zero[:, None], torch.zeros_like(inv), inv)
    return inv[:n].reshape(shape)


# ================================================================================
# Quadratic extension: (..., d, 2), d in {1, 2}; x² = x + 1
# (math/src/field/f128/mod.rs:264-287)
# ================================================================================


def ext_add(a, b):
    return f128_add(a, b)


def ext_sub(a, b):
    return f128_sub(a, b)


def ext_mul(a, b):
    if a.shape[-2] == 1:
        return f128_mul(a, b)
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    t2 = f128_mul(a1, b1)
    c0 = f128_add(f128_mul(a0, b0), t2)
    c1 = f128_add(f128_add(f128_mul(a0, b1), f128_mul(a1, b0)), t2)
    return torch.stack([c0, c1], dim=-2)


def ext_mul_base(a, s):
    """(..., d, 2) extension elements × (..., 2) base elements."""
    return f128_mul(a, s[..., None, :])


@lru_cache(maxsize=None)
def _frobenius_image() -> tuple:
    """x^p in the quadratic extension (the image of the basis element x)."""
    return Field(F128, 2)._frobenius_images()[1]


def _conj_norm(a):
    """(conjugate c, norm) with a·c = norm in the base field."""
    img = _frobenius_image()
    a0, a1 = a[..., 0, :], a[..., 1, :]
    c = torch.stack([f128_add(a0, f128_mul(a1, img[0])), f128_mul(a1, img[1])],
                    dim=-2)
    return c, ext_mul(a, c)[..., 0, :]


def ext_inv(a):
    if a.shape[-2] == 1:
        return f128_inv(a)
    c, norm = _conj_norm(a)
    return ext_mul_base(c, f128_inv(norm))


def ext_batch_inv(a):
    """ext_inv with the norm inverted by f128_batch_inv."""
    if a.shape[-2] == 1:
        return f128_batch_inv(a)
    c, norm = _conj_norm(a)
    return ext_mul_base(c, f128_batch_inv(norm))


def pow_table_from_jumps(jumps, n: int):
    """(n, d, 2) table of z^k from the jumps z^(2^j) ((log n, d, 2)), by
    log-doubling; it starts from one, made on the device."""
    d = jumps.shape[1]
    one = torch.cat([fill(1, (1, 1), jumps.device),
                     fill(0, (1, d - 1), jumps.device)], dim=1)
    cur, j = one, 0
    while cur.shape[0] < n:
        cur = torch.cat([cur, ext_mul(cur, jumps[j].expand(cur.shape))])
        j += 1
    return cur[:n]


def ext_power_table(e, n: int):
    """(n, d, 2) powers e^k, k < n, of a (d, 2) device element."""
    jumps = [e]
    for _ in range(max((n - 1).bit_length(), 1) - 1):
        jumps.append(ext_mul(jumps[-1], jumps[-1]))
    return pow_table_from_jumps(torch.stack(jumps), n)


def sum0(arr):
    """Modular sum along axis 0 (power-of-two length), as a tree."""
    while arr.shape[0] > 1:
        half = arr.shape[0] // 2
        arr = f128_add(arr[:half], arr[half : 2 * half])
    return arr[0]


# ================================================================================
# Power series and NTT (radix-2 DIT over the leading axis, natural order)
# ================================================================================

_dev_cache: Dict[tuple, torch.Tensor] = {}


def _cached(key, build):
    """Per-device tables (twiddles, power series) built once per process."""
    t = _dev_cache.get(key)
    if t is None:
        t = _dev_cache[key] = build()
    return t


def power_series(s: int, n: int, device, scale: int = 1):
    """(n, 2) series [scale · s^k for k < n], built on ``device`` by
    log-doubling from host-computed jumps s^(2^j)."""
    out = fill(scale, (1,), device)
    jump = s % P
    while out.shape[0] < n:
        out = torch.cat([out, f128_mul(out, jump)])
        jump = jump * jump % P
    return out[:n]


@lru_cache(maxsize=None)
def _bitrev_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    perm = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for i in range(logn):
        rev = (rev << 1) | ((perm >> i) & 1)
    return rev


def _root(n: int, inverse: bool) -> int:
    r = F128.get_root_of_unity(n.bit_length() - 1)
    return pow(r, P - 2, P) if inverse else r


def mid_twiddles(n: int, a: int, inverse: bool, device):
    """(b, a, 2) table ω^(j·k), j < b = n/a, k < a, of the n-th root ω (its
    inverse), by row doubling from power series of ω^(2^r) (JAX
    _mid_twiddles_dev, winterfell_tpu/ops/f128.py:467)."""
    def build():
        root = _root(n, inverse)
        tw, m = fill(1, (1, a), device), 1
        while m < n // a:
            ratio = power_series(pow(root, m, P), a, device)
            tw = torch.cat([tw, f128_mul(tw, ratio[None])])
            m *= 2
        return tw

    return _cached(("mxu_mid", n, a, inverse, str(device)), build)


def _mxu_plan(n: int, inverse: bool, device):
    """The six-step plan of the JAX engine under the switch (ntt_plan :515):
    ("leaf", padded leaf matrix) up to 128 points, else ("six", mid
    twiddles (b, a, 2), inner plan of b, outer plan of a) with a =
    2^⌊log2 n / 2⌋; built once per process, the leaf matrices and mid
    twiddles of every level with it."""
    from . import ntt_mxu

    def build():
        if n <= _MXU_LEAF:
            return ("leaf", ntt_mxu.leaf_matrix_dev(n, inverse, device))
        a = 1 << ((n.bit_length() - 1) // 2)
        return ("six", mid_twiddles(n, a, inverse, device),
                _mxu_plan(n // a, inverse, device),
                _mxu_plan(a, inverse, device))

    return _cached(("mxu_plan", n, inverse, str(device)), build)


def ntt_plan(n: int, inverse: bool, device):
    """The tables of a size-n transform on ``device``, built once per
    process: under the switch the six-step plan (``_mxu_plan``), else (the
    bit-reversal permutation, (n/2, 2) powers of the n-th root). The
    permutation and the leaf matrices are host copies: the resident prove
    builds its plans before its run."""
    if _USE_MXU:
        return _mxu_plan(n, inverse, device)
    perm = _cached(("bitrev", n, str(device)),
                   lambda: torch.from_numpy(_bitrev_perm(n)).to(device))
    tw_all = _cached(("tw", n, inverse, str(device)),
                     lambda: power_series(_root(n, inverse), max(n // 2, 1),
                                          device))
    return perm, tw_all


def ntt_stage_plain(x, tw_all, half: int):
    """One radix-2 stage of ``ntt_stage`` in plain PyTorch (a new tensor)."""
    n, cols = x.shape[0], x.shape[1]
    mm = 2 * half
    tw = tw_all[:: n // mm][:half].reshape(1, half, 1, 2)
    blk = x.reshape(n // mm, 2, half, cols, 2)
    u = blk[:, 0]
    v = mul_plain(blk[:, 1], tw)
    return torch.cat([add_plain(u, v), sub_plain(u, v)], dim=1).reshape(
        n, cols, 2)


def ntt_stage(x, tw_all, half: int):
    """B13n: the stage of butterflies of ``half`` over x (n, cols, 2), a
    contiguous matrix of rows in bit-reversed order, with the twiddles
    tw_all[j · n/(2·half)] ((n/2, 2) powers of the n-th root). In place for
    a CUDA tensor (returns x); a new tensor from the plain version on the
    CPU."""
    if x.dtype != I64 or x.dim() != 3 or x.shape[2] != 2 or \
            not x.is_contiguous():
        raise ValueError("ntt_stage: expected a contiguous (n, cols, 2) int64 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    n, cols = x.shape[0], x.shape[1]
    if n < 2 or n & (n - 1) or half < 1 or half & (half - 1) or 2 * half > n:
        raise ValueError(f"ntt_stage: bad stage {half} of a size-{n} NTT")
    if tw_all.shape != (n // 2, 2) or not tw_all.is_contiguous() or \
            tw_all.device != x.device or tw_all.dtype != I64:
        raise ValueError("ntt_stage: expected a contiguous (n/2, 2) twiddle "
                         "table on the tensor's device")
    if x.device.type == "cpu":
        return ntt_stage_plain(x, tw_all, half)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_stage runs on cpu or cuda, not {x.device}")
    if n // 2 * cols > field_kernels.INDEX_LIMIT:
        raise ValueError("ntt_stage: more than 2^31 − 1 butterflies")
    lib = _kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_f128_ntt_stage(x.data_ptr(), tw_all.data_ptr(), n, cols,
                                    half.bit_length() - 1, n // (2 * half),
                                    stream)
    _raise_on(err, "f128_ntt_stage")
    LAUNCHES["f128_ntt_stage"] += 1
    return x


def _ntt_mxu(x, n: int, plan):
    """The six-step NTT of x (n, ..., 2) along axis 0 (JAX _ntt_core :571):
    a leaf is one B16 leaf DFT; above, the inner NTTs over b, the mid
    twiddles, the transpose and the outer NTTs over a."""
    from . import ntt_mxu

    if plan[0] == "leaf":
        return ntt_mxu.leaf_dft(x.reshape(n, -1, 2).contiguous(), plan[1],
                                n).reshape(x.shape)
    _, mid_tw, inner, outer = plan
    rest = x.shape[1:-1]
    b, a = mid_tw.shape[0], mid_tw.shape[1]
    y = _ntt_mxu(x.reshape((b, a) + rest + (2,)), b, inner)
    y = f128_mul(y, mid_tw.reshape((b, a) + (1,) * len(rest) + (2,)))
    z = y.transpose(0, 1).contiguous()
    return _ntt_mxu(z, a, outer).reshape(x.shape)


def _ntt_core(x, n: int, inverse: bool):
    """x: (n, ..., 2) → NTT/iNTT without the 1/n scale, natural order in
    and out: the bit-reversal gather, then log2 n stages; under the switch
    the six-step NTT over B16 leaves."""
    if n == 1:
        return x
    if _USE_MXU:
        return _ntt_mxu(x, n, ntt_plan(n, inverse, x.device))
    shape = x.shape
    perm, tw_all = ntt_plan(n, inverse, x.device)
    y = x.index_select(0, perm).reshape(n, -1, 2)
    half = 1
    while half < n:
        y = ntt_stage(y, tw_all, half)
        half *= 2
    return y.reshape(shape)


def _col(v, ndim: int):
    """(n, 2) → (n, 1, ..., 2) to broadcast over ndim − 2 middle axes."""
    return v.reshape((v.shape[0],) + (1,) * (ndim - 2) + (2,))


def ntt_evaluate(coeffs, n: int):
    return _ntt_core(coeffs, n, inverse=False)


def ntt_interpolate(evals, n: int):
    return f128_mul(_ntt_core(evals, n, inverse=True), pow(n, P - 2, P))


def lde_offset_powers(n: int, offset: int, device):
    """offset^i for i < n, the coefficient scale of the coset LDE."""
    return _cached(("pows", offset % P, n, 1, str(device)),
                   lambda: power_series(offset, n, device))


def ntt_evaluate_with_offset(coeffs, n: int, offset: int, blowup: int):
    """Coset LDE over the n·blowup domain offset·h^m, natural order
    (math.ntt.evaluate_poly_with_offset value for value)."""
    dev = coeffs.device
    scaled = f128_mul(coeffs, _col(lde_offset_powers(n, offset, dev),
                                   coeffs.ndim))
    big_n = n * blowup
    padded = torch.cat([scaled, torch.zeros((big_n - n,) + coeffs.shape[1:],
                                            dtype=I64, device=dev)])
    return _ntt_core(padded, big_n, inverse=False)


def interp_offset_powers(n: int, offset: int, device):
    """(1/n)·offset^-i, the combined scale of offset interpolation."""
    inv_offset = pow(offset % P, P - 2, P)
    inv_n = pow(n, P - 2, P)
    return _cached(("pows", inv_offset, n, inv_n, str(device)),
                   lambda: power_series(inv_offset, n, device, inv_n))


def ntt_interpolate_with_offset(evals, n: int, offset: int):
    coeffs = _ntt_core(evals, n, inverse=True)
    return f128_mul(coeffs, _col(interp_offset_powers(n, offset, evals.device),
                                 coeffs.ndim))


# ================================================================================
# FRI folding (fri/src/folding/mod.rs apply_drp; JAX ops/f128.py:683-737)
# ================================================================================


def fri_inv_offset_powers(n: int, n_fold: int, domain_offset: int, device):
    """(N, rows, 2) matrix of ((offset·g^i)^-1)^k."""
    def build():
        rows = n // n_fold
        g = F128.get_root_of_unity(n.bit_length() - 1)
        inv_offsets = power_series(pow(g, P - 2, P), rows, device,
                                   pow(domain_offset % P, P - 2, P))
        out = [fill(1, (rows,), device)]
        for _ in range(1, n_fold):
            out.append(f128_mul(out[-1], inv_offsets))
        return torch.stack(out)

    return _cached(("fri", n, n_fold, domain_offset % P, str(device)), build)


def fri_fold(evaluations, n_fold: int, domain_offset: int, alpha):
    """evaluations (n, d, 2), alpha (d, 2) → folded (n/N, d, 2): per row an
    N-point iNTT over the row's coset, the inverse-offset scaling, Horner at
    α."""
    n, d = evaluations.shape[0], evaluations.shape[1]
    rows = n // n_fold
    inv_pows = fri_inv_offset_powers(n, n_fold, domain_offset,
                                     evaluations.device)
    coeffs = _ntt_core(evaluations.reshape(n_fold, rows, d, 2), n_fold,
                       inverse=True)
    coeffs = f128_mul(coeffs, pow(n_fold, P - 2, P))
    result = torch.zeros((rows, d, 2), dtype=I64, device=evaluations.device)
    alpha_b = alpha.reshape(1, d, 2).expand(rows, d, 2)
    for k in range(n_fold - 1, -1, -1):
        result = ext_add(ext_mul(result, alpha_b),
                         f128_mul(coeffs[k], inv_pows[k][:, None, :]))
    return result


# ================================================================================
# Host <-> tensor conversion
# ================================================================================


def to_pairs_np(arr_obj) -> np.ndarray:
    """Object (or integer) array of canonical ints -> (..., 2) uint64 array
    of (lo, hi) words."""
    arr_obj = np.asarray(arr_obj, dtype=object)
    out = np.empty(arr_obj.shape + (2,), dtype=np.uint64)
    out[..., 0] = np.bitwise_and(arr_obj, _M64).astype(np.uint64)
    out[..., 1] = np.right_shift(arr_obj, 64).astype(np.uint64)
    return out


def from_pairs_np(pairs: np.ndarray) -> np.ndarray:
    """(..., 2) uint64 (lo, hi) words -> object array of Python ints."""
    pairs = np.asarray(pairs, dtype=np.uint64)
    return pairs[..., 0].astype(object) + (pairs[..., 1].astype(object) << 64)


def to_device(arr_obj, device) -> torch.Tensor:
    """Object array of canonical ints -> (..., 2) int64 tensor on
    ``device``."""
    return torch.from_numpy(to_pairs_np(arr_obj).view(np.int64)).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """(..., 2) int64 tensor -> (..., 2) uint64 array (same bits)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def to_ints(t: torch.Tensor) -> np.ndarray:
    """(..., 2) int64 tensor -> object array of Python ints."""
    return from_pairs_np(to_u64(t))


# ================================================================================
# The engine interface of the tensor provers (prover/device.py); ops/
# goldilocks.py gives the same names
# ================================================================================

NAME = "f128"
ELEM = (2,)  # the trailing axes of one element: its (lo, hi) words
add, sub, mul = f128_add, f128_sub, f128_mul
pow_const, batch_inv = f128_pow_const, f128_batch_inv


def elements(pairs: np.ndarray):
    """A (..., 2) uint64 array of (lo, hi) words as Python ints, nested
    tuples over its leading axes."""
    if pairs.ndim == 1:
        return int(pairs[0]) | (int(pairs[1]) << 64)
    return tuple(elements(x) for x in pairs)
