"""f62 field arithmetic, NTT and FRI folding on torch tensors: the port of
winterfell_tpu/ops/f62.py, the engine of the f62 prover
(``prover/device_limb.py`` F62Prover).

p = 2^62 − 111·2^39 + 1 (math/src/field/f62/mod.rs), TWO_ADICITY 39,
GENERATOR 3, quadratic extension x² = x + 1, cubic extension x³ = −2 − 2x.

Layout: an element is one int64 holding its canonical value. p < 2^62, so
the sign bit is never set and a + b never overflows; the int64's
little-endian bytes are the element's 8 bytes, which BLAKE3 and SHA3
``hash_elements`` hash, so ``words.rows_from_u64`` reads f62 rows as it
reads f64 rows. Extension elements are (..., d) with the components on the
last axis, as in ``ops/goldilocks.py``. The JAX engine holds two 32-bit
limbs on a trailing axis of 2 instead; ``interop.py`` converts.

Every field op of the prover goes through three entry points, ``f62_add``,
``f62_sub`` and ``f62_mul`` (B14, csrc/f62.cu), and every NTT stage through
``ntt_stage`` (B14n): for a CUDA tensor the hand-written kernel on the
current stream, without synchronising, adding one to its count in
``LAUNCHES``; for a CPU tensor the plain version. The second operand of a
binary op may be a tensor that broadcasts against the first or a Python int
(one element for every output, passed to the kernel by value). Operands are
checked on every device (``field_kernels.mul_layout``), so the CPU tests
hold every caller to what the kernel reads. Both versions take canonical
operands and return canonical values, so they agree with the JAX engine bit
for bit.

Everything else here (extension ops, powers, inversion, NTT plans, coset
LDE, FRI folding) is torch code over those entry points; the ext ops use
f62's own polynomials and Frobenius constants (winterfell_tpu/ops/f62.py
:269-340), not Goldilocks'.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from ..math.fields import F62, Field
from . import field_kernels

P = F62.p
E = (111 << 39) - 1  # 2^62 mod p
I64 = torch.int64
_M23 = (1 << 23) - 1
_M31 = (1 << 31) - 1
_M62 = (1 << 62) - 1

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"f62_add": 0, "f62_sub": 0, "f62_mul": 0,
                            "f62_ntt_stage": 0}
_OPS = {"add": 0, "sub": 1, "mul": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def const(v: int) -> int:
    """The element v as the Python int the ops take as a second operand."""
    return v % P


# ================================================================================
# Plain versions
# ================================================================================


# The plain ops call torch's functions with 0-dim CPU tensor constants (which
# every device takes as scalars) rather than Python operators with int
# constants: the same kernels at less host time per call, which is what a
# small tensor costs (as ops/goldilocks.py does).
_T = {v: torch.tensor(v) for v in (P, E, 111, 23, 31, 39, 62, _M23, _M31,
                                   _M62)}
_and, _shr, _shl = (torch.bitwise_and, torch.bitwise_right_shift,
                    torch.bitwise_left_shift)
_add, _sub, _mul, _where = torch.add, torch.sub, torch.mul, torch.where


def _cond_sub_p(s):
    return _where(torch.ge(s, _T[P]), _sub(s, _T[P]), s)


def add_plain(a, b):
    """a + b (< 2^63, no overflow), one conditional subtract of p."""
    return _cond_sub_p(_add(a, b))


def sub_plain(a, b):
    """a − b, plus p on a borrow."""
    d = _sub(a, b)
    return _where(torch.lt(d, 0), _add(d, _T[P]), d)


def _fold(h, l):
    """The value h·2^62 + l (0 <= l < 2^62) as h'·2^62 + l' equal to
    h·E + l, congruent mod p (2^62 ≡ E = 111·2^39 − 1): with h = hh·2^23 +
    hl and 111·hl = g·2^23 + f, h·111·2^39 = (111·hh + g)·2^62 + f·2^39."""
    m = _mul(_and(h, _T[_M23]), _T[111])
    low = _sub(_add(_shl(_and(m, _T[_M23]), _T[39]), l), h)
    high = _add(_add(_mul(_shr(h, _T[23]), _T[111]), _shr(m, _T[23])),
                _shr(low, _T[62]))
    return high, _and(low, _T[_M62])


def mul_plain(a, b):
    """The canonical product in int64 tensors: the 124-bit product from
    31-bit halves as h·2^62 + l, three folds by 2^62 ≡ E (h below 2^46,
    2^30, 2^14), then h·E + l < 2^62 + 2^60 and one conditional subtract:
    the kernel's reduction (csrc/f62.cuh mul) in 64-bit signed integers.
    Exact for operands below 2^62."""
    if isinstance(b, int):
        b = torch.tensor(b)
    a0, a1 = _and(a, _T[_M31]), _shr(a, _T[31])
    if b is a:  # a square: the cross term once, doubled
        b0, b1 = a0, a1
        t1 = _shl(_mul(a0, a1), 1)
    else:
        b0, b1 = _and(b, _T[_M31]), _shr(b, _T[31])
        t1 = _add(_mul(a0, b1), _mul(a1, b0))                   # < 2^63
    s = _add(_mul(a0, b0), _shl(_and(t1, _T[_M31]), _T[31]))   # < 2^63
    h = _add(_add(_mul(a1, b1), _shr(t1, _T[31])), _shr(s, _T[62]))
    l = _and(s, _T[_M62])
    for _ in range(3):
        h, l = _fold(h, l)
    return _cond_sub_p(_add(_mul(h, _T[E]), l))


_PLAIN = {"add": add_plain, "sub": sub_plain, "mul": mul_plain}


# ================================================================================
# B14: the elementwise kernel and its entry points
# ================================================================================


_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("f62")
        vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        lib.wt_f62_op.argtypes = [ctypes.c_int, vp, vp, u64, vp, i64,
                                  ctypes.c_int, vp, vp, vp, vp]
        lib.wt_f62_op.restype = ctypes.c_int
        lib.wt_f62_ntt_stage.argtypes = [vp, vp, i64, i64, ctypes.c_int, i64,
                                         vp]
        lib.wt_f62_ntt_stage.restype = ctypes.c_int
        _lib = lib
    return _lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _launcher(name: str):
    code = _OPS[name]

    def launch(a, b, out, layout) -> None:
        """One B14 launch writing a ∘ b into the contiguous ``out``."""
        nd = len(layout.sizes)
        arr = ctypes.c_int64 * nd
        scalar = isinstance(b, int)
        lib = _kernels()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.wt_f62_op(
                code, a.data_ptr(), None if scalar else b.data_ptr(),
                b if scalar else 0, out.data_ptr(), layout.numel, nd,
                arr(*layout.sizes), arr(*layout.a_strides),
                None if scalar else arr(*layout.b_strides), stream)
        _raise_on(err, f"f62_{name}")
        LAUNCHES[f"f62_{name}"] += 1

    return launch


_LAUNCH = {name: _launcher(name) for name in _OPS}


def op_kernel(name: str, a, b, layout=None):
    """B14 on CUDA tensors: a ∘ b (name "add", "sub" or "mul"), a new
    contiguous tensor of the broadcast shape. A product beyond the kernel's
    32-bit offsets is split into launches that fit, as K3 splits."""
    if layout is None:
        layout = field_kernels.mul_layout(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"f62_{name}: the kernel takes CUDA tensors, got "
                         f"{a.device}")
    if isinstance(b, int):
        b = b % P
    out = torch.empty(layout.shape, dtype=I64, device=a.device)
    field_kernels.mul_into(a, b, out, _LAUNCH[name], layout)
    return out


def _op(name: str, a, b):
    layout = field_kernels.mul_layout(a, b)
    if isinstance(b, int):
        b = b % P
    if a.device.type == "cpu":
        return _PLAIN[name](a, b)
    return op_kernel(name, a, b, layout)


def f62_add(a, b):
    return _op("add", a, b)


def f62_sub(a, b):
    return _op("sub", a, b)


def f62_mul(a, b):
    return _op("mul", a, b)


def f62_neg(a):
    """−a: 0 − a."""
    return f62_sub(torch.zeros_like(a), a)


# ================================================================================
# Powers and inversion
# ================================================================================


def f62_pow_const(a, e: int):
    """a ** e for a Python-int exponent (square and multiply)."""
    if e == 0:
        return torch.ones_like(a)
    result = a
    for bit in bin(e)[3:]:
        result = f62_mul(result, result)
        if bit == "1":
            result = f62_mul(result, a)
    return result


# p − 2 = [16 ones][0010000][39 ones] in binary
assert P - 2 == ((2**16 - 1) * 2**7 + 0b0010000) * 2**39 + 2**39 - 1


def f62_inv(a):
    """a^(p−2) (Fermat; inv(0) = 0) by an addition chain over the runs of
    ones of p − 2: 87 squarings and 10 multiplies, where square and multiply
    takes 113 (the JAX base_inv's value, fewer launches)."""
    def ones(x, k: int, y):  # x^(2^k) · y
        for _ in range(k):
            x = f62_mul(x, x)
        return f62_mul(x, y)

    e2 = ones(a, 1, a)        # a^(2^k − 1) as e_k
    e3 = ones(e2, 1, a)
    e6 = ones(e3, 3, e3)
    e12 = ones(e6, 6, e6)
    e13 = ones(e12, 1, a)
    e16 = ones(e13, 3, e3)
    r = ones(e16, 3, a)       # ‖ 001
    for _ in range(4):        # ‖ 0000
        r = f62_mul(r, r)
    e39 = ones(ones(e13, 13, e13), 13, e13)
    return ones(r, 39, e39)


_BATCH_INV_G = 128  # scan-block width, as the JAX engine's


def _scan_mul(x):
    """Inclusive prefix products along the last axis (Hillis–Steele)."""
    step = 1
    while step < x.shape[-1]:
        y = x.clone()
        y[..., step:] = f62_mul(x[..., step:], x[..., :-step])
        x = y
        step *= 2
    return x


def f62_batch_inv(a):
    """Montgomery batch inversion over blocks of 128 and one Fermat chain on
    the block totals (winterfell_tpu/ops/f62.py:346 base_batch_inv).
    Value-identical to f62_inv for every input, zeros included (masked to 1
    for the scans, restored after)."""
    shape = a.shape
    flat = a.reshape(-1)
    n = flat.shape[0]
    if n < 2 * _BATCH_INV_G:
        return f62_inv(a)
    pad = (-n) % _BATCH_INV_G
    if pad:
        flat = torch.cat([flat, torch.ones(pad, dtype=I64, device=a.device)])
    is_zero = flat == 0
    az = torch.where(is_zero, torch.ones_like(flat), flat).reshape(
        -1, _BATCH_INV_G)
    pref = _scan_mul(az)
    suff = _scan_mul(az.flip(-1)).flip(-1)
    tinv = f62_batch_inv(pref[:, -1])
    ones_col = torch.ones((az.shape[0], 1), dtype=I64, device=a.device)
    pprev = torch.cat([ones_col, pref[:, :-1]], dim=1)
    snext = torch.cat([suff[:, 1:], ones_col], dim=1)
    inv = f62_mul(f62_mul(pprev, snext), tinv[:, None]).reshape(-1)
    inv = torch.where(is_zero, torch.zeros_like(inv), inv)
    return inv[:n].reshape(shape)


# ================================================================================
# Extension field ops: trailing axis d in {1, 2, 3}
# (quad x² = x + 1, cubic x³ = −2 − 2x — f62/mod.rs; JAX ops/f62.py:269-340)
# ================================================================================


def ext_add(a, b):
    return f62_add(a, b)


def ext_sub(a, b):
    return f62_sub(a, b)


def ext_mul(a, b):
    d = a.shape[-1]
    if d == 1:
        return f62_mul(a, b)
    if d == 2:
        a0, a1 = a[..., 0], a[..., 1]
        b0, b1 = b[..., 0], b[..., 1]
        t2 = f62_mul(a1, b1)
        c0 = f62_add(f62_mul(a0, b0), t2)
        c1 = f62_add(f62_add(f62_mul(a0, b1), f62_mul(a1, b0)), t2)
        return torch.stack([c0, c1], dim=-1)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    t0 = f62_mul(a0, b0)
    t1 = f62_add(f62_mul(a0, b1), f62_mul(a1, b0))
    t2 = f62_add(f62_add(f62_mul(a0, b2), f62_mul(a1, b1)), f62_mul(a2, b0))
    t3 = f62_add(f62_mul(a1, b2), f62_mul(a2, b1))
    t4 = f62_mul(a2, b2)
    # x³ = −2 − 2x; x⁴ = −2x − 2x²
    t3x2, t4x2 = f62_add(t3, t3), f62_add(t4, t4)
    return torch.stack([f62_sub(t0, t3x2), f62_sub(f62_sub(t1, t3x2), t4x2),
                        f62_sub(t2, t4x2)], dim=-1)


def ext_mul_base(a, s):
    """Extension array × base scalars (broadcast over the trailing axis)."""
    return f62_mul(a, s[..., None] if s.ndim == a.ndim - 1 else s)


@lru_cache(maxsize=None)
def _frobenius_consts(d: int) -> np.ndarray:
    """Matrix F with frob(a)_j = Σ_i a_i · F[i, j] (images of basis powers)."""
    images = Field(F62, d)._frobenius_images()
    return np.array([[images[i][j] for j in range(d)] for i in range(d)],
                    dtype=np.int64)


def frobenius_table(d: int, device) -> torch.Tensor:
    """The (d, d) Frobenius matrix on ``device`` (built once per process)."""
    return _cached(("frob", d, str(device)),
                   lambda: torch.from_numpy(_frobenius_consts(d)).to(device))


def ext_frobenius(a):
    d = a.shape[-1]
    fr = frobenius_table(d, a.device)
    acc = None
    for i in range(d):
        term = f62_mul(a[..., i : i + 1], fr[i])
        acc = term if acc is None else f62_add(acc, term)
    return acc


def _conj_norm(a):
    """(c, norm) with a·c = norm in the base field. For d = 2 the conjugate
    of x is 1 − x (the roots of x² − x − 1 sum to 1)."""
    d = a.shape[-1]
    if d == 2:
        a0, a1 = a[..., 0], a[..., 1]
        c = torch.stack([f62_add(a0, a1), f62_neg(a1)], dim=-1)
    else:
        conj1 = ext_frobenius(a)
        c = ext_mul(conj1, ext_frobenius(conj1))
    return c, ext_mul(a, c)[..., 0]


def ext_inv(a):
    """Inverse of extension elements (..., d) via the norm."""
    if a.shape[-1] == 1:
        return f62_inv(a)
    c, norm = _conj_norm(a)
    return ext_mul_base(c, f62_inv(norm))


def ext_batch_inv(a):
    """ext_inv with the norm inverted by f62_batch_inv."""
    if a.shape[-1] == 1:
        return f62_batch_inv(a)
    c, norm = _conj_norm(a)
    return ext_mul_base(c, f62_batch_inv(norm))


def pow_table_from_jumps(jumps, n: int):
    """(n, d) table of z^k from the jumps z^(2^j) ((log n, d)), by
    log-doubling; it starts from one, made on the device."""
    d, dev = jumps.shape[1], jumps.device
    cur = torch.cat([torch.ones((1, 1), dtype=I64, device=dev),
                     torch.zeros((1, d - 1), dtype=I64, device=dev)], dim=1)
    j = 0
    while cur.shape[0] < n:
        cur = torch.cat([cur, ext_mul(cur, jumps[j].expand(cur.shape[0], d))])
        j += 1
    return cur[:n]


def ext_power_table(e, n: int):
    """(n, d) powers e^k, k < n, of a (d,) device element."""
    jumps = [e]
    for _ in range(max((n - 1).bit_length(), 1) - 1):
        jumps.append(ext_mul(jumps[-1], jumps[-1]))
    return pow_table_from_jumps(torch.stack(jumps), n)


def sum0(arr):
    """Modular sum along axis 0 (power-of-two length), as a tree."""
    while arr.shape[0] > 1:
        half = arr.shape[0] // 2
        arr = f62_add(arr[:half], arr[half : 2 * half])
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
    """[scale · s^k for k < n], built on ``device`` by log-doubling from
    host-computed jumps s^(2^j)."""
    out = torch.full((1,), const(scale), dtype=I64, device=device)
    jump = s % P
    while out.shape[0] < n:
        out = torch.cat([out, f62_mul(out, jump)])
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
    r = F62.get_root_of_unity(n.bit_length() - 1)
    return pow(r, P - 2, P) if inverse else r


def ntt_plan(n: int, inverse: bool, device):
    """(bit-reversal permutation, n/2 powers of the n-th root) of a size-n
    transform on ``device``, built once per process (the permutation is a
    host copy: the resident prove builds its plans before its run)."""
    perm = _cached(("bitrev", n, str(device)),
                   lambda: torch.from_numpy(_bitrev_perm(n)).to(device))
    tw_all = _cached(("tw", n, inverse, str(device)),
                     lambda: power_series(_root(n, inverse), max(n // 2, 1),
                                          device))
    return perm, tw_all


def ntt_stage_plain(x, tw_all, half: int):
    """One radix-2 stage of ``ntt_stage`` in plain PyTorch (a new tensor)."""
    n, cols = x.shape
    mm = 2 * half
    tw = tw_all[:: n // mm][:half].reshape(1, half, 1)
    blk = x.reshape(n // mm, 2, half, cols)
    u = blk[:, 0]
    v = mul_plain(blk[:, 1], tw)
    return torch.cat([add_plain(u, v), sub_plain(u, v)], dim=1).reshape(
        n, cols)


def ntt_stage(x, tw_all, half: int):
    """B14n: the stage of butterflies of ``half`` over x (n, cols), a
    contiguous matrix of rows in bit-reversed order, with the twiddles
    tw_all[j · n/(2·half)] ((n/2,) powers of the n-th root). In place for a
    CUDA tensor (returns x); a new tensor from the plain version on the
    CPU."""
    if x.dtype != I64 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("ntt_stage: expected a contiguous (n, cols) int64 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    n, cols = x.shape
    if n < 2 or n & (n - 1) or half < 1 or half & (half - 1) or 2 * half > n:
        raise ValueError(f"ntt_stage: bad stage {half} of a size-{n} NTT")
    if tw_all.shape != (n // 2,) or not tw_all.is_contiguous() or \
            tw_all.device != x.device or tw_all.dtype != I64:
        raise ValueError("ntt_stage: expected a contiguous (n/2,) twiddle "
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
        err = lib.wt_f62_ntt_stage(x.data_ptr(), tw_all.data_ptr(), n, cols,
                                   half.bit_length() - 1, n // (2 * half),
                                   stream)
    _raise_on(err, "f62_ntt_stage")
    LAUNCHES["f62_ntt_stage"] += 1
    return x


def _ntt_core(x, n: int, inverse: bool):
    """x: (n, ...) → NTT/iNTT without the 1/n scale, natural order in and
    out: the bit-reversal gather, then log2 n stages."""
    if n == 1:
        return x
    shape = x.shape
    perm, tw_all = ntt_plan(n, inverse, x.device)
    y = x.index_select(0, perm).reshape(n, -1)
    half = 1
    while half < n:
        y = ntt_stage(y, tw_all, half)
        half *= 2
    return y.reshape(shape)


def _col(v, ndim: int):
    """(n,) → (n, 1, ...) to broadcast over ndim − 1 trailing axes."""
    return v.reshape((v.shape[0],) + (1,) * (ndim - 1))


def ntt_evaluate(coeffs, n: int):
    return _ntt_core(coeffs, n, inverse=False)


def ntt_interpolate(evals, n: int):
    return f62_mul(_ntt_core(evals, n, inverse=True), pow(n, P - 2, P))


def lde_offset_powers(n: int, offset: int, device):
    """offset^i for i < n, the coefficient scale of the coset LDE."""
    return _cached(("pows", offset % P, n, 1, str(device)),
                   lambda: power_series(offset, n, device))


def ntt_evaluate_with_offset(coeffs, n: int, offset: int, blowup: int):
    """Coset LDE over the n·blowup domain offset·h^m, natural order
    (math.ntt.evaluate_poly_with_offset value for value)."""
    dev = coeffs.device
    scaled = f62_mul(coeffs, _col(lde_offset_powers(n, offset, dev),
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
    return f62_mul(coeffs, _col(interp_offset_powers(n, offset, evals.device),
                                coeffs.ndim))


# ================================================================================
# FRI folding (fri/src/folding/mod.rs apply_drp; JAX ops/f62.py:633-667)
# ================================================================================


def fri_inv_offset_powers(n: int, n_fold: int, domain_offset: int, device):
    """(N, rows) matrix of ((offset·g^i)^-1)^k (folding/mod.rs:103-110)."""
    def build():
        rows = n // n_fold
        g = F62.get_root_of_unity(n.bit_length() - 1)
        inv_offsets = power_series(pow(g, P - 2, P), rows, device,
                                   pow(domain_offset % P, P - 2, P))
        out = [torch.ones_like(inv_offsets)]
        for _ in range(1, n_fold):
            out.append(f62_mul(out[-1], inv_offsets))
        return torch.stack(out)

    return _cached(("fri", n, n_fold, domain_offset % P, str(device)), build)


def fri_fold(evaluations, n_fold: int, domain_offset: int, alpha):
    """evaluations (n, d), alpha (d,) → folded (n/N, d): per row an N-point
    iNTT over the row's coset, the inverse-offset scaling, Horner at α."""
    n, d = evaluations.shape
    rows = n // n_fold
    inv_pows = fri_inv_offset_powers(n, n_fold, domain_offset,
                                     evaluations.device)
    coeffs = _ntt_core(evaluations.reshape(n_fold, rows, d), n_fold,
                       inverse=True)
    coeffs = f62_mul(coeffs, pow(n_fold, P - 2, P))
    result = torch.zeros((rows, d), dtype=I64, device=evaluations.device)
    alpha_b = alpha.reshape(1, d).expand(rows, d)
    for k in range(n_fold - 1, -1, -1):
        result = ext_add(ext_mul(result, alpha_b),
                         f62_mul(coeffs[k], inv_pows[k][:, None]))
    return result


# ================================================================================
# Host <-> tensor conversion
# ================================================================================


def to_device(arr_obj, device) -> torch.Tensor:
    """Object (or integer) array of canonical ints → int64 tensor."""
    u = np.ascontiguousarray(np.asarray(arr_obj).astype(np.uint64))
    return torch.from_numpy(u.view(np.int64)).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor → numpy uint64 array (same bits)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


# ================================================================================
# The engine interface of the tensor provers (prover/device.py); ops/
# goldilocks.py and ops/f128.py give the same names
# ================================================================================

NAME = "f62"
ELEM = ()  # the trailing axes of one element
add, sub, mul, neg = f62_add, f62_sub, f62_mul, f62_neg
pow_const, batch_inv = f62_pow_const, f62_batch_inv


def elements(a: np.ndarray):
    """A uint64 array as Python ints, nested tuples over its axes."""
    if a.ndim == 0:
        return int(a)
    return tuple(elements(x) for x in a)
