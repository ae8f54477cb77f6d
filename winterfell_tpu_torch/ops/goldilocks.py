"""Goldilocks (f64) field arithmetic, NTT, FRI folding and Rescue/Merkle entry
points on torch tensors — the port's compute core.

Representation: a field element is a ``torch.int64`` holding the u64 bit
pattern of its canonical value (numpy ``uint64`` crosses over with
``.view(np.int64)`` in both directions). Eager torch has no unsigned 64-bit
arithmetic, so:

- ``+``, ``-`` and ``*`` wrap modulo 2^64 on int64 exactly as on u64;
- an unsigned compare flips the sign bit of both sides first (``_ult``);
- a logical right shift is an arithmetic shift masked to the kept bits.

Multiplication forms the 128-bit product from 32-bit halves and reduces it
with 2^64 ≡ 2^32 − 1 and 2^96 ≡ −1 (mod p), as the JAX engine does
(winterfell_tpu/ops/goldilocks.py:97-131). Every op returns canonical values,
so results are bit-identical to the exact host oracle in ``math/`` whatever
the device.

Every field op, NTT stage and FRI fold goes through entry points that
dispatch on the device: ``gl_add``, ``gl_sub``, ``gl_mul`` (``gl_neg`` is one
subtract) and ``ext_mul`` to K3, B0 and B0x (``ops/field_kernels.py``);
``ntt_stage`` and ``ntt_bitrev_stage`` (under ``_ntt_core``) to B4 and
``fri_fold`` to B5, whose wrappers are below; the Rescue row hash and 2-to-1
merge (per level and over Merkle trees) to those of ``ops/rescue.py``. A CUDA
tensor goes to the hand-written kernel of ``csrc/`` (on the current stream,
without synchronising, one added to its count in
``field_kernels.LAUNCHES``), a CPU tensor to its plain version. Everything
else here (powers, inversion, plans, coset LDE) is torch code over those
entry points.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, List

import numpy as np
import torch

from ..math.fields import F64, GOLDILOCKS_P, Field
from . import field_kernels, rescue

P = GOLDILOCKS_P
I64 = torch.int64


def _s64(v: int) -> int:
    """u64 python int -> the int64 with the same bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


_P_S = _s64(P)          # p as an int64 pattern
_MASK32 = 0xFFFFFFFF
_EPS = 0xFFFFFFFF       # 2^64 mod p
_SIGN = -(1 << 63)
_P_FLIP = _s64(P) ^ _SIGN  # p with the sign bit flipped, for unsigned compares

# The hot ops below call torch's functions with 0-dim CPU tensor constants
# (which every device takes as scalars) rather than Python operators with
# int constants: the same kernels, at about half the host time per call,
# which is what a small tensor costs.
_T_MASK32 = torch.tensor(_MASK32)
_T_EPS = torch.tensor(_EPS)
_T_SIGN = torch.tensor(_SIGN)
_T_P_FLIP = torch.tensor(_P_FLIP)
_T_P_S = torch.tensor(_P_S)
_T_32 = torch.tensor(32)
_and, _or, _xor = torch.bitwise_and, torch.bitwise_or, torch.bitwise_xor
_shr, _shl = torch.bitwise_right_shift, torch.bitwise_left_shift
_add, _sub, _mul, _where = torch.add, torch.sub, torch.mul, torch.where


def _flip(x):
    """x with its sign bit flipped (tensor or Python int)."""
    return x ^ _SIGN if isinstance(x, int) else _xor(x, _T_SIGN)


def _ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return torch.lt(_flip(a), _flip(b))


def _hi32(a):
    """Logical a >> 32."""
    return _and(_shr(a, _T_32), _T_MASK32)


def _canon(s):
    """s mod p for any u64 pattern s (one conditional subtract)."""
    return _where(torch.ge(_flip(s), _T_P_FLIP), _sub(s, _T_P_S), s)


_dev_cache: Dict[tuple, torch.Tensor] = {}


def _cached(key, build):
    """Per-device tables (twiddles, power series) built once per process."""
    t = _dev_cache.get(key)
    if t is None:
        t = _dev_cache[key] = build()
    return t


# ================================================================================
# Base field ops
# ================================================================================


def gl_add(a, b):
    """(a + b) mod p: on u64 overflow add 2^32 − 1, then canonicalize (B0,
    or its plain version on the CPU)."""
    return field_kernels.op("gl_add", a, b)


def gl_sub(a, b):
    """a − b: on a borrow subtract 2^32 − 1 (B0, or its plain version)."""
    return field_kernels.op("gl_sub", a, b)


def gl_neg(a):
    """−a as 0 − a: one subtract, equal to the reference's gl_neg
    (0 if a = 0, else p − a) for every u64 pattern."""
    zero = _cached(("zero", str(a.device)),
                   lambda: torch.zeros((), dtype=I64, device=a.device))
    return gl_sub(zero, a)


def _mul_128(a, b):
    """Full 128-bit product of u64 patterns (tensors) as (hi, lo) u64
    patterns."""
    a_lo, a_hi = _and(a, _T_MASK32), _hi32(a)
    b_lo, b_hi = _and(b, _T_MASK32), _hi32(b)
    t0 = _mul(a_lo, b_lo)
    t1 = _mul(a_lo, b_hi)
    t2 = _mul(a_hi, b_lo)
    t3 = _mul(a_hi, b_hi)
    mid = _add(_add(_hi32(t0), _and(t1, _T_MASK32)), _and(t2, _T_MASK32))
    lo = _or(_and(t0, _T_MASK32), _shl(mid, _T_32))
    hi = _add(_add(_add(t3, _hi32(t1)), _hi32(t2)), _hi32(mid))
    return hi, lo


def _sqr_128(a):
    """Full 128-bit square of u64 patterns as (hi, lo): _mul_128(a, a) with
    the equal cross products computed once."""
    a_lo, a_hi = _and(a, _T_MASK32), _hi32(a)
    t0 = _mul(a_lo, a_lo)
    t1 = _mul(a_lo, a_hi)
    t3 = _mul(a_hi, a_hi)
    mid = _add(_hi32(t0), _shl(_and(t1, _T_MASK32), 1))
    lo = _or(_and(t0, _T_MASK32), _shl(mid, _T_32))
    hi = _add(_add(t3, _shl(_hi32(t1), 1)), _hi32(mid))
    return hi, lo


def _reduce_128_lazy(hi, lo):
    """hi·2^64 + lo mod p via 2^64 ≡ 2^32 − 1, 2^96 ≡ −1, as a u64 pattern
    that may still be >= p (a valid input to the next multiply)."""
    hi_hi = _hi32(hi)
    t0 = _sub(lo, hi_hi)
    t0 = _where(_ult(lo, hi_hi), _sub(t0, _T_EPS), t0)
    t1 = _mul(_and(hi, _T_MASK32), _T_EPS)
    t2 = _add(t0, t1)
    return _where(_ult(t2, t0), _add(t2, _T_EPS), t2)


def _reduce_128(hi, lo):
    """hi·2^64 + lo mod p, canonical."""
    return _canon(_reduce_128_lazy(hi, lo))


def gl_mul(a, b):
    """a·b mod p (``b`` a tensor that broadcasts against ``a``, or a Python
    int). The layout is checked on every device; then a CUDA tensor goes to
    the K3 kernel and a CPU tensor to its plain version."""
    return field_kernels.op("gl_mul", a, b)


def gl_mul_small(a, c):
    """a · c mod p where every element of ``c`` is < 2^32 (reference
    mul_small, f64/mod.rs:106): half the partial products of gl_mul."""
    t0 = (a & _MASK32) * c
    t2 = _hi32(a) * c
    mid = _hi32(t0) + (t2 & _MASK32)
    lo = (t0 & _MASK32) | (mid << 32)
    hi = _hi32(t2) + _hi32(mid)
    return _reduce_128(hi, lo)


def gl_pow_const(a, e: int):
    """a ** e for a python-int exponent (square and multiply)."""
    if e == 0:
        return torch.ones_like(a)
    result = a
    for bit in bin(e)[3:]:
        result = gl_mul(result, result)
        if bit == "1":
            result = gl_mul(result, a)
    return result


def gl_inv(a):
    """a^(p−2) (Fermat); inv(0) = 0."""
    return gl_pow_const(a, P - 2)


def const(v: int) -> int:
    """The field element v as an int64 pattern. The ops above take such a
    python int in place of either tensor operand but the first, so constants
    never become host-to-device copies."""
    return _s64(v % P)


# ================================================================================
# Extension field ops: trailing axis d in {1, 2, 3}
# (reduction polys: quad x² = x − 2, cubic x³ = x + 1 — f64/mod.rs:398-499)
# ================================================================================


def ext_add(a, b):
    return gl_add(a, b)


def ext_sub(a, b):
    return gl_sub(a, b)


def ext_mul(a, b):
    """a·b of (..., d) extension elements: K3 for d = 1, B0x (or its plain
    version on the CPU) for the quadratic and cubic extensions."""
    if a.shape[-1] == 1:
        return gl_mul(a, b)
    return field_kernels.ext_mul(a, b)


def ext_mul_base(a, s):
    """Extension array × base scalars (broadcast over the trailing axis)."""
    return gl_mul(a, s[..., None] if s.ndim == a.ndim - 1 else s)


@lru_cache(maxsize=None)
def _frobenius_consts(d: int) -> np.ndarray:
    """Matrix F with frob(a)_j = Σ_i a_i · F[i, j] (images of basis powers)."""
    images = Field(F64, d)._frobenius_images()
    return np.array([[_s64(images[i][j]) for j in range(d)] for i in range(d)],
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
        term = gl_mul(a[..., i : i + 1], fr[i])
        acc = term if acc is None else gl_add(acc, term)
    return acc


def _conj_norm(a):
    """(c, norm) with a·c = norm in the base field."""
    d = a.shape[-1]
    if d == 2:
        a0, a1 = a[..., 0], a[..., 1]
        c = torch.stack([gl_add(a0, a1), gl_neg(a1)], dim=-1)
    else:
        conj1 = ext_frobenius(a)
        c = ext_mul(conj1, ext_frobenius(conj1))
    return c, ext_mul(a, c)[..., 0]


def ext_inv(a):
    """Inverse of extension elements (..., d) via the norm."""
    if a.shape[-1] == 1:
        return gl_inv(a)
    c, norm = _conj_norm(a)
    return ext_mul_base(c, gl_inv(norm))


def pow_table_from_jumps(jumps, n: int):
    """(n, d) table of z^k from the jumps z^(2^j) ((log n, d)), by
    log-doubling (winterfell_tpu/prover/device.py _pow_table_from_jumps):
    the z and z·g tables of the OOD step when z lives on the device. The
    table starts from one, made on the device (no host copy)."""
    d, dev = jumps.shape[1], jumps.device
    cur = torch.cat([torch.ones((1, 1), dtype=I64, device=dev),
                     torch.zeros((1, d - 1), dtype=I64, device=dev)], dim=1)
    j = 0
    while cur.shape[0] < n:
        cur = torch.cat([cur, ext_mul(cur, jumps[j].expand(cur.shape[0], d))])
        j += 1
    return cur[:n]


def ext_power_table(e, n: int):
    """(n, d) powers e^k, k < n, of a (d,) device element; the jumps
    e^(2^j) are squarings on the device."""
    jumps = [e]
    for _ in range(max((n - 1).bit_length(), 1) - 1):
        jumps.append(ext_mul(jumps[-1], jumps[-1]))
    return pow_table_from_jumps(torch.stack(jumps), n)


_BATCH_INV_G = 128  # scan-block width


def _scan_mul(x):
    """Inclusive prefix products along the last axis (Hillis–Steele)."""
    step = 1
    while step < x.shape[-1]:
        y = x.clone()
        y[..., step:] = gl_mul(x[..., step:], x[..., :-step])
        x = y
        step *= 2
    return x


def gl_batch_inv(a):
    """Montgomery batch inversion: prefix/suffix products over blocks of 128
    and one Fermat chain on the block totals. Value-identical to gl_inv for
    every input, zeros included (masked to 1 for the scans, restored after)."""
    shape = a.shape
    flat = a.reshape(-1)
    n = flat.shape[0]
    if n < 2 * _BATCH_INV_G:
        return gl_inv(a)
    pad = (-n) % _BATCH_INV_G
    if pad:
        flat = torch.cat([flat, torch.ones(pad, dtype=I64, device=a.device)])
    is_zero = flat == 0
    az = torch.where(is_zero, torch.ones_like(flat), flat).reshape(
        -1, _BATCH_INV_G)
    pref = _scan_mul(az)
    suff = _scan_mul(az.flip(-1)).flip(-1)
    tinv = gl_batch_inv(pref[:, -1])
    ones_col = torch.ones((az.shape[0], 1), dtype=I64, device=a.device)
    pprev = torch.cat([ones_col, pref[:, :-1]], dim=1)
    snext = torch.cat([suff[:, 1:], ones_col], dim=1)
    inv = gl_mul(gl_mul(pprev, snext), tinv[:, None]).reshape(-1)
    inv = torch.where(is_zero, torch.zeros_like(inv), inv)
    return inv[:n].reshape(shape)


def ext_batch_inv(a):
    """ext_inv with the norm inverted by gl_batch_inv (domain-sized arrays)."""
    if a.shape[-1] == 1:
        return gl_batch_inv(a)
    c, norm = _conj_norm(a)
    return ext_mul_base(c, gl_batch_inv(norm))


# ================================================================================
# Power series and NTT (radix-2 DIT over the leading axis, natural order)
# ================================================================================


def power_series(s: int, n: int, device, scale: int = 1):
    """[scale · s^k for k < n], built on ``device`` by log-doubling from
    host-computed jumps s^(2^j): O(log n) tensor ops, no host loop."""
    out = torch.full((1,), const(scale), dtype=I64, device=device)
    jump = s % P
    while out.shape[0] < n:
        out = torch.cat([out, gl_mul(out, const(jump))])
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
    r = F64.get_root_of_unity(n.bit_length() - 1)
    return pow(r, P - 2, P) if inverse else r


def bitrev_perm(n: int, device) -> torch.Tensor:
    """The bit-reversal permutation of n rows on ``device`` (a host copy,
    built once per process; the plain path's gather)."""
    return _cached(("bitrev", n, str(device)),
                   lambda: torch.from_numpy(_bitrev_perm(n)).to(device))


def ntt_plan(n: int, inverse: bool, device):
    """(bit-reversal permutation, n/2 powers of the n-th root) of a size-n
    transform on ``device``, built once per process. Building a plan copies
    the permutation from the host, so the resident prove builds every plan it
    needs before its device run."""
    tw_all = _cached(("tw", n, inverse, str(device)),
                     lambda: power_series(_root(n, inverse), n // 2, device))
    return bitrev_perm(n, device), tw_all


def ntt_stage_plain(x, tw_all, half: int):
    """One radix-2 stage of ``ntt_stage`` in plain PyTorch (a new tensor)."""
    n, cols = x.shape
    mm = 2 * half
    tw = tw_all[:: n // mm].reshape(1, half, 1)
    blk = x.reshape(n // mm, 2, half, cols)
    u = blk[:, 0]
    v = field_kernels.gl_mul_plain(blk[:, 1], tw)
    return torch.cat([field_kernels.gl_add_plain(u, v),
                      field_kernels.gl_sub_plain(u, v)], dim=1).reshape(
                          n, cols)


def _check_stage(x, tw_all, half: int) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != I64 or x.dim() != 2:
        raise ValueError("ntt_stage: expected an (n, cols) int64 tensor, got "
                         f"{getattr(x, 'dtype', type(x).__name__)} "
                         f"{tuple(getattr(x, 'shape', ()))}")
    n, cols = x.shape
    if n < 2 or n & (n - 1) or half < 1 or half & (half - 1) or 2 * half > n:
        raise ValueError(f"ntt_stage: bad stage {half} of a size-{n} NTT")
    if tuple(tw_all.shape) != (n // 2,) or not tw_all.is_contiguous() or \
            tw_all.device != x.device or tw_all.dtype != I64:
        raise ValueError("ntt_stage: expected a contiguous (n/2,) twiddle "
                         "table on the tensor's device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ntt_stage runs on cpu or cuda, not {x.device}")
    if n // 2 * cols > field_kernels.INDEX_LIMIT:
        raise ValueError("ntt_stage: more than 2^31 − 1 butterflies")


def ntt_stage_kernel(x, tw_all, half: int, src=None):
    """B4 on CUDA tensors: the stage of ``half`` over the contiguous x in
    place, or with ``src`` (x's shape) the first stage (half 1) from src's
    rows in bit-reversed order into x. Returns x."""
    _check_stage(x, tw_all, half)
    field_kernels.require_cuda(x, "gl_ntt_stage")
    if not x.is_contiguous():
        raise ValueError("ntt_stage: the kernel works in place on a "
                         "contiguous matrix")
    if src is not None:
        if half != 1 or src.shape != x.shape or src.dtype != I64 or \
                src.device != x.device:
            raise ValueError("ntt_stage: a bit-reversed source is read by "
                             "the first stage, in the shape of its output")
        src = src.contiguous()
    n, cols = x.shape
    lib = field_kernels.kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_gl_ntt_stage(x.data_ptr(),
                                  None if src is None else src.data_ptr(),
                                  tw_all.data_ptr(), n, cols,
                                  half.bit_length() - 1, n // (2 * half),
                                  stream)
    field_kernels.raise_on(err, "gl_ntt_stage")
    field_kernels.LAUNCHES["gl_ntt_stage"] += 1
    return x


def ntt_stage(x, tw_all, half: int):
    """B4: the stage of butterflies of ``half`` over x (n, cols), a
    contiguous matrix of rows in bit-reversed order, with the twiddles
    tw_all[j · n/(2·half)] ((n/2,) powers of the n-th root). In place for a
    CUDA tensor (returns x); a new tensor from the plain version on the
    CPU."""
    if x.device.type == "cpu":
        _check_stage(x, tw_all, half)
        return ntt_stage_plain(x, tw_all, half)
    return ntt_stage_kernel(x, tw_all, half)


def ntt_bitrev_stage(x, tw_all):
    """B4's first stage (half 1) over the rows of x (n, cols) in natural
    order, read in bit-reversed order: a new contiguous (n, cols) tensor,
    the input of the later stages. On the CPU the bit-reversal gather, then
    the plain stage."""
    if x.device.type == "cpu":
        _check_stage(x, tw_all, 1)
        return ntt_stage_plain(x.index_select(0, bitrev_perm(x.shape[0],
                                                             x.device)),
                               tw_all, 1)
    out = torch.empty(x.shape, dtype=I64, device=x.device)
    return ntt_stage_kernel(out, tw_all, 1, src=x)


def _ntt_core(x, n: int, inverse: bool):
    """x: (n, ...) → NTT/iNTT without the 1/n scale, natural order in and
    out: the first stage reading x bit-reversed, then log2 n − 1 stages in
    place (B4 on the card). Stage m uses the m-th roots w_n^(j·n/m): strided
    reads of one table of n/2 powers of w_n."""
    if n == 1 or x.numel() == 0:
        return x
    _, tw_all = ntt_plan(n, inverse, x.device)
    y = ntt_bitrev_stage(x.reshape(n, -1), tw_all)
    half = 2
    while half < n:
        y = ntt_stage(y, tw_all, half)
        half *= 2
    return y.reshape(x.shape)


def ntt_plain(x, n: int, inverse: bool):
    """``_ntt_core`` in plain PyTorch on any device: the bit-reversal
    gather, then the plain stages."""
    if n == 1:
        return x
    perm, tw_all = ntt_plan(n, inverse, x.device)
    y = x.index_select(0, perm).reshape(n, -1)
    half = 1
    while half < n:
        y = ntt_stage_plain(y, tw_all, half)
        half *= 2
    return y.reshape(x.shape)


def _col(v, ndim: int):
    """(n,) → (n, 1, ...) to broadcast over ndim−1 trailing axes."""
    return v.reshape((v.shape[0],) + (1,) * (ndim - 1))


def ntt_evaluate(coeffs, n: int):
    return _ntt_core(coeffs, n, inverse=False)


def ntt_interpolate(evals, n: int):
    coeffs = _ntt_core(evals, n, inverse=True)
    return gl_mul(coeffs, const(pow(n, P - 2, P)))


def lde_offset_powers(n: int, offset: int, device):
    """offset^i for i < n, the coefficient scale of the coset LDE."""
    return _cached(("pows", offset % P, n, 1, str(device)),
                   lambda: power_series(offset, n, device))


def ntt_evaluate_with_offset(coeffs, n: int, offset: int, blowup: int):
    """Coset LDE, natural order over the n·blowup domain offset·h^m (matches
    math.ntt.evaluate_poly_with_offset value for value)."""
    dev = coeffs.device
    off_pows = lde_offset_powers(n, offset, dev)
    scaled = gl_mul(coeffs, _col(off_pows, coeffs.ndim))
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
    return gl_mul(coeffs, _col(interp_offset_powers(n, offset, evals.device),
                               coeffs.ndim))


# ================================================================================
# FRI folding (fri/src/folding/mod.rs apply_drp, tensor version)
# ================================================================================


def fri_inv_offset_powers(n: int, n_fold: int, domain_offset: int, device):
    """(N, rows) matrix of ((offset·g^i)^-1)^k (folding/mod.rs:103-110)."""
    def build():
        rows = n // n_fold
        g = F64.get_root_of_unity(n.bit_length() - 1)
        inv_offsets = power_series(pow(g, P - 2, P), rows, device,
                                   pow(domain_offset % P, P - 2, P))
        out = [torch.ones_like(inv_offsets)]
        for _ in range(1, n_fold):
            out.append(gl_mul(out[-1], inv_offsets))
        return torch.stack(out)

    return _cached(("fri", n, n_fold, domain_offset % P, str(device)), build)


def fri_fold_plain(evaluations, n_fold: int, domain_offset: int, alpha):
    """``fri_fold`` in plain PyTorch on any device: per row an N-point iNTT
    over the row's coset, the 1/N and inverse-offset scaling, Horner at α
    (the JAX fri_fold_body)."""
    fk = field_kernels
    n, d = evaluations.shape
    rows = n // n_fold
    inv_pows = fri_inv_offset_powers(n, n_fold, domain_offset,
                                     evaluations.device)
    coeffs = ntt_plain(evaluations.reshape(n_fold, rows, d), n_fold,
                       inverse=True)
    coeffs = fk.gl_mul_plain(coeffs, const(pow(n_fold, P - 2, P)))
    result = torch.zeros((rows, d), dtype=I64, device=evaluations.device)
    alpha_b = alpha.reshape(1, d).expand(rows, d)
    ext = fk.gl_mul_plain if d == 1 else fk.ext_mul_plain
    for k in range(n_fold - 1, -1, -1):
        result = fk.gl_add_plain(ext(result, alpha_b),
                                 fk.gl_mul_plain(coeffs[k],
                                                 inv_pows[k][:, None]))
    return result


@lru_cache(maxsize=None)
def _fold_twiddles(n_fold: int):
    """The n_fold/2 powers of the inverse n_fold-th root, and 1/n_fold."""
    r = _root(n_fold, True)
    return [pow(r, k, P) for k in range(n_fold // 2)], pow(n_fold, P - 2, P)


def _check_fold(evaluations, n_fold: int, alpha) -> None:
    if not isinstance(evaluations, torch.Tensor) or \
            evaluations.dtype != I64 or evaluations.dim() != 2:
        raise ValueError("fri_fold: expected (n, d) int64 evaluations")
    n, d = evaluations.shape
    if n_fold not in (2, 4, 8, 16) or d not in (1, 2, 3) or n % n_fold or \
            n == 0:
        raise ValueError(f"fri_fold: a fold by {n_fold} of {n} rows of "
                         f"degree {d}")
    if not isinstance(alpha, torch.Tensor) or alpha.dtype != I64 or \
            alpha.numel() != d or alpha.device != evaluations.device:
        raise ValueError("fri_fold: α must be a (d,) int64 tensor on the "
                         "evaluations' device")
    if evaluations.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fri_fold runs on cpu or cuda, not "
                         f"{evaluations.device}")
    if n // n_fold > field_kernels.INDEX_LIMIT:
        raise ValueError("fri_fold: more than 2^31 − 1 folded rows")


def fri_fold_kernel(evaluations, n_fold: int, domain_offset: int, alpha):
    """B5 on CUDA tensors: the folded (n/N, d) layer, one thread per row; α
    is read from device memory (no host copy)."""
    _check_fold(evaluations, n_fold, alpha)
    field_kernels.require_cuda(evaluations, "gl_fri_fold")
    n, d = evaluations.shape
    rows = n // n_fold
    inv_pows = fri_inv_offset_powers(n, n_fold, domain_offset,
                                     evaluations.device)
    ev, al = evaluations.contiguous(), alpha.contiguous()
    out = torch.empty((rows, d), dtype=I64, device=ev.device)
    tw, inv_n = _fold_twiddles(n_fold)
    lib = field_kernels.kernels()
    with torch.cuda.device(ev.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_gl_fri_fold(ev.data_ptr(), inv_pows.data_ptr(),
                                 al.data_ptr(), out.data_ptr(), rows, n_fold,
                                 d, (ctypes.c_uint64 * len(tw))(*tw), inv_n,
                                 stream)
    field_kernels.raise_on(err, "gl_fri_fold")
    field_kernels.LAUNCHES["gl_fri_fold"] += 1
    return out


def fri_fold(evaluations, n_fold: int, domain_offset: int, alpha):
    """evaluations (n, d), alpha (d,) → folded (n/N, d): B5 for a CUDA
    tensor, the plain version for a CPU tensor."""
    if evaluations.device.type == "cpu":
        _check_fold(evaluations, n_fold, alpha)
        return fri_fold_plain(evaluations, n_fold, domain_offset, alpha)
    return fri_fold_kernel(evaluations, n_fold, domain_offset, alpha)


# ================================================================================
# Rp64_256 row hashing and Merkle levels (kernels in ops/rescue.py)
# ================================================================================


def rp64_hash_rows(rows):
    """hash_elements of each row: rows (m, k) → digests (m, 4)."""
    return rescue.rp64_hash_rows(rows.contiguous())


def merkle_levels_rp64(leaves) -> List[torch.Tensor]:
    """Internal Merkle levels from leaf digests (m, 4), largest first: level
    of size s holds heap nodes [s, 2s), the root alone in the last (the
    reference layout, crypto/src/merkle/mod.rs:344-368). On the card a few
    launches of the tree kernel build them all."""
    return rescue.rp64_merkle_levels(leaves.contiguous())


# ================================================================================
# Host <-> tensor conversion
# ================================================================================


def to_device(arr_obj: np.ndarray, device) -> torch.Tensor:
    """numpy object (or uint64) array of canonical ints → int64 tensor."""
    u = np.ascontiguousarray(arr_obj.astype(np.uint64))
    return torch.from_numpy(u.view(np.int64)).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor → numpy uint64 array (same bits)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


# ================================================================================
# The engine interface of the tensor provers (prover/device.py); ops/f62.py
# and ops/f128.py give the same names
# ================================================================================

NAME = "f64"
ELEM = ()  # the trailing axes of one element
add, sub, mul, neg = gl_add, gl_sub, gl_mul, gl_neg
pow_const, batch_inv = gl_pow_const, gl_batch_inv


def sum0(arr):
    """Modular sum along axis 0 (power-of-two length), as a tree."""
    while arr.shape[0] > 1:
        half = arr.shape[0] // 2
        arr = gl_add(arr[:half], arr[half : 2 * half])
    return arr[0]


def elements(a: np.ndarray):
    """A uint64 array as Python ints, nested tuples over its axes."""
    if a.ndim == 0:
        return int(a)
    return tuple(elements(x) for x in a)
