"""Host NTT (radix-2) over object arrays — the exact oracle for the device NTT.

API mirrors the reference fft module semantics (math/src/fft/mod.rs):

- ``evaluate_poly``: coefficients -> evaluations over the size-n multiplicative
  subgroup, natural order (evals[i] = p(g^i)).
- ``evaluate_poly_with_offset``: coset LDE — evals[m] = p(offset · h^m) over
  the size n·blowup domain with generator h (math/src/fft/serial.rs:29-56).
- ``interpolate_poly(_with_offset)``: the inverses (serial.rs:66-101).

All functions operate on the leading axis and broadcast over any trailing axes,
so one code path serves base-field matrices (n, width) and extension-field
vectors (n, degree): twiddles are base-field scalars either way, matching
``mul_base`` semantics.

These object-int transforms (f64 and f128) are the host side of the
verifier and the exact oracle of the tensor NTTs in ``ops/goldilocks.py``
and ``ops/f128.py``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .fields import BaseField


@lru_cache(maxsize=None)
def _bitrev_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    perm = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for i in range(logn):
        rev = (rev << 1) | ((perm >> i) & 1)
    return rev


@lru_cache(maxsize=None)
def _stage_twiddles(base_name: str, p: int, n: int, root: int):
    """Per-stage twiddle power series for an n-point DIT NTT."""
    stages = []
    m = 2
    while m <= n:
        w_m = pow(root, n // m, p)
        half = m // 2
        tw = np.empty(half, dtype=object)
        acc = 1
        for j in range(half):
            tw[j] = acc
            acc = acc * w_m % p
        stages.append(tw)
        m *= 2
    return stages


def _ntt_core(base: BaseField, a: np.ndarray, root: int) -> np.ndarray:
    """In-place-style radix-2 DIT, natural order in and out."""
    n = a.shape[0]
    assert n & (n - 1) == 0, "NTT size must be a power of two"
    if n == 1:
        return a.copy()
    p = base.p
    rest = a.shape[1:]
    a = a[_bitrev_perm(n)]
    for tw in _stage_twiddles(base.name, p, n, root):
        half = tw.shape[0]
        m = 2 * half
        twb = tw.reshape((1, half) + (1,) * len(rest))
        blk = a.reshape((n // m, 2, half) + rest)
        u = blk[:, 0]
        v = blk[:, 1] * twb % p
        a = np.concatenate([(u + v) % p, (u - v) % p], axis=1).reshape((n,) + rest)
    return a


def get_root(base: BaseField, n: int) -> int:
    return base.get_root_of_unity(n.bit_length() - 1)


def evaluate_poly(base: BaseField, coeffs: np.ndarray) -> np.ndarray:
    """NTT: coefficients -> evaluations at powers of the n-th root (natural)."""
    n = coeffs.shape[0]
    return _ntt_core(base, coeffs, get_root(base, n))


def interpolate_poly(base: BaseField, evals: np.ndarray) -> np.ndarray:
    """iNTT: evaluations -> coefficients."""
    n = evals.shape[0]
    inv_root = pow(get_root(base, n), base.p - 2, base.p)
    coeffs = _ntt_core(base, evals, inv_root)
    inv_n = pow(n, base.p - 2, base.p)
    return coeffs * inv_n % base.p


def _scale_by_powers(base: BaseField, coeffs: np.ndarray, s: int) -> np.ndarray:
    """coeff[k] *= s^k (broadcast over trailing axes)."""
    n = coeffs.shape[0]
    powers = np.empty(n, dtype=object)
    acc = 1
    for k in range(n):
        powers[k] = acc
        acc = acc * s % base.p
    return coeffs * powers.reshape((n,) + (1,) * (coeffs.ndim - 1)) % base.p


def evaluate_poly_with_offset(base: BaseField, coeffs: np.ndarray, offset: int,
                              blowup: int) -> np.ndarray:
    """Coset LDE: returns evals of size n·blowup in natural order over the
    domain offset·h^m (h = (n·blowup)-th root). Sub-coset j occupies indices
    j, j+blowup, ... since h^blowup = g."""
    n = coeffs.shape[0]
    domain_size = n * blowup
    h = get_root(base, domain_size)
    out = np.empty((domain_size,) + coeffs.shape[1:], dtype=object)
    root = get_root(base, n)
    for j in range(blowup):
        s = offset * pow(h, j, base.p) % base.p
        out[j::blowup] = _ntt_core(base, _scale_by_powers(base, coeffs, s), root)
    return out


def interpolate_poly_with_offset(base: BaseField, evals: np.ndarray,
                                 offset: int) -> np.ndarray:
    """Inverse of evaluate over the coset offset·g^i: iNTT then scale
    coeff[k] by offset^-k (serial.rs:84-101)."""
    n = evals.shape[0]
    inv_offset = pow(offset % base.p, base.p - 2, base.p)
    coeffs = interpolate_poly(base, evals)
    return _scale_by_powers(base, coeffs, inv_offset)


def infer_degree(base: BaseField, evals: np.ndarray, offset: int = 1) -> int:
    """Degree of the polynomial underlying evaluations over the (coset of
    the) size-n multiplicative subgroup (fft/mod.rs:543-562): interpolate,
    then index of the highest non-zero coefficient."""
    n = evals.shape[0]
    assert n & (n - 1) == 0, "number of evaluations must be a power of 2"
    assert n.bit_length() - 1 <= base.two_adicity, (
        f"multiplicative subgroup of size {n} does not exist in {base.name}")
    assert offset % base.p != 0, "domain offset cannot be zero"
    coeffs = (interpolate_poly(base, evals) if offset % base.p == 1
              else interpolate_poly_with_offset(base, evals, offset))
    for i in range(n - 1, -1, -1):
        if any(int(x) != 0 for x in np.atleast_1d(coeffs[i])):
            return i
    return 0
