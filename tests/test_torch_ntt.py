"""Port NTT family and FRI fold (winterfell_tpu_torch.ops.goldilocks) against
the JAX package: its exact host NTT (winterfell_tpu.math.ntt) for every size
2 … 2^10, its device engine (winterfell_tpu.ops.goldilocks) at sizes on both
sides of its six-step split (_SMALL_NTT = 2^13), and its FRI folding
(device fri_fold and host apply_drp) for folding factors 2, 4, 8 and 16
and extension degrees 1, 2 and 3. The whole NTT of B4's stages (the first
reading its input bit-reversed; the plain stages on the CPU) and of the
plain path (gather, then stages) is held against the JAX engine's _ntt_core
at every size 2 … 2^10, and B5's plain version against its fri_fold."""

import jax
import numpy as np
import pytest
import torch

from winterfell_tpu.fri.folding import apply_drp, transpose_evaluations
from winterfell_tpu.math import ntt as host_ntt
from winterfell_tpu.math.fields import F64, Field
from winterfell_tpu.ops import goldilocks as jgl
from winterfell_tpu_torch.ops import goldilocks as tgl

jax.config.update("jax_platforms", "cpu")

P = F64.p
OFFSET = F64.generator


def _rand(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    a.flat[0], a.flat[-1] = P - 1, 0
    return a


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _u64(t):
    return t.numpy().view(np.uint64)


def _obj(a):
    return a.astype(object)


@pytest.mark.parametrize("logn", range(1, 11))
def test_ntt_family_matches_host_ntt(logn):
    n = 1 << logn
    a = _rand(logn, (n, 3))
    assert np.array_equal(_u64(tgl.ntt_evaluate(_t(a), n)).astype(object),
                          host_ntt.evaluate_poly(F64, _obj(a)))
    assert np.array_equal(_u64(tgl.ntt_interpolate(_t(a), n)).astype(object),
                          host_ntt.interpolate_poly(F64, _obj(a)))
    assert np.array_equal(
        _u64(tgl.ntt_evaluate_with_offset(_t(a), n, OFFSET, 4)).astype(object),
        host_ntt.evaluate_poly_with_offset(F64, _obj(a), OFFSET, 4))
    assert np.array_equal(
        _u64(tgl.ntt_interpolate_with_offset(_t(a), n, OFFSET)).astype(object),
        host_ntt.interpolate_poly_with_offset(F64, _obj(a), OFFSET))
    for inverse in (False, True):
        core = jax.jit(lambda x: jgl._ntt_core(x, n, inverse, plan=None))
        expected = np.asarray(core(jgl.jnp.asarray(a)))
        assert np.array_equal(_u64(tgl._ntt_core(_t(a), n, inverse)),
                              expected)
        assert np.array_equal(_u64(tgl.ntt_plain(_t(a), n, inverse)),
                              expected)
        # the stages one by one: the bit-reversed first, then in order
        _, tw = tgl.ntt_plan(n, inverse, "cpu")
        y = tgl.ntt_bitrev_stage(_t(a), tw)
        half = 2
        while half < n:
            y = tgl.ntt_stage(y, tw, half)
            half *= 2
        assert np.array_equal(_u64(y), expected)


@pytest.mark.parametrize("logn", [4, 14])
def test_ntt_family_matches_jax_engine(logn):
    """2^14 crosses the JAX engine's six-step split; the port is one radix-2
    path at every size."""
    n = 1 << logn
    a = _rand(100 + logn, (n, 2))
    j = jgl.jnp.asarray(a)
    pairs = [
        (tgl.ntt_evaluate(_t(a), n), jgl.ntt_evaluate(j, n)),
        (tgl.ntt_interpolate(_t(a), n), jgl.ntt_interpolate(j, n)),
        (tgl.ntt_evaluate_with_offset(_t(a), n, OFFSET, 2),
         jgl.ntt_evaluate_with_offset(j, n, OFFSET, 2)),
        (tgl.ntt_interpolate_with_offset(_t(a), n, OFFSET),
         jgl.ntt_interpolate_with_offset(j, n, OFFSET)),
    ]
    for got, expected in pairs:
        assert np.array_equal(_u64(got), np.asarray(expected))


@pytest.mark.parametrize("n_fold", [2, 4, 8])
def test_fri_fold_matches_jax(n_fold):
    """Each folding factor at degrees 1, 2 and 3; the case of 8 runs 16 too
    (the reference's four factors)."""
    for nf in (n_fold, 16) if n_fold == 8 else (n_fold,):
        for d in (1, 2, 3):
            n = 256
            ev = _rand(200 + nf + d, (n, d))
            alpha = _rand(300 + nf + d, (d,))
            expected = np.asarray(jgl.fri_fold(jgl.jnp.asarray(ev), nf,
                                               OFFSET,
                                               jgl.jnp.asarray(alpha)))
            got = _u64(tgl.fri_fold(_t(ev), nf, OFFSET, _t(alpha)))
            assert np.array_equal(got, expected), (nf, d)
            assert np.array_equal(
                _u64(tgl.fri_fold_plain(_t(ev), nf, OFFSET, _t(alpha))),
                expected), (nf, d)
            if d == 3:
                host = apply_drp(Field(F64, d),
                                 transpose_evaluations(_obj(ev), nf), OFFSET,
                                 tuple(int(x) for x in alpha))
                assert np.array_equal(got.astype(object), host)


def test_power_series():
    s, n, scale = 0x123456789ABCDEF, 37, 5
    expected = [scale * pow(s, k, P) % P for k in range(n)]
    got = _u64(tgl.power_series(s, n, "cpu", scale))
    assert [int(v) for v in got] == expected
