"""Port field core (winterfell_tpu_torch.ops.goldilocks) against the JAX
engine (winterfell_tpu.ops.goldilocks) on the CPU: base and extension ops,
inversion and batch inversion, and the plain versions of the B0 and B0x
kernels (ops/field_kernels.py) on every pair of a u64 corner set, values
>= p included, and on the operand layouts the prover passes. Exact
equality: this is integer arithmetic."""

import jax
import numpy as np
import pytest
import torch

from winterfell_tpu.math.fields import F64
from winterfell_tpu.ops import goldilocks as jgl
from winterfell_tpu_torch.ops import field_kernels as fk
from winterfell_tpu_torch.ops import goldilocks as tgl

jax.config.update("jax_platforms", "cpu")

P = F64.p
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
         0xFFFFFFFF00000000, 0xFFFFFFFEFFFFFFFF, 0xFFFFFFFE00000001,
         1 << 63, (1 << 63) - 1]
# u64 patterns >= p: the kernels and their plain versions compute the JAX
# formulas for these too (a wrapped sum, a borrow past p)
ABOVE_P = [P, P + 1, (1 << 64) - (1 << 32), (1 << 64) - 2, (1 << 64) - 1]


def _operands(seed: int, shape_tail=()):
    """(a, b) uint64 arrays: every pair of edge values plus random values."""
    rng = np.random.default_rng(seed)
    e = np.array(EDGES, dtype=np.uint64)
    a = np.concatenate([np.repeat(e, len(e)),
                        rng.integers(0, P, size=256, dtype=np.uint64)])
    b = np.concatenate([np.tile(e, len(e)),
                        rng.integers(0, P, size=256, dtype=np.uint64)])
    if shape_tail:
        d = shape_tail[0]
        a = np.stack([np.roll(a, 7 * i) for i in range(d)], axis=-1)
        b = np.stack([np.roll(b, 5 * i + 3) for i in range(d)], axis=-1)
    return a, b


def _all_pairs(vals, d=0):
    """(a, b) uint64 arrays holding every ordered pair of ``vals`` (with a
    trailing axis of d components, rolled apart, for d > 0)."""
    v = np.array(vals, dtype=np.uint64)
    a, b = np.repeat(v, len(v)), np.tile(v, len(v))
    if d:
        a = np.stack([np.roll(a, 3 * i) for i in range(d)], axis=-1)
        b = np.stack([np.roll(b, 7 * i + 1) for i in range(d)], axis=-1)
    return a, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _j(a):
    return jgl.jnp.asarray(a)


def _same(port_out, jax_out):
    got = port_out.numpy().view(np.uint64)
    assert np.array_equal(got, np.asarray(jax_out))


BASE_BINARY = ["gl_add", "gl_sub", "gl_mul"]


@pytest.mark.parametrize("op", BASE_BINARY)
def test_base_binary_op(op):
    a, b = _operands(1)
    _same(getattr(tgl, op)(_t(a), _t(b)), getattr(jgl, op)(_j(a), _j(b)))
    # the kernels' plain versions (B0, K3) on every pair of the corner set
    # with the patterns >= p, and on broadcast and strided operands
    plain = getattr(fk, f"{op}_plain")
    a, b = _all_pairs(EDGES + ABOVE_P)
    _same(plain(_t(a), _t(b)), getattr(jgl, op)(_j(a), _j(b)))
    _same(getattr(tgl, op)(_t(a), _t(b)), getattr(jgl, op)(_j(a), _j(b)))
    m = _t(a.reshape(18, 18))
    jm = _j(a.reshape(18, 18))
    for x, y, jx, jy in ((m[:, 1:], m[:, :-1], jm[:, 1:], jm[:, :-1]),
                         (m, m[:1], jm, jm[:1]),
                         (m[::2], m[1::2, 3:4], jm[::2], jm[1::2, 3:4])):
        _same(plain(x, y), getattr(jgl, op)(jx, jy))
    for c in (0, 1, P - 1, P, (1 << 64) - 1):
        _same(plain(_t(a), tgl.const(c) if c < P else c),
              getattr(jgl, op)(_j(a), jgl.jnp.uint64(c % (1 << 64)
                                                     if c >= P else c)))


def test_base_neg():
    a, _ = _operands(2)
    _same(tgl.gl_neg(_t(a)), jgl.gl_neg(_j(a)))
    a, _ = _all_pairs(EDGES + ABOVE_P)
    _same(tgl.gl_neg(_t(a)), jgl.gl_neg(_j(a)))  # one B0 subtract 0 − a


def test_base_mul_small():
    a, _ = _operands(3)
    c = np.random.default_rng(4).integers(0, 1 << 32, size=a.shape,
                                          dtype=np.uint64)
    c[:4] = [0, 1, 26, (1 << 32) - 1]
    _same(tgl.gl_mul_small(_t(a), _t(c)), jgl.gl_mul_small(_j(a), _j(c)))


@pytest.mark.parametrize("e", [0, 1, 2, 7, 1 << 18, P - 2, 10540996611094048183])
def test_base_pow_const(e):
    a, _ = _operands(5)
    _same(tgl.gl_pow_const(_t(a), e), jgl.gl_pow_const(_j(a), e))


def test_python_int_constant_operand():
    a, _ = _operands(6)
    for v in (0, 1, P - 1, 123456789123456789):
        _same(tgl.gl_mul(_t(a), tgl.const(v)),
              jgl.gl_mul(_j(a), jgl.jnp.uint64(v)))
        _same(tgl.gl_sub(_t(a), tgl.const(v)),
              jgl.gl_sub(_j(a), jgl.jnp.uint64(v)))


def test_base_inv_and_batch_inv_with_zeros():
    a, _ = _operands(7)
    a = np.concatenate([a, a[::-1]])  # 2·425 elements: the scan path
    a[::9] = 0
    expected = jgl.gl_inv(_j(a))
    _same(tgl.gl_inv(_t(a)), expected)
    _same(tgl.gl_batch_inv(_t(a)), expected)
    _same(tgl.gl_batch_inv(_t(a[:100])), jgl.gl_inv(_j(a[:100])))


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("op", ["ext_add", "ext_sub", "ext_mul"])
def test_ext_binary_op(op, d):
    a, b = _operands(10 + d, (d,))
    _same(getattr(tgl, op)(_t(a), _t(b)), getattr(jgl, op)(_j(a), _j(b)))
    if op == "ext_mul" and d > 1:
        # B0x's plain version on corner pairs with patterns >= p, and on the
        # prover's operand layouts: an expanded α (the FRI fold), pows2
        # expanded over the columns (_eval_cols_pair), z expanded over the
        # domain (_deep_combine), a strided column of a wider matrix
        jmul = jgl.ext_mul
        a, b = _all_pairs(EDGES + ABOVE_P, d)
        _same(fk.ext_mul_plain(_t(a), _t(b)), jmul(_j(a), _j(b)))
        _same(tgl.ext_mul(_t(a), _t(b)), jmul(_j(a), _j(b)))
        ta, tb = _t(a), _t(b)
        polys = ta[:96].reshape(16, 6, d)
        pows2 = tb[:32].reshape(16, 2, d)
        wide = _t(np.concatenate([a, b], axis=-1))
        cases = [
            (ta, tb[5].expand_as(ta)),
            (polys[:, :, None], pows2[:, None].expand((16, 6, 2, d))),
            (ta[:40], tb[7][None].expand(40, d)),
            (wide[:, :d], wide[:, d:]),
            (ta[::3], tb[1::3][: ta[::3].shape[0]]),
        ]
        for x, y in cases:
            want = jmul(_j(x.contiguous().numpy().view(np.uint64)),
                        _j(y.contiguous().numpy().view(np.uint64)))
            _same(fk.ext_mul_plain(x, y), want)
            _same(tgl.ext_mul(x, y), want)


@pytest.mark.parametrize("d", [2, 3])
def test_ext_mul_base_and_frobenius(d):
    a, b = _operands(20 + d, (d,))
    s = b[:, 0].copy()
    _same(tgl.ext_mul_base(_t(a), _t(s)), jgl.ext_mul_base(_j(a), _j(s)))
    _same(tgl.ext_frobenius(_t(a)), jgl.ext_frobenius(_j(a)))


@pytest.mark.parametrize("d", [2, 3])
def test_ext_inv_and_batch_inv_with_zeros(d):
    a, _ = _operands(30 + d, (d,))
    a = np.concatenate([a, a[::-1]])
    a[::11] = 0
    expected = jgl.ext_inv(_j(a))
    _same(tgl.ext_inv(_t(a)), expected)
    _same(tgl.ext_batch_inv(_t(a)), expected)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_torch_ops_match_jax_ops(d):
    from winterfell_tpu.math.fields import Field
    from winterfell_tpu.ops.jax_ops import JaxOps
    from winterfell_tpu_torch.math.fields import Field as TField
    from winterfell_tpu_torch.math.fields import F64 as TF64
    from winterfell_tpu_torch.ops.torch_ops import TorchOps

    a, b = _operands(40 + d, (d,))
    jo, to = JaxOps(Field(F64, d)), TorchOps(TField(TF64, d), "cpu")
    ja, jb, ta, tb = _j(a), _j(b), _t(a), _t(b)
    _same(to.add(ta, tb), jo.add(ja, jb))
    _same(to.sub(ta, tb), jo.sub(ja, jb))
    _same(to.mul(ta, tb), jo.mul(ja, jb))
    _same(to.neg(ta), jo.neg(ja))
    _same(to.exp(ta, 7), jo.exp(ja, 7))
    _same(to.mul_base(ta, 12345), jo.mul_base(ja, 12345))
    _same(to.mul_base(ta, _t(b[:, 0].copy())), jo.mul_base(ja, _j(b[:, 0])))
    e = tuple(int(v) for v in b[3])
    _same(to.mul(ta, to.lift(e)), jo.mul(ja, jo.lift(e)))
    _same(to.add(ta, to.constant(P - 1)), jo.add(ja, jo.constant(P - 1)))
    _same(to.zeros(5), jo.zeros(5))
