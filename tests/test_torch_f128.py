"""The port's f128 engine (winterfell_tpu_torch/ops/f128.py, the plain versions
of its kernels B13 and B13n on CPU tensors) against the JAX engine
(winterfell_tpu/ops/f128.py) on the CPU, with the same inputs made from a
numpy seed and exact equality: field ops on canonical and non-canonical
values, the quadratic extension, NTT and iNTT, FRI folding. Other sizes
and the rest (powers, inversion, batch inversion through its block scan,
coset LDE, offset interpolation, folding by 4 and 8) against the exact host
oracle that tests/test_f128_jax.py holds the JAX engine to: XLA:CPU takes
5-30 s to compile each of the JAX engine's programs (its batch inversion
20 s). Then the f128 device coin against the
JAX host DefaultRandomCoin (draws, coefficient draws, a planted rejection),
the layout conversions of interop.py, and the native Rescue trace builder
against the Python one and the JAX package's trace."""

import jax
import numpy as np
import pytest
import torch

from winterfell_tpu.air.coefficients import _draw
from winterfell_tpu.air.options import BatchingMethod
from winterfell_tpu.crypto.hashers import HASHERS as JAX_HASHERS
from winterfell_tpu.crypto.random_coin import DefaultRandomCoin
from winterfell_tpu.examples.rescue import build_rescue_trace as jax_rescue
from winterfell_tpu.fri import folding as host_fold
from winterfell_tpu.math import ntt as host_ntt
from winterfell_tpu.math.fields import F128, Field
from winterfell_tpu.ops import f128 as jf
from winterfell_tpu_torch import interop
from winterfell_tpu_torch.examples import rescue as port_rescue
from winterfell_tpu_torch.ops import device_coin as dc
from winterfell_tpu_torch.ops import f128 as tf

jax.config.update("jax_platforms", "cpu")

P = F128.p
_CORNERS = [0, 1, 2, P - 1, P - 2, jf.PHI - 1, jf.PHI, 2**64 - 1, 2**64,
            2**127, (2**128 - 1) % P]
# non-canonical 128-bit patterns, where the engines must agree on every op
_WIDE = [P, P + 1, 2**128 - 1, 2**128 - 2]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, shape, bound=P):
    """Object array of ints below ``bound`` from the numpy generator."""
    n = int(np.prod(shape, dtype=np.int64))
    raw = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint64)
    vals = [int(r[0]) | int(r[1]) << 32 | int(r[2]) << 64 | int(r[3]) << 96
            for r in raw]
    return np.array([v % bound for v in vals], dtype=object).reshape(shape)


def _port(obj):
    return tf.to_device(obj, "cpu")


def _jax(obj):
    return jf.jnp.asarray(jf.to_limbs_np(np.asarray(obj, dtype=object)))


def _same(port_t, jax_a, what):
    got = tf.to_ints(port_t)
    want = jf.from_limbs_np(np.asarray(jax_a))
    assert got.shape == want.shape, what
    assert (got == want).all(), what


def test_f128_engine_equals_jax_engine():
    rng = np.random.default_rng(20261017)
    vals = _CORNERS + _WIDE
    pairs = [(x, y) for x in vals for y in vals]
    a = np.array([x for x, _ in pairs] + list(_rand(rng, (500,), 2**128)),
                 dtype=object)
    b = np.array([y for _, y in pairs] + list(_rand(rng, (500,), 2**128)),
                 dtype=object)
    # B13's plain versions on every 128-bit input; a Python-int operand
    for port_op, jax_op in ((tf.f128_add, jf.f128_add),
                            (tf.f128_sub, jf.f128_sub),
                            (tf.f128_mul, jf.f128_mul)):
        _same(port_op(_port(a), _port(b)), jax_op(_jax(a), _jax(b)),
              port_op.__name__)
        c = int(b[-1]) % P
        _same(port_op(_port(a), c),
              jax_op(_jax(a), jf.jnp.broadcast_to(jf.scalar(c), (a.size, 4))),
              (port_op.__name__, "int"))
    can = _rand(rng, (64, 3))
    can[0, 0] = 0
    _same(tf.f128_neg(_port(can)), jf.f128_neg(_jax(can)), "neg")
    col = _rand(rng, (64,))
    _same(tf.f128_mul(_port(can), _port(col)[:, None]),
          jf.f128_mul_base(_jax(can), _jax(col)), "broadcast column")
    # the quadratic extension (x^2 = x + 1)
    x, y = _rand(rng, (40, 2)), _rand(rng, (40, 2))
    x[0] = 0
    _same(tf.ext_mul(_port(x), _port(y)), jf.ext_mul(_jax(x), _jax(y)),
          "ext_mul")
    _same(tf.ext_mul_base(_port(x), _port(col[:40])),
          jf.ext_mul_base(_jax(x), _jax(col[:40])), "ext_mul_base")
    # NTT and iNTT (B13n's plain stages) over extension columns, FRI folding
    coeffs = _rand(rng, (8, 3, 2))
    _same(tf.ntt_evaluate(_port(coeffs), 8), jf.ntt_evaluate(_jax(coeffs), 8),
          "ntt")
    _same(tf.ntt_interpolate(_port(coeffs), 8),
          jf.ntt_interpolate(_jax(coeffs), 8), "intt")
    ev, alpha = _rand(rng, (64, 2)), _rand(rng, (2,))
    _same(tf.fri_fold(_port(ev), 2, 3, _port(alpha)),
          jf.fri_fold(_jax(ev), 2, 3, _jax(alpha)), "fri_fold")

    # against the exact host oracle (winterfell_tpu.math, which
    # tests/test_f128_jax.py holds the JAX engine to): powers, inversions,
    # power tables, NTTs of other sizes and shapes, coset LDE, interpolation
    # with offset, FRI folding by 4 and 8
    def ints(t):
        return tf.to_ints(t).tolist()

    _same_host = [
        (ints(tf.f128_pow_const(_port(can), 12345)),
         [[pow(int(v), 12345, P) for v in r] for r in can]),
        (ints(tf.f128_inv(_port(can))),
         [[F128.inv(int(v)) if v else 0 for v in r] for r in can])]
    for d in (1, 2):
        ext = Field(F128, d)
        wide = _rand(rng, (300, d))
        wide[5] = 0
        want = [list(ext.inv(tuple(int(v) for v in e))) for e in wide]
        _same_host.append((ints(tf.ext_batch_inv(_port(wide))), want))
        _same_host.append((ints(tf.ext_inv(_port(wide[:9]))), want[:9]))
        z = tuple(int(v) for v in _rand(rng, (d,)))
        want, acc = [], ext.one()
        for _ in range(37):
            want.append(list(acc))
            acc = ext.mul(acc, z)
        table = tf.ext_power_table(_port(np.array(z, dtype=object)), 37)
        _same_host.append((ints(table), want))
    for n, shape in ((2, (3,)), (256, (3,)), (1024, ())):
        coeffs = _rand(rng, (n,) + shape)
        _same_host.append((ints(tf.ntt_evaluate(_port(coeffs), n)),
                           host_ntt.evaluate_poly(F128, coeffs).tolist()))
        _same_host.append((ints(tf.ntt_interpolate(_port(coeffs), n)),
                           host_ntt.interpolate_poly(F128, coeffs).tolist()))
    coeffs = _rand(rng, (32, 3))
    _same_host.append((ints(tf.ntt_evaluate_with_offset(_port(coeffs), 32, 3,
                                                        8)),
                       host_ntt.evaluate_poly_with_offset(F128, coeffs, 3,
                                                          8).tolist()))
    evals = _rand(rng, (64, 2, 1))
    _same_host.append((ints(tf.ntt_interpolate_with_offset(_port(evals), 64,
                                                           3)),
                       host_ntt.interpolate_poly_with_offset(F128, evals,
                                                             3).tolist()))
    for n_fold, d in ((4, 2), (8, 1)):
        ev, alpha = _rand(rng, (64, d)), _rand(rng, (d,))
        want = host_fold.apply_drp(
            Field(F128, d), host_fold.transpose_evaluations(ev, n_fold), 3,
            tuple(int(v) for v in alpha))
        _same_host.append((ints(tf.fri_fold(_port(ev), n_fold, 3,
                                            _port(alpha))),
                           [list(e) for e in want]))
    for i, (got, want) in enumerate(_same_host):
        assert got == want, i

    # the stage wrapper refuses what the kernel cannot read
    x = _port(_rand(rng, (16, 2)))
    _, tw = tf.ntt_plan(16, False, "cpu")
    for bad in (x[:, :, None], x.transpose(0, 1)[:8], x[:12]):
        with pytest.raises(ValueError):
            tf.ntt_stage(bad.contiguous() if bad.dim() == 3 else bad, tw, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.op_kernel("mul", x, x)


def _words(t: torch.Tensor):
    return [tuple(int(v) for v in row) for row in tf.to_ints(t)]


def test_f128_coin_conversions_and_native_trace():
    # the f128 draws of each byte coin against the JAX host coin
    base = Field(F128, 1)
    for kind in ("blake3_256", "blake3_192", "sha3_256"):
        hasher = JAX_HASHERS[kind]
        for d in (1, 2):
            ext = Field(F128, d)
            coin = DefaultRandomCoin(hasher, [(d,), (7,)], base)
            merge, draw = dc.coin_bundle(kind, d, "f128")
            seed = dc.seed_tensor(coin.seed, "cpu", kind)
            root = hasher.hash(bytes([d, 9]))
            coin.reseed(root)
            seed = merge(seed, dc.seed_tensor(root, "cpu", kind))
            assert dc.words_to_seed(seed.numpy()) == coin.seed
            elems, counter = draw(seed, 3)
            assert _words(elems) == [coin.draw(ext) for _ in range(3)]
            assert counter.tolist() == [coin.counter]
            for method in ("linear", "algebraic", "horner"):
                host = DefaultRandomCoin(hasher, [(d,), (7,)], base)
                host.reseed(root)
                want = _draw(host, ext, 4, BatchingMethod[method.upper()])
                elems, counter = dc.make_draw_k(draw, tf)(seed, 4, method)
                assert _words(elems) == want, (kind, d, method)
                assert counter.tolist() == [host.counter]
        # a planted rejection: an element >= p in the second candidate
        _, next_candidates = dc.byte_coin_ops(kind)
        seed = dc.seed_tensor(hasher.hash(b"seed"), "cpu", kind)
        cands = next_candidates(seed, 0, 3).clone()
        cands[1, :4] = -1  # element 0 of the second candidate 2^128 - 1 >= p
        elems, counter = dc.draw_plain(cands, seed, 0, 3, 1, kind, "f128")
        fresh = next_candidates(seed, 3, 1)
        assert counter.tolist() == [4]
        assert torch.equal(elems[1], cands[2, :4].view(torch.int64).reshape(
            1, 2)) and torch.equal(elems[2], fresh[0, :4].view(
                torch.int64).reshape(1, 2))
    with pytest.raises(ValueError):
        dc.coin_bundle("rp64_256", 1, "f128")

    # interop: JAX digit arrays, Python ints and the port's tensors
    rng = np.random.default_rng(7)
    vals = _rand(rng, (5, 3))
    limbs = jf.to_limbs_np(vals)
    t = interop.tensor_from_limbs(limbs)
    assert t.shape == (5, 3, 2) and (interop.ints_from_tensor(t) == vals).all()
    assert np.array_equal(interop.limbs_from_tensor(t), limbs)
    assert torch.equal(interop.tensor_from_ints(vals), t)

    # the native Rescue chain, the Python chain and the JAX package's trace
    native = port_rescue.build_rescue_trace((3, 4), 4)
    assert native.native_rows() is not None
    py = port_rescue.build_rescue_trace_py((3, 4), 4)
    assert (native.main_segment() == py.main_segment()).all()
    assert (np.asarray(jax_rescue((3, 4), 4).main_segment())
            == native.main_segment()).all()
    assert native.get(0, 63) == port_rescue.compute_hash_chain((3, 4), 4)[0]


# the names the shared prover pipeline (prover/device.py DeviceProver) calls
# on its field's engine
_ENGINE_NAMES = (
    "NAME", "ELEM", "P", "add", "sub", "mul", "pow_const", "batch_inv",
    "const", "sum0", "elements", "to_device", "to_u64", "ext_add", "ext_sub",
    "ext_mul", "ext_mul_base", "ext_batch_inv", "ext_power_table",
    "power_series", "ntt_plan", "ntt_evaluate", "ntt_interpolate",
    "ntt_evaluate_with_offset", "ntt_interpolate_with_offset",
    "lde_offset_powers", "interp_offset_powers", "fri_inv_offset_powers",
    "fri_fold", "_cached")


@pytest.mark.parametrize("field", ["f64", "f128"])
def test_engine_interface(field):
    """Both engines give the pipeline's names; an element array crosses to
    the tensor layout and back (``to_device``, ``to_u64``, ``elements``)
    and ``sum0`` sums modulo p, against Python ints."""
    from winterfell_tpu_torch.ops import goldilocks as gl

    eng = {"f64": gl, "f128": tf}[field]
    assert [n for n in _ENGINE_NAMES if not hasattr(eng, n)] == []
    assert eng.NAME == field
    rng = np.random.default_rng(7)
    vals = [[int(v) % eng.P for v in rng.integers(0, 2**62, 3)] + [eng.P - 1]
            for _ in range(4)]
    t = eng.to_device(np.array(vals, dtype=object), "cpu")
    assert tuple(t.shape) == (4, 4) + eng.ELEM
    assert eng.elements(eng.to_u64(t)) == tuple(map(tuple, vals))
    want = tuple(sum(col) % eng.P for col in zip(*vals))
    assert eng.elements(eng.to_u64(eng.sum0(t))) == want
