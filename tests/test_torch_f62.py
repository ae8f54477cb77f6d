"""The port's f62 slice below the prover, on the CPU, against the JAX package
with the same inputs made from a numpy seed and exact equality:

- the engine (winterfell_tpu_torch/ops/f62.py, the plain versions of its
  kernels B14 and B14n on CPU tensors) against the JAX engine
  (winterfell_tpu/ops/f62.py): add, sub, neg, mul (Python-int operands and
  broadcast columns too), powers, inversion, the quadratic and cubic
  extensions (products and inverses), NTT and iNTT; the rest against the
  exact host oracle that tests/test_f62_jax.py holds the JAX engine to
  (winterfell_tpu.math, winterfell_tpu.fri.folding): batch inversion with
  zeros (base and extension), coset LDE, interpolation with offset, FRI
  folding by 4 and 8 (XLA:CPU takes 10-110 s to compile each of those JAX
  programs); the interop conversions of f62 arrays;
- the Rp62_248 ops (ops/rp62.py, the plain versions of B15) against the JAX
  device ops (winterfell_tpu/ops/rp62_device.py: the permutation, one row
  hash, the merge, digest packing) and the JAX host Rp62_248 (row hashes of
  1 ... 16 elements, merge, merge_many, a whole tree); each XLA:CPU compile
  of the JAX programs takes seconds, so one shape each;
- the device coin over f62 against the JAX host DefaultRandomCoin: the
  Rp62_248 coin's reseed and merge_with_int candidates (a counter >= p62
  included), its draws, and the byte coins' f62 draws at degree 1 and 3
  from a seed whose first candidate lies in [p62, 2^64)."""

import jax
import numpy as np
import pytest
import torch

from winterfell_tpu.air.coefficients import _draw
from winterfell_tpu.air.options import BatchingMethod
from winterfell_tpu.crypto.hashers import HASHERS as JAX_HASHERS
from winterfell_tpu.crypto.random_coin import DefaultRandomCoin
from winterfell_tpu.fri import folding as host_fold
from winterfell_tpu.math import ntt as host_ntt
from winterfell_tpu.math.fields import F62, Field
from winterfell_tpu.ops import f62 as jf
from winterfell_tpu.ops import rp62_device as jr
from winterfell_tpu_torch import interop
from winterfell_tpu_torch.ops import device_coin as dc
from winterfell_tpu_torch.ops import f62 as tf
from winterfell_tpu_torch.ops import rp62

jax.config.update("jax_platforms", "cpu")

P = F62.p
_CORNERS = [0, 1, 2, P - 2, P - 1, 2**31, 2**32 - 1, 2**61, jf.E]
JAX_RP62 = JAX_HASHERS["rp62_248"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def _port(arr):
    return interop.tensor_from_u64(np.asarray(arr, dtype=np.uint64))


def _jax(arr):
    return jf.jnp.asarray(jf.to_limbs_np(np.asarray(arr, dtype=np.uint64)))


def _same(port_t, jax_a, what):
    got = interop.u64_from_tensor(port_t)
    want = interop.u64_from_tensor(interop.tensor_from_f62_limbs(
        np.asarray(jax_a)))
    assert got.shape == want.shape, what
    assert (got == want).all(), what


def test_f62_engine_equals_jax_engine():
    rng = np.random.default_rng(20261018)
    pairs = [(x, y) for x in _CORNERS for y in _CORNERS]
    a = np.concatenate([np.array([x for x, _ in pairs], dtype=np.uint64),
                        _rand(rng, (400,))])
    b = np.concatenate([np.array([y for _, y in pairs], dtype=np.uint64),
                        _rand(rng, (400,))])
    for port_op, jax_op in ((tf.f62_add, jf.base_add), (tf.f62_sub, jf.base_sub),
                            (tf.f62_mul, jf.base_mul)):
        _same(port_op(_port(a), _port(b)), jax_op(_jax(a), _jax(b)),
              port_op.__name__)
        c = int(b[-1])
        _same(port_op(_port(a), c),
              jax_op(_jax(a), jf.jnp.broadcast_to(jf.scalar(c), (a.size, 2))),
              (port_op.__name__, "int"))
    _same(tf.f62_neg(_port(a)), jf.base_neg(_jax(a)), "neg")
    col, ext3 = _rand(rng, (64,)), _rand(rng, (64, 3))
    _same(tf.ext_mul_base(_port(ext3), _port(col)),
          jf.ext_mul_base(_jax(ext3), _jax(col)), "broadcast column")
    _same(tf.f62_pow_const(_port(a), 12345), jf.base_pow_const(_jax(a), 12345),
          "pow")
    _same(tf.f62_inv(_port(a)), jf.base_inv(_jax(a)), "inv (0 -> 0)")
    # the quadratic (x² = x + 1) and cubic (x³ = −2 − 2x) extensions
    for d in (2, 3):
        x, y = _rand(rng, (300, d)), _rand(rng, (300, d))
        x[0] = 0
        x[1] = [P - 1] * d
        _same(tf.ext_mul(_port(x), _port(y)), jf.ext_mul(_jax(x), _jax(y)),
              ("ext_mul", d))
        _same(tf.ext_inv(_port(x)), jf.ext_inv(_jax(x)), ("ext_inv", d))
    # NTT and iNTT (B14n's plain stages) over extension columns
    coeffs = _rand(rng, (64, 3))
    _same(tf.ntt_evaluate(_port(coeffs), 64), jf.ntt_evaluate(_jax(coeffs), 64),
          "ntt")
    _same(tf.ntt_interpolate(_port(coeffs), 64),
          jf.ntt_interpolate(_jax(coeffs), 64), "intt")

    # against the exact host oracle: batch inversion with zeros, coset LDE,
    # interpolation with offset, FRI folding
    def ints(t):
        return interop.u64_from_tensor(t).astype(object)

    z = _rand(rng, (700,))
    z[[0, 5, 129, 699]] = 0
    assert [int(v) for v in ints(tf.f62_batch_inv(_port(z)))] == [
        pow(int(v), P - 2, P) for v in z]
    for d in (2, 3):  # the norms through the base batch inverse's scan
        x = _rand(rng, (300, d))
        x[[0, 7]] = 0
        assert [tuple(r) for r in ints(tf.ext_batch_inv(_port(x)))] == [
            Field(F62, d).inv(tuple(int(v) for v in r)) for r in x], d
    lde = tf.ntt_evaluate_with_offset(_port(coeffs), 64, 3, 8)
    assert (ints(lde) == host_ntt.evaluate_poly_with_offset(
        F62, coeffs.astype(object), 3, 8)).all()
    evals = interop.u64_from_tensor(lde[:64]).astype(object)
    assert (ints(tf.ntt_interpolate_with_offset(lde[:64].contiguous(), 64,
                                                3)) ==
            host_ntt.interpolate_poly_with_offset(F62, evals, 3)).all()
    for n_fold, d in ((4, 3), (8, 2)):
        ev, alpha = _rand(rng, (256, d)), _rand(rng, (d,))
        want = host_fold.apply_drp(
            Field(F62, d), host_fold.transpose_evaluations(
                ev.astype(object), n_fold), 3, tuple(int(v) for v in alpha))
        assert [tuple(r) for r in ints(tf.fri_fold(
            _port(ev), n_fold, 3, _port(alpha)))] == [tuple(e) for e in want]
    # interop: f62 arrays between the JAX engine's limbs and tensors
    limbs = jf.to_limbs_np(ev.astype(object))
    t = interop.tensor_from_f62_limbs(limbs)
    assert t.dtype == torch.int64 and t.shape == ev.shape
    assert np.array_equal(interop.f62_limbs_from_tensor(t), limbs)
    assert np.array_equal(interop.u64_from_tensor(t), ev)


def _bytes(words) -> bytes:
    """A packed digest tensor's 31 digest bytes."""
    return interop.u32_from_tensor(words).astype("<u4").tobytes()[:31]


def test_rp62_ops_equal_jax_device_ops_and_host_hasher():
    rng = np.random.default_rng(7)
    # the permutation against rp62_permutation_rows
    state = _rand(rng, (20, 12))
    state[0] = P - 1
    state[1] = 0
    # every lane at p - 1 (the kernels' MDS sums at their largest), at
    # E = 2^62 mod p, E + 1, 2^61 and p - E
    for i, v in enumerate((P - 1, tf.E, tf.E + 1, 2**61, P - tf.E)):
        state[2 + i] = v
    _same(rp62._perm_plain(_port(state)),
          jr.rp62_permutation_rows(_jax(state)), "permutation")
    # row hashes against the host Rp62_248.hash_elements; k = 9 (a full and
    # a partial rate chunk) against rp62_hash_words too
    for k in (1, 7, 8, 9, 16):
        rows = _rand(rng, (5, k))
        rows[0, 0] = P - 1
        got = rp62.rp62_hash_rows(_port(rows))
        for i in range(5):
            assert _bytes(got[i]) == JAX_RP62.hash_elements(
                [(int(v),) for v in rows[i]], None), (k, i)
        if k == 9:
            want = jr.rp62_hash_words(
                jf.jnp.asarray(jf.to_limbs_np(rows.astype(object)).reshape(
                    5, 18).astype(np.uint32)), 72)
            assert np.array_equal(interop.u32_from_tensor(got),
                                  np.asarray(want))
    # digest packing against _pack_digest / _unpack_digest
    elems = _rand(rng, (6, 4))
    packed = rp62.pack(_port(elems))
    assert np.array_equal(interop.u32_from_tensor(packed), np.asarray(
        jr._pack_digest(_jax(elems))))
    _same(rp62.unpack(packed), jr._unpack_digest(jf.jnp.asarray(
        interop.u32_from_tensor(packed))), "unpack")
    # merge (against rp62_merge_rows and the host), merge_many (the
    # partitioned commitment's combine), a tree of 16 leaves
    leaves = rp62.rp62_hash_rows(_port(_rand(rng, (16, 3))))
    merged = rp62.rp62_merge_rows(leaves[0::2], leaves[1::2])
    assert np.array_equal(interop.u32_from_tensor(merged), np.asarray(
        jr.rp62_merge_rows(jf.jnp.asarray(interop.u32_from_tensor(
            leaves[0::2])), jf.jnp.asarray(interop.u32_from_tensor(
                leaves[1::2])))))
    combined = rp62.rp62_combine([leaves[:8], leaves[8:]])
    for i in range(8):
        assert _bytes(combined[i]) == JAX_RP62.merge_many(
            [_bytes(leaves[i]), _bytes(leaves[8 + i])])
    nodes = [_bytes(r) for r in leaves]
    levels = rp62.rp62_merkle_levels(leaves)
    for level in levels:
        nodes = [JAX_RP62.merge(nodes[2 * i], nodes[2 * i + 1])
                 for i in range(len(nodes) // 2)]
        assert [_bytes(r) for r in level] == nodes
    assert len(nodes) == 1


def _host_coin(seed: bytes) -> DefaultRandomCoin:
    coin = DefaultRandomCoin(JAX_RP62, [], Field(F62, 1))
    coin.seed = seed
    return coin


def test_f62_device_coin_equals_host_coin():
    rng = np.random.default_rng(3)
    # the Rp62_248 coin: reseed (one merge) and the merge_with_int
    # candidates, below p62 and at or above it (count 6, c div p in lane 5)
    seed_b = JAX_RP62.hash(b"seed")
    root_b = JAX_RP62.hash(b"root")
    merge, draw = dc.coin_bundle("rp62_248", 3, "f62")
    seed = dc.seed_tensor(seed_b, "cpu", "rp62_248")
    assert _bytes(merge(seed, dc.seed_tensor(root_b, "cpu", "rp62_248"))) == \
        JAX_RP62.merge(seed_b, root_b)
    for c0 in (0, P - 2, 2**64 - 4):
        cands = rp62.coin_candidates(seed, c0, 3)
        for j in range(3):
            assert _bytes(cands[j]) == JAX_RP62.merge_with_int(
                seed_b, c0 + 1 + j), (c0, j)
    # draws of the Rp62_248 coin and the byte coins over f62, at degree 1
    # and 3, against the host coin; each byte coin's seed is chosen so that
    # its first candidate's first u64 lies in [p62, 2^64) (rejected)
    for kind in ("rp62_248", "blake3_256", "sha3_256"):
        jax_h = JAX_HASHERS[kind]
        seed_b = jax_h.hash(b"draw")
        if kind != "rp62_248":
            for i in range(64):
                seed_b = jax_h.hash(bytes([i]))
                head = int.from_bytes(jax_h.merge_with_int(seed_b, 1)[:8],
                                      "little")
                if head >= P:
                    break
            assert head >= P
        for d, k in ((1, 3), (3, 2)):
            _, draw = dc.coin_bundle(kind, d, "f62")
            elems, counter = draw(dc.seed_tensor(seed_b, "cpu", kind), k)
            coin = DefaultRandomCoin(jax_h, [], Field(F62, d))
            coin.seed = seed_b
            want = [coin.draw(Field(F62, d)) for _ in range(k)]
            assert [tuple(int(v) for v in row)
                    for row in interop.u64_from_tensor(elems)] == want, (
                        kind, d)
            assert int(counter[0]) == coin.counter
    # the algebraic coefficient draw (powers of one draw) with the f62
    # engine's power table
    _, draw = dc.coin_bundle("rp62_248", 3, "f62")
    draw_k = dc.make_draw_k(draw, tf)
    elems, _ = draw_k(dc.seed_tensor(seed_b, "cpu", "rp62_248"), 5,
                      "algebraic")
    coin = _host_coin(seed_b)
    want = _draw(coin, Field(F62, 3), 5, BatchingMethod.ALGEBRAIC)
    assert [tuple(int(v) for v in row)
            for row in interop.u64_from_tensor(elems)] == list(want)
