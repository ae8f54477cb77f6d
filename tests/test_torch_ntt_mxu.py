"""B16, the f128 NTT on int8 digit products under WINTER_MXU_NTT=1: the port
(winterfell_tpu_torch/ops/ntt_mxu.py, the plain versions of its kernels on
CPU tensors, and the six-step NTT of ops/f128.py under its ``_USE_MXU``)
against the JAX package's winterfell_tpu/ops/ntt_mxu.py and its f128 engine
under theirs, on the CPU, with the same inputs made from a numpy seed and
exact equality: the leaf matrices byte for byte, the digits and the
recombine (corner values, digit 9 across the words, diagonal sums at their
maximum), leaf DFTs in both directions with a batch across the chunk,
whole NTTs, iNTTs and coset LDEs against the JAX engine and the host NTT,
and a small f128 fib proof with the switch on, on the resident and phased
routes, against the JAX host prover's bytes and the port's without it."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from winterfell_tpu.air import FieldExtension, ProofOptions
from winterfell_tpu.air.proof import Proof
from winterfell_tpu.crypto import hashers as jax_hashers
from winterfell_tpu.examples import fibonacci as jfib
from winterfell_tpu.math import ntt as host_ntt
from winterfell_tpu.math.fields import F128
from winterfell_tpu.ops import f128 as jf
from winterfell_tpu.ops import ntt_mxu as jm
from winterfell_tpu.verifier import verify as jax_verify
import winterfell_tpu_torch as wt
from winterfell_tpu_torch import interop
from winterfell_tpu_torch.examples import fibonacci as tfib
from winterfell_tpu_torch.ops import f128 as tf
from winterfell_tpu_torch.ops import ntt_mxu as tm
from winterfell_tpu_torch.prover import device_limb
from winterfell_tpu_torch.prover.device_limb import F128Prover
from winterfell_tpu_torch.utils import tracing

jax.config.update("jax_platforms", "cpu")

P = F128.p
# canonical corners, and values whose digit 9 (bits 63-69) spans the
# (lo, hi) words or whose top digit (bits 126-127) is set
CORNERS = [0, 1, 2, P - 1, P - 2, 2**127, 2**63, 2**64, 2**64 - 1,
           0x7F << 63, 1 << 69, (1 << 69) | (1 << 63), 2**126 + 2**63]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, shape):
    """Object array of canonical ints from the numpy generator, the corners
    first."""
    n = int(np.prod(shape, dtype=np.int64))
    raw = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint64)
    vals = [(int(r[0]) | int(r[1]) << 32 | int(r[2]) << 64 | int(r[3]) << 96)
            % P for r in raw]
    vals[: len(CORNERS)] = CORNERS[: n]
    return np.array(vals[:n], dtype=object).reshape(shape)


def _port(obj):
    return tf.to_device(obj, "cpu")


def _limbs(obj):
    return jf.jnp.asarray(jf.to_limbs_np(np.asarray(obj, dtype=object)))


def _ints(jax_limbs):
    return jf.from_limbs_np(np.asarray(jax_limbs))


@pytest.fixture
def mxu(monkeypatch):
    """Both engines under WINTER_MXU_NTT=1, the JAX plan cache cleared
    (the port keys its plans by mode)."""
    monkeypatch.setattr(jf, "_USE_MXU", True)
    monkeypatch.setattr(tf, "_USE_MXU", True)
    jf.ntt_plan.cache_clear()
    yield
    jf.ntt_plan.cache_clear()


@pytest.mark.parametrize("n", [2, 8, 128])
def test_leaf_matrix_equals_jax(n):
    for inverse in (False, True):
        got = tm._leaf_matrix_np(n, inverse)
        want = jm._leaf_matrix_np(n, inverse)
        assert got.dtype == want.dtype == np.int8
        assert got.tobytes() == want.tobytes(), (n, inverse)
        dev = tm.leaf_matrix_dev(n, inverse, "cpu")
        rows, cols = tm.padded_shape(n)
        assert tuple(dev.shape) == (rows, cols) and rows % 16 == 0 \
            and cols % 32 == 0
        assert np.array_equal(dev[: 37 * n, : 19 * n].numpy(), want)
        assert int(dev.abs().sum()) == int(np.abs(want.astype(np.int64)).sum())


def test_digitize_and_recombine_equal_jax():
    """Digits of random values and of the corners, and the recombine of
    random diagonal sums and of sums at their maximum 127²·19n (every carry
    of the sweep), against the JAX _digitize and _recombine."""
    rng = np.random.default_rng(17)
    n, cols = 8, 40
    vals = _rand(rng, (n, cols))
    got = tm.digitize_plain(_port(vals))
    want = np.asarray(jax.jit(jm._digitize)(_limbs(vals)))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    top = 127 * 127 * 19 * n
    diags = rng.integers(0, top + 1, size=(37 * n, cols), dtype=np.int64)
    diags[:, 0] = top
    diags[:, 1] = 0
    diags[::2, 2] = top
    diags = diags.astype(np.int32)
    got = tm.recombine_plain(torch.from_numpy(diags), n)
    want = jax.jit(partial(jm._recombine, L=n))(jf.jnp.asarray(diags))
    assert (tf.to_ints(got) == _ints(want)).all()
    assert torch.equal(got, interop.tensor_from_limbs(np.asarray(want)))


@pytest.mark.parametrize("n", [2, 8, 64, 128])
def test_leaf_dft_plain_equals_jax(n, monkeypatch):
    """The port's leaf DFT (digit product and recombine) against the JAX
    leaf_dft, both directions; at n = 8 a batch of 40 columns in chunks of
    16 (the JAX scan in chunks of 8)."""
    rng = np.random.default_rng(n)
    cols = 40 if n == 8 else 24
    if n == 8:
        monkeypatch.setattr(tm, "_CHUNK", 16)
        monkeypatch.setattr(jm, "_CHUNK", 16)
    vals = _rand(rng, (n, cols))
    for inverse in (False, True):
        got = tm.leaf_dft(_port(vals), tm.leaf_matrix_dev(n, inverse, "cpu"),
                          n)
        want = jm.leaf_dft(_limbs(vals), n, inverse)
        assert (tf.to_ints(got) == _ints(want)).all(), (n, inverse)


def test_mxu_ntt_equals_jax_and_host(mxu):
    """Under both switches: the NTT at 2^10 and the iNTT at 2^9 against the
    JAX engine and the host NTT, the coset LDE of 2^7 rows by 8 against the
    host NTT (XLA:CPU takes ~7 s to compile each JAX program)."""
    rng = np.random.default_rng(1017)
    a = _rand(rng, (1 << 10, 2))
    got = tf.to_ints(tf.ntt_evaluate(_port(a), 1 << 10))
    assert (got == _ints(jf.ntt_evaluate(_limbs(a), 1 << 10))).all()
    for j in range(2):
        assert (got[:, j] == host_ntt.evaluate_poly(F128, a[:, j])).all()
    b = _rand(rng, (1 << 9, 1))
    got = tf.to_ints(tf.ntt_interpolate(_port(b), 1 << 9))
    assert (got == _ints(jf.ntt_interpolate(_limbs(b), 1 << 9))).all()
    assert (got[:, 0] == host_ntt.interpolate_poly(F128, b[:, 0])).all()
    c = _rand(rng, (1 << 7, 2))
    got = tf.to_ints(tf.ntt_evaluate_with_offset(_port(c), 1 << 7,
                                                 F128.generator, 8))
    for j in range(2):
        want = host_ntt.evaluate_poly_with_offset(F128, c[:, j],
                                                  F128.generator, 8)
        assert (got[:, j] == want).all()


def test_mxu_proof_bytes_equal_jax_host_and_switch_off(monkeypatch):
    """f128 fib, trace 2^6: the port's F128Prover with the switch on, on the
    resident and the phased (fused FRI) routes, gives the bytes of the JAX
    host prover and of the port without the switch; both verifiers accept.
    The resident run builds no plan table of its own (_resident_consts
    built them all)."""
    seq = 128
    opts = (28, 8, 0, "NONE", 4, 7)
    jax_opts = ProofOptions(*opts[:3], FieldExtension.NONE, *opts[4:])
    ref = jfib.FibProver(jax_opts, jax_hashers.HASHERS["blake3_256"]).prove(
        jfib.build_fib_trace(F128, seq)).to_bytes()
    port_opts = wt.ProofOptions(*opts[:3], wt.FieldExtension.NONE, *opts[4:])
    prover = F128Prover.accelerate(tfib.FibProver)(port_opts, wt.Blake3_256,
                                                    device="cpu")
    assert prover.prove(tfib.build_fib_trace(wt.F128, seq)).to_bytes() == ref
    monkeypatch.setattr(tf, "_USE_MXU", True)
    run = prover._resident_run

    def no_new_tables(*args, **kwargs):
        before = set(tf._dev_cache)
        out = run(*args, **kwargs)
        assert set(tf._dev_cache) == before
        return out

    prover._resident_run = no_new_tables
    for route in ("resident", "fused"):
        monkeypatch.setattr(device_limb, "_RESIDENT_ON", route == "resident")
        proof = prover.prove(tfib.build_fib_trace(wt.F128, seq))
        marks = [s["name"] for s in tracing.last_spans()]
        assert ("resident_pipeline" in marks) == (route == "resident")
        assert proof.to_bytes() == ref, route
    pub = jfib.compute_fib_term(F128, seq)
    wt.verify(tfib.FibAir, wt.Proof.from_bytes(ref), pub, wt.Blake3_256)
    jax_verify(jfib.FibAir, Proof.from_bytes(proof.to_bytes()), pub,
               jax_hashers.HASHERS["blake3_256"])


def test_plan_tables_follow_the_switch(monkeypatch):
    """Without the switch ntt_plan and the NTT build no leaf matrix and no
    mid twiddles; with it, ntt_plan builds the leaf matrix of every leaf
    size and the mid twiddles of every level at once."""
    monkeypatch.setattr(tf, "_dev_cache", {})

    def refuse(*args):
        raise AssertionError("a leaf matrix was built with the switch off")

    monkeypatch.setattr(tm, "leaf_matrix_dev", refuse)
    x = _port(_rand(np.random.default_rng(3), (1 << 12, 1)))
    want = tf.ntt_evaluate(x, 1 << 12)
    assert not [k for k in tf._dev_cache if k[0].startswith("mxu")]
    monkeypatch.undo()
    monkeypatch.setattr(tf, "_dev_cache", {})
    monkeypatch.setattr(tf, "_USE_MXU", True)
    plan = tf.ntt_plan(1 << 12, False, "cpu")
    assert plan[0] == "six" and tuple(plan[1].shape) == (64, 64, 2)
    assert {k[:3] for k in tf._dev_cache if k[0] != "mxu_plan"} >= {
        ("mxu_mid", 1 << 12, 64), ("mxu_leaf", 64, False)}
    built = set(tf._dev_cache)
    assert torch.equal(tf.ntt_evaluate(x, 1 << 12), want)
    assert set(tf._dev_cache) == built
