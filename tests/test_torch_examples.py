"""The reference's other examples in the port, and its CLI: for fib8, mulfib,
mulfib8, vdf, vdfx, merkle, lamport (one signature) and lamport_threshold,
the port's host prover and its F128Prover (on the CPU, on the phased route
with fused FRI) give the JAX host prover's proof bytes, and each package's
verify() accepts the other's proof; the port's CLI builds the same traces
and public inputs as the JAX CLI for all 13 examples and proves and
verifies from its command line; the native Lamport and width-6 Rescue
builders (native/f128.c) equal the port's Python oracles and the JAX
package's builders. rescue_raps, the aux-segment example, is pinned in
tests/test_torch_aux.py.

The JAX F128Prover is not run (its XLA:CPU compiles crash in long
processes); the JAX host provers are the byte reference."""

import jax
import numpy as np
import pytest

from winterfell_tpu.air import FieldExtension, ProofOptions
from winterfell_tpu.air.proof import Proof
from winterfell_tpu.crypto.hashers import Blake3_256 as JaxBlake3_256
from winterfell_tpu.examples import cli as jax_cli
from winterfell_tpu.examples import lamport as jlam
from winterfell_tpu.verifier import verify
import winterfell_tpu_torch as wt
from winterfell_tpu_torch.crypto import native
from winterfell_tpu_torch.examples import cli as port_cli
from winterfell_tpu_torch.examples import lamport as tlam
from winterfell_tpu_torch.examples import merkle as tmerkle
from winterfell_tpu_torch.prover import device_limb
from winterfell_tpu_torch.utils import tracing

jax.config.update("jax_platforms", "cpu")

# the CLI's -n of each example at a size with FRI layers (sequence length,
# chain length, tree depth or signatures)
SIZES = {"fib": 64, "fib2": 64, "fib8": 128, "fib_small": 64, "mulfib": 64,
         "mulfib8": 128, "vdf": 64, "vdfx": 64, "rescue": 4,
         "rescue_raps": 4, "merkle": 3, "lamport": 1, "lamport_threshold": 1}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for torch (small tensors; several test workers
    share the cores)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _options(pkg):
    """Folding 4, remainder degree 7: FRI layers at these sizes, so the fused
    FRI route runs."""
    return pkg.ProofOptions(28, 8, 0, pkg.FieldExtension.NONE, 4, 7)


class _JaxOpts:
    ProofOptions, FieldExtension = ProofOptions, FieldExtension


def _elements(prover, trace, air_cls, options):
    """The public inputs as the seed's elements."""
    return air_cls(trace.info(), prover.get_pub_inputs(trace),
                   options).pub_inputs_to_elements()


def _same_example(name):
    """The JAX CLI's and the port's get_example at SIZES[name]: (JAX host
    prover, trace, AIR), (port host prover, trace, AIR); their traces and
    public inputs are equal."""
    n = SIZES[name]
    jax_ex = jax_cli.get_example(name, n, _options(_JaxOpts), JaxBlake3_256,
                                 False)
    port_ex = port_cli.get_example(name, n, _options(wt), wt.Blake3_256,
                                   "host")
    (jp, jt, ja), (pp, pt, pa) = jax_ex, port_ex
    assert (pt.info().width, pt.length) == (jt.info().width, jt.length), name
    assert np.array_equal(pt.main_segment(), jt.main_segment()), name
    assert (_elements(pp, pt, pa, _options(wt))
            == _elements(jp, jt, ja, _options(_JaxOpts))), name
    return jax_ex, port_ex


# the examples new to the port in this slice (rescue_raps: test_torch_aux.py)
_NEW = ("fib8", "mulfib", "mulfib8", "vdf", "vdfx", "merkle", "lamport",
        "lamport_threshold")


@pytest.mark.parametrize("name", _NEW)
def test_port_example_proofs_equal_jax_host_proofs(name, monkeypatch):
    monkeypatch.setattr(device_limb, "_RESIDENT_ON", False)
    monkeypatch.setattr(device_limb, "_FUSED_FRI_ON", True)
    (jp, jt, ja), (pp, pt, pa) = _same_example(name)
    ref = jp.prove(jt).to_bytes()
    assert pp.prove(pt).to_bytes() == ref, (name, "host")
    dp, dt, _ = port_cli.get_example(name, SIZES[name], _options(wt),
                                     wt.Blake3_256, "cpu")
    got = dp.prove(dt).to_bytes()
    assert "fri_layers_fused" in [s["name"] for s in tracing.last_spans()]
    assert got == ref, (name, "F128Prover")
    wt.verify(pa, wt.Proof.from_bytes(ref), pp.get_pub_inputs(pt),
              wt.Blake3_256)
    verify(ja, Proof.from_bytes(got), jp.get_pub_inputs(jt), JaxBlake3_256)


@pytest.mark.parametrize("name", port_cli.EXAMPLES)
def test_port_cli_get_example_equals_jax_cli(name):
    """get_example gives the JAX CLI's trace and public inputs."""
    _same_example(name)


def test_port_cli_main_proves_and_verifies(capsys):
    """main() proves and verifies on the CPU with the device prover and
    with the host prover, and prints the JAX CLI's lines."""
    assert set(port_cli.EXAMPLES) == set(SIZES)
    for where in ("--cpu", "--host"):
        port_cli.main(["fib_small", "-n", "64", "-g", "0", where])
        out = capsys.readouterr().out.splitlines()
        assert [line.split(" ")[0] for line in out] == [
            "Built", "Proof", "Proof", "Conjectured", "Proof"], out
        assert out[0] == "Built execution trace of 2x32 in " + \
            out[0].rsplit(" ", 2)[1] + " ms"
        assert out[-1].startswith("Proof verified in ")


def test_native_lamport_and_rescue_builders_equal_python_oracles():
    """native/f128.c's width-6 Rescue sponge and batch digest and its
    Lamport trace builder give the port's Python oracles' values and the
    JAX package's keys and traces."""
    assert native.f128_available()
    mds, ark, ia = tmerkle.MDS, tmerkle.ARK, tmerkle.INV_ALPHA
    rng = np.random.default_rng(7)
    p = wt.F128.p
    data = [int(v) % p for v in rng.integers(0, 2**63, size=11)] + [p - 1]
    for k in (0, 1, 3, 4, 5, 8, 12):
        assert (native.rescue128w6_sponge(data[:k], mds, ark, ia)
                == tmerkle.rescue128_digest(data[:k])), k
    pairs = [(data[i], data[i + 1]) for i in range(0, 12, 2)]
    assert (native.rescue128w6_hash2_many(pairs, mds, ark, ia)
            == [tmerkle.rescue128_digest(list(q)) for q in pairs])
    key, jax_key = tlam.PrivateKey(3), jlam.PrivateKey(3)
    assert key.sec_keys == jax_key.sec_keys
    assert key.pub_keys == tlam.pub_keys_py(key.sec_keys) == jax_key.pub_keys
    assert key.pub_key() == tlam.hash_pub_keys(key.pub_keys) == \
        jax_key.pub_key()
    pks, msgs, sigs = tlam.sign_messages(2)
    rows = tlam.build_lamport_trace(msgs, sigs).main_segment()
    assert np.array_equal(rows,
                          tlam.build_lamport_trace_py(msgs, sigs).main_segment())
    jax_sigs = [jlam.PrivateKey(i).sign(f"test message {i}".encode())
                for i in range(2)]
    assert np.array_equal(rows, jlam.build_lamport_trace(
        msgs, jax_sigs).main_segment())
