"""The f62 slice as a whole: the port's F62Prover, run on the CPU, gives the
same proof bytes as the JAX package's host prover over f62 (the Fibonacci AIR
of tests/test_e2e_f62.py, 64 rows, ProofOptions(28, 8, 0, ext, 4, 7)) on
each of its three routes (resident, phased + fused FRI, phased + host coin):
Blake3_256 with no extension, the quadratic and the cubic one, Sha3_256 with
the quadratic one, Rp62_248 with no extension and the cubic one, and
Rp62_248 with partitioned commitments (two partitions, quadratic); each
package's verify() accepts the other's proof and rejects a wrong public
result. An f128 proof with partitioned commitments through F128Prover
equals the JAX host prover's too. The port picks the route the JAX
LimbFieldProver would pick, Rp62_248's OOD row limit included, and refuses
what it refuses; the port's CLI offers the JAX CLI's hashers, and
``-H rp62_248`` on an f128 example fails in both.

The JAX F62Prover is not run here: its XLA:CPU compiles crash in long
processes (tests/test_device_f62_prover.py runs it in fresh interpreters),
and its bytes equal the host prover's by the JAX package's own tests."""

import jax
import pytest

from winterfell_tpu.air import FieldExtension, ProofOptions
from winterfell_tpu.air.options import PartitionOptions
from winterfell_tpu.air.proof import Proof
from winterfell_tpu.crypto import hashers as jax_hashers
from winterfell_tpu.examples import cli as jax_cli
from winterfell_tpu.examples import fibonacci as jfib
from winterfell_tpu.math.fields import F128
from winterfell_tpu.verifier import VerifierError, verify
import winterfell_tpu_torch as wt
from winterfell_tpu_torch.air.options import PartitionOptions as PortParts
from winterfell_tpu_torch.crypto import hashers as port_hashers
from winterfell_tpu_torch.examples import cli as port_cli
from winterfell_tpu_torch.examples import fib_f62 as tf62
from winterfell_tpu_torch.examples import fibonacci as tfib
from winterfell_tpu_torch.math.fields import F62 as PORT_F62
from winterfell_tpu_torch.prover import device as port_device
from winterfell_tpu_torch.prover import device_limb
from winterfell_tpu_torch.prover.device_limb import F62Prover, F128Prover
from winterfell_tpu_torch.utils import tracing
from winterfell_tpu_torch.verifier import VerifierError as PortVerifierError

from tests.test_e2e_f62 import FibF62Air, FibF62Prover, _trace

jax.config.update("jax_platforms", "cpu")

ROUTES = ("resident", "fused", "host")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for torch (small tensors; several test workers
    share the cores)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _options(pkg, ext_name, parts=None):
    """Folding 4, remainder degree 7: two FRI layers at 64 rows, so the
    three routes differ."""
    kwargs = {} if parts is None else {"partition_options": parts}
    return pkg.ProofOptions(28, 8, 0, getattr(pkg.FieldExtension, ext_name),
                            4, 7, **kwargs)


def _route_taken() -> str:
    names = [s["name"] for s in tracing.last_spans()]
    if "resident_pipeline" in names:
        return "resident"
    return "fused" if "fri_layers_fused" in names else "host"


def _prove_on_routes(prover, trace_fn, monkeypatch):
    """{route: proof bytes}, each route forced through the port's switches
    and checked from the phase marks."""
    out = {}
    for route in ROUTES:
        monkeypatch.setattr(device_limb, "_RESIDENT_ON", route == "resident")
        monkeypatch.setattr(device_limb, "_FUSED_FRI_ON", route != "host")
        out[route] = prover.prove(trace_fn()).to_bytes()
        assert _route_taken() == route
    return out


def _cross_verify(port_air, jax_air, proof_bytes, result, port_h, jax_h, p):
    """Each package's verify() accepts the proof and rejects it for a wrong
    public result."""
    wt.verify(port_air, wt.Proof.from_bytes(proof_bytes), result, port_h)
    verify(jax_air, Proof.from_bytes(proof_bytes), result, jax_h)
    with pytest.raises(PortVerifierError):
        wt.verify(port_air, wt.Proof.from_bytes(proof_bytes), (result + 1) % p,
                  port_h)
    with pytest.raises(VerifierError):
        verify(jax_air, Proof.from_bytes(proof_bytes), (result + 1) % p, jax_h)


# case -> [(hasher, extension)], partitions (num_partitions, hash_rate)
_CASES = {
    "byte-hashers": ([("blake3_256", "NONE"), ("blake3_256", "QUADRATIC"),
                      ("blake3_256", "CUBIC"), ("sha3_256", "QUADRATIC")],
                     None),
    "rp62-none": ([("rp62_248", "NONE")], None),
    "rp62-cubic": ([("rp62_248", "CUBIC")], None),
    "rp62-partitioned": ([("rp62_248", "QUADRATIC")], (2, 1)),
    "f128-partitioned": ([("blake3_256", "QUADRATIC")], (2, 1)),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_port_f62_proof_bytes_equal_jax_host_proof(case, monkeypatch):
    runs, parts = _CASES[case]
    for name, ext_name in runs:
        jax_h, port_h = jax_hashers.HASHERS[name], port_hashers.HASHERS[name]
        jax_opts = _options(
            _Jax, ext_name, None if parts is None else PartitionOptions(*parts))
        port_opts = _options(
            wt, ext_name, None if parts is None else PortParts(*parts))
        if case.startswith("f128"):
            # Queue C's last untested path: f128 with partitions
            seq = 256
            ref = jfib.FibProver(jax_opts, jax_h).prove(
                jfib.build_fib_trace(F128, seq)).to_bytes()
            prover = F128Prover.accelerate(tfib.FibProver)(port_opts, port_h,
                                                           device="cpu")
            by_route = _prove_on_routes(
                prover, lambda: tfib.build_fib_trace(wt.F128, seq),
                monkeypatch)
            result, airs, p = (jfib.compute_fib_term(F128, seq),
                               (tfib.FibAir, jfib.FibAir), F128.p)
        else:
            host = FibF62Prover(jax_opts, jax_h)
            ref = host.prove(_trace()).to_bytes()
            prover = F62Prover.accelerate(tf62.FibF62Prover)(
                port_opts, port_h, device="cpu")
            by_route = _prove_on_routes(
                prover, lambda: tf62.build_fib_f62_trace(64), monkeypatch)
            result, airs, p = (host.get_pub_inputs(_trace()),
                               (tf62.FibF62Air, FibF62Air), PORT_F62.p)
        assert by_route == {route: ref for route in ROUTES}, (case, name,
                                                              ext_name)
        _cross_verify(*airs, ref, result, port_h, jax_h, p)


class _Jax:
    ProofOptions, FieldExtension = ProofOptions, FieldExtension


class _Taken(Exception):
    pass


def _stop(name):
    def f(*args, **kwargs):
        raise _Taken(name)
    return f


def _route_of(prover, trace) -> str:
    with pytest.raises(_Taken) as taken:
        prover.prove(trace)
    return str(taken.value)


def test_port_f62_route_matches_jax_dispatch_and_cli(monkeypatch):
    """The resident/phased choice equals the JAX LimbFieldProver's
    (device_limb.py:606-616) for each f62 hasher, each prove stopped where
    its route begins: resident with FRI layers, phased without one or with
    an LDE above the resident limit (monkeypatched on both sides), and, for
    Rp62_248 as for the byte hashers, phased with an OOD row above a lowered
    byte limit. A hasher the JAX prover refuses fails the port's with the
    same assertion (Rp64_256 over f62, Rp62_248 over f128). The CLIs offer
    the same hashers; ``-H rp62_248`` fails on an f128 example in both."""
    from winterfell_tpu.prover import device_limb as jax_limb

    monkeypatch.setattr(jax_limb.LimbFieldProver, "_prove_resident",
                        _stop("resident"))
    monkeypatch.setattr(jax_limb, "_commit_pipeline", _stop("phased"))
    monkeypatch.setattr(device_limb.LimbFieldProver, "_prove_resident",
                        _stop("resident"))
    monkeypatch.setattr(device_limb.LimbFieldProver, "_prove_phased",
                        _stop("phased"))
    JaxProver = jax_limb.F62Prover.accelerate(FibF62Prover)
    PortProver = F62Prover.accelerate(tf62.FibF62Prover)
    # (rows, FRI folding, remainder degree, resident limit, expected)
    for n, fold, rem, limit, want in ((64, 4, 7, None, "resident"),
                                      (64, 8, 63, None, "phased"),
                                      (128, 4, 7, 1 << 9, "phased")):
        for mod in (jax_limb, device_limb):
            monkeypatch.setattr(mod, "_LEVEL_FUSE", limit or 1 << 20)
        for name in ("blake3_256", "sha3_256", "rp62_248"):
            jax_opts = ProofOptions(28, 8, 0, FieldExtension.CUBIC, fold, rem)
            port_opts = wt.ProofOptions(28, 8, 0, wt.FieldExtension.CUBIC,
                                        fold, rem)
            got = (_route_of(JaxProver(jax_opts, jax_hashers.HASHERS[name]),
                             _trace(n)),
                   _route_of(PortProver(port_opts, port_hashers.HASHERS[name],
                                        device="cpu"),
                             tf62.build_fib_f62_trace(n)))
            assert got == (want, want), (n, fold, rem, limit, name)
    # the OOD row's bytes (fib, cubic: 2·(2 + 1)·3·8 = 144) above a lowered
    # limit: phased for every hasher, Rp62_248 included
    monkeypatch.setattr(port_device, "_OOD_BYTES_LIMIT", 143)
    for port_h in (wt.Blake3_256, port_hashers.Rp62_248):
        assert _route_of(PortProver(_options(wt, "CUBIC"), port_h,
                                    device="cpu"),
                         tf62.build_fib_f62_trace(64)) == "phased"
    for jax_cls, port_cls, name, jax_trace, port_trace in (
            (JaxProver, PortProver, "rp64_256", lambda: _trace(64),
             lambda: tf62.build_fib_f62_trace(64)),
            (jax_limb.F128Prover.accelerate(jfib.FibProver),
             F128Prover.accelerate(tfib.FibProver), "rp62_248",
             lambda: jfib.build_fib_trace(F128, 64),
             lambda: tfib.build_fib_trace(wt.F128, 64))):
        refused = []
        for prover, trace in (
                (jax_cls(_options(_Jax, "NONE"), jax_hashers.HASHERS[name]),
                 jax_trace()),
                (port_cls(_options(wt, "NONE"), port_hashers.HASHERS[name],
                          device="cpu"), port_trace())):
            with pytest.raises(AssertionError) as err:
                prover.prove(trace)
            refused.append(str(err.value))
        assert refused[0] == refused[1], name
    # the CLIs: the same -H choices; rp62_248 on an f128 example refused by
    # the JAX CLI's device prover and by the port's (on the CPU here)
    assert sorted(port_hashers.HASHERS) == sorted(jax_hashers.HASHERS)
    argv = ["fib", "-n", "64", "-g", "0", "-H", "rp62_248"]
    with pytest.raises(AssertionError, match="F62Prover"):
        jax_cli.main(argv + ["--device"])
    with pytest.raises(AssertionError, match="F62Prover"):
        port_cli.main(argv + ["--cpu"])
