"""The f128 slice as a whole: the port's F128Prover, run on the CPU, gives the
same proof bytes as the JAX package's host provers over f128 (FibProver with
no extension and with the quadratic one, RescueProver, the reference's
headline computation) on each of its three routes (resident, phased + fused
FRI, phased + host coin), with Blake3_256 and once each with Blake3_192 and
Sha3_256; each package's verify() accepts the other's proof; the port's
host prover and F128Prover both give the bytes derived from the reference's
sources alone (tests/test_reference_full_proof_fixture.py); and the port
picks the route the JAX LimbFieldProver would pick.

The JAX F128Prover is not run here: its XLA:CPU compiles crash in long
processes (tests/test_device_f128_prover.py), and its bytes equal the host
prover's by the JAX package's own tests."""

import jax
import pytest

from winterfell_tpu.air import FieldExtension, ProofOptions
from winterfell_tpu.air.proof import Proof
from winterfell_tpu.crypto import hashers as jax_hashers
from winterfell_tpu.examples import fibonacci as jfib
from winterfell_tpu.examples import rescue as jres
from winterfell_tpu.math.fields import F128
from winterfell_tpu.verifier import verify
import winterfell_tpu_torch as wt
from winterfell_tpu_torch.crypto import hashers as port_hashers
from winterfell_tpu_torch.examples import fibonacci as tfib
from winterfell_tpu_torch.examples import rescue as tres
from winterfell_tpu_torch.prover import device as port_device
from winterfell_tpu_torch.prover import device_limb
from winterfell_tpu_torch.prover.device_limb import F128Prover
from winterfell_tpu_torch.utils import tracing

from tests.test_reference_full_proof_fixture import (
    BLOWUP,
    FOLDING,
    N_ROWS,
    REMAINDER_MAX_DEG,
    derive_proof_bytes,
)

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


class _JaxOpts:
    ProofOptions, FieldExtension = ProofOptions, FieldExtension


def _options(pkg, ext_name):
    """Folding 4, remainder degree 7: two FRI layers at these sizes, so the
    three routes differ."""
    return pkg.ProofOptions(28, 8, 0, getattr(pkg.FieldExtension, ext_name),
                            4, 7)


def _route_taken() -> str:
    names = [s["name"] for s in tracing.last_spans()]
    if "resident_pipeline" in names:
        return "resident"
    return "fused" if "fri_layers_fused" in names else "host"


def _prove_on_routes(prover, trace_fn, monkeypatch, routes=ROUTES):
    """{route: proof bytes}, each route forced through the port's switches
    and checked from the phase marks."""
    out = {}
    for route in routes:
        monkeypatch.setattr(device_limb, "_RESIDENT_ON", route == "resident")
        monkeypatch.setattr(device_limb, "_FUSED_FRI_ON", route != "host")
        out[route] = prover.prove(trace_fn()).to_bytes()
        assert _route_taken() == route
    return out


# (example, extension, the other hasher proved once on the resident route)
_CASES = {
    "fib-none": ("fib", "NONE", "sha3_256"),
    "fib-quadratic": ("fib", "QUADRATIC", "blake3_192"),
    "rescue": ("rescue", "NONE", None),
}


def _example(name):
    """(JAX host prover class, its trace, port prover class, port trace
    builder, JAX AIR, port AIR, public inputs)."""
    if name == "fib":
        seq = 256
        return (jfib.FibProver, lambda: jfib.build_fib_trace(F128, seq),
                tfib.FibProver, lambda: tfib.build_fib_trace(wt.F128, seq),
                jfib.FibAir, tfib.FibAir, jfib.compute_fib_term(F128, seq))
    seed, iterations = (5, 6), 4
    result = jres.compute_hash_chain(seed, iterations)
    return (jres.RescueProver, lambda: jres.build_rescue_trace(seed, iterations),
            tres.RescueProver, lambda: tres.build_rescue_trace(seed, iterations),
            jres.RescueAir, tres.RescueAir,
            (jres.RescuePublicInputs(seed, result),
             tres.RescuePublicInputs(seed, result)))


@pytest.mark.parametrize("case", list(_CASES))
def test_port_f128_proof_bytes_equal_jax_host_proof(case, monkeypatch):
    example, ext_name, other = _CASES[case]
    (jax_prover, jax_trace, port_prover, port_trace, jax_air, port_air,
     pub) = _example(example)
    jax_pub, port_pub = (pub, pub) if example == "fib" else pub
    refs = {}
    for name, routes in (("blake3_256", ROUTES), (other, ("resident",))):
        if name is None:
            continue
        jax_h, port_h = jax_hashers.HASHERS[name], port_hashers.HASHERS[name]
        ref = refs[name] = jax_prover(_options(_JaxOpts, ext_name),
                                      jax_h).prove(jax_trace()).to_bytes()
        prover = F128Prover.accelerate(port_prover)(
            _options(wt, ext_name), port_h, device="cpu")
        by_route = _prove_on_routes(prover, port_trace, monkeypatch, routes)
        assert by_route == {route: ref for route in routes}, (case, name)
        # each verifier accepts the other package's proof
        wt.verify(port_air, wt.Proof.from_bytes(ref), port_pub, port_h)
        verify(jax_air, Proof.from_bytes(by_route[routes[0]]), jax_pub, jax_h)
    if example == "fib":  # the port's host prover too
        assert port_prover(_options(wt, ext_name), wt.Blake3_256).prove(
            port_trace()).to_bytes() == refs["blake3_256"]


def test_port_f128_provers_give_the_reference_derived_bytes():
    """tests/test_reference_full_proof_fixture.py derives the complete bytes
    of a fib2 proof over f128 with Blake3_256 from the reference's sources
    alone; the port's host prover and its F128Prover (here on its default,
    resident route) give them for each case the fixture pins."""
    for num_queries, grinding in ((2, 0), (7, 4)):
        derived = derive_proof_bytes(num_queries, grinding)
        options = wt.ProofOptions(num_queries, BLOWUP, grinding,
                                  wt.FieldExtension.NONE, FOLDING,
                                  REMAINDER_MAX_DEG)
        host = tfib.FibProver(options, wt.Blake3_256).prove(
            tfib.build_fib_trace(wt.F128, 2 * N_ROWS))
        assert host.to_bytes() == derived, (num_queries, grinding)
        dev = F128Prover.accelerate(tfib.FibProver)(
            options, wt.Blake3_256, device="cpu").prove(
                tfib.build_fib_trace(wt.F128, 2 * N_ROWS))
        assert _route_taken() == "resident"
        assert dev.to_bytes() == derived, (num_queries, grinding)


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


def test_port_f128_route_matches_jax_dispatch(monkeypatch):
    """The resident/phased choice equals the JAX LimbFieldProver's
    (device_limb.py:606-616) for each BLAKE3/SHA3 hasher: resident with FRI
    layers, phased without one, with an LDE above the resident limit
    (monkeypatched on both sides) or an OOD row above a lowered byte limit;
    each prove is stopped where its route begins. A hasher the JAX prover
    refuses fails the port's with the same assertion."""
    from winterfell_tpu.prover import device_limb as jax_limb

    monkeypatch.setattr(jax_limb.LimbFieldProver, "_prove_resident",
                        _stop("resident"))
    monkeypatch.setattr(jax_limb, "_commit_pipeline", _stop("phased"))
    monkeypatch.setattr(device_limb.LimbFieldProver, "_prove_resident",
                        _stop("resident"))
    monkeypatch.setattr(device_limb.LimbFieldProver, "_prove_phased",
                        _stop("phased"))
    JaxProver = jax_limb.F128Prover.accelerate(jfib.FibProver)
    PortProver = F128Prover.accelerate(tfib.FibProver)
    # (sequence, FRI folding, remainder degree, resident limit, expected)
    for seq, fold, rem, limit, want in ((64, 4, 7, None, "resident"),
                                        (64, 8, 31, None, "phased"),
                                        (256, 4, 7, 1 << 9, "phased")):
        for mod in (jax_limb, device_limb):
            monkeypatch.setattr(mod, "_LEVEL_FUSE", limit or 1 << 20)
        for name in ("blake3_256", "blake3_192", "sha3_256"):
            jax_opts = ProofOptions(28, 8, 0, FieldExtension.NONE, fold, rem)
            port_opts = wt.ProofOptions(28, 8, 0, wt.FieldExtension.NONE,
                                        fold, rem)
            got = (_route_of(JaxProver(jax_opts, jax_hashers.HASHERS[name]),
                             jfib.build_fib_trace(F128, seq)),
                   _route_of(PortProver(port_opts, port_hashers.HASHERS[name],
                                        device="cpu"),
                             tfib.build_fib_trace(wt.F128, seq)))
            assert got == (want, want), (seq, fold, rem, limit, name)
    # the OOD row's bytes (fib: 2·(2 + 1)·16 = 96) above a lowered limit
    monkeypatch.setattr(port_device, "_OOD_BYTES_LIMIT", 95)
    assert _route_of(PortProver(_options(wt, "NONE"), wt.Blake3_256,
                                device="cpu"),
                     tfib.build_fib_trace(wt.F128, 64)) == "phased"
    # a hasher with no f128 device row hash: Rp64_256
    refused = []
    for prover, trace in (
            (JaxProver(_options(_JaxOpts, "NONE"), jax_hashers.Rp64_256),
             jfib.build_fib_trace(F128, 64)),
            (PortProver(_options(wt, "NONE"), wt.Rp64_256, device="cpu"),
             tfib.build_fib_trace(wt.F128, 64))):
        with pytest.raises(AssertionError) as err:
            prover.prove(trace)
        refused.append(str(err.value))
    assert refused[0] == refused[1]
