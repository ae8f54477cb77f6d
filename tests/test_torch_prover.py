"""The slice as a whole: the port's GoldilocksProver, run on the CPU, gives
the same proof bytes as the JAX package's host FibSmallProver on each of its
three routes (resident, phased + fused FRI, phased + host coin), each
package's verify() accepts the other's proof, and the port picks the route
the JAX package's GoldilocksProver would pick."""

import jax
import pytest

from winterfell_tpu.air import FieldExtension, ProofOptions
from winterfell_tpu.air.proof import Proof
from winterfell_tpu.crypto.hashers import Rp64_256
from winterfell_tpu.examples.fibonacci import (
    FibSmallAir,
    FibSmallProver,
    build_fib_trace,
    compute_fib_term,
)
from winterfell_tpu.math.fields import F64
from winterfell_tpu.verifier import verify
import winterfell_tpu_torch as wt
from winterfell_tpu_torch.examples import fibonacci as tfib
from winterfell_tpu_torch.prover import device as port_device
from winterfell_tpu_torch.prover.device import GoldilocksProver
from winterfell_tpu_torch.utils import tracing

jax.config.update("jax_platforms", "cpu")

PortProver = GoldilocksProver.accelerate(tfib.FibSmallProver)
ROUTES = ("resident", "fused", "host")
# FRI folding 8 and remainder degree 3: every byte pin below has one FRI
# layer, so the three routes differ (with bench_fib's remainder degree 31 a
# trace of 2^5 or fewer rows has none, and every route is the host coin's)
FOLD, REM_DEG = 8, 3


def _options(pkg, ext_name, fold=FOLD, rem_deg=REM_DEG):
    return pkg.ProofOptions(32, 8, 0, getattr(pkg.FieldExtension, ext_name),
                            fold, rem_deg)


class _JaxOpts:
    ProofOptions, FieldExtension = ProofOptions, FieldExtension


def _route_taken() -> str:
    """The route of the last port prove, read from its phase marks."""
    names = [s["name"] for s in tracing.last_spans()]
    if "resident_pipeline" in names:
        return "resident"
    return "fused" if "fri_layers_fused" in names else "host"


def _prove_on_routes(prover, trace_fn, monkeypatch, routes=ROUTES):
    """{route: proof bytes}: one prove per route, each forced through the
    port's switches (WINTER_RESIDENT, WINTER_FUSED_FRI) and checked from the
    phase marks to have run on that route."""
    out = {}
    for route in routes:
        monkeypatch.setattr(port_device, "_RESIDENT_ON_F64",
                            route == "resident")
        monkeypatch.setattr(port_device, "_FUSED_FRI_ON", route != "host")
        out[route] = prover.prove(trace_fn()).to_bytes()
        assert _route_taken() == route
    return out


# the case that also pins the host-coin route (it differs from the fused
# route only in the FRI phase) and bench_fib's options (no FRI layer)
_FULL_CASE = (3, "CUBIC")


@pytest.mark.parametrize("log_n,ext_name", [(3, "CUBIC"), (5, "CUBIC"),
                                            (4, "NONE"), (4, "QUADRATIC")])
def test_port_proof_bytes_equal_jax_host_proof(log_n, ext_name, monkeypatch):
    """Each route's bytes equal the JAX host prover's (computed once for
    the routes), and each verifier accepts the other package's proof. One
    case also runs the host-coin route, and bench_fib's remainder degree 31,
    where the trace has no FRI layer: every switch setting then takes the
    phased route with an empty fold loop, as the JAX package does."""
    seq = 2 << log_n
    full = (log_n, ext_name) == _FULL_CASE
    routes = ROUTES if full else ("resident", "fused")
    ref = FibSmallProver(_options(_JaxOpts, ext_name), Rp64_256).prove(
        build_fib_trace(F64, seq)).to_bytes()
    prover = PortProver(_options(wt, ext_name), wt.Rp64_256, device="cpu")
    by_route = _prove_on_routes(
        prover, lambda: tfib.build_fib_trace(wt.F64, seq), monkeypatch,
        routes)
    assert by_route == {route: ref for route in routes}

    result = compute_fib_term(F64, seq)
    assert tfib.compute_fib_term(wt.F64, seq) == result
    wt.verify(tfib.FibSmallAir, wt.Proof.from_bytes(ref), result, wt.Rp64_256)
    verify(FibSmallAir, Proof.from_bytes(by_route["resident"]), result,
           Rp64_256)
    if full:
        ref = FibSmallProver(_options(_JaxOpts, ext_name, 8, 31),
                             Rp64_256).prove(build_fib_trace(F64, seq))
        monkeypatch.setattr(port_device, "_RESIDENT_ON_F64", True)
        monkeypatch.setattr(port_device, "_FUSED_FRI_ON", True)
        port = PortProver(_options(wt, ext_name, 8, 31), wt.Rp64_256,
                          device="cpu").prove(tfib.build_fib_trace(wt.F64,
                                                                   seq))
        assert _route_taken() == "host"
        assert port.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("batching,partitions", [("LINEAR", 2),
                                                  ("ALGEBRAIC", 1),
                                                  ("HORNER", 1)])
def test_port_proof_with_batching_and_partitions(batching, partitions,
                                                 monkeypatch):
    """Other constraint/DEEP batching methods, and PartitionOptions(2, 1):
    each trace column hashed alone, the column digests combined with
    merge_many (row_matrix.rs:184-229). The coefficient draws run on the
    device coin in the resident route and on the host coin in both phased
    ones (which differ only in the FRI phase, pinned above), so the fused
    route adds nothing here."""
    from winterfell_tpu.air import BatchingMethod, PartitionOptions

    ref_b = getattr(BatchingMethod, batching)
    ref_opts = ProofOptions(32, 8, 0, FieldExtension.CUBIC, FOLD, REM_DEG,
                            ref_b, ref_b, PartitionOptions(partitions, 1))
    ref = FibSmallProver(ref_opts, Rp64_256).prove(
        build_fib_trace(F64, 16)).to_bytes()
    port_b = getattr(wt.BatchingMethod, batching)
    port_opts = wt.ProofOptions(32, 8, 0, wt.FieldExtension.CUBIC, FOLD,
                                REM_DEG, port_b, port_b,
                                wt.PartitionOptions(partitions, 1))
    by_route = _prove_on_routes(
        PortProver(port_opts, wt.Rp64_256, device="cpu"),
        lambda: tfib.build_fib_trace(wt.F64, 16), monkeypatch,
        ("resident", "host"))
    assert by_route == {"resident": ref, "host": ref}


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


# (log_n, FRI folding, remainder degree, resident limit or None, expected)
_DISPATCH_CASES = [
    (3, 8, 31, None, "phased"),     # no FRI layer
    (3, 8, 3, None, "resident"),    # one layer
    (4, 4, 7, None, "resident"),    # one layer, remainder 32
    (5, 2, 3, None, "resident"),    # three layers
    (5, 8, 3, 1 << 7, "phased"),    # LDE 2^8 above a resident limit of 2^7
]


def test_port_route_matches_jax_dispatch(monkeypatch):
    """The resident/phased choice equals the JAX GoldilocksProver's for the
    same shapes. Each prove() is stopped where its route begins, before any
    device work (the byte pins above check from the phase marks that a
    forced route runs to its end); where a case needs an LDE above the
    resident limit, the limit is monkeypatched on both sides (proving 2^20
    rows on the CPU would take minutes)."""
    from winterfell_tpu.prover import device as jax_device

    monkeypatch.setattr(jax_device.GoldilocksProver, "_prove_resident",
                        _stop("resident"))
    monkeypatch.setattr(jax_device, "_commit_pipeline", _stop("phased"))
    monkeypatch.setattr(GoldilocksProver, "_prove_resident",
                        _stop("resident"))
    monkeypatch.setattr(GoldilocksProver, "_prove_phased", _stop("phased"))
    for log_n, fold, rem_deg, limit, want in _DISPATCH_CASES:
        for mod in (jax_device, port_device):
            monkeypatch.setattr(mod, "_RESIDENT_ON_F64", True)
            monkeypatch.setattr(mod, "_RESIDENT_LIMIT_F64",
                                limit or 1 << 22)
        seq = 2 << log_n
        expected = _route_of(
            jax_device.GoldilocksProver.accelerate(FibSmallProver)(
                _options(_JaxOpts, "CUBIC", fold, rem_deg), Rp64_256),
            build_fib_trace(F64, seq))
        got = _route_of(PortProver(_options(wt, "CUBIC", fold, rem_deg),
                                   wt.Rp64_256, device="cpu"),
                        tfib.build_fib_trace(wt.F64, seq))
        assert (got, expected) == (want, want), (log_n, fold, rem_deg, limit)


def test_port_host_prover_bytes_equal_jax_host_prover():
    ref = FibSmallProver(_options(_JaxOpts, "CUBIC", 8, 31), Rp64_256).prove(
        build_fib_trace(F64, 16))
    port = tfib.FibSmallProver(_options(wt, "CUBIC", 8, 31), wt.Rp64_256).prove(
        tfib.build_fib_trace(wt.F64, 16))
    assert port.to_bytes() == ref.to_bytes()


def test_port_trace_equals_jax_trace():
    ours = tfib.build_fib_trace(wt.F64, 512).native_rows()
    ref = build_fib_trace(F64, 512)
    assert [[int(v) for v in r] for r in ours] == \
        [[int(v) for v in r] for r in ref.main_segment()]


def test_cuda_device_is_never_a_silent_fallback():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PortProver(_options(wt, "CUBIC"), wt.Rp64_256)


class _PortSeqFibAir(wt.Air):
    """The port's twin of tests/test_device_parity.py:SeqFibAir: the fib
    constraints plus a SEQUENCE assertion on column 0 (boundary value
    polynomials, air/src/air/boundary/mod.rs:42-144)."""

    base_field = wt.F64

    def __init__(self, trace_info, pub_inputs, options):
        degrees = [wt.TransitionConstraintDegree.new(1),
                   wt.TransitionConstraintDegree.new(1)]
        self.context = wt.AirContext.new(wt.F64, trace_info, degrees, 3,
                                         options)
        self.seq_values, self.result = pub_inputs

    def pub_inputs_to_elements(self):
        return [(v,) for v in self.seq_values] + [(self.result,)]

    def evaluate_transition(self, frame, periodic_values, ops):
        cur0, cur1 = frame.current(0), frame.current(1)
        nxt0, nxt1 = frame.next(0), frame.next(1)
        return [ops.sub(nxt0, ops.add(cur0, cur1)),
                ops.sub(nxt1, ops.add(cur1, nxt0))]

    def get_assertions(self):
        n = self.trace_length
        return [
            wt.Assertion.single(1, 0, (1,)),
            wt.Assertion.single(1, n - 1, (self.result,)),
            wt.Assertion.sequence(0, 0, n // 4,
                                  [(v,) for v in self.seq_values]),
        ]


class _PortSeqFibProver(wt.Prover):
    air_class = _PortSeqFibAir

    def __init__(self, options, hasher):
        super().__init__(options)
        self.hasher = hasher

    def get_pub_inputs(self, trace):
        n = trace.length
        seq = [int(trace.get(0, i * (n // 4))) for i in range(4)]
        return (tuple(seq), int(trace.get(1, n - 1)))


def test_port_sequence_assertions_equal_jax_host_proof(monkeypatch):
    from tests.test_device_parity import SeqFibProver, build_seqfib_trace

    ref = SeqFibProver(_options(_JaxOpts, "CUBIC"), Rp64_256).prove(
        build_seqfib_trace(32)).to_bytes()
    prover = GoldilocksProver.accelerate(_PortSeqFibProver)(
        _options(wt, "CUBIC"), wt.Rp64_256, device="cpu")
    by_route = _prove_on_routes(
        prover, lambda: tfib.build_fib_trace(wt.F64, 64), monkeypatch,
        ("resident", "fused"))
    assert by_route == {"resident": ref, "fused": ref}
