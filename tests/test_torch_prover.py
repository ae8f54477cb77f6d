"""The slice as a whole: the port's GoldilocksProver, run on the CPU, gives
the same proof bytes as the JAX package's host FibSmallProver on each of its
three routes (resident, phased + fused FRI, phased + host coin) and with
each f64 hasher (Rp64_256, Blake3_256, Blake3_192, Sha3_256, RpJive64_256),
grinding, sequence assertions and periodic columns included, each
package's verify() accepts the other's proof, and the port picks the route
the JAX package's GoldilocksProver would pick."""

import jax
import pytest

from winterfell_tpu.air import FieldExtension, ProofOptions
from winterfell_tpu.air.proof import Proof
from winterfell_tpu.crypto import hashers as jax_hashers
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
from winterfell_tpu_torch.crypto import hashers as port_hashers
from winterfell_tpu_torch.examples import fibonacci as tfib
from winterfell_tpu_torch.prover import device as port_device
from winterfell_tpu_torch.prover.device import GoldilocksProver
from winterfell_tpu_torch.utils import tracing

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for torch: these proves work on tensors of a few
    thousand rows, where the thread pool only adds overhead, and several
    test workers share the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

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


# (hasher name, extension, partitions, grinding, routes the JAX dispatch
# gives it): the cases of tests/test_device_f64_byte_hashers.py, fib 256
# with ProofOptions(28, 8, grinding, ext, 4, 7), spread over the cases of
# test_port_proof_bytes_equal_jax_host_proof; RpJive64_256 has no device
# coin, so only the host-coin route
_BYTE_HASHER_CASES = {
    (3, "CUBIC"): [("blake3_256", "CUBIC", None, 4, ("resident",)),
                   ("rp_jive64_256", "QUADRATIC", None, 0, ("host",))],
    (5, "CUBIC"): [("blake3_256", "NONE", None, 0, ROUTES),
                   ("sha3_256", "CUBIC", None, 0, ("resident",))],
    (4, "NONE"): [("blake3_256", "CUBIC", None, 0, ROUTES),
                  ("sha3_256", "NONE", None, 0, ROUTES)],
    (4, "QUADRATIC"): [("blake3_192", "CUBIC", None, 0, ROUTES),
                       ("blake3_256", "QUADRATIC", (2, 2), 0,
                        ("resident", "host"))],
}


def _byte_hasher_options(pkg, ext_name, partitions, grinding):
    options = pkg.ProofOptions(28, 8, grinding,
                               getattr(pkg.FieldExtension, ext_name), 4, 7)
    return options.with_partitions(*partitions) if partitions else options


def _pin_byte_hashers(cases, monkeypatch):
    """Blake3_256, Blake3_192, Sha3_256 and RpJive64_256: each route the JAX
    dispatch gives the hasher yields the JAX host prover's bytes (with
    partitions and with grinding 4, whose BLAKE3 nonce scan runs in the
    native library), and each verifier accepts the other package's proof."""
    for name, ext_name, partitions, grinding, routes in cases:
        jax_h, port_h = jax_hashers.HASHERS[name], port_hashers.HASHERS[name]
        ref = FibSmallProver(
            _byte_hasher_options(_JaxOpts, ext_name, partitions, grinding),
            jax_h).prove(build_fib_trace(F64, 256)).to_bytes()
        prover = PortProver(
            _byte_hasher_options(wt, ext_name, partitions, grinding), port_h,
            device="cpu")
        by_route = _prove_on_routes(
            prover, lambda: tfib.build_fib_trace(wt.F64, 256), monkeypatch,
            routes)
        assert by_route == {route: ref for route in routes}, (name, ext_name)
        result = compute_fib_term(F64, 256)
        proof = wt.Proof.from_bytes(ref)
        wt.verify(tfib.FibSmallAir, proof, result, port_h)
        verify(FibSmallAir, Proof.from_bytes(by_route[routes[0]]), result,
               jax_h)


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
    phased route with an empty fold loop, as the JAX package does. Each case
    then pins two of the other hashers' proofs (``_BYTE_HASHER_CASES``)."""
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
        # grinding: the options of tests/test_device_prover.py:58-64
        # (grinding 4) with the Python nonce scan of the Rp64 coin
        ref = FibSmallProver(ProofOptions(28, 8, 4, FieldExtension.CUBIC, 8,
                                          31), Rp64_256).prove(
            build_fib_trace(F64, seq)).to_bytes()
        port = PortProver(wt.ProofOptions(28, 8, 4, wt.FieldExtension.CUBIC,
                                          8, 31), wt.Rp64_256,
                          device="cpu").prove(tfib.build_fib_trace(wt.F64,
                                                                   seq))
        assert port.to_bytes() == ref
    _pin_byte_hashers(_BYTE_HASHER_CASES[log_n, ext_name], monkeypatch)


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
    same shapes and each f64 hasher (RpJive64_256, with no device coin, is
    always phased). Each prove() is stopped where its route begins, before
    any device work (the byte pins above check from the phase marks that a
    forced route runs to its end); where a case needs an LDE above the
    resident limit, the limit is monkeypatched on both sides (proving 2^20
    rows on the CPU would take minutes). A hasher the JAX prover refuses
    (one with no device row hash; Rp62_248, the f62 prover's) fails the
    port's with the same assertion."""
    from winterfell_tpu.prover import device as jax_device

    monkeypatch.setattr(jax_device.GoldilocksProver, "_prove_resident",
                        _stop("resident"))
    monkeypatch.setattr(jax_device, "_commit_pipeline", _stop("phased"))
    monkeypatch.setattr(GoldilocksProver, "_prove_resident",
                        _stop("resident"))
    monkeypatch.setattr(GoldilocksProver, "_prove_phased", _stop("phased"))
    for (log_n, fold, rem_deg, limit, want), name in (
            (case, name) for case in _DISPATCH_CASES
            for name in port_hashers.HASHERS if name != "rp62_248"):
        for mod in (jax_device, port_device):
            monkeypatch.setattr(mod, "_RESIDENT_ON_F64", True)
            monkeypatch.setattr(mod, "_RESIDENT_LIMIT_F64",
                                limit or 1 << 22)
        if name == "rp_jive64_256":
            want = "phased"
        seq = 2 << log_n
        expected = _route_of(
            jax_device.GoldilocksProver.accelerate(FibSmallProver)(
                _options(_JaxOpts, "CUBIC", fold, rem_deg),
                jax_hashers.HASHERS[name]),
            build_fib_trace(F64, seq))
        got = _route_of(PortProver(_options(wt, "CUBIC", fold, rem_deg),
                                   port_hashers.HASHERS[name], device="cpu"),
                        tfib.build_fib_trace(wt.F64, seq))
        assert (got, expected) == (want, want), (log_n, fold, rem_deg, limit,
                                                 name)
    # the byte hashers' OOD row is one BLAKE3 chunk at most on the resident
    # route (the JAX rule ood_bytes <= 1024, device.py:1111-1118; no fib
    # AIR reaches it): below this AIR's 144 OOD bytes they go phased, and
    # Rp64_256 stays resident
    monkeypatch.setattr(port_device, "_OOD_BYTES_LIMIT", 100)
    for name, want in (("blake3_256", "phased"), ("sha3_256", "phased"),
                       ("rp64_256", "resident")):
        got = _route_of(PortProver(_options(wt, "CUBIC", 8, 3),
                                   port_hashers.HASHERS[name], device="cpu"),
                        tfib.build_fib_trace(wt.F64, 16))
        assert got == want, name

    class Other:  # a hasher with no device row hash
        pass

    for jax_h, port_h in ((Other, Other),
                          (jax_hashers.Rp62_248, port_hashers.Rp62_248)):
        refused = []
        for prover, trace in (
                (jax_device.GoldilocksProver.accelerate(FibSmallProver)(
                    _options(_JaxOpts, "CUBIC"), jax_h),
                 build_fib_trace(F64, 16)),
                (PortProver(_options(wt, "CUBIC"), port_h, device="cpu"),
                 tfib.build_fib_trace(wt.F64, 16))):
            with pytest.raises(AssertionError) as err:
                prover.prove(trace)
            refused.append(str(err.value))
        assert refused[0] == refused[1]


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


def _periodic_airs():
    """A small f64 AIR with periodic columns, written once against each
    package: column 0 adds a cycle-8 periodic constant each step, column 1
    adds column 0 where a cycle-4 periodic mask is 1 (a degree-2 product
    with a periodic value). Returns ((JAX prover class, JAX trace), (port
    prover class, port trace), the last value of column 1)."""
    import winterfell_tpu as jwt
    from winterfell_tpu.prover import TraceTable as JaxTraceTable

    p, ks, mask, n = F64.p, [3, 1, 4, 1, 5, 9, 2, 6], [1, 0, 1, 1], 32
    col0, col1 = [0], [1]
    for i in range(n - 1):
        col0.append((col0[-1] + ks[i % 8]) % p)
        col1.append((col1[-1] + mask[i % 4] * col0[-2]) % p)

    def classes(pkg, table_cls):
        class PeriodicAir(pkg.Air):
            base_field = pkg.F64

            def __init__(self, trace_info, pub_inputs, options):
                degrees = [
                    pkg.TransitionConstraintDegree.with_cycles(1, [8]),
                    pkg.TransitionConstraintDegree.with_cycles(1, [4])]
                self.context = pkg.AirContext.new(self.base_field, trace_info,
                                                  degrees, 3, options)
                self.result = pub_inputs

            def pub_inputs_to_elements(self):
                return [(self.result,)]

            def evaluate_transition(self, frame, periodic_values, ops):
                k, m = periodic_values
                cur0, cur1 = frame.current(0), frame.current(1)
                return [ops.sub(frame.next(0), ops.add(cur0, k)),
                        ops.sub(frame.next(1),
                                ops.add(cur1, ops.mul(m, cur0)))]

            def get_assertions(self):
                return [pkg.Assertion.single(0, 0, (0,)),
                        pkg.Assertion.single(1, 0, (1,)),
                        pkg.Assertion.single(1, self.trace_length - 1,
                                             (self.result,))]

            def get_periodic_column_values(self):
                return [list(ks), list(mask)]

        class PeriodicProver(pkg.Prover):
            air_class = PeriodicAir

            def __init__(self, options, hasher):
                super().__init__(options)
                self.hasher = hasher

            def get_pub_inputs(self, trace):
                return int(trace.get(1, trace.length - 1))

        def trace():
            return table_cls.init(pkg.F64, [list(col0), list(col1)])

        return PeriodicProver, trace

    return (classes(jwt, JaxTraceTable), classes(wt, wt.TraceTable),
            col1[-1])


def test_port_sequence_assertions_equal_jax_host_proof(monkeypatch):
    """Sequence assertions (the boundary value polynomials) on the resident
    and fused routes; then periodic columns (an AIR written for each package
    in this file, Blake3_256) on all three routes, against the JAX host
    prover."""
    from tests.test_device_parity import SeqFibProver, build_seqfib_trace

    ref = SeqFibProver(_options(_JaxOpts, "CUBIC"), Rp64_256).prove(
        build_seqfib_trace(32)).to_bytes()
    prover = GoldilocksProver.accelerate(_PortSeqFibProver)(
        _options(wt, "CUBIC"), wt.Rp64_256, device="cpu")
    by_route = _prove_on_routes(
        prover, lambda: tfib.build_fib_trace(wt.F64, 64), monkeypatch,
        ("resident", "fused"))
    assert by_route == {"resident": ref, "fused": ref}

    (jax_prover, jax_trace), (port_prover, port_trace), result = \
        _periodic_airs()
    ref = jax_prover(_options(_JaxOpts, "QUADRATIC"),
                     jax_hashers.Blake3_256).prove(jax_trace()).to_bytes()
    by_route = _prove_on_routes(
        GoldilocksProver.accelerate(port_prover)(
            _options(wt, "QUADRATIC"), wt.Blake3_256, device="cpu"),
        port_trace, monkeypatch)
    assert by_route == {route: ref for route in ROUTES}
    verify(jax_prover.air_class, Proof.from_bytes(by_route["resident"]),
           result, jax_hashers.Blake3_256)
    wt.verify(port_prover.air_class, wt.Proof.from_bytes(ref), result,
              wt.Blake3_256)
