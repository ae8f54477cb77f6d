"""Aux segments (Randomized AIR) in the port's one device pipeline: the port's
GoldilocksProver and F128Prover, run on the CPU, give the same proof bytes
as the JAX package's host provers for a multi-segment AIR on both phased
routes (fused FRI, host coin), with the resident switch left on — a
multi-segment AIR never takes the resident route, in either package.

- f64: the port's AuxFibAir (examples/fibonacci.py: a running product and
  a ramp with a sequence assertion over γ), written here for the JAX
  package too, with Rp64_256 and the cubic extension and with Blake3_256
  and the quadratic one;
- f128: the reference's rescue_raps (aux width 3, 3 random elements) with
  Blake3_256 without and with the quadratic extension, and once with
  Sha3_256; the port's host prover gives the same bytes.

Each package's verify() accepts the other's proof. The JAX F128Prover is
not run (its XLA:CPU compiles crash in long processes); the JAX host
provers are the byte reference."""

import jax
import numpy as np
import pytest

from winterfell_tpu.air import (AirContext, Assertion, FieldExtension,
                                ProofOptions, TransitionConstraintDegree)
from winterfell_tpu.air.proof import Proof
from winterfell_tpu.crypto import hashers as jax_hashers
from winterfell_tpu.examples import fibonacci as jfib
from winterfell_tpu.examples import rescue_raps as jraps
from winterfell_tpu.math.fields import F64, Field
from winterfell_tpu.verifier import verify
import winterfell_tpu_torch as wt
from winterfell_tpu_torch.crypto import hashers as port_hashers
from winterfell_tpu_torch.examples import fibonacci as tfib
from winterfell_tpu_torch.examples import rescue_raps as traps
from winterfell_tpu_torch.prover import device as port_device
from winterfell_tpu_torch.prover import device_limb
from winterfell_tpu_torch.prover.device import GoldilocksProver
from winterfell_tpu_torch.prover.device_limb import F128Prover
from winterfell_tpu_torch.utils import tracing

jax.config.update("jax_platforms", "cpu")

SEQ = 64  # fib sequence length: a trace of 32 rows


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for torch (small tensors; several test workers
    share the cores)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the f64 aux AIR in the JAX package's terms (examples/fibonacci.py's
# AuxFibAir of the port) ------------------------------------------------------


class JaxAuxFibAir(jfib.FibSmallAir):
    def __init__(self, trace_info, pub_inputs, options):
        self.context = AirContext.new_multi_segment(
            F64, trace_info,
            [TransitionConstraintDegree.new(1)] * 2,
            [TransitionConstraintDegree.new(2),
             TransitionConstraintDegree.new(1)], 3, 2, options)
        self.result = pub_inputs

    def evaluate_aux_transition(self, main_frame, aux_frame, periodic_values,
                                aux_rand_elements, ops):
        gamma = ops.lift(aux_rand_elements[0])
        acc, ramp = aux_frame.current(0), aux_frame.current(1)
        term = ops.add(main_frame.current(0), gamma)
        return [ops.sub(aux_frame.next(0), ops.mul(acc, term)),
                ops.sub(aux_frame.next(1), ops.add(ramp, gamma))]

    def get_aux_assertions(self, aux_rand_elements):
        ext, gamma = self.ext_field, aux_rand_elements[0]
        steps = range(1, self.trace_length, tfib.AUX_STRIDE)
        return [Assertion.single(0, 0, ext.one()),
                Assertion.sequence(1, 1, tfib.AUX_STRIDE,
                                   [ext.mul_base(gamma, s) for s in steps])]


class JaxAuxFibProver(jfib.FibSmallProver):
    air_class = JaxAuxFibAir

    def build_aux_trace(self, trace, aux_rand_elements):
        ext = Field(F64, self.options.field_extension.degree)
        gamma, main = aux_rand_elements[0], trace.main_segment()
        aux = np.zeros((trace.length, 2, ext.degree), dtype=object)
        acc, ramp = ext.one(), ext.zero()
        for i in range(trace.length):
            aux[i, 0], aux[i, 1] = list(acc), list(ramp)
            acc = ext.mul(acc, ext.add(ext.from_base(int(main[i, 0])), gamma))
            ramp = ext.add(ramp, gamma)
        return aux


def _jax_auxfib_trace():
    trace = jfib.build_fib_trace(F64, SEQ)
    trace.set_aux_shape(tfib.AUX_WIDTH, tfib.NUM_AUX_RANDS)
    return trace


def _raps_seeds(n=4):
    seeds = [(i + 1, i + 2) for i in range(n)]
    return seeds, seeds[2:] + seeds[:2]


def _options(pkg, ext_name):
    """Folding 4, remainder degree 7: FRI layers at these sizes, so the two
    phased routes differ."""
    return pkg.ProofOptions(28, 8, 0, getattr(pkg.FieldExtension, ext_name),
                            4, 7)


class _JaxOpts:
    ProofOptions, FieldExtension = ProofOptions, FieldExtension


def _route_taken() -> str:
    names = [s["name"] for s in tracing.last_spans()]
    if "resident_pipeline" in names:
        return "resident"
    return "fused" if "fri_layers_fused" in names else "host"


# (field, hasher, extension, whether the port's host prover is pinned too)
_CASES = {
    "f64": [("rp64_256", "CUBIC", False), ("blake3_256", "QUADRATIC", True)],
    "f128": [("blake3_256", "NONE", True), ("blake3_256", "QUADRATIC", False),
             ("sha3_256", "NONE", False)],
}


@pytest.mark.parametrize("field", list(_CASES))
def test_port_aux_proof_bytes_equal_jax_host_proof(field, monkeypatch):
    """The phased routes of the port's device prover (the resident switch
    on: the dispatch must still take a phased route) give the JAX host
    prover's bytes; each verifier accepts the other package's proof."""
    if field == "f64":
        jax_prover, port_prover = JaxAuxFibProver, tfib.AuxFibProver
        jax_air, port_air = JaxAuxFibAir, tfib.AuxFibAir
        jax_trace = _jax_auxfib_trace
        port_trace = lambda: tfib.build_auxfib_trace(SEQ)  # noqa: E731
        device_prover = GoldilocksProver
        switches = (port_device, "_RESIDENT_ON_F64", "_FUSED_FRI_ON")
    else:
        seeds, permuted = _raps_seeds()
        jax_prover, port_prover = jraps.RescueRapsProver, traps.RescueRapsProver
        jax_air, port_air = jraps.RescueRapsAir, traps.RescueRapsAir
        jax_trace = lambda: jraps.build_raps_trace(seeds, permuted)  # noqa: E731
        port_trace = lambda: traps.build_raps_trace(seeds, permuted)  # noqa: E731
        device_prover = F128Prover
        switches = (device_limb, "_RESIDENT_ON", "_FUSED_FRI_ON")
    mod, resident_on, fused_on = switches
    for name, ext_name, pin_host in _CASES[field]:
        jax_h, port_h = jax_hashers.HASHERS[name], port_hashers.HASHERS[name]
        ref = jax_prover(_options(_JaxOpts, ext_name), jax_h).prove(
            jax_trace()).to_bytes()
        prover = device_prover.accelerate(port_prover)(
            _options(wt, ext_name), port_h, device="cpu")
        for route in ("fused", "host"):
            monkeypatch.setattr(mod, resident_on, True)
            monkeypatch.setattr(mod, fused_on, route == "fused")
            got = prover.prove(port_trace()).to_bytes()
            assert _route_taken() == route, (field, name, ext_name)
            assert got == ref, (field, name, ext_name, route)
        if pin_host:
            assert port_prover(_options(wt, ext_name), port_h).prove(
                port_trace()).to_bytes() == ref, (field, name, ext_name)
        port_pub = prover.get_pub_inputs(port_trace())
        jax_pub = jax_prover(_options(_JaxOpts, ext_name),
                             jax_h).get_pub_inputs(jax_trace())
        wt.verify(port_air, wt.Proof.from_bytes(ref), port_pub, port_h)
        verify(jax_air, Proof.from_bytes(got), jax_pub, jax_h)


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


def test_multi_segment_air_never_takes_the_resident_route(monkeypatch):
    """With every switch on and a size where the single-segment AIR of the
    same trace goes resident, both packages' dispatch sends the aux AIR to
    the phased route (winterfell_tpu/prover/device.py:1125,
    device_limb.py:611); each prove is stopped where its route begins."""
    from winterfell_tpu.prover import device as jax_device
    from winterfell_tpu.prover import device_limb as jax_limb

    for jax_mod, jax_cls, port_cls in (
            (jax_device, jax_device.GoldilocksProver, GoldilocksProver),
            (jax_limb, jax_limb.LimbFieldProver, F128Prover)):
        monkeypatch.setattr(jax_cls, "_prove_resident", _stop("resident"))
        monkeypatch.setattr(jax_mod, "_commit_pipeline", _stop("phased"))
        monkeypatch.setattr(port_cls, "_prove_resident", _stop("resident"))
        monkeypatch.setattr(port_cls, "_prove_phased", _stop("phased"))
    monkeypatch.setattr(port_device, "_RESIDENT_ON_F64", True)
    monkeypatch.setattr(device_limb, "_RESIDENT_ON", True)
    seeds, permuted = _raps_seeds()
    cases = [
        # (JAX prover, JAX trace, port prover, port trace, extension, the
        # route both must take): fib_small's single segment as the control
        (jax_device.GoldilocksProver.accelerate(jfib.FibSmallProver),
         lambda: jfib.build_fib_trace(F64, SEQ),
         GoldilocksProver.accelerate(tfib.FibSmallProver),
         lambda: tfib.build_fib_trace(wt.F64, SEQ), "CUBIC", "resident"),
        (jax_device.GoldilocksProver.accelerate(JaxAuxFibProver),
         _jax_auxfib_trace, GoldilocksProver.accelerate(tfib.AuxFibProver),
         lambda: tfib.build_auxfib_trace(SEQ), "CUBIC", "phased"),
        (jax_limb.F128Prover.accelerate(jraps.RescueRapsProver),
         lambda: jraps.build_raps_trace(seeds, permuted),
         F128Prover.accelerate(traps.RescueRapsProver),
         lambda: traps.build_raps_trace(seeds, permuted), "NONE", "phased"),
    ]
    for jax_p, jax_t, port_p, port_t, ext_name, want in cases:
        for name in ("blake3_256", "rp64_256"):
            if name == "rp64_256" and port_p.engine is not port_device.gl:
                continue
            got = (_route_of(jax_p(_options(_JaxOpts, ext_name),
                                   jax_hashers.HASHERS[name]), jax_t()),
                   _route_of(port_p(_options(wt, ext_name),
                                    port_hashers.HASHERS[name], device="cpu"),
                             port_t()))
            assert got == (want, want), (port_p.__name__, name)
