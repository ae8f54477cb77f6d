"""Example runner CLI — the port of winterfell_tpu/examples/cli.py (itself
the reference examples binary, examples/src/main.rs + lib.rs): pick one of
the 13 examples, prove, report timing / proof size / security bits, then
verify. Same examples, flags, defaults and printout.

By default every example proves on the card with the port's device provers:
``F128Prover.accelerate(...)`` for the 12 f128 examples (lamport_threshold
included, which the JAX CLI proves on the host only), and
``GoldilocksProver.accelerate(FibSmallProver)`` for fib_small. ``--cpu``
runs the same provers on the CPU; ``--host`` runs the port's host prover,
what the JAX CLI runs without ``--device``. ``-H`` takes the JAX CLI's
hashers, ``rp62_248`` included; it hashes f62 elements, so the device
provers of these f64 and f128 examples refuse it (as the JAX CLI's
``--device`` does), and the f62 AIR proves with it outside the CLI
(``examples/fib_f62.py``).

Usage:
    python -m winterfell_tpu_torch.examples.cli fib -n 1024
    python -m winterfell_tpu_torch.examples.cli lamport -n 4 --cpu
    python -m winterfell_tpu_torch.examples.cli rescue_raps -n 8 -e 2 --host
"""

from __future__ import annotations

import argparse
import time

from ..air import BatchingMethod, FieldExtension, ProofOptions
from ..crypto.hashers import HASHERS
from ..math.fields import F64, F128
from ..verifier import AcceptableOptions, verify

EXAMPLES = ("fib", "fib2", "fib8", "fib_small", "mulfib", "mulfib8", "vdf",
            "vdfx", "rescue", "rescue_raps", "merkle", "lamport",
            "lamport_threshold")
EXTENSIONS = {1: FieldExtension.NONE, 2: FieldExtension.QUADRATIC,
              3: FieldExtension.CUBIC}


def build_options(args) -> ProofOptions:
    """Defaults mirror examples/src/lib.rs:96-105: FRI folding 8, remainder
    degree 31, Linear batching."""
    return ProofOptions(
        num_queries=args.queries,
        blowup_factor=args.blowup,
        grinding_factor=args.grinding,
        field_extension=EXTENSIONS[args.extension],
        fri_folding_factor=args.folding,
        fri_remainder_max_degree=31,
        batching_constraints=BatchingMethod.LINEAR,
        batching_deep=BatchingMethod.LINEAR,
    )


def _make(cls, backend: str, *args):
    """An instance of the host prover class ``cls`` for ``backend == "host"``,
    else of its device prover subclass (f64 for fib_small's AIR, f128
    otherwise) on ``backend``, "cuda" or "cpu"."""
    if backend == "host":
        return cls(*args)
    if getattr(cls.air_class, "base_field", F128) is F64:
        from ..prover.device import GoldilocksProver as device_prover
    else:
        from ..prover.device_limb import F128Prover as device_prover
    return device_prover.accelerate(cls)(*args, device=backend)


def get_example(name: str, n: int, options: ProofOptions, hasher,
                backend: str = "cuda"):
    """Returns (prover, trace, air_class), as the JAX CLI's get_example."""
    if name in ("fib", "fib2"):
        from .fibonacci import FibAir, FibProver, build_fib_trace
        return (_make(FibProver, backend, options, hasher),
                build_fib_trace(F128, n), FibAir)
    if name == "fib8":
        from .fibonacci import Fib8Air, Fib8Prover, build_fib8_trace
        return (_make(Fib8Prover, backend, options, hasher),
                build_fib8_trace(F128, n), Fib8Air)
    if name == "fib_small":
        from .fibonacci import FibSmallAir, FibSmallProver, build_fib_trace
        return (_make(FibSmallProver, backend, options, hasher),
                build_fib_trace(F64, n), FibSmallAir)
    if name == "mulfib":
        from .fibonacci import MulFib2Air, MulFib2Prover, build_mulfib_trace
        return (_make(MulFib2Prover, backend, options, hasher),
                build_mulfib_trace(F128, n), MulFib2Air)
    if name == "mulfib8":
        from .fibonacci import MulFib8Air, MulFib8Prover, build_mulfib8_trace
        return (_make(MulFib8Prover, backend, options, hasher),
                build_mulfib8_trace(F128, n), MulFib8Air)
    if name == "vdf":
        from .vdf import VdfAir, VdfProver, build_vdf_trace
        return (_make(VdfProver, backend, options, hasher),
                build_vdf_trace(F128, 123, n), VdfAir)
    if name == "vdfx":
        from .vdf import VdfExemptAir, VdfExemptProver, build_vdf_trace_exempt
        return (_make(VdfExemptProver, backend, options, hasher),
                build_vdf_trace_exempt(F128, 123, n), VdfExemptAir)
    if name == "rescue":
        from .rescue import RescueAir, RescueProver, build_rescue_trace
        return (_make(RescueProver, backend, options, hasher),
                build_rescue_trace((42, 43), n), RescueAir)
    if name == "rescue_raps":
        from .rescue_raps import (RescueRapsAir, RescueRapsProver,
                                  build_raps_trace)
        seeds = [(i + 1, i + 2) for i in range(n)]
        permuted = seeds[2:] + seeds[:2]
        return (_make(RescueRapsProver, backend, options, hasher),
                build_raps_trace(seeds, permuted), RescueRapsAir)
    if name == "merkle":
        from .merkle import (MerkleAir, MerkleProver, build_merkle_trace,
                             build_rescue128_merkle_tree, merkle_prove_path)
        value, index = (42, 43), 13 % (1 << n)
        leaves, nodes = build_rescue128_merkle_tree(n, value, index)
        leaf, path = merkle_prove_path(leaves, nodes, index)
        return (_make(MerkleProver, backend, options, hasher, nodes[1]),
                build_merkle_trace(value, [leaf] + path, index), MerkleAir)
    if name == "lamport":
        from .lamport import (LamportAggregateAir, LamportAggregateProver,
                              build_lamport_trace, sign_messages)
        pks, msgs, sigs = sign_messages(n)
        return (_make(LamportAggregateProver, backend, options, hasher, pks,
                      msgs),
                build_lamport_trace(msgs, sigs), LamportAggregateAir)
    if name == "lamport_threshold":
        # reference examples/src/lamport/threshold/mod.rs:70-92 — n signers
        # (n+1 a power of two), ~2/3 of them sign; here the subset is
        # deterministic (every signer except each third) instead of random.
        from .lamport import PrivateKey, message_to_elements
        from .lamport_threshold import (AggPublicKey, LamportThresholdAir,
                                        LamportThresholdProver,
                                        build_threshold_trace)
        msg = b"test message"
        keys = [PrivateKey(200 + i) for i in range(n)]
        pub_key = AggPublicKey([k.pub_key() for k in keys])
        # signature index refers to the SORTED key order inside AggPublicKey
        sorted_keys = sorted(range(n), key=lambda i: keys[i].pub_key())
        signer_indexes = [i for i in range(n) if i % 3 != 2]
        signatures = [(si, keys[sorted_keys[si]].sign(msg))
                      for si in signer_indexes]
        prover = _make(LamportThresholdProver, backend, options, hasher,
                       pub_key, message_to_elements(msg), len(signatures))
        return (prover, build_threshold_trace(pub_key,
                                              message_to_elements(msg),
                                              signatures),
                LamportThresholdAir)
    raise SystemExit(f"unknown example: {name}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="winterfell_tpu_torch example runner")
    parser.add_argument("example", choices=EXAMPLES)
    parser.add_argument("-n", type=int, default=1024,
                        help="size parameter (sequence length / chain length / "
                             "tree depth / #signatures)")
    parser.add_argument("-q", "--queries", type=int, default=28)
    parser.add_argument("-b", "--blowup", type=int, default=8)
    parser.add_argument("-g", "--grinding", type=int, default=16)
    parser.add_argument("-e", "--extension", type=int, default=1,
                        choices=[1, 2, 3])
    parser.add_argument("-f", "--folding", type=int, default=8)
    parser.add_argument("-H", "--hash", dest="hash_fn", default="blake3_256",
                        choices=sorted(HASHERS))
    where = parser.add_mutually_exclusive_group()
    where.add_argument("--cpu", dest="backend", action="store_const",
                       const="cpu", help="run the device provers on the CPU")
    where.add_argument("--host", dest="backend", action="store_const",
                       const="host", help="run the host prover")
    args = parser.parse_args(argv)

    options = build_options(args)
    hasher = HASHERS[args.hash_fn]

    t0 = time.time()
    prover, trace, air_class = get_example(
        args.example, args.n, options, hasher, args.backend or "cuda")
    print(f"Built execution trace of {trace.info().width}x{trace.length} "
          f"in {1000 * (time.time() - t0):.0f} ms")

    t0 = time.time()
    proof = prover.prove(trace)
    prove_ms = 1000 * (time.time() - t0)
    data = proof.to_bytes()
    conj = proof.conjectured_security(hasher)
    print(f"Proof generated in {prove_ms:.0f} ms")
    print(f"Proof size: {len(data) / 1024:.1f} KB")
    print(f"Conjectured security: {conj.bits} bits")

    pub_inputs = prover.get_pub_inputs(trace)
    t0 = time.time()
    verify(air_class, proof, pub_inputs, hasher,
           AcceptableOptions(option_set=[options]))
    print(f"Proof verified in {1000 * (time.time() - t0):.1f} ms")


if __name__ == "__main__":
    main()
