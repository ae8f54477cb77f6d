"""Fibonacci over f62: the two-column AIR the JAX package proves over its
62-bit field (tests/test_e2e_f62.py:22-67, ``FibF62Air``, ``FibF62Prover``,
``_trace``), with the same constraints, assertions and trace. The reference
runs no example over f62; the JAX package pins the field with this AIR, and
the port proves it with ``F62Prover`` (``prover/device_limb.py``). It is not
an example of the CLI, as in the JAX package.

Row 0 is (1, 1); each step sets s0' = s0 + s1 and s1' = s1 + s0', so row i
holds the terms (2i, 2i + 1) of the sequence 1, 1, 2, 3, ...; the public
input is the last row's second term.
"""

from __future__ import annotations

import numpy as np

from ..air import (
    Air,
    AirContext,
    Assertion,
    TraceInfo,
    TransitionConstraintDegree,
)
from ..math.fields import F62
from ..prover import Prover, TraceTable


class FibF62Air(Air):
    base_field = F62

    def __init__(self, trace_info: TraceInfo, pub_inputs, options):
        degrees = [TransitionConstraintDegree.new(1),
                   TransitionConstraintDegree.new(1)]
        self.context = AirContext.new(F62, trace_info, degrees, 3, options)
        self.result = pub_inputs

    def pub_inputs_to_elements(self):
        return [(self.result,)]

    def evaluate_transition(self, frame, periodic_values, ops):
        c0, c1 = frame.current(0), frame.current(1)
        n0, n1 = frame.next(0), frame.next(1)
        return [ops.sub(n0, ops.add(c0, c1)), ops.sub(n1, ops.add(c1, n0))]

    def get_assertions(self):
        last = self.trace_length - 1
        return [
            Assertion.single(0, 0, (1,)),
            Assertion.single(1, 0, (1,)),
            Assertion.single(1, last, (self.result,)),
        ]


class FibF62Prover(Prover):
    air_class = FibF62Air

    def __init__(self, options, hasher):
        super().__init__(options)
        self.hasher = hasher

    def get_pub_inputs(self, trace):
        return int(trace.get(1, trace.length - 1))


def build_fib_f62_trace(n: int = 64) -> TraceTable:
    """The n-row trace of ``_trace`` (tests/test_e2e_f62.py:56-66), held as
    the table's native uint64 rows (n, 2)."""
    p = F62.p
    rows = np.empty((n, 2), dtype=np.uint64)
    a, b = 1, 1
    rows[0] = (a, b)
    for step in range(1, n):
        a = (a + b) % p
        b = (a + b) % p
        rows[step] = (a, b)
    trace = TraceTable(F62, 2, n)
    trace.set_native_rows(rows)
    return trace
