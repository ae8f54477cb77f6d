"""The Fibonacci examples (examples/src/fibonacci/): fib2 (width 2, two terms
per row) over f128, the reference's default field, and fib_small, the same
AIR over f64 (Goldilocks)."""

from __future__ import annotations

import numpy as np
import torch

from ..air import Air, AirContext, Assertion, TraceInfo, TransitionConstraintDegree
from ..math.fields import F64, F128, BaseField
from ..ops import f128 as f128_ops
from ..ops import goldilocks as gl
from ..prover import Prover, TraceTable

TRACE_WIDTH = 2


def compute_fib_term(base: BaseField, n: int) -> int:
    """n-th term of the 2-term-per-row Fibonacci sequence
    (examples/src/fibonacci/utils.rs:8)."""
    t0, t1 = 1, 1
    for _ in range(n - 1):
        t1 = (t0 + t1) % base.p
        t0, t1 = t1, t0
    return t1


def _fib_rows(base: BaseField, length: int, device) -> torch.Tensor:
    """(length, 2) rows of terms (2i, 2i+1), as (length, 2, 2) word pairs
    over f128. One row step is the linear map M = [[1, 1], [1, 2]]; rows
    [L, 2L) are M^L applied to rows [0, L), so the trace is built by
    log-doubling with the tensor field ops."""
    p = base.p
    if base is F128:
        add, mul = f128_ops.f128_add, f128_ops.f128_mul
        rows = f128_ops.fill(1, (1, 2), device)
    else:
        add, mul = gl.gl_add, gl.gl_mul
        rows = torch.tensor([[1, 1]], dtype=gl.I64, device=device)
    m = ((1, 1), (1, 2))  # M^L for L = current row count
    while rows.shape[0] < length:
        a, b = rows[:, 0], rows[:, 1]
        new_a = add(mul(a, m[0][0]), mul(b, m[0][1]))
        new_b = add(mul(a, m[1][0]), mul(b, m[1][1]))
        rows = torch.cat([rows, torch.stack([new_a, new_b], dim=1)])
        m = tuple(tuple(sum(m[i][k] * m[k][j] for k in range(2)) % p
                        for j in range(2)) for i in range(2))
    return rows[:length]


def build_fib_trace(base: BaseField, sequence_length: int,
                    device="cpu") -> TraceTable:
    """(examples/src/fibonacci/fib2/prover.rs build_trace): row i holds terms
    (2i, 2i+1). The rows are built as a tensor on ``device`` and stored as
    the table's native uint64 rows ((n, 2), or (n, 2, 2) word pairs over
    f128)."""
    assert base in (F64, F128), "the port builds f64 and f128 traces"
    assert sequence_length & (sequence_length - 1) == 0
    length = sequence_length // 2
    trace = TraceTable(base, TRACE_WIDTH, length)
    rows = _fib_rows(base, length, device).cpu().numpy().view(np.uint64)
    trace.set_native_rows(rows.copy())
    return trace


class FibAir(Air):
    """fib2 (examples/src/fibonacci/fib2/air.rs:28-68), over f128."""

    base_field: BaseField = F128

    def __init__(self, trace_info: TraceInfo, pub_inputs, options):
        degrees = [TransitionConstraintDegree.new(1), TransitionConstraintDegree.new(1)]
        assert trace_info.width == TRACE_WIDTH
        self.context = AirContext.new(self.base_field, trace_info, degrees, 3, options)
        self.result = pub_inputs  # base int

    def pub_inputs_to_elements(self):
        return [(self.result,)]

    def evaluate_transition(self, frame, periodic_values, ops):
        cur0, cur1 = frame.current(0), frame.current(1)
        nxt0, nxt1 = frame.next(0), frame.next(1)
        # s0' = s0 + s1 ; s1' = s1 + s0'
        r0 = ops.sub(nxt0, ops.add(cur0, cur1))
        r1 = ops.sub(nxt1, ops.add(cur1, nxt0))
        return [r0, r1]

    def get_assertions(self):
        last_step = self.trace_length - 1
        return [
            Assertion.single(0, 0, (1,)),
            Assertion.single(1, 0, (1,)),
            Assertion.single(1, last_step, (self.result,)),
        ]


class FibSmallAir(FibAir):
    """fib_small: the fib2 AIR over f64
    (examples/src/fibonacci/fib_small/mod.rs:12)."""

    base_field: BaseField = F64


class FibProver(Prover):
    air_class = FibAir

    def __init__(self, options, hasher):
        super().__init__(options)
        self.hasher = hasher

    def get_pub_inputs(self, trace):
        return int(trace.get(1, trace.length - 1))


class FibSmallProver(FibProver):
    air_class = FibSmallAir
