"""The Fibonacci examples (examples/src/fibonacci/): fib2 (width 2, two terms
per row) over f128, the reference's default field, fib_small, the same AIR
over f64 (Goldilocks), fib8 (eight terms per row) and the multiplicative
mulfib2 / mulfib8 over f128; and AuxFibAir, a two-column aux segment over
the f64 fib trace, the port's f64 Randomized AIR (the reference's one
Randomized-AIR example, rescue_raps, is f128)."""

from __future__ import annotations

import numpy as np
import torch

from ..air import Air, AirContext, Assertion, TraceInfo, TransitionConstraintDegree
from ..math.fields import F64, F128, BaseField, Field
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


# ================================================================================
# fib8: 8 Fibonacci terms per row (examples/src/fibonacci/fib8/)
# ================================================================================


def build_fib8_trace(base: BaseField, sequence_length: int) -> TraceTable:
    """Row i holds terms (8i+6, 8i+7) (fib8/prover.rs:32-62)."""
    assert sequence_length & (sequence_length - 1) == 0
    p = base.p
    terms = [1, 1]
    for _ in range(6):
        terms.append((terms[-2] + terms[-1]) % p)
    reg0, reg1 = [terms[6]], [terms[7]]
    for i in range(sequence_length // 8 - 1):
        a, b = reg0[i], reg1[i]
        for _ in range(4):
            a = (a + b) % p
            b = (a + b) % p
        reg0.append(a)
        reg1.append(b)
    return TraceTable.init(base, [reg0, reg1])


class Fib8Air(Air):
    """(examples/src/fibonacci/fib8/air.rs)."""

    base_field: BaseField = F128

    def __init__(self, trace_info: TraceInfo, pub_inputs, options):
        degrees = [TransitionConstraintDegree.new(1), TransitionConstraintDegree.new(1)]
        assert trace_info.width == TRACE_WIDTH
        self.context = AirContext.new(self.base_field, trace_info, degrees, 3, options)
        self.result = pub_inputs

    def pub_inputs_to_elements(self):
        return [(self.result,)]

    def evaluate_transition(self, frame, periodic_values, ops):
        cur0, cur1 = frame.current(0), frame.current(1)
        n = [ops.add(cur0, cur1)]
        n.append(ops.add(cur1, n[0]))
        for k in range(2, 8):
            n.append(ops.add(n[k - 2], n[k - 1]))
        return [
            ops.sub(frame.next(0), n[6]),
            ops.sub(frame.next(1), n[7]),
        ]

    def get_assertions(self):
        p = self.base_field.p
        last_step = self.trace_length - 1
        return [
            Assertion.single(0, 0, (13 % p,)),
            Assertion.single(1, 0, (21 % p,)),
            Assertion.single(1, last_step, (self.result,)),
        ]


class Fib8Prover(FibProver):
    air_class = Fib8Air


# ================================================================================
# mulfib2 / mulfib8: multiplicative Fibonacci (examples/src/fibonacci/mulfib*/)
# ================================================================================


def build_mulfib_trace(base: BaseField, sequence_length: int) -> TraceTable:
    """(mulfib2/prover.rs:32-44)."""
    assert sequence_length & (sequence_length - 1) == 0
    p = base.p
    reg0, reg1 = [1], [2]
    for i in range(sequence_length // 2 - 1):
        reg0.append(reg0[i] * reg1[i] % p)
        reg1.append(reg1[i] * reg0[i + 1] % p)
    return TraceTable.init(base, [reg0, reg1])


def compute_mulfib_term(base: BaseField, n: int) -> int:
    p = base.p
    t0, t1 = 1, 2
    for _ in range(n - 2):
        t0, t1 = t1, t0 * t1 % p
    return t1 if n > 1 else t0


class MulFib2Air(Air):
    """(examples/src/fibonacci/mulfib2/air.rs) — degree-2 constraints."""

    base_field: BaseField = F128

    def __init__(self, trace_info: TraceInfo, pub_inputs, options):
        degrees = [TransitionConstraintDegree.new(2), TransitionConstraintDegree.new(2)]
        assert trace_info.width == TRACE_WIDTH
        self.context = AirContext.new(self.base_field, trace_info, degrees, 3, options)
        self.result = pub_inputs

    def pub_inputs_to_elements(self):
        return [(self.result,)]

    def evaluate_transition(self, frame, periodic_values, ops):
        cur0, cur1 = frame.current(0), frame.current(1)
        nxt0, nxt1 = frame.next(0), frame.next(1)
        return [
            ops.sub(nxt0, ops.mul(cur0, cur1)),
            ops.sub(nxt1, ops.mul(cur1, nxt0)),
        ]

    def get_assertions(self):
        last_step = self.trace_length - 1
        return [
            Assertion.single(0, 0, (1,)),
            Assertion.single(1, 0, (2,)),
            Assertion.single(0, last_step, (self.result,)),
        ]


class MulFib2Prover(Prover):
    air_class = MulFib2Air

    def __init__(self, options, hasher):
        super().__init__(options)
        self.hasher = hasher

    def get_pub_inputs(self, trace):
        return int(trace.get(0, trace.length - 1))


def build_mulfib8_trace(base: BaseField, sequence_length: int) -> TraceTable:
    """8 registers of the multiplicative sequence (mulfib8/prover.rs)."""
    assert sequence_length & (sequence_length - 1) == 0
    p = base.p
    seq = [1, 2]
    for i in range(sequence_length - 2):
        seq.append(seq[i] * seq[i + 1] % p)
    rows = sequence_length // 8
    cols = [[seq[8 * r + c] for r in range(rows)] for c in range(8)]
    return TraceTable.init(base, cols)


class MulFib8Air(Air):
    """(examples/src/fibonacci/mulfib8/air.rs) — width 8, degree 2."""

    base_field: BaseField = F128

    def __init__(self, trace_info: TraceInfo, pub_inputs, options):
        degrees = [TransitionConstraintDegree.new(2) for _ in range(8)]
        assert trace_info.width == 8
        self.context = AirContext.new(self.base_field, trace_info, degrees, 3, options)
        self.result = pub_inputs

    def pub_inputs_to_elements(self):
        return [(self.result,)]

    def evaluate_transition(self, frame, periodic_values, ops):
        cur = [frame.current(i) for i in range(8)]
        nxt = [frame.next(i) for i in range(8)]
        results = [
            ops.sub(nxt[0], ops.mul(cur[6], cur[7])),
            ops.sub(nxt[1], ops.mul(cur[7], nxt[0])),
        ]
        for k in range(2, 8):
            results.append(ops.sub(nxt[k], ops.mul(nxt[k - 2], nxt[k - 1])))
        return results

    def get_assertions(self):
        last_step = self.trace_length - 1
        return [
            Assertion.single(0, 0, (1,)),
            Assertion.single(1, 0, (2,)),
            Assertion.single(6, last_step, (self.result,)),
        ]


class MulFib8Prover(Prover):
    air_class = MulFib8Air

    def __init__(self, options, hasher):
        super().__init__(options)
        self.hasher = hasher

    def get_pub_inputs(self, trace):
        return int(trace.get(6, trace.length - 1))


# ================================================================================
# auxfib: the fib2 trace over f64 with a two-column aux segment
# ================================================================================

AUX_WIDTH = 2
NUM_AUX_RANDS = 1
AUX_STRIDE = 8  # the ramp column's sequence assertion


def build_auxfib_trace(sequence_length: int, device="cpu") -> TraceTable:
    """The fib_small trace, declared with a two-column aux segment."""
    trace = build_fib_trace(F64, sequence_length, device)
    trace.set_aux_shape(AUX_WIDTH, NUM_AUX_RANDS)
    return trace


class AuxFibAir(FibSmallAir):
    """fib_small's constraints plus an aux segment over the random element
    γ: a running product acc' = acc·(s0 + γ) from acc = 1 (degree 2), and a
    ramp r' = r + γ from r = 0 whose values at steps 1 + 8k are asserted as
    one sequence, (1 + 8k)·γ. It drives the aux commitment, the aux
    transition and both kinds of aux boundary constraint (single and
    sequence) of the provers over f64."""

    def __init__(self, trace_info: TraceInfo, pub_inputs, options):
        main_degrees = [TransitionConstraintDegree.new(1),
                        TransitionConstraintDegree.new(1)]
        aux_degrees = [TransitionConstraintDegree.new(2),
                       TransitionConstraintDegree.new(1)]
        self.context = AirContext.new_multi_segment(
            F64, trace_info, main_degrees, aux_degrees, 3, 2, options)
        self.result = pub_inputs

    def evaluate_aux_transition(self, main_frame, aux_frame, periodic_values,
                                aux_rand_elements, ops):
        gamma = ops.lift(aux_rand_elements[0])
        acc, ramp = aux_frame.current(0), aux_frame.current(1)
        term = ops.add(main_frame.current(0), gamma)
        return [ops.sub(aux_frame.next(0), ops.mul(acc, term)),
                ops.sub(aux_frame.next(1), ops.add(ramp, gamma))]

    def get_aux_assertions(self, aux_rand_elements):
        ext = self.ext_field
        gamma = aux_rand_elements[0]
        steps = range(1, self.trace_length, AUX_STRIDE)
        return [Assertion.single(0, 0, ext.one()),
                Assertion.sequence(1, 1, AUX_STRIDE,
                                   [ext.mul_base(gamma, s) for s in steps])]


class AuxFibProver(FibSmallProver):
    air_class = AuxFibAir

    def build_aux_trace(self, trace, aux_rand_elements) -> np.ndarray:
        ext = Field(F64, self.options.field_extension.degree)
        gamma = aux_rand_elements[0]
        n = trace.length
        main = trace.main_segment()
        aux = np.zeros((n, AUX_WIDTH, ext.degree), dtype=object)
        acc, ramp = ext.one(), ext.zero()
        for i in range(n):
            aux[i, 0], aux[i, 1] = list(acc), list(ramp)
            acc = ext.mul(acc, ext.add(ext.from_base(int(main[i, 0])), gamma))
            ramp = ext.add(ramp, gamma)
        return aux
