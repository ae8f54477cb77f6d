"""VDF examples (examples/src/vdf/): x ← (x − 42)^(1/3) over f128; the
transition constraint checks cur − (next³ + 42) = 0 (degree 3).

The `exempt` variant puts garbage in the last trace row and uses 2 transition
exemptions (examples/src/vdf/exempt/air.rs:47)."""

from __future__ import annotations

from dataclasses import dataclass

from ..air import Air, AirContext, Assertion, TraceInfo, TransitionConstraintDegree
from ..math.fields import F128, BaseField
from ..prover import Prover, TraceTable

ALPHA = 3
INV_ALPHA = 226854911280625642308916371969163307691  # 1/3 mod (p-1), f128
FORTY_TWO = 42
TRACE_WIDTH = 1


@dataclass(frozen=True)
class VdfInputs:
    seed: int
    result: int


def execute_vdf(base: BaseField, seed: int, num_steps: int) -> int:
    state = seed % base.p
    for _ in range(num_steps):
        state = pow((state - FORTY_TWO) % base.p, INV_ALPHA, base.p)
    return state


def build_vdf_trace(base: BaseField, seed: int, n: int) -> TraceTable:
    """Regular variant: n rows, each the VDF state."""
    column = [seed % base.p]
    state = seed % base.p
    for _ in range(n - 1):
        state = pow((state - FORTY_TWO) % base.p, INV_ALPHA, base.p)
        column.append(state)
    return TraceTable.init(base, [column])


def build_vdf_trace_exempt(base: BaseField, seed: int, n: int) -> TraceTable:
    """Exempt variant: last row is garbage (examples/src/vdf/exempt/prover.rs)."""
    column = [seed % base.p]
    state = seed % base.p
    for _ in range(n - 2):
        state = pow((state - FORTY_TWO) % base.p, INV_ALPHA, base.p)
        column.append(state)
    column.append(123)
    return TraceTable.init(base, [column])


class VdfAir(Air):
    base_field = F128
    num_exemptions = 1

    def __init__(self, trace_info: TraceInfo, pub_inputs: VdfInputs, options):
        degrees = [TransitionConstraintDegree.new(3)]
        assert trace_info.width == TRACE_WIDTH
        ctx = AirContext.new(self.base_field, trace_info, degrees, 2, options)
        if self.num_exemptions != 1:
            ctx = ctx.set_num_transition_exemptions(self.num_exemptions)
        self.context = ctx
        self.seed = pub_inputs.seed
        self.result = pub_inputs.result

    def pub_inputs_to_elements(self):
        return [(self.seed,), (self.result,)]

    def evaluate_transition(self, frame, periodic_values, ops):
        cur = frame.current(0)
        nxt = frame.next(0)
        return [ops.sub(cur, ops.add(ops.exp(nxt, ALPHA), ops.constant(FORTY_TWO)))]

    def get_assertions(self):
        last_step = self.trace_length - self.num_exemptions
        return [
            Assertion.single(0, 0, (self.seed,)),
            Assertion.single(0, last_step, (self.result,)),
        ]


class VdfExemptAir(VdfAir):
    num_exemptions = 2

    def get_assertions(self):
        # result asserted on the second-to-last step (exempt/air.rs:66-74)
        return [
            Assertion.single(0, 0, (self.seed,)),
            Assertion.single(0, self.trace_length - 2, (self.result,)),
        ]


class VdfProver(Prover):
    air_class = VdfAir

    def __init__(self, options, hasher):
        super().__init__(options)
        self.hasher = hasher

    def get_pub_inputs(self, trace):
        return VdfInputs(seed=trace.get(0, 0), result=trace.get(0, trace.length - 1))


class VdfExemptProver(VdfProver):
    air_class = VdfExemptAir

    def get_pub_inputs(self, trace):
        return VdfInputs(seed=trace.get(0, 0), result=trace.get(0, trace.length - 2))
