"""The Rescue hash-chain example (examples/src/rescue/): a width-4 trace over
f128, cycles of 16 steps (14 hash rounds, then 2 copy steps), 4 degree-3
constraints under a cycle-16 periodic mask and 8 periodic round-constant
columns. It is the reference's headline benchmark computation (its README's
Rescue table; bench.py's ``rescue_f128``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..air import Air, AirContext, Assertion, TraceInfo, TransitionConstraintDegree
from ..math.fields import F128
from ..prover import Prover, TraceTable
from .rescue_f128_constants import ARK, INV_MDS, MDS

STATE_WIDTH = 4
CYCLE_LENGTH = 16
NUM_HASH_ROUNDS = 14
TRACE_WIDTH = 4
ALPHA = 3
INV_ALPHA = 226854911280625642308916371969163307691

_P = F128.p

CYCLE_MASK = [1] * NUM_HASH_ROUNDS + [0] * (CYCLE_LENGTH - NUM_HASH_ROUNDS)


def _apply_mds(state, mds=MDS):
    return [
        sum(mds[i * STATE_WIDTH + j] * state[j] for j in range(STATE_WIDTH)) % _P
        for i in range(STATE_WIDTH)
    ]


def apply_round(state: List[int], step: int) -> List[int]:
    """One Rescue round (examples/src/rescue/rescue.rs:21-34)."""
    ark = ARK[step % CYCLE_LENGTH]
    state = [pow(x, ALPHA, _P) for x in state]
    state = _apply_mds(state)
    state = [(s + k) % _P for s, k in zip(state, ark[:STATE_WIDTH])]
    state = [pow(x, INV_ALPHA, _P) for x in state]
    state = _apply_mds(state)
    return [(s + k) % _P for s, k in zip(state, ark[STATE_WIDTH:])]


def rescue_hash(value: Tuple[int, int]) -> Tuple[int, int]:
    state = [value[0], value[1], 0, 0]
    for i in range(NUM_HASH_ROUNDS):
        state = apply_round(state, i)
    return state[0], state[1]


def compute_hash_chain(seed: Tuple[int, int], chain_length: int) -> Tuple[int, int]:
    values = seed
    for _ in range(chain_length):
        values = rescue_hash(values)
    return values


def build_rescue_trace_py(seed: Tuple[int, int], iterations: int) -> TraceTable:
    """(examples/src/rescue/prover.rs build_trace) in Python ints: the
    oracle of the native builder."""
    trace = TraceTable(F128, TRACE_WIDTH, iterations * CYCLE_LENGTH)

    def init(state):
        state[0], state[1], state[2], state[3] = seed[0], seed[1], 0, 0

    def update(step, state):
        if step % CYCLE_LENGTH < NUM_HASH_ROUNDS:
            state[:] = apply_round(state, step)
        else:
            state[2] = 0
            state[3] = 0

    trace.fill(init, update)
    return trace


def build_rescue_trace(seed: Tuple[int, int], iterations: int) -> TraceTable:
    """The chain's trace, built by native/f128.c (``crypto/native.py``) where
    the C compiler is present: the chain is serial, and the Python rounds
    take seconds per thousand rows. The (n, 4, 2) word rows upload to the
    f128 prover as they are. Without a compiler, the Python builder."""
    from ..crypto import native

    if not native.f128_available():
        return build_rescue_trace_py(seed, iterations)
    trace = TraceTable(F128, TRACE_WIDTH, iterations * CYCLE_LENGTH)
    trace.set_native_rows(native.rescue128_trace(seed, iterations, MDS, ARK,
                                                 INV_ALPHA))
    return trace


@dataclass(frozen=True)
class RescuePublicInputs:
    seed: Tuple[int, int]
    result: Tuple[int, int]


class RescueAir(Air):
    """(examples/src/rescue/air.rs:18-127)."""

    def __init__(self, trace_info: TraceInfo, pub_inputs: RescuePublicInputs, options):
        degrees = [
            TransitionConstraintDegree.with_cycles(3, [CYCLE_LENGTH])
            for _ in range(4)
        ]
        assert trace_info.width == TRACE_WIDTH
        self.context = AirContext.new(F128, trace_info, degrees, 4, options)
        self.seed = pub_inputs.seed
        self.result = pub_inputs.result

    def pub_inputs_to_elements(self):
        return [(self.seed[0],), (self.seed[1],), (self.result[0],), (self.result[1],)]

    def evaluate_transition(self, frame, periodic_values, ops):
        hash_flag = periodic_values[0]
        ark = periodic_values[1:]
        cur = [frame.current(i) for i in range(STATE_WIDTH)]
        nxt = [frame.next(i) for i in range(STATE_WIDTH)]

        # hash rounds: S-box, MDS and constants forward from the current row
        # equal the inverse direction from the next (rescue.rs:37-69)
        step1 = [ops.exp(c, ALPHA) for c in cur]
        step1 = self._mds(ops, step1, MDS)
        step1 = [ops.add(s, k) for s, k in zip(step1, ark[:STATE_WIDTH])]
        step2 = [ops.sub(n, k) for n, k in zip(nxt, ark[STATE_WIDTH:])]
        step2 = self._mds(ops, step2, INV_MDS)
        step2 = [ops.exp(s, ALPHA) for s in step2]

        one = ops.constant(1)
        copy_flag = ops.sub(one, hash_flag)

        # copy steps: registers 0, 1 carried over; 2, 3 reset to zero
        copy_targets = [
            ops.sub(cur[0], nxt[0]),
            ops.sub(cur[1], nxt[1]),
            nxt[2],
            nxt[3],
        ]
        results = []
        for i in range(STATE_WIDTH):
            hash_term = ops.mul(hash_flag, ops.sub(step2[i], step1[i]))
            copy_term = ops.mul(copy_flag, copy_targets[i])
            results.append(ops.add(hash_term, copy_term))
        return results

    @staticmethod
    def _mds(ops, state, mds):
        out = []
        for i in range(STATE_WIDTH):
            acc = ops.mul_base(state[0], mds[i * STATE_WIDTH])
            for j in range(1, STATE_WIDTH):
                acc = ops.add(acc, ops.mul_base(state[j], mds[i * STATE_WIDTH + j]))
            out.append(acc)
        return out

    def get_assertions(self):
        last_step = self.trace_length - 1
        return [
            Assertion.single(0, 0, (self.seed[0],)),
            Assertion.single(1, 0, (self.seed[1],)),
            Assertion.single(0, last_step, (self.result[0],)),
            Assertion.single(1, last_step, (self.result[1],)),
        ]

    def get_periodic_column_values(self):
        # the mask column and the 8 round-constant columns (air.rs:119-124)
        result = [list(CYCLE_MASK)]
        for j in range(STATE_WIDTH * 2):
            result.append([ARK[i][j] for i in range(CYCLE_LENGTH)])
        return result


class RescueProver(Prover):
    air_class = RescueAir

    def __init__(self, options, hasher):
        super().__init__(options)
        self.hasher = hasher

    def get_pub_inputs(self, trace):
        last = trace.length - 1
        return RescuePublicInputs(
            seed=(trace.get(0, 0), trace.get(1, 0)),
            result=(trace.get(0, last), trace.get(1, last)),
        )
