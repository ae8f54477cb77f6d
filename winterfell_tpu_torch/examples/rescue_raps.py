"""Rescue RAPs example (examples/src/rescue_raps/): two parallel Rescue hash
chains absorbing permuted seed sets, tied together by a Randomized AIR
permutation argument over a 3-column auxiliary segment (aux width 3, 3 random
elements — custom_trace_table.rs:92, air.rs:73-80)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..air import Air, AirContext, Assertion, TraceInfo, TransitionConstraintDegree
from ..math.fields import F128, Field
from ..prover import Prover, TraceTable
from .rescue import (
    ALPHA,
    ARK,
    CYCLE_LENGTH,
    INV_MDS,
    MDS,
    NUM_HASH_ROUNDS,
    STATE_WIDTH,
    apply_round,
)

TRACE_WIDTH = 2 * STATE_WIDTH  # 8
AUX_WIDTH = 3
NUM_AUX_RANDS = 3

_P = F128.p

CYCLE_MASK = [1] * NUM_HASH_ROUNDS + [0] * (CYCLE_LENGTH - NUM_HASH_ROUNDS)
ABSORPTION_MASK = [0] * NUM_HASH_ROUNDS + [1, 0]


def compute_permuted_hash_chains(seeds: List[Tuple[int, int]],
                                 permuted_seeds: List[Tuple[int, int]]):
    """Two absorbing hash chains (examples/src/rescue_raps/mod.rs:168+)."""
    def chain(sds):
        state = [sds[0][0], sds[0][1], 0, 0]
        for idx in range(len(sds)):
            for step in range(NUM_HASH_ROUNDS):
                state = apply_round(state, step)
            if idx + 1 < len(sds):
                state[0] = (state[0] + sds[idx + 1][0]) % _P
                state[1] = (state[1] + sds[idx + 1][1]) % _P
        return (state[0], state[1])

    return [chain(seeds), chain(permuted_seeds)]


def build_raps_trace(seeds: List[Tuple[int, int]],
                     permuted_seeds: List[Tuple[int, int]]) -> TraceTable:
    """(examples/src/rescue_raps/prover.rs build_trace)."""
    assert len(seeds) == len(permuted_seeds)
    trace_length = len(seeds) * CYCLE_LENGTH
    trace = TraceTable(F128, TRACE_WIDTH, trace_length)
    trace.set_aux_shape(AUX_WIDTH, NUM_AUX_RANDS)

    def init(state):
        state[0], state[1], state[2], state[3] = seeds[0][0], seeds[0][1], 0, 0
        state[4], state[5] = permuted_seeds[0][0], permuted_seeds[0][1]
        state[6], state[7] = 0, 0

    def update(step, state):
        phase = step % CYCLE_LENGTH
        if phase < NUM_HASH_ROUNDS:
            state[:STATE_WIDTH] = apply_round(state[:STATE_WIDTH], step)
            state[STATE_WIDTH:] = apply_round(state[STATE_WIDTH:], step)
        elif phase == NUM_HASH_ROUNDS:
            idx = step // CYCLE_LENGTH + 1
            if idx < len(seeds):
                state[0] = (state[0] + seeds[idx][0]) % _P
                state[1] = (state[1] + seeds[idx][1]) % _P
                state[4] = (state[4] + permuted_seeds[idx][0]) % _P
                state[5] = (state[5] + permuted_seeds[idx][1]) % _P

    trace.fill(init, update)
    return trace


@dataclass(frozen=True)
class RapsPublicInputs:
    result: Tuple[Tuple[int, int], Tuple[int, int]]


class RescueRapsAir(Air):
    """(examples/src/rescue_raps/air.rs:54-253)."""

    def __init__(self, trace_info: TraceInfo, pub_inputs: RapsPublicInputs, options):
        main_degrees = [
            TransitionConstraintDegree.with_cycles(3, [CYCLE_LENGTH])
            for _ in range(TRACE_WIDTH)
        ]
        aux_degrees = [
            TransitionConstraintDegree.with_cycles(1, [CYCLE_LENGTH]),
            TransitionConstraintDegree.with_cycles(1, [CYCLE_LENGTH]),
            TransitionConstraintDegree.new(2),
        ]
        assert trace_info.width == TRACE_WIDTH + AUX_WIDTH
        self.context = AirContext.new_multi_segment(
            F128, trace_info, main_degrees, aux_degrees, 8, 2, options)
        self.result = pub_inputs.result

    def pub_inputs_to_elements(self):
        return [(self.result[0][0],), (self.result[0][1],),
                (self.result[1][0],), (self.result[1][1],)]

    # -- main constraints ---------------------------------------------------

    def evaluate_transition(self, frame, periodic_values, ops):
        hash_flag = periodic_values[0]
        absorption_flag = periodic_values[1]
        ark = periodic_values[2:]
        cur = [frame.current(i) for i in range(TRACE_WIDTH)]
        nxt = [frame.next(i) for i in range(TRACE_WIDTH)]

        results = [None] * TRACE_WIDTH
        for half in (0, 1):
            off = half * STATE_WIDTH
            c = cur[off : off + STATE_WIDTH]
            x = nxt[off : off + STATE_WIDTH]
            step1 = [ops.exp(v, ALPHA) for v in c]
            step1 = _mds(ops, step1, MDS)
            step1 = [ops.add(s, k) for s, k in zip(step1, ark[:STATE_WIDTH])]
            step2 = [ops.sub(n, k) for n, k in zip(x, ark[STATE_WIDTH:])]
            step2 = _mds(ops, step2, INV_MDS)
            step2 = [ops.exp(s, ALPHA) for s in step2]
            for i in range(STATE_WIDTH):
                results[off + i] = ops.mul(hash_flag, ops.sub(step2[i], step1[i]))

        # absorption: capacity registers (2,3,6,7) unchanged (air.rs:131-137)
        for i in (2, 3, 6, 7):
            results[i] = ops.add(
                results[i], ops.mul(absorption_flag, ops.sub(cur[i], nxt[i])))

        # copy steps: all registers carried over (air.rs:262-270)
        copy_flag = ops.sub(ops.constant(1), ops.add(hash_flag, absorption_flag))
        for i in range(TRACE_WIDTH):
            results[i] = ops.add(
                results[i], ops.mul(copy_flag, ops.sub(cur[i], nxt[i])))
        return results

    # -- aux constraints ----------------------------------------------------

    def evaluate_aux_transition(self, main_frame, aux_frame, periodic_values,
                                aux_rand_elements, ops):
        absorption_flag = periodic_values[1]
        a0 = ops.lift(aux_rand_elements[0])
        a1 = ops.lift(aux_rand_elements[1])
        gamma = ops.lift(aux_rand_elements[2])

        mc = [main_frame.current(i) for i in range(TRACE_WIDTH)]
        mn = [main_frame.next(i) for i in range(TRACE_WIDTH)]
        ac = [aux_frame.current(i) for i in range(AUX_WIDTH)]
        an = [aux_frame.next(i) for i in range(AUX_WIDTH)]

        copied_1 = ops.add(
            ops.mul(a0, ops.sub(mn[0], mc[0])), ops.mul(a1, ops.sub(mn[1], mc[1])))
        copied_2 = ops.add(
            ops.mul(a0, ops.sub(mn[4], mc[4])), ops.mul(a1, ops.sub(mn[5], mc[5])))
        r0 = ops.mul(absorption_flag, ops.sub(ac[0], copied_1))
        r1 = ops.mul(absorption_flag, ops.sub(ac[1], copied_2))
        r2 = ops.sub(
            ops.mul(an[2], ops.add(ac[1], gamma)),
            ops.mul(ac[2], ops.add(ac[0], gamma)))
        return [r0, r1, r2]

    # -- assertions ----------------------------------------------------------

    def get_assertions(self):
        last_step = self.trace_length - 1
        return [
            Assertion.single(2, 0, (0,)),
            Assertion.single(3, 0, (0,)),
            Assertion.single(6, 0, (0,)),
            Assertion.single(7, 0, (0,)),
            Assertion.single(0, last_step, (self.result[0][0],)),
            Assertion.single(1, last_step, (self.result[0][1],)),
            Assertion.single(4, last_step, (self.result[1][0],)),
            Assertion.single(5, last_step, (self.result[1][1],)),
        ]

    def get_aux_assertions(self, aux_rand_elements):
        ext = self.ext_field
        last_step = self.trace_length - 1
        return [
            Assertion.single(2, 0, ext.one()),
            Assertion.single(2, last_step, ext.one()),
        ]

    def get_periodic_column_values(self):
        result = [list(CYCLE_MASK), list(ABSORPTION_MASK)]
        for j in range(STATE_WIDTH * 2):
            result.append([ARK[i][j] for i in range(CYCLE_LENGTH)])
        return result


def _mds(ops, state, mds):
    out = []
    for i in range(STATE_WIDTH):
        acc = ops.mul_base(state[0], mds[i * STATE_WIDTH])
        for j in range(1, STATE_WIDTH):
            acc = ops.add(acc, ops.mul_base(state[j], mds[i * STATE_WIDTH + j]))
        out.append(acc)
    return out


class RescueRapsProver(Prover):
    air_class = RescueRapsAir

    def __init__(self, options, hasher):
        super().__init__(options)
        self.hasher = hasher

    def get_pub_inputs(self, trace):
        last = trace.length - 1
        return RapsPublicInputs(result=(
            (trace.get(0, last), trace.get(1, last)),
            (trace.get(4, last), trace.get(5, last)),
        ))

    def build_aux_trace(self, trace, aux_rand_elements) -> np.ndarray:
        """(examples/src/rescue_raps/prover.rs build_aux_trace). The running
        product divides by (col1 + γ) at every row; the denominators are
        inverted together (Montgomery's trick: one inversion and three
        products each), which takes most of the host time out of the
        per-row field inversions."""
        ext = Field(F128, self.options.field_extension.degree)

        n = trace.length
        main = trace.main_segment()
        a0, a1, gamma = aux_rand_elements[:3]

        aux = np.zeros((n, AUX_WIDTH, ext.degree), dtype=object)

        def combine(r0, r1):
            return ext.add(ext.mul_base(a0, r0), ext.mul_base(a1, r1))

        col0 = [ext.zero()] * n
        col1 = [ext.zero()] * n
        col0[0] = combine(int(main[0, 0]), int(main[0, 1]))
        col1[0] = combine(int(main[0, 4]), int(main[0, 5]))
        for index in range(NUM_HASH_ROUNDS, n - 1, CYCLE_LENGTH):
            col0[index] = combine(
                (int(main[index + 1, 0]) - int(main[index, 0])) % _P,
                (int(main[index + 1, 1]) - int(main[index, 1])) % _P)
            col1[index] = combine(
                (int(main[index + 1, 4]) - int(main[index, 4])) % _P,
                (int(main[index + 1, 5]) - int(main[index, 5])) % _P)
        dens = [ext.add(c, gamma) for c in col1[:-1]]
        prefix = [ext.one()]
        for den in dens:
            prefix.append(ext.mul(prefix[-1], den))
        inv = ext.inv(prefix[-1])
        col2 = [ext.one()] * n
        ratios = [None] * (n - 1)
        for i in range(n - 2, -1, -1):
            ratios[i] = ext.mul(ext.add(col0[i], gamma),
                                ext.mul(inv, prefix[i]))
            inv = ext.mul(inv, dens[i])
        for index in range(1, n):
            col2[index] = ext.mul(col2[index - 1], ratios[index - 1])

        for i in range(n):
            aux[i, 0] = list(col0[i])
            aux[i, 1] = list(col1[i])
            aux[i, 2] = list(col2[i])
        return aux
