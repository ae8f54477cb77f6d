"""Merkle path verification example (examples/src/merkle/): width-7 f128
trace proving knowledge of a Merkle path, with bit constraints and 8-cycle
periodic masks. Hash is Rescue128 (state 6, rate 4, 7 rounds —
examples/src/utils/rescue.rs)."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Tuple

from ..air import Air, AirContext, Assertion, TraceInfo, TransitionConstraintDegree
from ..math.fields import F128
from ..prover import Prover, TraceTable
from .rescue128_constants import ARK, INV_MDS, MDS

STATE_WIDTH = 6
RATE_WIDTH = 4
NUM_HASH_ROUNDS = 7
HASH_CYCLE_LEN = 8
TRACE_WIDTH = 7
ALPHA = 3
INV_ALPHA = 226854911280625642308916371969163307691

_P = F128.p

HASH_CYCLE_MASK = [1] * NUM_HASH_ROUNDS + [0]


def _sbox(state):
    return [pow(x, ALPHA, _P) for x in state]


def _inv_sbox(state):
    return [pow(x, INV_ALPHA, _P) for x in state]


def _mds_mul(state, mds):
    return [
        sum(mds[i * STATE_WIDTH + j] * state[j] for j in range(STATE_WIDTH)) % _P
        for i in range(STATE_WIDTH)
    ]


def apply_round128(state: List[int], step: int) -> List[int]:
    ark = ARK[step % HASH_CYCLE_LEN]
    state = _mds_mul(_sbox(state), MDS)
    state = [(s + k) % _P for s, k in zip(state, ark[:STATE_WIDTH])]
    state = _mds_mul(_inv_sbox(state), MDS)
    state = [(s + k) % _P for s, k in zip(state, ark[STATE_WIDTH:])]
    return state


def rescue128_digest(data: List[int]) -> Tuple[int, int]:
    """(examples/src/utils/rescue.rs:81-101)."""
    state = [0] * STATE_WIDTH
    i = 0
    for element in data:
        state[i] = (state[i] + element) % _P
        i += 1
        if i % RATE_WIDTH == 0:
            for r in range(NUM_HASH_ROUNDS):
                state = apply_round128(state, r)
            i = 0
    if i > 0:
        for r in range(NUM_HASH_ROUNDS):
            state = apply_round128(state, r)
    return state[0], state[1]


def rescue128_merge(d0: Tuple[int, int], d1: Tuple[int, int]) -> Tuple[int, int]:
    return rescue128_digest([d0[0], d0[1], d1[0], d1[1]])


def build_rescue128_merkle_tree(depth: int, value: Tuple[int, int], index: int):
    """(examples/src/merkle/mod.rs:162-176): random leaves, ours at `index`."""
    rng = random.Random(42)
    n = 1 << depth
    leaves = [rescue128_digest([rng.randrange(_P), rng.randrange(_P)])
              for _ in range(n)]
    leaves[index] = rescue128_digest([value[0], value[1]])
    nodes = [None] * n
    half = n // 2
    for i in range(half):
        nodes[half + i] = rescue128_merge(leaves[2 * i], leaves[2 * i + 1])
    for i in range(half - 1, 0, -1):
        nodes[i] = rescue128_merge(nodes[2 * i], nodes[2 * i + 1])
    return leaves, nodes


def merkle_prove_path(leaves, nodes, index: int):
    """(leaf, sibling chain) like crypto/src/merkle/mod.rs:193-207."""
    n = len(leaves)
    path = [leaves[index ^ 1]]
    idx = (index + n) >> 1
    while idx > 1:
        path.append(nodes[idx ^ 1])
        idx >>= 1
    return leaves[index], path


def build_merkle_trace(value: Tuple[int, int], branch, index: int) -> TraceTable:
    """(examples/src/merkle/prover.rs build_trace). `branch` = [leaf] + path."""
    trace_length = len(branch) * HASH_CYCLE_LEN
    trace = TraceTable(F128, TRACE_WIDTH, trace_length)
    siblings = branch[1:]

    def init(state):
        state[0], state[1] = value
        for i in range(2, TRACE_WIDTH):
            state[i] = 0

    def update(step, state):
        cycle_num = step // HASH_CYCLE_LEN
        cycle_pos = step % HASH_CYCLE_LEN
        if cycle_pos < NUM_HASH_ROUNDS:
            state[:STATE_WIDTH] = apply_round128(state[:STATE_WIDTH], step)
        else:
            node = siblings[cycle_num]
            bit = (index >> cycle_num) & 1
            if bit == 0:
                state[2], state[3] = node
            else:
                state[2], state[3] = state[0], state[1]
                state[0], state[1] = node
            state[4] = 0
            state[5] = 0
            state[6] = bit

    trace.fill(init, update)
    # keep the bit-register constraint degree stable (prover.rs:76-81)
    trace.set(6, 1, 1)
    return trace


@dataclass(frozen=True)
class MerklePublicInputs:
    tree_root: Tuple[int, int]


class MerkleAir(Air):
    """(examples/src/merkle/air.rs:27-121)."""

    def __init__(self, trace_info: TraceInfo, pub_inputs: MerklePublicInputs, options):
        degrees = [
            TransitionConstraintDegree.with_cycles(5, [HASH_CYCLE_LEN])
            for _ in range(6)
        ] + [TransitionConstraintDegree.new(2)]
        assert trace_info.width == TRACE_WIDTH
        self.context = AirContext.new(F128, trace_info, degrees, 4, options)
        self.tree_root = pub_inputs.tree_root

    def pub_inputs_to_elements(self):
        return [(self.tree_root[0],), (self.tree_root[1],)]

    def evaluate_transition(self, frame, periodic_values, ops):
        hash_flag = periodic_values[0]
        ark = periodic_values[1:]
        cur = [frame.current(i) for i in range(TRACE_WIDTH)]
        nxt = [frame.next(i) for i in range(TRACE_WIDTH)]

        # Rescue round constraints on registers [0..6)
        step1 = [ops.exp(c, ALPHA) for c in cur[:STATE_WIDTH]]
        step1 = self._mds(ops, step1, MDS)
        step1 = [ops.add(s, k) for s, k in zip(step1, ark[:STATE_WIDTH])]
        step2 = [ops.sub(x, k) for x, k in zip(nxt[:STATE_WIDTH], ark[STATE_WIDTH:])]
        step2 = self._mds(ops, step2, INV_MDS)
        step2 = [ops.exp(s, ALPHA) for s in step2]
        results = [
            ops.mul(hash_flag, ops.sub(step2[i], step1[i]))
            for i in range(STATE_WIDTH)
        ]

        one = ops.constant(1)
        init_flag = ops.sub(one, hash_flag)
        bit = nxt[6]
        not_bit = ops.sub(one, bit)
        # accumulated hash routed by the index bit (air.rs:86-96)
        results[0] = ops.add(results[0], ops.mul(
            init_flag, ops.mul(not_bit, ops.sub(cur[0], nxt[0]))))
        results[1] = ops.add(results[1], ops.mul(
            init_flag, ops.mul(not_bit, ops.sub(cur[1], nxt[1]))))
        results[2] = ops.add(results[2], ops.mul(
            init_flag, ops.mul(bit, ops.sub(cur[0], nxt[2]))))
        results[3] = ops.add(results[3], ops.mul(
            init_flag, ops.mul(bit, ops.sub(cur[1], nxt[3]))))
        # capacity registers reset
        results[4] = ops.add(results[4], ops.mul(init_flag, nxt[4]))
        results[5] = ops.add(results[5], ops.mul(init_flag, nxt[5]))
        # bit register is binary: b² − b
        results.append(ops.sub(ops.mul(cur[6], cur[6]), cur[6]))
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
            Assertion.single(0, last_step, (self.tree_root[0],)),
            Assertion.single(1, last_step, (self.tree_root[1],)),
            Assertion.periodic(4, 0, HASH_CYCLE_LEN, (0,)),
            Assertion.periodic(5, 0, HASH_CYCLE_LEN, (0,)),
        ]

    def get_periodic_column_values(self):
        result = [list(HASH_CYCLE_MASK)]
        for j in range(STATE_WIDTH * 2):
            result.append([ARK[i][j] for i in range(HASH_CYCLE_LEN)])
        return result


class MerkleProver(Prover):
    air_class = MerkleAir

    def __init__(self, options, hasher, tree_root: Tuple[int, int]):
        super().__init__(options)
        self.hasher = hasher
        self.tree_root = tree_root

    def get_pub_inputs(self, trace):
        return MerklePublicInputs(tree_root=self.tree_root)
