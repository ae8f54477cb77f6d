"""Lamport+ threshold signature example (examples/src/lamport/threshold/):
width-28 f128 trace — the reference's largest AIR. Each 1024-step signature
cycle verifies one Lamport signature (three Rescue128 sponges) AND an
in-circuit Merkle membership path of the previous cycle's public key against
an aggregated public-key root, plus a running signature counter."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..air import Air, AirContext, Assertion, TraceInfo, TransitionConstraintDegree
from ..math.fields import F128
from ..prover import Prover, TraceTable
from .lamport import (
    HASH_CYCLE_LEN,
    SIG_CYCLE_LEN,
    Signature,
    _build_key_schedule,
)
from .merkle import (
    ARK,
    INV_MDS,
    MDS,
    NUM_HASH_ROUNDS,
    STATE_WIDTH,
    apply_round128,
    rescue128_digest,
    rescue128_merge,
)

TRACE_WIDTH = 28
ALPHA = 3
_P = F128.p

HASH_CYCLE_MASK = [1] * NUM_HASH_ROUNDS + [0]
ZERO_KEY = (0, 0)


class AggPublicKey:
    """Merkle tree over Rescue128 digests of the individual public keys
    (threshold/signature.rs:19-87)."""

    def __init__(self, keys: List[Tuple[int, int]]):
        self.keys = sorted(keys)
        leaves = [rescue128_digest(list(k)) for k in self.keys]
        n = len(leaves)
        num_leaves = (n + 1 if n & (n - 1) == 0 else n)
        p = 1
        while p < num_leaves:
            p *= 2
        zero_hash = rescue128_digest([0, 0])
        leaves += [zero_hash] * (p - n)
        self.leaves = leaves
        half = p // 2
        nodes: List = [None] * p
        for i in range(half):
            nodes[half + i] = rescue128_merge(leaves[2 * i], leaves[2 * i + 1])
        for i in range(half - 1, 0, -1):
            nodes[i] = rescue128_merge(nodes[2 * i], nodes[2 * i + 1])
        self.nodes = nodes

    @property
    def root(self) -> Tuple[int, int]:
        return self.nodes[1]

    def num_keys(self) -> int:
        return len(self.keys)

    def num_leaves(self) -> int:
        return len(self.leaves)

    def get_key(self, index: int) -> Tuple[int, int]:
        return self.keys[index] if index < len(self.keys) else ZERO_KEY

    def get_leaf_path(self, index: int) -> List[Tuple[int, int]]:
        """[leaf, sibling chain] (threshold/signature.rs:80-86)."""
        n = len(self.leaves)
        path = [self.leaves[index], self.leaves[index ^ 1]]
        idx = (index + n) >> 1
        while idx > 1:
            path.append(self.nodes[idx ^ 1])
            idx >>= 1
        return path


def _sig_index_to_key_index(sig_index: int, num_cycles: int) -> int:
    return num_cycles - 1 if sig_index == 0 else sig_index - 1


def build_threshold_trace(pub_key: AggPublicKey, message: Tuple[int, int],
                          signatures: List[Tuple[int, Signature]]) -> TraceTable:
    """(threshold/prover.rs build_trace)."""
    num_cycles = pub_key.num_leaves()
    trace = TraceTable(F128, TRACE_WIDTH, SIG_CYCLE_LEN * num_cycles)
    powers_of_two = [pow(2, i, _P) for i in range(128)]

    signature_map: Dict[int, Signature] = {i: s for i, s in signatures}
    sig_count = [0]
    for i in range(1, num_cycles):
        sig_count.append(sig_count[i - 1] + (1 if (i - 1) in signature_map else 0))
    zero_sig = Signature(ones=[ZERO_KEY] * 254, zeros=[ZERO_KEY] * 254)

    m0, m1 = message
    for i in range(num_cycles):
        sig = signature_map.get(i, zero_sig)
        sig_flag = 1 if i in signature_map else 0
        key_index = _sig_index_to_key_index(i, num_cycles)
        sec1, sec2, pub1, pub2 = _build_key_schedule(m0, m1, sig)
        key_path = pub_key.get_leaf_path(key_index)
        pk = pub_key.get_key(key_index)
        base = i * SIG_CYCLE_LEN

        state = [0] * TRACE_WIDTH
        state[0], state[1] = sec1[0]
        state[6], state[7] = sec2[0]
        state[18], state[19] = pk
        state[24] = key_index & 1
        state[26] = sig_flag
        state[27] = sig_count[i]
        trace.update_row(base, state)

        for step in range(SIG_CYCLE_LEN - 1):
            cycle_num = step // HASH_CYCLE_LEN
            cycle_step = step % HASH_CYCLE_LEN
            if cycle_step < NUM_HASH_ROUNDS:
                state[0:6] = apply_round128(state[0:6], cycle_step)
                state[6:12] = apply_round128(state[6:12], cycle_step)
                state[12:18] = apply_round128(state[12:18], cycle_step)
                state[18:24] = apply_round128(state[18:24], cycle_step)
            else:
                m0_bit = (m0 >> cycle_num) & 1
                m1_bit = (m1 >> cycle_num) & 1
                mp_bit = state[24]
                # public key aggregation (prover.rs update_pub_key_hash)
                k1 = (state[0], state[1]) if m0_bit else pub1[cycle_num]
                k2 = (state[6], state[7]) if m1_bit else pub2[cycle_num]
                state[12] = (state[12] + k1[0]) % _P
                state[13] = (state[13] + k1[1]) % _P
                state[14] = (state[14] + k2[0]) % _P
                state[15] = (state[15] + k2[1]) % _P
                # next secret keys
                state[0:2] = sec1[cycle_num + 1]
                state[2:6] = [0, 0, 0, 0]
                state[6:8] = sec2[cycle_num + 1]
                state[8:12] = [0, 0, 0, 0]
                # merkle path index accumulator (update_merkle_path_index)
                state[24] = (key_index >> (cycle_num + 1)) & 1
                state[25] = (state[25] + powers_of_two[cycle_num] * mp_bit) % _P
                # merkle path hashing registers (update_merkle_path_hash)
                h1, h2 = state[18], state[19]
                node = key_path[(cycle_num + 1) % len(key_path)]
                if mp_bit == 1:
                    state[18], state[19], state[20], state[21] = node[0], node[1], h1, h2
                else:
                    state[18], state[19], state[20], state[21] = h1, h2, node[0], node[1]
                state[22] = 0
                state[23] = 0
            trace.update_row(base + step + 1, state)
    return trace


@dataclass(frozen=True)
class ThresholdPublicInputs:
    pub_key_root: Tuple[int, int]
    num_pub_keys: int
    num_signatures: int
    message: Tuple[int, int]


class LamportThresholdAir(Air):
    """(examples/src/lamport/threshold/air.rs)."""

    def __init__(self, trace_info: TraceInfo, pub_inputs: ThresholdPublicInputs,
                 options):
        def deg(base, cycles):
            return TransitionConstraintDegree.with_cycles(base, cycles)

        degrees = (
            [deg(5, [HASH_CYCLE_LEN, SIG_CYCLE_LEN])] * 24
            + [deg(2, [HASH_CYCLE_LEN, SIG_CYCLE_LEN]),
               deg(1, [HASH_CYCLE_LEN, SIG_CYCLE_LEN, SIG_CYCLE_LEN]),
               deg(2, [SIG_CYCLE_LEN]),
               deg(1, [SIG_CYCLE_LEN]),
               deg(2, [SIG_CYCLE_LEN]),
               deg(2, [SIG_CYCLE_LEN])]
        )
        assert trace_info.width == TRACE_WIDTH
        self.context = AirContext.new(F128, trace_info, degrees, 26, options)
        self.pub_key_root = pub_inputs.pub_key_root
        self.num_pub_keys = pub_inputs.num_pub_keys
        self.num_signatures = pub_inputs.num_signatures
        self.message = pub_inputs.message

    def pub_inputs_to_elements(self):
        return [(self.pub_key_root[0],), (self.pub_key_root[1],),
                (self.num_pub_keys,), (self.num_signatures,),
                (self.message[0],), (self.message[1],)]

    def evaluate_transition(self, frame, periodic_values, ops):
        sig_cycle_end_flag = periodic_values[0]
        power_of_two = periodic_values[1]
        m0_bit = periodic_values[2]
        m1_bit = periodic_values[3]
        hash_flag = periodic_values[4]
        ark = periodic_values[5:]
        cur = [frame.current(i) for i in range(TRACE_WIDTH)]
        nxt = [frame.next(i) for i in range(TRACE_WIDTH)]
        one = ops.constant(1)
        not_end = ops.sub(one, sig_cycle_end_flag)

        results = [None] * (TRACE_WIDTH + 2)

        # hash steps: four Rescue sponges + copy of regs 24/25 (air.rs:258-264)
        flag = ops.mul(not_end, hash_flag)
        for slot, off in ((0, 0), (6, 6), (12, 12), (18, 18)):
            r = self._enforce_round(ops, cur[off : off + 6], nxt[off : off + 6], ark)
            for j in range(6):
                results[slot + j] = ops.mul(flag, r[j])
        results[24] = ops.mul(flag, ops.sub(cur[24], nxt[24]))
        results[25] = ops.mul(flag, ops.sub(cur[25], nxt[25]))

        # bit-injection steps (air.rs:267-310)
        flag = ops.mul(not_end, ops.sub(one, hash_flag))

        def agg(slot, f, term):
            results[slot] = ops.add(results[slot], ops.mul(f, term))

        for slot, col in zip(range(0, 8), (2, 3, 4, 5, 8, 9, 10, 11)):
            agg(slot, flag, nxt[col])
        agg(8, flag, ops.sub(cur[16], nxt[16]))
        agg(9, flag, ops.sub(cur[17], nxt[17]))
        fm0 = ops.mul(flag, m0_bit)
        agg(10, fm0, ops.sub(ops.add(cur[12], cur[0]), nxt[12]))
        agg(11, fm0, ops.sub(ops.add(cur[13], cur[1]), nxt[13]))
        fm1 = ops.mul(flag, m1_bit)
        agg(16, fm1, ops.sub(ops.add(cur[14], cur[6]), nxt[14]))
        agg(17, fm1, ops.sub(ops.add(cur[15], cur[7]), nxt[15]))

        mp_bit = cur[24]
        not_mp = ops.sub(one, mp_bit)
        agg(18, ops.mul(flag, not_mp), ops.sub(cur[18], nxt[18]))
        agg(19, ops.mul(flag, not_mp), ops.sub(cur[19], nxt[19]))
        agg(20, ops.mul(flag, mp_bit), ops.sub(cur[18], nxt[20]))
        agg(21, ops.mul(flag, mp_bit), ops.sub(cur[19], nxt[21]))
        agg(22, flag, nxt[22])
        agg(23, flag, nxt[23])
        agg(24, flag, ops.sub(ops.mul(cur[24], cur[24]), cur[24]))
        agg(25, flag, ops.sub(ops.add(cur[25], ops.mul(cur[24], power_of_two)),
                              nxt[25]))

        # signature flag/count (air.rs:313-331)
        sig_flag = cur[26]
        results[26] = ops.mul(not_end, ops.sub(sig_flag, nxt[26]))
        agg(26, sig_cycle_end_flag,
            ops.sub(ops.mul(sig_flag, sig_flag), sig_flag))
        results[27] = ops.mul(not_end, ops.sub(cur[27], nxt[27]))
        agg(27, sig_cycle_end_flag,
            ops.sub(ops.add(cur[27], sig_flag), nxt[27]))
        end_sig = ops.mul(sig_cycle_end_flag, sig_flag)
        results[28] = ops.mul(end_sig, ops.sub(cur[12], nxt[18]))
        results[29] = ops.mul(end_sig, ops.sub(cur[13], nxt[19]))
        return results[:30]

    @staticmethod
    def _enforce_round(ops, cur, nxt, ark):
        step1 = [ops.exp(c, ALPHA) for c in cur]
        step1 = LamportThresholdAir._mds(ops, step1, MDS)
        step1 = [ops.add(s, k) for s, k in zip(step1, ark[:STATE_WIDTH])]
        step2 = [ops.sub(x, k) for x, k in zip(nxt, ark[STATE_WIDTH:])]
        step2 = LamportThresholdAir._mds(ops, step2, INV_MDS)
        step2 = [ops.exp(s, ALPHA) for s in step2]
        return [ops.sub(step2[i], step1[i]) for i in range(STATE_WIDTH)]

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
        assertions = [Assertion.periodic(c, 0, SIG_CYCLE_LEN, (0,))
                      for c in (2, 3, 4, 5, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                                20, 21, 22, 23, 25)]
        num_cycles = self.num_pub_keys + 1
        p = 1
        while p < num_cycles:
            p *= 2
        num_cycles = p
        merkle_root_offset = (num_cycles.bit_length() - 1 + 1) * HASH_CYCLE_LEN
        index_list = [(num_cycles - 1,)] + [(i,) for i in range(num_cycles - 1)]
        assertions += [
            Assertion.sequence(25, merkle_root_offset, SIG_CYCLE_LEN, index_list),
            Assertion.periodic(18, merkle_root_offset, SIG_CYCLE_LEN,
                               (self.pub_key_root[0],)),
            Assertion.periodic(19, merkle_root_offset, SIG_CYCLE_LEN,
                               (self.pub_key_root[1],)),
        ]
        last_step = self.trace_length - 1
        assertions += [
            Assertion.single(27, 0, (0,)),
            Assertion.single(27, last_step, (self.num_signatures,)),
            Assertion.single(18, 0, (0,)),
            Assertion.single(19, 0, (0,)),
        ]
        return assertions

    def get_periodic_column_values(self):
        sig_cycle_mask = [0] * (SIG_CYCLE_LEN - 1) + [1]
        powers_of_two = [1] * SIG_CYCLE_LEN
        cur = 1
        for i in range(1, SIG_CYCLE_LEN):
            if i % HASH_CYCLE_LEN == 0:
                cur = cur * 2 % _P
            powers_of_two[i] = cur
        m0, m1 = self.message
        m0_bits = [(m0 >> (i // HASH_CYCLE_LEN)) & 1 for i in range(SIG_CYCLE_LEN)]
        m1_bits = [(m1 >> (i // HASH_CYCLE_LEN)) & 1 for i in range(SIG_CYCLE_LEN)]
        result = [sig_cycle_mask, powers_of_two, m0_bits, m1_bits,
                  list(HASH_CYCLE_MASK)]
        for j in range(STATE_WIDTH * 2):
            result.append([ARK[i][j] for i in range(HASH_CYCLE_LEN)])
        return result


class LamportThresholdProver(Prover):
    air_class = LamportThresholdAir

    def __init__(self, options, hasher, pub_key: AggPublicKey,
                 message: Tuple[int, int], num_signatures: int):
        super().__init__(options)
        self.hasher = hasher
        self.pub_inputs = ThresholdPublicInputs(
            pub_key.root, pub_key.num_keys(), num_signatures, message)

    def get_pub_inputs(self, trace):
        return self.pub_inputs
