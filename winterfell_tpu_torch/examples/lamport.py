"""Lamport+ aggregate signature example (examples/src/lamport/aggregate/):
width-22 f128 trace verifying many Lamport signatures — 1024 steps per
signature (128 hash cycles of 8 steps), three parallel Rescue128 sponges
(two secret-key hashers + one public-key aggregator), message-bit
accumulators with powers-of-two periodic column, and sequence assertions.
This is the reference's widest / most periodic-column-heavy AIR."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Tuple

from ..air import Air, AirContext, Assertion, TraceInfo, TransitionConstraintDegree
from ..crypto.blake3_host import blake3
from ..math.fields import F128
from ..prover import Prover, TraceTable
from .merkle import (
    ARK,
    INV_ALPHA,
    INV_MDS,
    MDS,
    NUM_HASH_ROUNDS,
    STATE_WIDTH,
    apply_round128,
    rescue128_digest,
)

HASH_CYCLE_LEN = 8
SIG_CYCLE_LEN = 128 * HASH_CYCLE_LEN  # 1024 steps per signature
TRACE_WIDTH = 22
MESSAGE_BITS = 254
ALPHA = 3

_P = F128.p

HASH_CYCLE_MASK = [1] * NUM_HASH_ROUNDS + [0]


# ================================================================================
# Signature scheme (examples/src/lamport/signature.rs)
# ================================================================================


def message_to_elements(message: bytes) -> Tuple[int, int]:
    """blake3(message) as two 127-bit ints with an 8-bit checksum
    (signature.rs:164-188)."""
    h = blake3(message)
    m0 = int.from_bytes(h[:16], "little")
    m1 = int.from_bytes(h[16:], "little")
    m0 = m0 & ((1 << 127) - 1)
    m1 = m1 & ((1 << 119) - 1)
    checksum = (128 - bin(m0).count("1")) + (128 - bin(m1).count("1"))
    m1 |= checksum << 119
    return m0, m1


@dataclass
class Signature:
    ones: List[Tuple[int, int]]
    zeros: List[Tuple[int, int]]


class PrivateKey:
    """254 secret key pairs from ``seed``; their per-bit public keys and the
    key's hash are computed by native/f128.c (``crypto/native.py``);
    ``pub_keys_py`` and ``hash_pub_keys`` are the Python oracles."""

    def __init__(self, seed: int):
        from ..crypto import native

        rng = random.Random(seed)
        self.sec_keys = [
            (rng.randrange(_P), rng.randrange(_P)) for _ in range(MESSAGE_BITS)
        ]
        self.pub_keys = native.rescue128w6_hash2_many(
            self.sec_keys, MDS, ARK, INV_ALPHA)
        self.pub_key_hash = native.rescue128w6_sponge(
            _pub_keys_data(self.pub_keys), MDS, ARK, INV_ALPHA)

    def pub_key(self) -> Tuple[int, int]:
        return self.pub_key_hash

    def sign(self, message: bytes) -> Signature:
        ones, zeros = [], []
        n = 0
        for element in message_to_elements(message):
            assert element < (1 << 127)
            for i in range(127):
                if (element >> i) & 1:
                    ones.append(self.sec_keys[n])
                else:
                    zeros.append(self.pub_keys[n])
                n += 1
        return Signature(ones, zeros)


def sign_messages(n: int):
    """(public keys, messages, signatures) of ``n`` signers, signer i with
    key ``PrivateKey(i)`` signing b"test message i": the inputs of the CLI's
    lamport example and of bench.py's lamport workload (``bench_lamport``)."""
    keys = [PrivateKey(i) for i in range(n)]
    texts = [f"test message {i}".encode() for i in range(n)]
    return ([k.pub_key() for k in keys], [message_to_elements(t) for t in texts],
            [k.sign(t) for k, t in zip(keys, texts)])


def verify_signature(pub_key: Tuple[int, int], message: bytes, sig: Signature) -> bool:
    """(signature.rs:100-123)."""
    n_zeros = n_ones = 0
    pub_keys = []
    for element in message_to_elements(message):
        for i in range(127):
            if (element >> i) & 1:
                if n_ones == len(sig.ones):
                    return False
                pub_keys.append(rescue128_digest(list(sig.ones[n_ones])))
                n_ones += 1
            else:
                if n_zeros == len(sig.zeros):
                    return False
                pub_keys.append(sig.zeros[n_zeros])
                n_zeros += 1
    return pub_key == hash_pub_keys(pub_keys)


def _pub_keys_data(keys) -> List[int]:
    """The sponge input of hash_pub_keys: a zero block, then the two halves
    of the keys interleaved."""
    data = [0, 0, 0, 0]
    half = MESSAGE_BITS // 2
    for i in range(half):
        data.extend(keys[i])
        data.extend(keys[i + half])
    return data


def hash_pub_keys(keys) -> Tuple[int, int]:
    """Sponge over interleaved halves (signature.rs hash_pub_keys)."""
    return rescue128_digest(_pub_keys_data(keys))


def pub_keys_py(sec_keys) -> List[Tuple[int, int]]:
    """The per-bit public keys in Python ints (signature.rs:60-78): the
    oracle of the native batch digest."""
    return [rescue128_digest(list(sk)) for sk in sec_keys]


# ================================================================================
# Trace construction (examples/src/lamport/aggregate/prover.rs)
# ================================================================================

ZERO_KEY = (0, 0)


def _build_key_schedule(m0: int, m1: int, sig: Signature):
    sec1 = [ZERO_KEY] * 128
    sec2 = [ZERO_KEY] * 128
    pub1 = [ZERO_KEY] * 128
    pub2 = [ZERO_KEY] * 128
    n_ones = n_zeros = 0
    for i in range(127):
        if (m0 >> i) & 1:
            sec1[i] = sig.ones[n_ones]
            n_ones += 1
        else:
            pub1[i] = sig.zeros[n_zeros]
            n_zeros += 1
    for i in range(127):
        if (m1 >> i) & 1:
            sec2[i] = sig.ones[n_ones]
            n_ones += 1
        else:
            pub2[i] = sig.zeros[n_zeros]
            n_zeros += 1
    return sec1, sec2, pub1, pub2


def build_lamport_trace(messages: List[Tuple[int, int]],
                        signatures: List[Signature]) -> TraceTable:
    """(examples/src/lamport/aggregate/prover.rs build_trace): the
    1024-step-per-signature three-sponge state machine, built by
    native/f128.c ``wt_lamport_trace`` from the key schedules; the
    (n, 22, 2) word rows upload to the f128 prover as they are."""
    from ..crypto import native

    trace = TraceTable(F128, TRACE_WIDTH, SIG_CYCLE_LEN * len(messages))
    scheds = [_build_key_schedule(m0, m1, sig)
              for (m0, m1), sig in zip(messages, signatures)]
    trace.set_native_rows(native.lamport_trace(
        messages, *([s[k] for s in scheds] for k in range(4)),
        MDS, ARK, INV_ALPHA))
    return trace


def build_lamport_trace_py(messages: List[Tuple[int, int]],
                           signatures: List[Signature]) -> TraceTable:
    """The same trace in Python ints: the oracle of the native builder."""
    trace = TraceTable(F128, TRACE_WIDTH, SIG_CYCLE_LEN * len(messages))
    powers_of_two = [pow(2, i, _P) for i in range(128)]

    for sig_idx, (msg, sig) in enumerate(zip(messages, signatures)):
        m0, m1 = msg
        sec1, sec2, pub1, pub2 = _build_key_schedule(m0, m1, sig)
        base = sig_idx * SIG_CYCLE_LEN

        state = [0] * TRACE_WIDTH
        state[0] = m0 & 1
        state[1] = m1 & 1
        state[4], state[5] = sec1[0]
        state[10], state[11] = sec2[0]
        trace.update_row(base, state)

        for step in range(SIG_CYCLE_LEN - 1):
            cycle_num = step // HASH_CYCLE_LEN
            cycle_step = step % HASH_CYCLE_LEN
            if cycle_step < NUM_HASH_ROUNDS:
                state[4:10] = apply_round128(state[4:10], cycle_step)
                state[10:16] = apply_round128(state[10:16], cycle_step)
                state[16:22] = apply_round128(state[16:22], cycle_step)
            else:
                m0_bit, m1_bit = state[0], state[1]
                # public key aggregation (prover.rs update_pub_key_hash)
                k1 = (state[4], state[5]) if m0_bit == 1 else pub1[cycle_num]
                k2 = (state[10], state[11]) if m1_bit == 1 else pub2[cycle_num]
                state[16] = (state[16] + k1[0]) % _P
                state[17] = (state[17] + k1[1]) % _P
                state[18] = (state[18] + k2[0]) % _P
                state[19] = (state[19] + k2[1]) % _P
                # next secret keys
                state[4], state[5] = sec1[cycle_num + 1]
                state[6:10] = [0, 0, 0, 0]
                state[10], state[11] = sec2[cycle_num + 1]
                state[12:16] = [0, 0, 0, 0]
                # message accumulation
                state[0] = (m0 >> (cycle_num + 1)) & 1
                state[1] = (m1 >> (cycle_num + 1)) & 1
                state[2] = (state[2] + powers_of_two[cycle_num] * m0_bit) % _P
                state[3] = (state[3] + powers_of_two[cycle_num] * m1_bit) % _P
            trace.update_row(base + step + 1, state)
    return trace


# ================================================================================
# AIR (examples/src/lamport/aggregate/air.rs)
# ================================================================================


@dataclass(frozen=True)
class LamportPublicInputs:
    pub_keys: Tuple[Tuple[int, int], ...]
    messages: Tuple[Tuple[int, int], ...]


class LamportAggregateAir(Air):
    def __init__(self, trace_info: TraceInfo, pub_inputs: LamportPublicInputs,
                 options):
        def deg(base, cycles):
            return TransitionConstraintDegree.with_cycles(base, cycles)

        degrees = (
            [deg(2, [HASH_CYCLE_LEN, SIG_CYCLE_LEN])] * 2
            + [deg(1, [HASH_CYCLE_LEN, SIG_CYCLE_LEN, SIG_CYCLE_LEN])] * 2
            + [deg(5, [HASH_CYCLE_LEN, SIG_CYCLE_LEN])] * 18
        )
        assert trace_info.width == TRACE_WIDTH
        self.context = AirContext.new(F128, trace_info, degrees, 22, options)
        self.pub_keys = pub_inputs.pub_keys
        self.messages = pub_inputs.messages

    def pub_inputs_to_elements(self):
        out = []
        for pk in self.pub_keys:
            out += [(pk[0],), (pk[1],)]
        for m in self.messages:
            out += [(m[0],), (m[1],)]
        return out

    def evaluate_transition(self, frame, periodic_values, ops):
        sig_cycle_end_flag = periodic_values[0]
        power_of_two = periodic_values[1]
        hash_flag = periodic_values[2]
        ark = periodic_values[3:]
        cur = [frame.current(i) for i in range(TRACE_WIDTH)]
        nxt = [frame.next(i) for i in range(TRACE_WIDTH)]
        one = ops.constant(1)

        results = [ops.zeros(cur[0].shape[0]) if hasattr(cur[0], "shape")
                   else None for _ in range(TRACE_WIDTH)]

        # hash steps (not sig-cycle end): copy 0..4, Rescue rounds on 3 sponges
        flag = ops.mul(ops.sub(one, sig_cycle_end_flag), hash_flag)
        for i in range(4):
            results[i] = ops.mul(flag, ops.sub(cur[i], nxt[i]))
        for off in (4, 10, 16):
            r = self._enforce_round(ops, cur[off : off + 6], nxt[off : off + 6], ark)
            for i in range(6):
                results[off + i] = ops.mul(flag, r[i])

        # bit-injection steps (not sig-cycle end)
        flag = ops.mul(ops.sub(one, sig_cycle_end_flag), ops.sub(one, hash_flag))
        results[0] = ops.add(results[0], ops.mul(
            flag, ops.sub(ops.mul(cur[0], cur[0]), cur[0])))
        results[1] = ops.add(results[1], ops.mul(
            flag, ops.sub(ops.mul(cur[1], cur[1]), cur[1])))
        results[2] = ops.add(results[2], ops.mul(
            flag, ops.sub(ops.add(cur[2], ops.mul(cur[0], power_of_two)), nxt[2])))
        results[3] = ops.add(results[3], ops.mul(
            flag, ops.sub(ops.add(cur[3], ops.mul(cur[1], power_of_two)), nxt[3])))
        for slot, col in zip(range(4, 12), (6, 7, 8, 9, 12, 13, 14, 15)):
            results[slot] = ops.add(results[slot], ops.mul(flag, nxt[col]))
        results[12] = ops.add(results[12], ops.mul(flag, ops.sub(cur[20], nxt[20])))
        results[13] = ops.add(results[13], ops.mul(flag, ops.sub(cur[21], nxt[21])))
        m0_bit, m1_bit = cur[0], cur[1]
        results[14] = ops.add(results[14], ops.mul(ops.mul(flag, m0_bit),
                              ops.sub(ops.add(cur[16], cur[4]), nxt[16])))
        results[15] = ops.add(results[15], ops.mul(ops.mul(flag, m0_bit),
                              ops.sub(ops.add(cur[17], cur[5]), nxt[17])))
        results[16] = ops.add(results[16], ops.mul(ops.mul(flag, m1_bit),
                              ops.sub(ops.add(cur[18], cur[10]), nxt[18])))
        results[17] = ops.add(results[17], ops.mul(ops.mul(flag, m1_bit),
                              ops.sub(ops.add(cur[19], cur[11]), nxt[19])))
        return results

    @staticmethod
    def _enforce_round(ops, cur, nxt, ark):
        step1 = [ops.exp(c, ALPHA) for c in cur]
        step1 = LamportAggregateAir._mds(ops, step1, MDS)
        step1 = [ops.add(s, k) for s, k in zip(step1, ark[:STATE_WIDTH])]
        step2 = [ops.sub(x, k) for x, k in zip(nxt, ark[STATE_WIDTH:])]
        step2 = LamportAggregateAir._mds(ops, step2, INV_MDS)
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
        last = SIG_CYCLE_LEN - 1
        m0s = [(m[0],) for m in self.messages]
        m1s = [(m[1],) for m in self.messages]
        pk0s = [(k[0],) for k in self.pub_keys]
        pk1s = [(k[1],) for k in self.pub_keys]
        out = [Assertion.periodic(c, 0, SIG_CYCLE_LEN, (0,))
               for c in (2, 3, 6, 7, 8, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21)]
        out += [
            Assertion.periodic(0, last, SIG_CYCLE_LEN, (0,)),
            Assertion.periodic(1, last, SIG_CYCLE_LEN, (0,)),
            Assertion.sequence(2, last, SIG_CYCLE_LEN, m0s),
            Assertion.sequence(3, last, SIG_CYCLE_LEN, m1s),
            Assertion.sequence(16, last, SIG_CYCLE_LEN, pk0s),
            Assertion.sequence(17, last, SIG_CYCLE_LEN, pk1s),
        ]
        return out

    def get_periodic_column_values(self):
        sig_cycle_mask = [0] * (SIG_CYCLE_LEN - 1) + [1]
        powers_of_two = [1] * SIG_CYCLE_LEN
        cur = 1
        for i in range(1, SIG_CYCLE_LEN):
            if i % HASH_CYCLE_LEN == 0:
                cur = cur * 2 % _P
            powers_of_two[i] = cur
        result = [sig_cycle_mask, powers_of_two, list(HASH_CYCLE_MASK)]
        for j in range(STATE_WIDTH * 2):
            result.append([ARK[i][j] for i in range(HASH_CYCLE_LEN)])
        return result


class LamportAggregateProver(Prover):
    air_class = LamportAggregateAir

    def __init__(self, options, hasher, pub_keys, messages):
        super().__init__(options)
        self.hasher = hasher
        self.pub_inputs = LamportPublicInputs(tuple(pub_keys), tuple(messages))

    def get_pub_inputs(self, trace):
        return self.pub_inputs
