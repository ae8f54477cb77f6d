"""Host-side hash functions of the provers with the reference
Hasher/ElementHasher semantics (crypto/src/hash/{blake,sha,rescue}/*.rs):

- digests are raw ``bytes`` — 32 for the *_256 hashers, 24 for Blake3_192;
- the byte hashers (BLAKE3, SHA3): ``merge`` hashes the two concatenated
  digests, ``merge_with_int`` hashes digest ‖ LE64(value)
  (crypto/src/hash/blake/mod.rs:41-46) and ``hash_elements`` the canonical
  little-endian bytes of the elements (blake/mod.rs:52-66);
- Rescue-Prime Rp64_256 is a 12-element f64 sponge, rate 8 / capacity 4,
  digest = state[4..8], 7 rounds (rp64_256/mod.rs:23-55), with capacity[0]
  initialized to the absorbed element count; its digest bytes are the
  little-endian bytes of the 4 digest elements;
- RpJive64_256 is Rescue-Prime over a state of 8 with the Jive compression
  as its merge (rp64_256_jive/mod.rs);
- Rp62_248 is Rescue-Prime over f62, rate state[0..8), the element count in
  state[11], digest = state[0..4) packed as 4×62 bits into 31 bytes
  (rp62_248/mod.rs, digest.rs:36-62); the hasher of the f62 prover.

These run the Fiat–Shamir transcript; bulk row hashing uses the row-parallel
kernels in ``ops/`` (this module is their oracle).
"""

from __future__ import annotations

import hashlib

from ..math.fields import F62, F64, Field
from . import native
from .blake3_host import blake3 as _blake3_py
from .rescue_constants import RP64_256_ARK1, RP64_256_ARK2, RP64_256_MDS
from .rescue_jive_constants import (JIVE_ARK1, JIVE_ARK2, JIVE_MDS,
                                    RP62_ARK1, RP62_ARK2, RP62_MDS)



def blake3(data: bytes) -> bytes:
    """BLAKE3 of ``data``: the native C library where the C compiler built it
    (at the first call, not at import), else the pure-Python oracle
    (tests/test_torch_hashers.py pins the two together)."""
    return native.blake3(data) if native.available() else _blake3_py(data)


# ================================================================================
# Byte-digest hashers (BLAKE3, SHA3)
# ================================================================================


class _ByteHasher:
    digest_size: int = 32
    collision_resistance: int = 128
    name: str = ""

    @staticmethod
    def _raw(data: bytes) -> bytes:
        raise NotImplementedError

    @classmethod
    def hash(cls, data: bytes) -> bytes:
        return cls._raw(data)[: cls.digest_size]

    @classmethod
    def merge(cls, d0: bytes, d1: bytes) -> bytes:
        return cls._raw(d0 + d1)[: cls.digest_size]

    @classmethod
    def merge_many(cls, digests) -> bytes:
        return cls._raw(b"".join(digests))[: cls.digest_size]

    @classmethod
    def merge_with_int(cls, seed: bytes, value: int) -> bytes:
        return cls._raw(seed + (value & (1 << 64) - 1).to_bytes(8, "little"))[
            : cls.digest_size
        ]

    @classmethod
    def hash_elements(cls, elements, field: Field) -> bytes:
        return cls._raw(field.elements_to_le_bytes(elements))[: cls.digest_size]


class Blake3_256(_ByteHasher):
    digest_size = 32
    collision_resistance = 128
    name = "blake3_256"
    _raw = staticmethod(blake3)


class Blake3_192(_ByteHasher):
    digest_size = 24
    collision_resistance = 96
    name = "blake3_192"
    _raw = staticmethod(blake3)


class Sha3_256(_ByteHasher):
    digest_size = 32
    collision_resistance = 128
    name = "sha3_256"

    @staticmethod
    def _raw(data: bytes) -> bytes:
        return hashlib.sha3_256(data).digest()

# ================================================================================
# Rescue-Prime Rp64_256 (host scalar version)
# ================================================================================

_P = F64.p
_STATE_WIDTH = 12
_RATE_START = 4
_RATE_WIDTH = 8
_DIGEST_RANGE = slice(4, 8)
_NUM_ROUNDS = 7

ALPHA = 7
INV_ALPHA = 10540996611094048183  # rp64_256/mod.rs:55


def _rp64_sbox(state):
    return [pow(x, ALPHA, _P) for x in state]


def _rp64_inv_sbox(state):
    return [pow(x, INV_ALPHA, _P) for x in state]


def _rp64_mds(state):
    return [
        sum(RP64_256_MDS[i][k] * state[k] for k in range(_STATE_WIDTH)) % _P
        for i in range(_STATE_WIDTH)
    ]


def rp64_permutation(state):
    """Rescue-XLIX permutation (rp64_256/mod.rs:299-319). `state`: 12 ints."""
    state = list(state)
    for r in range(_NUM_ROUNDS):
        state = _rp64_sbox(state)
        state = _rp64_mds(state)
        state = [(s + k) % _P for s, k in zip(state, RP64_256_ARK1[r])]
        state = _rp64_inv_sbox(state)
        state = _rp64_mds(state)
        state = [(s + k) % _P for s, k in zip(state, RP64_256_ARK2[r])]
    return state


def _digest_to_elements(d: bytes):
    return [int.from_bytes(d[8 * i : 8 * i + 8], "little") for i in range(4)]


def _elements_to_digest(elems) -> bytes:
    return b"".join(e.to_bytes(8, "little") for e in elems)


class Rp64_256:
    digest_size = 32
    collision_resistance = 128
    name = "rp64_256"

    @classmethod
    def hash(cls, data: bytes) -> bytes:
        """Byte-string hashing: 7-byte chunks, 1-byte terminator on the last
        (partial) chunk, element count in capacity[0] (rp64_256/mod.rs:123-178)."""
        num_elements = (len(data) + 6) // 7 if len(data) % 7 else len(data) // 7
        state = [0] * _STATE_WIDTH
        state[0] = num_elements % _P
        i = 0
        chunks = [data[j : j + 7] for j in range(0, len(data), 7)]
        for chunk in chunks:
            # NB: the reference compares the RATE index `i` (which resets every
            # 8 absorptions), not the chunk index, against num_elements-1
            # (rp64_256/mod.rs:142-156); replicated for bit-compatibility.
            if i < num_elements - 1:
                buf = chunk + b"\x00"  # non-last branch assumes a full 7-byte chunk
            else:
                buf = chunk + b"\x01" + b"\x00" * (7 - len(chunk))
            v = int.from_bytes(buf, "little")
            state[_RATE_START + i] = (state[_RATE_START + i] + v) % _P
            i += 1
            if i % _RATE_WIDTH == 0:
                state = rp64_permutation(state)
                i = 0
        if i > 0:
            state = rp64_permutation(state)
        return _elements_to_digest(state[_DIGEST_RANGE])

    @classmethod
    def merge(cls, d0: bytes, d1: bytes) -> bytes:
        state = [0] * _STATE_WIDTH
        state[0] = _RATE_WIDTH
        elems = _digest_to_elements(d0) + _digest_to_elements(d1)
        state[_RATE_START : _RATE_START + 8] = elems
        state = rp64_permutation(state)
        return _elements_to_digest(state[_DIGEST_RANGE])

    @classmethod
    def merge_many(cls, digests) -> bytes:
        elems = [e for d in digests for e in _digest_to_elements(d)]
        return cls._hash_base_elements(elems)

    @classmethod
    def merge_with_int(cls, seed: bytes, value: int) -> bytes:
        state = [0] * _STATE_WIDTH
        state[4:8] = _digest_to_elements(seed)
        state[8] = value % _P
        if value < _P:
            state[0] = 5
        else:
            state[9] = value // _P
            state[0] = 6
        state = rp64_permutation(state)
        return _elements_to_digest(state[_DIGEST_RANGE])

    @classmethod
    def hash_elements(cls, elements, field: Field) -> bytes:
        assert field.base is F64, "Rp64_256 hashes f64-based elements only"
        base_elems = [b for e in elements for b in e]
        return cls._hash_base_elements(base_elems)

    @classmethod
    def _hash_base_elements(cls, base_elems) -> bytes:
        state = [0] * _STATE_WIDTH
        state[0] = len(base_elems) % _P
        i = 0
        for e in base_elems:
            state[_RATE_START + i] = (state[_RATE_START + i] + e) % _P
            i += 1
            if i % _RATE_WIDTH == 0:
                state = rp64_permutation(state)
                i = 0
        if i > 0:
            state = rp64_permutation(state)
        return _elements_to_digest(state[_DIGEST_RANGE])



# ================================================================================
# RpJive64_256 — Rescue-Prime with the Jive compression (state 8 over f64)
# (crypto/src/hash/rescue/rp64_256_jive/mod.rs; Hirose-style padding per
# crypto/README.md:19)
# ================================================================================

_JIVE_STATE = 8
_JIVE_RATE = 4  # rate = state[4..8), capacity = state[0..4)


def _jive_mds(state):
    return [sum(JIVE_MDS[i][k] * state[k] for k in range(_JIVE_STATE)) % _P
            for i in range(_JIVE_STATE)]


def rp_jive64_permutation(state):
    """Rescue-XLIX at width 8 (rp64_256_jive/mod.rs:259-296): the S-boxes of
    Rp64_256 and the 8×8 MDS. `state`: 8 ints."""
    state = list(state)
    for r in range(_NUM_ROUNDS):
        state = _jive_mds([pow(x, ALPHA, _P) for x in state])
        state = [(s + k) % _P for s, k in zip(state, JIVE_ARK1[r])]
        state = _jive_mds([pow(x, INV_ALPHA, _P) for x in state])
        state = [(s + k) % _P for s, k in zip(state, JIVE_ARK2[r])]
    return state


def _jive_sponge(values, num_elements: int) -> bytes:
    """The sponge over field values: capacity[0] = 1 iff the count is not a
    multiple of the rate; a partial last chunk is padded with ONE, then
    zeros (mod.rs:119-206); digest = the rate after the last permutation."""
    state = [0] * _JIVE_STATE
    if num_elements % _JIVE_RATE != 0:
        state[0] = 1
    i = 0
    for v in values:
        state[_JIVE_RATE + i] = (state[_JIVE_RATE + i] + v) % _P
        i += 1
        if i % _JIVE_RATE == 0:
            state = rp_jive64_permutation(state)
            i = 0
    if i > 0:
        state[_JIVE_RATE + i] = 1
        state = rp_jive64_permutation(state)
    return _elements_to_digest(state[4:8])


class RpJive64_256:
    """Sponge for hash/hash_elements; Jive 2-to-1 compression for merge
    (rp64_256_jive/mod.rs:114-296). NB: merge and hash_elements are NOT
    consistent with each other by design (mod.rs:94-111)."""

    digest_size = 32
    collision_resistance = 128
    name = "rp_jive64_256"

    @staticmethod
    def _jive_sum(initial, final) -> bytes:
        out = [
            (initial[i] + initial[4 + i] + final[i] + final[4 + i]) % _P
            for i in range(4)
        ]
        return _elements_to_digest(out)

    @classmethod
    def hash(cls, data: bytes) -> bytes:
        """7-byte chunks with a 1-byte terminator on the last (mod.rs:119-180)."""
        num_elements = -(-len(data) // 7)
        chunks = [data[j : j + 7] for j in range(0, len(data), 7)]
        values = [
            int.from_bytes(chunk + (b"\x00" if index < num_elements - 1 else
                                    b"\x01" + b"\x00" * (7 - len(chunk))),
                           "little")
            for index, chunk in enumerate(chunks)]
        return _jive_sponge(values, num_elements)

    @classmethod
    def merge(cls, d0: bytes, d1: bytes) -> bytes:
        initial = _digest_to_elements(d0) + _digest_to_elements(d1)
        final = rp_jive64_permutation(initial)
        return cls._jive_sum(initial, final)

    @classmethod
    def merge_many(cls, digests) -> bytes:
        elems = [(e,) for d in digests for e in _digest_to_elements(d)]
        return cls.hash_elements(elems, None)

    @classmethod
    def merge_with_int(cls, seed: bytes, value: int) -> bytes:
        initial = _digest_to_elements(seed) + [0] * 4
        initial[4] = value % _P
        if value < _P:
            initial[7] = 5
        else:
            initial[5] = value // _P
            initial[7] = 6
        final = rp_jive64_permutation(initial)
        return cls._jive_sum(initial, final)

    @classmethod
    def hash_elements(cls, elements, field) -> bytes:
        base_elems = [b for e in elements for b in e]
        return _jive_sponge(base_elems, len(base_elems))


# ================================================================================
# Rp62_248 — Rescue-Prime over f62, 248-bit digests
# (crypto/src/hash/rescue/rp62_248/mod.rs)
# ================================================================================

_P62 = F62.p
RP62_ALPHA = 3
RP62_INV_ALPHA = 3074416663688030891  # (2p − 1) / 3
_RP62_STATE = 12
_RP62_RATE = 8  # rate = state[0..8), capacity = state[8..12), count in state[11]


def rp62_permutation(state):
    """Rescue-XLIX over f62 (rp62_248/mod.rs): 7 rounds of S-box x^3, MDS,
    ARK1, inverse S-box, MDS, ARK2. `state`: 12 ints."""
    state = list(state)
    for r in range(_NUM_ROUNDS):
        for mds, ark, e in ((RP62_MDS, RP62_ARK1, RP62_ALPHA),
                            (RP62_MDS, RP62_ARK2, RP62_INV_ALPHA)):
            state = [pow(x, e, _P62) for x in state]
            state = [(sum(m * x for m, x in zip(row, state)) + k) % _P62
                     for row, k in zip(mds, ark[r])]
    return state


def _rp62_digest(elems) -> bytes:
    """The 4 digest elements packed as 4×62 bits into 31 bytes and a zero
    pad byte (rp62_248/digest.rs:36-50)."""
    v = 0
    for i, e in enumerate(elems):
        v |= int(e) << (62 * i)
    return v.to_bytes(32, "little")


def _rp62_digest_to_elements(d: bytes):
    v = int.from_bytes(d[:32], "little")
    mask = (1 << 62) - 1
    return [(v >> (62 * i)) & mask for i in range(4)]


class Rp62_248:
    digest_size = 31  # digests serialize to 31 bytes (digest.rs:58-62)
    collision_resistance = 124
    name = "rp62_248"

    @classmethod
    def _digest_elems(cls, d: bytes):
        return _rp62_digest_to_elements(d + b"\x00" * (32 - len(d)))

    @classmethod
    def _squeeze(cls, state) -> bytes:
        return _rp62_digest(rp62_permutation(state)[:4])[:31]

    @classmethod
    def hash(cls, data: bytes) -> bytes:
        """7-byte chunks, a 1-byte terminator on the last one; the element
        count in state[11] (rp62_248/mod.rs hash)."""
        num_elements = -(-len(data) // 7)
        state = [0] * _RP62_STATE
        state[11] = num_elements % _P62
        i = 0
        for chunk in (data[j : j + 7] for j in range(0, len(data), 7)):
            # as Rp64_256, the rate index i (not the chunk index) is compared
            if i < num_elements - 1:
                buf = chunk + b"\x00"
            else:
                buf = chunk + b"\x01" + b"\x00" * (7 - len(chunk))
            state[i] = (state[i] + int.from_bytes(buf, "little")) % _P62
            i += 1
            if i % _RP62_RATE == 0:
                state = rp62_permutation(state)
                i = 0
        if i > 0:
            state = rp62_permutation(state)
        return _rp62_digest(state[:4])[:31]

    @classmethod
    def merge(cls, d0: bytes, d1: bytes) -> bytes:
        state = cls._digest_elems(d0) + cls._digest_elems(d1) + [0] * 4
        state[11] = _RP62_RATE
        return cls._squeeze(state)

    @classmethod
    def merge_many(cls, digests) -> bytes:
        elems = [(e,) for d in digests for e in cls._digest_elems(d)]
        return cls.hash_elements(elems, None)

    @classmethod
    def merge_with_int(cls, seed: bytes, value: int) -> bytes:
        state = cls._digest_elems(seed) + [0] * 8
        state[4] = value % _P62
        if value < _P62:
            state[11] = 5
        else:
            state[5] = value // _P62
            state[11] = 6
        return cls._squeeze(state)

    @classmethod
    def hash_elements(cls, elements, field) -> bytes:
        base_elems = [b for e in elements for b in e]
        state = [0] * _RP62_STATE
        state[11] = len(base_elems) % _P62
        i = 0
        for e in base_elems:
            state[i] = (state[i] + e) % _P62
            i += 1
            if i % _RP62_RATE == 0:
                state = rp62_permutation(state)
                i = 0
        if i > 0:
            state = rp62_permutation(state)
        return _rp62_digest(state[:4])[:31]


HASHERS = {
    "blake3_256": Blake3_256,
    "blake3_192": Blake3_192,
    "sha3_256": Sha3_256,
    "rp64_256": Rp64_256,
    "rp_jive64_256": RpJive64_256,
    "rp62_248": Rp62_248,
}
