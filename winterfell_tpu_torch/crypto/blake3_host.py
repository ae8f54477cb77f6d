"""Pure-Python BLAKE3 (hash mode only, 256-bit output).

Implemented from the public BLAKE3 specification. Used for the host-side
Fiat-Shamir transcript where the native library (crypto/native.py) is not
built, and as the oracle of the native hash and of the row-hashing kernels
(ops/blake3.py).
The reference uses the `blake3` crate (crypto/src/hash/blake/mod.rs:29-47).

Transcript inputs are tiny (32-4080 bytes), so pure Python is fine here; bulk
row hashing never goes through this module.
"""

from __future__ import annotations

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8

_MASK = 0xFFFFFFFF

BLOCK_LEN = 64
CHUNK_LEN = 1024


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _compress(cv, block_words, counter, block_len, flags):
    s = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)

    def g(a, b, c, d, mx, my):
        s[a] = (s[a] + s[b] + mx) & _MASK
        s[d] = _rotr(s[d] ^ s[a], 16)
        s[c] = (s[c] + s[d]) & _MASK
        s[b] = _rotr(s[b] ^ s[c], 12)
        s[a] = (s[a] + s[b] + my) & _MASK
        s[d] = _rotr(s[d] ^ s[a], 8)
        s[c] = (s[c] + s[d]) & _MASK
        s[b] = _rotr(s[b] ^ s[c], 7)

    for r in range(7):
        g(0, 4, 8, 12, m[0], m[1])
        g(1, 5, 9, 13, m[2], m[3])
        g(2, 6, 10, 14, m[4], m[5])
        g(3, 7, 11, 15, m[6], m[7])
        g(0, 5, 10, 15, m[8], m[9])
        g(1, 6, 11, 12, m[10], m[11])
        g(2, 7, 8, 13, m[12], m[13])
        g(3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]

    return tuple((s[i] ^ s[i + 8]) & _MASK for i in range(8))


def _words_from_block(block: bytes):
    block = block + b"\x00" * (BLOCK_LEN - len(block))
    return tuple(int.from_bytes(block[4 * i : 4 * i + 4], "little") for i in range(16))


def _chunk_cv(chunk: bytes, chunk_counter: int, is_root: bool):
    """Chaining value of one chunk (<= 1024 bytes)."""
    blocks = [chunk[i : i + BLOCK_LEN] for i in range(0, len(chunk), BLOCK_LEN)] or [b""]
    cv = IV
    n = len(blocks)
    for i, block in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == n - 1:
            flags |= CHUNK_END
            if is_root:
                flags |= ROOT
        cv = _compress(cv, _words_from_block(block), chunk_counter, len(block), flags)
    return cv


def _parent_cv(left, right, is_root: bool):
    block = tuple(left) + tuple(right)
    flags = PARENT | (ROOT if is_root else 0)
    return _compress(IV, block, 0, BLOCK_LEN, flags)


def _left_len(total_chunks: int) -> int:
    """Number of chunks in the left subtree: the largest power of two strictly
    less than total_chunks."""
    n = 1
    while n * 2 < total_chunks:
        n *= 2
    return n


def _subtree_cv(data: bytes, chunk_counter: int, is_root: bool):
    n_chunks = max(1, (len(data) + CHUNK_LEN - 1) // CHUNK_LEN)
    if n_chunks == 1:
        return _chunk_cv(data, chunk_counter, is_root)
    left_chunks = _left_len(n_chunks)
    split = left_chunks * CHUNK_LEN
    left = _subtree_cv(data[:split], chunk_counter, False)
    right = _subtree_cv(data[split:], chunk_counter + left_chunks, False)
    return _parent_cv(left, right, is_root)


def blake3(data: bytes) -> bytes:
    """BLAKE3 hash, 32-byte output."""
    cv = _subtree_cv(data, 0, True)
    return b"".join(w.to_bytes(4, "little") for w in cv)
