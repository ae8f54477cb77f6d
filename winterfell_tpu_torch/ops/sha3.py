"""SHA3-256 row hashing, 2-to-1 merge and whole Merkle trees (B11): the port
of the jnp programs of winterfell_tpu/ops/sha3_device.py.

Messages and digests are u32 words in int32 tensors (``ops/words.py``:
``rows_from_u64`` makes the message of an element row). Rows of any length
absorb in 136-byte rate blocks with the padding 0x06 … 0x80; the digest is
the first 32 bytes of the state, 8 words.

Each function has a wrapper that launches the hand-written kernel of
``csrc/keccak.cu`` for a CUDA tensor (counted in ``LAUNCHES``) and runs the
plain version for a CPU tensor, and the plain PyTorch version (``*_plain``)
that the CPU tests use and ``chip_smoke.py`` holds the kernel against. The
plain Keccak-f keeps each u64 lane as two 32-bit halves in int64 tensors,
the 25 lanes of a row side by side, so that every shift is exact.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import rescue
from .words import M32, check_leaves, check_pair, check_words, i32, u32

RATE_BYTES = 136  # SHA3-256: 1600/8 − 2·32
_RATE_LANES = RATE_BYTES // 8

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets r[x][y] (FIPS 202 Table 2); lane (x, y) lives at 5y + x
_ROT = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)
# ρ + π: B[y, 2x + 3y] = rot(A[x, y], r[x][y]); as a gather, lane i of B
# comes from lane _PI_SRC[i] of A rotated by _RHO[_PI_SRC[i]]
_RHO = [_ROT[i % 5][i // 5] for i in range(25)]
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[5 * ((2 * _x + 3 * _y) % 5) + _y] = 5 * _y + _x

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"sha3_hash_rows": 0, "sha3_merge_rows": 0,
                            "sha3_merkle_tree": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ================================================================================
# Plain versions
# ================================================================================


def _rotl(lo, hi, n):
    """(lo, hi) 32-bit halves of u64 lanes rotated left by n (a tensor of
    per-lane amounts in 0..63, or an int)."""
    big = n >= 32
    if isinstance(n, torch.Tensor):
        lo, hi = torch.where(big, hi, lo), torch.where(big, lo, hi)
    elif big:
        lo, hi = hi, lo
    s = n % 32
    # a shift by 32 - 0 = 32 of a value < 2^32 gives 0, as a rotation by 0
    return (((lo << s) | (hi >> (32 - s))) & M32,
            ((hi << s) | (lo >> (32 - s))) & M32)


def _keccak_f_plain(lo, hi):
    """Keccak-f[1600] of (m, 25) lanes as 32-bit halves (sha3_device.py:57)."""
    m = lo.shape[0]
    dev = lo.device
    rho = torch.tensor(_RHO, dtype=torch.int64, device=dev)
    src = torch.tensor(_PI_SRC, dtype=torch.int64, device=dev)
    rho_src = rho[src]
    fwd, back = [1, 2, 3, 4, 0], [4, 0, 1, 2, 3]
    for r in range(24):
        # θ: column parities c[x], d[x] = c[x-1] ^ rot(c[x+1], 1)
        lo5, hi5 = lo.view(m, 5, 5), hi.view(m, 5, 5)
        c_lo = lo5[:, 0] ^ lo5[:, 1] ^ lo5[:, 2] ^ lo5[:, 3] ^ lo5[:, 4]
        c_hi = hi5[:, 0] ^ hi5[:, 1] ^ hi5[:, 2] ^ hi5[:, 3] ^ hi5[:, 4]
        r_lo, r_hi = _rotl(c_lo[:, fwd], c_hi[:, fwd], 1)
        lo = (lo5 ^ (c_lo[:, back] ^ r_lo)[:, None, :]).reshape(m, 25)
        hi = (hi5 ^ (c_hi[:, back] ^ r_hi)[:, None, :]).reshape(m, 25)
        # ρ + π
        lo, hi = _rotl(lo[:, src], hi[:, src], rho_src)
        # χ: b[x] ^ (~b[x+1] & b[x+2]) along each row y
        lo5, hi5 = lo.view(m, 5, 5), hi.view(m, 5, 5)
        nxt, nxt2 = [1, 2, 3, 4, 0], [2, 3, 4, 0, 1]
        lo = (lo5 ^ ((lo5[:, :, nxt] ^ M32) & lo5[:, :, nxt2])).reshape(m, 25)
        hi = (hi5 ^ ((hi5[:, :, nxt] ^ M32) & hi5[:, :, nxt2])).reshape(m, 25)
        # ι
        lo[:, 0] ^= _RC[r] & M32
        hi[:, 0] ^= _RC[r] >> 32
    return lo, hi


def sha3_hash_words_plain(words, byte_len: int, digest_words: int = 8):
    """SHA3-256 of each row: words (m, W) int32, zero past byte_len (a
    multiple of 4) -> (m, 8) int32 digests (sha3_device.py:92; digest_words
    kept for the interface of the byte hashers)."""
    m = words.shape[0]
    need = -(-byte_len // 4)
    n_blocks = byte_len // RATE_BYTES + 1  # always room for the 0x06 pad
    total = n_blocks * _RATE_LANES
    w = torch.zeros((m, 2 * total), dtype=torch.int64, device=words.device)
    w[:, :need] = u32(words[:, :need])
    lo_all, hi_all = w[:, 0::2].clone(), w[:, 1::2].clone()
    # 0x06 after the message, 0x80 in the last byte of the last block
    pad_lane, shift = byte_len // 8, 8 * (byte_len % 8)
    if shift < 32:
        lo_all[:, pad_lane] ^= 0x06 << shift
    else:
        hi_all[:, pad_lane] ^= 0x06 << (shift - 32)
    hi_all[:, total - 1] ^= 0x80 << 24
    lo = torch.zeros((m, 25), dtype=torch.int64, device=words.device)
    hi = torch.zeros_like(lo)
    for b in range(n_blocks):
        blk = slice(b * _RATE_LANES, (b + 1) * _RATE_LANES)
        lo[:, :_RATE_LANES] ^= lo_all[:, blk]
        hi[:, :_RATE_LANES] ^= hi_all[:, blk]
        lo, hi = _keccak_f_plain(lo, hi)
    out = torch.stack([lo[:, :4], hi[:, :4]], dim=-1).reshape(m, 8)
    return i32(out[:, :digest_words]).contiguous()


def sha3_merge_rows_plain(left, right):
    """merge(d0, d1) = SHA3-256(d0 ‖ d1) of (m, 8) digest words."""
    return sha3_hash_words_plain(torch.cat([left, right], dim=1), 64, 8)


def sha3_merkle_levels_plain(leaves):
    """Internal Merkle levels over (n, 8) leaf digests, largest first, root
    last: the per-level plain merge of sibling pairs."""
    levels, current = [], leaves
    while current.shape[0] > 1:
        current = sha3_merge_rows_plain(current[0::2], current[1::2])
        levels.append(current)
    return levels


# ================================================================================
# Kernel wrappers
# ================================================================================

_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("keccak")
        vp, i64, i32_, u64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_uint64)
        lib.wt_sha3_hash_rows.argtypes = [vp, i64, vp, i64, i32_, vp]
        lib.wt_sha3_hash_rows.restype = ctypes.c_int
        lib.wt_sha3_merge_rows.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.wt_sha3_merge_rows.restype = ctypes.c_int
        lib.wt_sha3_merkle_levels.argtypes = [vp, vp, i32_, i32_, vp]
        lib.wt_sha3_merkle_levels.restype = ctypes.c_int
        for draw in (lib.wt_sha3_coin_draw, lib.wt_sha3_coin_draw_f128,
                     lib.wt_sha3_coin_draw_f62):
            draw.argtypes = [vp, vp, vp, vp, u64, i64, i64, i32_, i32_, vp]
            draw.restype = ctypes.c_int
        _lib = lib
    return _lib


def sha3_hash_words(words, byte_len: int, digest_words: int = 8):
    """B11 row hash: (m, 8) int32 digests of the byte_len-byte rows of
    words (m, W) (zero past byte_len, a multiple of 4)."""
    check_words(words, "sha3_hash_words")
    m, width = words.shape
    if byte_len < 0 or byte_len % 4 or width < byte_len // 4 \
            or digest_words != 8:
        raise ValueError(f"sha3_hash_words: {width} words of {byte_len}-byte "
                         f"rows (a multiple of 4) to {digest_words} words (8)")
    if words.device.type == "cpu":
        return sha3_hash_words_plain(words, byte_len, digest_words)
    out = torch.empty((m, 8), dtype=torch.int32, device=words.device)
    if m == 0:
        return out
    lib = _kernels()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_sha3_hash_rows(words.data_ptr(), words.stride(0),
                                    out.data_ptr(), m, byte_len, stream)
    rescue._raise_on(err, "sha3_hash_rows")
    LAUNCHES["sha3_hash_rows"] += 1
    return out


def sha3_merge_rows(left, right):
    """B11 merge: merge(left[i], right[i]) of (m, 8) digest words, each of
    unit word stride and the two of one row stride."""
    check_pair(left, right, "sha3_merge_rows")
    m, w = left.shape
    if w != 8:
        raise ValueError(f"sha3_merge_rows: digests of {w} words")
    if left.device.type == "cpu":
        return sha3_merge_rows_plain(left, right)
    out = torch.empty((m, 8), dtype=torch.int32, device=left.device)
    if m == 0:
        return out
    lib = _kernels()
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_sha3_merge_rows(left.data_ptr(), right.data_ptr(),
                                     out.data_ptr(), m,
                                     left.stride(0) if m > 1 else 8, stream)
    rescue._raise_on(err, "sha3_merge_rows")
    LAUNCHES["sha3_merge_rows"] += 1
    return out


def sha3_merkle_levels(leaves):
    """B11 over a whole tree: the internal Merkle levels over (n, 8) leaf
    digests (n a power of two), largest first, root last, built as
    ``blake3_merkle_levels`` builds them."""
    check_leaves(leaves, "sha3_merkle_levels")
    if leaves.shape[1] != 8:
        raise ValueError(f"sha3_merkle_levels: digests of {leaves.shape[1]} "
                         "words")
    if leaves.device.type == "cpu":
        return sha3_merkle_levels_plain(leaves)
    lib = _kernels()

    def launch(src, dst, lg, b, stream):
        rescue._raise_on(lib.wt_sha3_merkle_levels(src, dst, lg, b, stream),
                         "sha3_merkle_levels")
        LAUNCHES["sha3_merkle_tree"] += 1

    return rescue.levels_by_plan(leaves, launch)

