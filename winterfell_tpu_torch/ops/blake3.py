"""BLAKE3 row hashing, 2-to-1 merge and whole Merkle trees (B10), for
Blake3_256 (8 digest words) and Blake3_192 (6): the port of the jnp
programs of winterfell_tpu/ops/blake3_device.py.

Messages and digests are u32 words in int32 tensors (``ops/words.py``:
``rows_from_u64`` makes the message of an element row). Each row is at most
one 1024-byte chunk; longer rows raise, as the JAX package asserts
(blake3_device.py:119).

Each function has three parts:

- the wrapper (``blake3_hash_words``, ``blake3_merge_rows``,
  ``blake3_merkle_levels``): for a CUDA tensor it launches the hand-written
  kernel of ``csrc/blake3.cu`` on the current stream, without synchronising,
  and adds one to its count in ``LAUNCHES`` per launch; for a CPU tensor it
  runs the plain version; any other device raises;
- the plain PyTorch version (``*_plain``) of the same function, in int64
  tensors masked to 32 bits after every add and shift, the four G functions
  of a column or diagonal step at once. The CPU tests use it, and
  ``chip_smoke.py`` holds the kernel against it on the card;
- the launch count, a plain integer per kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import rescue
from .words import M32, check_leaves, check_pair, check_words, i32, u32

MAX_BYTES = 1024  # one chunk

_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
_CHUNK_START, _CHUNK_END, _ROOT = 1, 2, 8

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"blake3_hash_rows": 0, "blake3_merge_rows": 0,
                            "blake3_merkle_tree": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_byte_len(byte_len: int) -> None:
    if not 0 <= byte_len <= MAX_BYTES:
        raise ValueError(f"blake3: rows of {byte_len} bytes; rows larger than "
                         "one chunk (1024 bytes) need the tree mode")


# ================================================================================
# Plain versions
# ================================================================================

# (7, 16): the message word each round reads at each position
_TABLE = [list(range(16))]
for _ in range(6):
    _TABLE.append([_TABLE[-1][j] for j in _MSG_PERMUTATION])


def _rotr(x, n: int):
    return (x >> n) | ((x << (32 - n)) & M32)


def _g4(a, b, c, d, mx, my):
    """Four G functions at once over (m, 4) columns of the state."""
    a = (a + b + mx) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


_DIAG_B, _DIAG_C, _DIAG_D = [1, 2, 3, 0], [2, 3, 0, 1], [3, 0, 1, 2]
_UNDIAG_B, _UNDIAG_D = [3, 0, 1, 2], [1, 2, 3, 0]


def _compress_plain(cv, block, block_len: int, flags: int):
    """cv (m, 8), block (m, 16) u32 values in int64 -> the next chaining
    value (m, 8): one compression with block counter 0."""
    m = cv.shape[0]
    iv = torch.tensor(_IV[:4], dtype=torch.int64, device=cv.device)
    tail = torch.tensor([0, 0, block_len, flags], dtype=torch.int64,
                        device=cv.device)
    a, b = cv[:, :4], cv[:, 4:]
    c, d = iv.expand(m, 4), tail.expand(m, 4)
    for r in range(7):
        w = block[:, _TABLE[r]]
        a, b, c, d = _g4(a, b, c, d, w[:, 0:8:2], w[:, 1:8:2])
        a, b, c, d = _g4(a, b[:, _DIAG_B], c[:, _DIAG_C], d[:, _DIAG_D],
                         w[:, 8:16:2], w[:, 9:16:2])
        b, c, d = b[:, _UNDIAG_B], c[:, _DIAG_C], d[:, _UNDIAG_D]
    return torch.cat([a ^ c, b ^ d], dim=1)


def blake3_hash_words_plain(words, byte_len: int, digest_words: int = 8):
    """BLAKE3 of each row: words (m, W) int32, zero past byte_len (<= 1024)
    -> (m, digest_words) int32 digests (blake3_device.py:142)."""
    _check_byte_len(byte_len)
    m = words.shape[0]
    need = -(-byte_len // 4)
    n_blocks = max(1, -(-byte_len // 64))
    w = torch.zeros((m, 16 * n_blocks), dtype=torch.int64, device=words.device)
    w[:, :need] = u32(words[:, :need])
    cv = torch.tensor(_IV, dtype=torch.int64, device=words.device).expand(m, 8)
    for i in range(n_blocks):
        flags = _CHUNK_START if i == 0 else 0
        blen = 64
        if i == n_blocks - 1:
            flags |= _CHUNK_END | _ROOT
            blen = byte_len - 64 * i
        cv = _compress_plain(cv, w[:, 16 * i : 16 * (i + 1)], blen, flags)
    return i32(cv[:, :digest_words]).contiguous()


def blake3_merge_rows_plain(left, right):
    """merge(d0, d1) = BLAKE3(d0 ‖ d1) of (m, w) digest words, w in {6, 8}."""
    w = left.shape[1]
    return blake3_hash_words_plain(torch.cat([left, right], dim=1), 8 * w, w)


def blake3_merkle_levels_plain(leaves):
    """Internal Merkle levels over (n, w) leaf digests, largest first, root
    last: the per-level plain merge of sibling pairs."""
    levels, current = [], leaves
    while current.shape[0] > 1:
        current = blake3_merge_rows_plain(current[0::2], current[1::2])
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

        lib = _build.load("blake3")
        vp, i64, i32_, u64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_uint64)
        lib.wt_blake3_hash_rows.argtypes = [vp, i64, vp, i64, i32_, i32_, vp]
        lib.wt_blake3_hash_rows.restype = ctypes.c_int
        lib.wt_blake3_merge_rows.argtypes = [vp, vp, vp, i64, i64, i32_, vp]
        lib.wt_blake3_merge_rows.restype = ctypes.c_int
        lib.wt_blake3_merkle_levels.argtypes = [vp, vp, i32_, i32_, i32_, vp]
        lib.wt_blake3_merkle_levels.restype = ctypes.c_int
        for draw in (lib.wt_blake3_coin_draw, lib.wt_blake3_coin_draw_f128,
                     lib.wt_blake3_coin_draw_f62):
            draw.argtypes = [vp, vp, vp, vp, u64, i64, i64, i32_, i32_, vp]
            draw.restype = ctypes.c_int
        _lib = lib
    return _lib


def blake3_hash_words(words, byte_len: int, digest_words: int = 8):
    """B10 row hash: (m, digest_words) int32 digests of the byte_len-byte
    rows of words (m, W) (zero past byte_len)."""
    check_words(words, "blake3_hash_words")
    _check_byte_len(byte_len)
    m, width = words.shape
    if width < -(-byte_len // 4) or not 1 <= digest_words <= 8:
        raise ValueError(f"blake3_hash_words: {width} words hold no "
                         f"{byte_len}-byte rows, or {digest_words} digest "
                         "words is not in 1..8")
    if words.device.type == "cpu":
        return blake3_hash_words_plain(words, byte_len, digest_words)
    out = torch.empty((m, digest_words), dtype=torch.int32, device=words.device)
    if m == 0:
        return out
    lib = _kernels()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_blake3_hash_rows(words.data_ptr(), words.stride(0),
                                      out.data_ptr(), m, byte_len,
                                      digest_words, stream)
    rescue._raise_on(err, "blake3_hash_rows")
    LAUNCHES["blake3_hash_rows"] += 1
    return out


def blake3_merge_rows(left, right):
    """B10 merge: merge(left[i], right[i]) of (m, w) digest words, w in
    {6, 8}, each of unit word stride and the two of one row stride
    (contiguous tensors, or the even and odd rows of one level)."""
    check_pair(left, right, "blake3_merge_rows")
    m, w = left.shape
    if w not in (6, 8):
        raise ValueError(f"blake3_merge_rows: digests of {w} words")
    if left.device.type == "cpu":
        return blake3_merge_rows_plain(left, right)
    out = torch.empty((m, w), dtype=torch.int32, device=left.device)
    if m == 0:
        return out
    lib = _kernels()
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_blake3_merge_rows(left.data_ptr(), right.data_ptr(),
                                       out.data_ptr(), m,
                                       left.stride(0) if m > 1 else w, w,
                                       stream)
    rescue._raise_on(err, "blake3_merge_rows")
    LAUNCHES["blake3_merge_rows"] += 1
    return out


def blake3_merkle_levels(leaves):
    """B10 over a whole tree: the internal Merkle levels over (n, w) leaf
    digests (w in {6, 8}, n a power of two), largest first, root last; on
    the card consecutive views of one buffer built in len(_tree_plan)
    launches (ops/rescue.py:levels_by_plan)."""
    check_leaves(leaves, "blake3_merkle_levels")
    w = leaves.shape[1]
    if w not in (6, 8):
        raise ValueError(f"blake3_merkle_levels: digests of {w} words")
    if leaves.device.type == "cpu":
        return blake3_merkle_levels_plain(leaves)
    lib = _kernels()

    def launch(src, dst, lg, b, stream):
        rescue._raise_on(lib.wt_blake3_merkle_levels(src, dst, lg, b, w,
                                                     stream),
                         "blake3_merkle_levels")
        LAUNCHES["blake3_merkle_tree"] += 1

    return rescue.levels_by_plan(leaves, launch)
