"""u32 words in int32 tensors: the messages and digests of the byte hashers
(BLAKE3 in ``ops/blake3.py``, SHA3 in ``ops/sha3.py``) and of their device
coins.

An int32 tensor holds the words' bit patterns; the plain versions widen
them to int64 (``u32``) so that every add and shift is exact, and narrow
the results back (``i32``). A row of int64 field elements viewed as int32
(``rows_from_u64``) is its little-endian element bytes, the message the
reference hashes (crypto/src/hash/blake/mod.rs:52-66), and a digest's bytes
are its words in ``<u4`` order.
"""

from __future__ import annotations

import torch

from . import rescue

M32 = 0xFFFFFFFF


def rows_from_u64(rows):
    """(m, k) contiguous int64 element rows -> ((m, 2k) int32 words, byte
    length): the little-endian element bytes are the [lo32, hi32] word pairs
    as the elements lie in memory."""
    return rows.view(torch.int32), 8 * rows.shape[1]


def u32(words):
    """int32 words -> their unsigned values in an int64 tensor."""
    return words.to(torch.int64) & M32


def i32(values):
    """int64 values in [0, 2^32) -> int32 words with the same bits."""
    return torch.where(values >= 2**31, values - 2**32, values).to(torch.int32)


def check_words(t, name: str) -> None:
    """What the byte-hash kernels read: a 2-D int32 tensor of unit word
    stride on cpu or cuda (checked on every device, so that the CPU tests
    hold the callers to it)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{name}: expected 2-D words of unit stride, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    rescue._device_kind(t)


def check_pair(left, right, name: str) -> None:
    check_words(left, name)
    check_words(right, name)
    if left.shape != right.shape or left.device != right.device:
        raise ValueError(f"{name}: expected two digest tensors of one shape "
                         f"and device, got {tuple(left.shape)} on "
                         f"{left.device} and {tuple(right.shape)} on "
                         f"{right.device}")
    if left.shape[0] > 1 and left.stride(0) != right.stride(0):
        raise ValueError(f"{name}: the two operands need equal row strides")


def check_leaves(leaves, name: str) -> None:
    check_words(leaves, name)
    n = leaves.shape[0]
    if n < 1 or n & (n - 1) or not leaves.is_contiguous():
        raise ValueError(f"{name}: expected contiguous leaves, a power of two "
                         f"of them, got {tuple(leaves.shape)}")
