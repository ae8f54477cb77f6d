"""Rp62_248 row hashing, the 2-to-1 merge per level and over whole Merkle
trees, and the device coin's merge_with_int candidates: the port of
winterfell_tpu/ops/rp62_device.py (B15, csrc/rp62.cu; the coin's draw
kernel's wrapper is in ops/device_coin.py).

Digests are (m, 8) int32 tensors of packed words: the 4 digest elements
packed as 4×62 bits into 31 bytes and a zero pad byte
(rp62_248/digest.rs:36-50), so the words' little-endian bytes are the
digest bytes plus the pad (proofs and the host coin take the first 31).
Rows to hash are (m, k) int64 tensors of canonical f62 elements
(``ops/f62.py``).

Each function has three parts, as those of ``ops/rescue.py``:

- the wrapper (``rp62_hash_rows``, ``rp62_merge_rows``,
  ``rp62_merkle_levels``, ``coin_candidates``): for a CUDA tensor it
  launches the hand-written kernel on the current stream, without
  synchronising, and adds one to its count in ``LAUNCHES`` per launch; for a
  CPU tensor it runs the plain version; any other device raises;
- the plain PyTorch version (``*_plain``) of the same function, vectorised
  over rows and the 12 state lanes, with the plain f62 arithmetic
  (``f62.mul_plain``), so on the card it runs no kernel of its own;
- the launch count, a plain integer per kernel.

``rp62_combine`` is the merge_many of a partitioned commitment: the chunk
digests' elements hashed as one row (B15's row hash).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np
import torch

from ..crypto.rescue_jive_constants import RP62_ARK1, RP62_ARK2, RP62_MDS
from . import f62
from .rescue import levels_by_plan

P = f62.P
_WIDTH, _RATE, _ROUNDS = 12, 8, 7
_M62 = (1 << 62) - 1

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"rp62_hash_rows": 0, "rp62_merge_rows": 0,
                            "rp62_merkle_tree": 0, "rp62_coin_candidates": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# the MDS matrix (row-major) then ARK1 and ARK2: the kernels' constant tables
_TABLES_NP = np.concatenate([np.array(RP62_MDS, dtype=np.int64).reshape(-1),
                             np.array(RP62_ARK1, dtype=np.int64).reshape(-1),
                             np.array(RP62_ARK2, dtype=np.int64).reshape(-1)])
_plain_tables: Dict[str, tuple] = {}


def _plain_consts(device):
    """(MDS (12, 12), ARK (2, 7, 12)) tensors for the plain version."""
    key = str(device)
    if key not in _plain_tables:
        t = torch.from_numpy(_TABLES_NP.copy()).to(device)
        _plain_tables[key] = (t[:144].reshape(12, 12),
                              t[144:].reshape(2, _ROUNDS, _WIDTH))
    return _plain_tables[key]


# ================================================================================
# Plain versions
# ================================================================================


def _sq_mul(x, k: int, y):
    """x^(2^k) · y."""
    for _ in range(k):
        x = f62.mul_plain(x, x)
    return f62.mul_plain(x, y)



def _inv_sbox_plain(x):
    """x^INV_ALPHA by csrc/rp62.cu's addition chain (62 squarings, 11
    multiplies): INV_ALPHA = (10)^8 ‖ 0001011 ‖ (01)^19 ‖ 1 in binary."""
    x3 = _sq_mul(x, 1, x)
    q2 = _sq_mul(x, 2, x)
    q4 = _sq_mul(q2, 4, q2)
    q8 = _sq_mul(q4, 8, q4)
    r = _sq_mul(q8, 5, x)
    r = _sq_mul(r, 3, x3)
    r = _sq_mul(r, 16, q8)
    r = _sq_mul(r, 16, q8)
    r = _sq_mul(r, 4, q2)
    r = _sq_mul(r, 2, x)
    return _sq_mul(r, 1, x)


def _perm_plain(state):
    """The Rp62_248 permutation of an (m, 12) state (rp62_248/mod.rs)."""
    mds, ark = _plain_consts(state.device)
    for r in range(_ROUNDS):
        for h in range(2):
            state = (_sq_mul(state, 1, state) if h == 0
                     else _inv_sbox_plain(state))
            prod = f62.mul_plain(state[:, None, :], mds)  # (m, 12, 12)
            acc = ark[h, r].expand(state.shape)
            for k in range(_WIDTH):
                acc = f62.add_plain(acc, prod[:, :, k])
            state = acc
    return state


def pack(elems):
    """(m, 4) int64 digest elements (< 2^62) -> (m, 8) int32 packed words."""
    v = [elems[:, j] for j in range(4)]
    q = torch.stack([v[0] | (v[1] << 62), (v[1] >> 2) | (v[2] << 60),
                     (v[2] >> 4) | (v[3] << 58), v[3] >> 6], dim=1)
    return q.contiguous().view(torch.int32)


def unpack(words):
    """(m, 8) int32 packed words -> (m, 4) int64 digest elements."""
    q = words.contiguous().view(torch.int64)
    q0, q1, q2, q3 = (q[:, j] for j in range(4))
    return torch.stack([q0 & _M62,
                        ((q0 >> 62) & 3 | (q1 << 2)) & _M62,
                        ((q1 >> 60) & 0xF | (q2 << 4)) & _M62,
                        ((q2 >> 58) & 0x3F | (q3 << 6)) & _M62], dim=1)


def rp62_hash_rows_plain(rows):
    """hash_elements of each row: rows (m, k) -> packed digests (m, 8).
    Lane 11 = k; the first rate chunk is written zero-padded, later chunks
    are added into lanes 0..; one permutation per chunk."""
    m, k = rows.shape
    state = torch.zeros((m, _WIDTH), dtype=torch.int64, device=rows.device)
    state[:, 11] = k % P
    first = min(k, _RATE)
    state[:, :first] = rows[:, :first]
    state = _perm_plain(state)
    for c in range(_RATE, k, _RATE):
        w = min(_RATE, k - c)
        state = state.clone()
        state[:, :w] = f62.add_plain(state[:, :w], rows[:, c : c + w])
        state = _perm_plain(state)
    return pack(state[:, :4])


def rp62_merge_rows_plain(left, right):
    """merge of packed digest pairs: (m, 8), (m, 8) -> (m, 8) (count 8)."""
    m = left.shape[0]
    cap = torch.zeros((m, 4), dtype=torch.int64, device=left.device)
    cap[:, 3] = _RATE
    state = _perm_plain(torch.cat([unpack(left), unpack(right), cap], dim=1))
    return pack(state[:, :4])


def rp62_merkle_levels_plain(leaves):
    """Internal Merkle levels over (n, 8) leaf digests, largest first, root
    last: the per-level plain merge of sibling pairs."""
    levels = []
    current = leaves
    while current.shape[0] > 1:
        current = rp62_merge_rows_plain(current[0::2], current[1::2])
        levels.append(current)
    return levels


def _counter_lanes(counter0: int, t: int, device):
    """(t, 2) int64 (c mod p, c div p) and (t,) counts 5 or 6 of the counters
    c = counter0 + 1 .. counter0 + t (any u64)."""
    c = np.arange(1, t + 1, dtype=np.uint64) + np.uint64(counter0)
    hi = c // np.uint64(P)
    lo = c - hi * np.uint64(P)
    lanes = np.stack([lo, hi], axis=1).astype(np.int64)
    count = np.where(hi > 0, 6, 5).astype(np.int64)
    return (torch.from_numpy(lanes).to(device),
            torch.from_numpy(count).to(device))


def coin_candidates_plain(seed, counter0: int, t: int):
    """merge_with_int(seed, c) for c = counter0 + 1 .. counter0 + t
    (rp62_248/mod.rs: the seed's elements in lanes 0..4, c mod p in lane 4,
    c div p in lane 5, count 5, or 6 when c >= p): (t, 8) packed digests."""
    if counter0 < 0 or counter0 + t >= 1 << 64:
        raise ValueError("coin_candidates: counters must stay below 2^64")
    dev = seed.device
    lanes, count = _counter_lanes(counter0, t, dev)
    elems = unpack(seed.reshape(1, 8)).expand(t, 4)
    zeros = torch.zeros((t, 5), dtype=torch.int64, device=dev)
    state = torch.cat([elems, lanes, zeros, count[:, None]], dim=1)
    return pack(_perm_plain(state)[:, :4])


# ================================================================================
# Kernel wrappers
# ================================================================================

_lib = None
_ready = set()  # devices whose constant tables are set


def _kernels():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("rp62")
        vp, i64, u64, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                             ctypes.c_int)
        lib.wt_rp62_init.argtypes = [vp]
        lib.wt_rp62_hash_rows.argtypes = [vp, vp, i64, i64, vp]
        lib.wt_rp62_merge_rows.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.wt_rp62_merkle_levels.argtypes = [vp, vp, i32, i32, vp]
        lib.wt_rp62_coin_candidates.argtypes = [vp, vp, u64, i64, vp]
        lib.wt_rp62_coin_draw_f62.argtypes = [vp, vp, vp, vp, u64, i64, i64,
                                              i32, i32, vp]
        for fn in (lib.wt_rp62_init, lib.wt_rp62_hash_rows,
                   lib.wt_rp62_merge_rows, lib.wt_rp62_merkle_levels,
                   lib.wt_rp62_coin_candidates, lib.wt_rp62_coin_draw_f62):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def prepare(device) -> ctypes.CDLL:
    """The loaded library, with the MDS matrix and round constants set in
    the constant memory of ``device`` (once per device: a host-to-device
    copy, so the resident prove calls it before its device run)."""
    lib = _kernels()
    key = str(device)
    if key not in _ready:
        with torch.cuda.device(device):
            _raise_on(lib.wt_rp62_init(_TABLES_NP.ctypes.data), "rp62_init")
        _ready.add(key)
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _device_kind(t) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"Rp62 kernels run on cpu or cuda, not {kind}")
    return kind


def _check_words(t, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8:
        raise ValueError(f"{name}: expected (m, 8) int32 packed digests, got "
                         f"{t.dtype} {tuple(t.shape)}")


def rp62_hash_rows(rows):
    """B15 row hash: packed digests (m, 8) of the rows (m, k) of a
    contiguous int64 tensor of f62 elements."""
    if rows.dtype != torch.int64 or rows.dim() != 2:
        raise ValueError("rp62_hash_rows: expected (m, k) int64 elements, "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("rp62_hash_rows: rows must be contiguous")
    m, k = rows.shape
    if k < 1:
        raise ValueError("rp62_hash_rows: rows must hold at least one element")
    if _device_kind(rows) == "cpu":
        return rp62_hash_rows_plain(rows)
    out = torch.empty((m, 8), dtype=torch.int32, device=rows.device)
    if m == 0:
        return out
    lib = prepare(rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_rp62_hash_rows(rows.data_ptr(), out.data_ptr(), m, k,
                                    stream)
    _raise_on(err, "rp62_hash_rows")
    LAUNCHES["rp62_hash_rows"] += 1
    return out


def rp62_merge_rows(left, right):
    """B15 merge(left[i], right[i]) of (m, 8) packed digests. Each must have
    unit word stride and the two the same row stride (contiguous tensors,
    or the even and odd rows of one contiguous level)."""
    _check_words(left, "rp62_merge_rows")
    _check_words(right, "rp62_merge_rows")
    if left.shape != right.shape or left.device != right.device:
        raise ValueError("rp62_merge_rows: operands of other shapes or "
                         "devices")
    m = left.shape[0]
    if left.stride(1) != 1 or right.stride(1) != 1 or (
            m > 1 and left.stride(0) != right.stride(0)):
        raise ValueError("rp62_merge_rows: rows need unit word stride and "
                         "equal row strides")
    if _device_kind(left) == "cpu":
        return rp62_merge_rows_plain(left, right)
    out = torch.empty((m, 8), dtype=torch.int32, device=left.device)
    if m == 0:
        return out
    stride = left.stride(0) if m > 1 else 8
    lib = prepare(left.device)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_rp62_merge_rows(left.data_ptr(), right.data_ptr(),
                                     out.data_ptr(), m, stride, stream)
    _raise_on(err, "rp62_merge_rows")
    LAUNCHES["rp62_merge_rows"] += 1
    return out


def rp62_merkle_levels(leaves) -> List[torch.Tensor]:
    """B15 over a whole tree: the internal Merkle levels over (n, 8) leaf
    digests, n a power of two, largest first, root last. On the card the
    levels are consecutive views of one (n - 1, 8) buffer, built in
    len(_tree_plan) launches (ops/rescue.py levels_by_plan)."""
    _check_words(leaves, "rp62_merkle_levels")
    n = leaves.shape[0]
    if n < 1 or n & (n - 1) or not leaves.is_contiguous():
        raise ValueError("rp62_merkle_levels: expected contiguous leaves, n a "
                         f"power of two, got {tuple(leaves.shape)}")
    if _device_kind(leaves) == "cpu":
        return rp62_merkle_levels_plain(leaves)
    lib = prepare(leaves.device)

    def launch(src, dst, lg, b, stream):
        _raise_on(lib.wt_rp62_merkle_levels(src, dst, lg, b, stream),
                  "rp62_merkle_levels")
        LAUNCHES["rp62_merkle_tree"] += 1

    return levels_by_plan(leaves, launch)


def coin_candidates(seed, counter0: int, t: int):
    """The Rp62 coin's candidates merge_with_int(seed, c) for c = counter0 +
    1 .. counter0 + t: (t, 8) packed digests of the (8,) int32 seed, one
    launch (counters at or above p included)."""
    if seed.dtype != torch.int32 or seed.shape != (8,) or t < 1:
        raise ValueError("coin_candidates: expected an (8,) int32 seed and "
                         "t >= 1")
    if _device_kind(seed) == "cpu":
        return coin_candidates_plain(seed, counter0, t)
    if counter0 < 0 or counter0 + t >= 1 << 64:
        raise ValueError("coin_candidates: counters must stay below 2^64")
    out = torch.empty((t, 8), dtype=torch.int32, device=seed.device)
    lib = prepare(seed.device)
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_rp62_coin_candidates(seed.contiguous().data_ptr(),
                                          out.data_ptr(), counter0, t, stream)
    _raise_on(err, "rp62_coin_candidates")
    LAUNCHES["rp62_coin_candidates"] += 1
    return out


def rp62_combine(digests):
    """merge_many of a partitioned commitment's chunk digests (a list of
    (m, 8)): their elements, in order, hashed as one row each
    (winterfell_tpu/ops/rp62_device.py:204 rp62_combine)."""
    return rp62_hash_rows(torch.cat([unpack(d) for d in digests],
                                    dim=1).contiguous())
