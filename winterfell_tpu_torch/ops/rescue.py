"""Rp64_256 row hashing (K1) and 2-to-1 merge (K2), per level and over whole
Merkle trees: the port of the TPU's Pallas kernels in
winterfell_tpu/ops/pallas_rescue.py. (The same CUDA source holds the device
coin's two kernels; their wrappers are in ops/device_coin.py.)

Each function has three parts:

- the wrapper (``rp64_hash_rows``, ``rp64_merge_rows``,
  ``rp64_merkle_levels``): for a CUDA tensor it launches the hand-written
  kernel of ``csrc/rescue.cu`` on the current stream, without synchronising,
  and adds one to its count in ``LAUNCHES`` per launch; for a CPU tensor it
  runs the plain version; any other device raises;
- the plain PyTorch version (``*_plain``) of the same function, vectorised
  over rows and the 12 state lanes. The CPU tests use it, and
  ``chip_smoke.py`` holds the kernel against it on the card. Its field
  multiplies are ``gl_mul_plain``, never the routed ``gl_mul``, so on the
  card it runs no kernel of its own;
- the launch count, a plain integer per kernel.

Inputs are int64 tensors of canonical Goldilocks elements (u64 bit patterns).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..crypto.rescue_constants import RP64_256_ARK1, RP64_256_ARK2, RP64_256_MDS
from ..math.fields import GOLDILOCKS_P
from . import field_kernels, goldilocks as gl

P = GOLDILOCKS_P
_WIDTH, _RATE, _ROUNDS = 12, 8, 7

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"rp64_hash_rows": 0, "rp64_merge_rows": 0,
                            "rp64_merkle_tree": 0}

# Merkle trees (rp64_merkle_levels): a block of a multi-level launch merges
# 2^_TREE_CHUNK_LOG nodes into that many levels; once at most
# 2^_TREE_TAIL_LOG nodes are left, one block (one group of threads per merge
# of its first level) finishes the tree.
_TREE_CHUNK_LOG = 10
_TREE_TAIL_LOG = 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _tree_plan(log_n: int):
    """The launches that build the levels over 2^log_n leaves: [(log2 of
    the input level's size, levels it merges)], largest level first. Each
    launch but the last leaves at least 2^_TREE_TAIL_LOG nodes; the last is
    one block."""
    plan = []
    while log_n > _TREE_TAIL_LOG:
        b = min(_TREE_CHUNK_LOG, log_n - _TREE_TAIL_LOG)
        plan.append((log_n, b))
        log_n -= b
    if log_n > 0:
        plan.append((log_n, log_n))
    return plan


def _i64(rows) -> np.ndarray:
    return np.array(rows, dtype=np.uint64).view(np.int64)


# (2, 7, 12): ARK1 then ARK2, the layout the kernels read
_ARK_NP = np.stack([_i64(RP64_256_ARK1), _i64(RP64_256_ARK2)])
_MDS_NP = np.array(RP64_256_MDS, dtype=np.int64)
_tables: Dict[tuple, torch.Tensor] = {}


def _table(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    t = _tables.get(key)
    if t is None:
        src = _ARK_NP if name == "ark" else _MDS_NP
        t = _tables[key] = torch.from_numpy(src.copy()).to(device)
    return t


# ================================================================================
# Plain versions
# ================================================================================


def _perm_plain(state):
    """Rescue-XLIX permutation of an (m, 12) state (rp64_256/mod.rs:299-319)."""
    ark = _table("ark", state.device)
    mds = _table("mds", state.device)
    for r in range(_ROUNDS):
        state = _mds_plain(_sbox_plain(state), mds)
        state = gl.gl_add(state, ark[0, r])
        state = _mds_plain(_inv_sbox_plain(state), mds)
        state = gl.gl_add(state, ark[1, r])
    return state


def _squarings_plain(x, k: int):
    """x^(2^k): k squarings, each reduced below 2^64 but not below p (the
    next squaring takes any u64 pattern), canonical at the end."""
    for _ in range(k):
        x = gl._reduce_128_lazy(*gl._sqr_128(x))
    return gl._canon(x)


def _sbox_plain(x):
    gl_mul = field_kernels.gl_mul_plain
    x2 = _squarings_plain(x, 1)
    x4 = _squarings_plain(x2, 1)
    return gl_mul(gl_mul(x4, x2), x)


def _inv_sbox_plain(x):
    """x^INV_ALPHA by the reference's 72-multiplication addition chain."""
    gl_mul = field_kernels.gl_mul_plain

    def exp_acc(base, tail, k):
        return gl_mul(_squarings_plain(base, k), tail)

    t1 = _squarings_plain(x, 1)
    t2 = _squarings_plain(t1, 1)
    t3 = exp_acc(t2, t2, 3)
    t4 = exp_acc(t3, t3, 6)
    t5 = exp_acc(t4, t4, 12)
    t6 = exp_acc(t5, t3, 6)
    t7 = exp_acc(t6, t6, 31)
    a = _squarings_plain(gl_mul(_squarings_plain(t7, 1), t6), 2)
    return gl_mul(a, gl_mul(gl_mul(t1, t2), x))


def _mds_plain(state, mds):
    """(m, 12) → MDS · state. The entries are <= 26, so each output is an
    exact integer sum: the 32-bit halves of the inputs are summed separately
    (each column sum < 2^41 fits int64), recombined to 128 bits, reduced once."""
    lo = (state & 0xFFFFFFFF)[:, None, :]
    hi = gl._hi32(state)[:, None, :]
    acc_lo = (lo * mds).sum(-1)
    acc_hi = (hi * mds).sum(-1)
    shifted = acc_hi << 32
    r_lo = acc_lo + shifted
    r_hi = (acc_hi >> 32) + gl._ult(r_lo, shifted).to(torch.int64)
    return gl._reduce_128(r_hi, r_lo)


def rp64_hash_rows_plain(rows):
    """Rp64_256 hash_elements of each row: rows (m, k) → digests (m, 4).
    capacity[0] = k mod p; the first rate chunk is written zero-padded, later
    chunks are added into lanes 4..; one permutation per chunk."""
    m, k = rows.shape
    state = torch.zeros((m, _WIDTH), dtype=torch.int64, device=rows.device)
    state[:, 0] = k % P
    first = min(k, _RATE)
    state[:, 4 : 4 + first] = rows[:, :first]
    state = _perm_plain(state)
    for c in range(_RATE, k, _RATE):
        w = min(_RATE, k - c)
        state[:, 4 : 4 + w] = gl.gl_add(state[:, 4 : 4 + w], rows[:, c : c + w])
        state = _perm_plain(state)
    return state[:, 4:8].contiguous()


def rp64_merge_rows_plain(left, right):
    """Rp64_256 merge of digest pairs: (m, 4), (m, 4) → (m, 4)."""
    m = left.shape[0]
    cap = torch.zeros((m, 4), dtype=torch.int64, device=left.device)
    cap[:, 0] = _RATE
    state = _perm_plain(torch.cat([cap, left, right], dim=1))
    return state[:, 4:8].contiguous()


def rp64_merkle_levels_plain(leaves):
    """Internal Merkle levels over (n, 4) leaf digests, largest first, root
    last: the per-level plain merge of sibling pairs."""
    levels = []
    current = leaves
    while current.shape[0] > 1:
        current = rp64_merge_rows_plain(current[0::2], current[1::2])
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

        lib = _build.load("rescue")
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        i32 = ctypes.c_int
        lib.wt_rp64_hash_rows.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.wt_rp64_hash_rows.restype = ctypes.c_int
        lib.wt_rp64_merge_rows.argtypes = [vp, vp, vp, vp, i64, i64, vp]
        lib.wt_rp64_merge_rows.restype = ctypes.c_int
        lib.wt_rp64_merkle_levels.argtypes = [vp, vp, vp, i32, i32, vp]
        lib.wt_rp64_merkle_levels.restype = ctypes.c_int
        lib.wt_rp64_permute_rows.argtypes = [vp, vp, vp, i64, vp]
        lib.wt_rp64_permute_rows.restype = ctypes.c_int
        lib.wt_rp64_coin_draw.argtypes = [vp, vp, vp, vp, vp, ctypes.c_uint64,
                                          i64, i64, i64, vp]
        lib.wt_rp64_coin_draw.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t, name: str) -> None:
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 field elements, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D tensor, got {tuple(t.shape)}")


def _device_kind(t) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"Rescue kernels run on cpu or cuda, not {kind}")
    return kind


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def rp64_hash_rows(rows):
    """K1: digests (m, 4) of the rows (m, k) of a contiguous int64 tensor."""
    _check(rows, "rp64_hash_rows")
    if not rows.is_contiguous():
        raise ValueError("rp64_hash_rows: rows must be contiguous")
    m, k = rows.shape
    if k < 1:
        raise ValueError("rp64_hash_rows: rows must hold at least one element")
    if _device_kind(rows) == "cpu":
        return rp64_hash_rows_plain(rows)
    out = torch.empty((m, 4), dtype=torch.int64, device=rows.device)
    if m == 0:
        return out
    lib = _kernels()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_rp64_hash_rows(rows.data_ptr(), out.data_ptr(),
                                    _table("ark", rows.device).data_ptr(),
                                    m, k, stream)
    _raise_on(err, "rp64_hash_rows")
    LAUNCHES["rp64_hash_rows"] += 1
    return out


def rp64_merge_rows(left, right):
    """K2: merge(left[i], right[i]) for (m, 4) digest tensors. Each must have
    unit element stride and the two the same row stride (contiguous tensors,
    or the even and odd rows of one contiguous level)."""
    _check(left, "rp64_merge_rows")
    _check(right, "rp64_merge_rows")
    if left.shape != right.shape or left.shape[1] != 4:
        raise ValueError("rp64_merge_rows: expected two (m, 4) tensors, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    if left.device != right.device:
        raise ValueError("rp64_merge_rows: operands on different devices")
    m = left.shape[0]
    # the layout the kernel reads, checked on every device so that the CPU
    # tests hold the main path to it
    if left.stride(1) != 1 or right.stride(1) != 1 or (
            m > 1 and left.stride(0) != right.stride(0)):
        raise ValueError("rp64_merge_rows: rows need unit element stride and "
                         "equal row strides")
    if _device_kind(left) == "cpu":
        return rp64_merge_rows_plain(left, right)
    out = torch.empty((m, 4), dtype=torch.int64, device=left.device)
    if m == 0:
        return out
    stride = left.stride(0) if m > 1 else 4
    lib = _kernels()
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_rp64_merge_rows(left.data_ptr(), right.data_ptr(),
                                     out.data_ptr(),
                                     _table("ark", left.device).data_ptr(),
                                     m, stride, stream)
    _raise_on(err, "rp64_merge_rows")
    LAUNCHES["rp64_merge_rows"] += 1
    return out


def rp64_merkle_levels(leaves):
    """K2 over a whole tree: the internal Merkle levels over (n, 4) leaf
    digests, n a power of two, largest first, root last (the level of size
    s holds heap nodes [s, 2s), crypto/src/merkle/mod.rs:344-368). On the
    card the levels are consecutive views of one (n - 1, 4) buffer, built in
    len(_tree_plan) launches; their offsets come from the shapes alone."""
    _check(leaves, "rp64_merkle_levels")
    n = leaves.shape[0]
    if leaves.shape[1] != 4 or n < 1 or n & (n - 1):
        raise ValueError("rp64_merkle_levels: expected (n, 4) leaves with n a "
                         f"power of two, got {tuple(leaves.shape)}")
    if not leaves.is_contiguous():
        raise ValueError("rp64_merkle_levels: leaves must be contiguous")
    if _device_kind(leaves) == "cpu":
        return rp64_merkle_levels_plain(leaves)
    lib = _kernels()
    ark = _table("ark", leaves.device).data_ptr()

    def launch(src, dst, lg, b, stream):
        _raise_on(lib.wt_rp64_merkle_levels(src, dst, ark, lg, b, stream),
                  "rp64_merkle_levels")
        LAUNCHES["rp64_merkle_tree"] += 1

    return levels_by_plan(leaves, launch)


def levels_by_plan(leaves, launch):
    """The internal Merkle levels over (n, w) leaf digests (n a power of two,
    contiguous, on the card), largest first, root last: consecutive views of
    one (n - 1, w) buffer, built by ``launch(src, dst, lg, b, stream)`` once
    per entry of _tree_plan: merge the level of 2^lg nodes at pointer src
    into b levels written from pointer dst on. The offsets come from the
    shapes alone, so no launch waits on the host."""
    n, w = leaves.shape
    buf = torch.empty((n - 1, w), dtype=leaves.dtype, device=leaves.device)
    log_n = n.bit_length() - 1
    base, row = buf.data_ptr(), w * buf.element_size()
    with torch.cuda.device(leaves.device):
        stream = torch.cuda.current_stream().cuda_stream
        for lg, b in _tree_plan(log_n):
            # the level of size s sits at rows [n - 2s, n - s) of buf
            src = (leaves.data_ptr() if lg == log_n else
                   base + row * (n - (2 << lg)))
            launch(src, base + row * (n - (1 << lg)), lg, b, stream)
    sizes = [n >> i for i in range(1, log_n + 1)]
    return [buf[n - 2 * s : n - s] for s in sizes]
