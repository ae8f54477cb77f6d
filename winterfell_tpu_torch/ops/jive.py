"""RpJive64_256 row hashing, the Jive 2-to-1 compression and whole Merkle
trees (B12): the port of the jnp programs of winterfell_tpu/ops/
jive_device.py.

Rescue-Prime over f64 with a state of 8: capacity = lanes 0..4, rate =
lanes 4..8. ``jive_hash_rows`` is the sponge whose digest is the rate after
the last permutation (rp64_256_jive/mod.rs:183-206); the merge is the Jive
compression, jive(x, y) = Σ(initial halves) + Σ(final halves), not a sponge
(mod.rs:94-111). Digests are (m, 4) int64 field elements, as Rp64_256's.

The row hash and the tree each have a wrapper that launches the
hand-written kernel of ``csrc/jive.cu`` for a CUDA tensor (counted in
``LAUNCHES``) and runs the plain version for a CPU tensor, and a plain
PyTorch version (``*_plain``) that the CPU tests use and ``chip_smoke.py``
holds the kernel against; the plain permutation is ``ops/rescue.py``'s
S-boxes and MDS product at width 8. The merge has only its plain version:
on the card the tree kernel merges (RpJive64_256 has no device coin to
reseed with a lone merge).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..crypto.rescue_jive_constants import JIVE_ARK1, JIVE_ARK2, JIVE_MDS
from . import goldilocks as gl
from . import rescue

_WIDTH, _RATE, _ROUNDS = 8, 4, 7

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"jive_hash_rows": 0, "jive_merkle_tree": 0}

# (2, 7, 8): ARK1 then ARK2, the layout the kernels read
_ARK_NP = np.stack([np.array(JIVE_ARK1, dtype=np.uint64).view(np.int64),
                    np.array(JIVE_ARK2, dtype=np.uint64).view(np.int64)])
_MDS_NP = np.array(JIVE_MDS, dtype=np.int64)
_tables: Dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def table(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    t = _tables.get(key)
    if t is None:
        src = _ARK_NP if name == "ark" else _MDS_NP
        t = _tables[key] = torch.from_numpy(src.copy()).to(device)
    return t


# ================================================================================
# Plain versions
# ================================================================================


def jive_permutation_rows_plain(state):
    """Rescue-XLIX at width 8 of each (m, 8) state row
    (rp64_256_jive/mod.rs:259-296)."""
    ark = table("ark", state.device)
    mds = table("mds", state.device)
    for r in range(_ROUNDS):
        state = rescue._mds_plain(rescue._sbox_plain(state), mds)
        state = gl.gl_add(state, ark[0, r])
        state = rescue._mds_plain(rescue._inv_sbox_plain(state), mds)
        state = gl.gl_add(state, ark[1, r])
    return state


def jive_hash_rows_plain(rows):
    """hash_elements of each row: rows (m, k) -> digests (m, 4): capacity[0]
    = 1 iff k is not a multiple of 4, chunks of 4 added into the rate, a
    partial last chunk followed by ONE (jive_device.py:84-117)."""
    m, k = rows.shape
    state = torch.zeros((m, _WIDTH), dtype=torch.int64, device=rows.device)
    state[:, 0] = 1 if k % _RATE else 0
    for c in range(0, k, _RATE):
        w = min(_RATE, k - c)
        state[:, 4 : 4 + w] = gl.gl_add(state[:, 4 : 4 + w],
                                        rows[:, c : c + w])
        if w < _RATE:
            state[:, 4 + w] = 1
        state = jive_permutation_rows_plain(state)
    return state[:, 4:8].contiguous()


def jive_merge_rows_plain(left, right):
    """The Jive compression of digest pairs: (m, 4), (m, 4) -> (m, 4)."""
    initial = torch.cat([left, right], dim=1)
    final = jive_permutation_rows_plain(initial)
    return gl.gl_add(gl.gl_add(initial[:, :4], initial[:, 4:]),
                     gl.gl_add(final[:, :4], final[:, 4:]))


def jive_merkle_levels_plain(leaves):
    """Internal Merkle levels over (n, 4) leaf digests, largest first, root
    last: the per-level plain merge of sibling pairs."""
    levels, current = [], leaves
    while current.shape[0] > 1:
        current = jive_merge_rows_plain(current[0::2], current[1::2])
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

        lib = _build.load("jive")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.wt_jive_hash_rows.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.wt_jive_hash_rows.restype = ctypes.c_int
        lib.wt_jive_merkle_levels.argtypes = [vp, vp, vp, i32, i32, vp]
        lib.wt_jive_merkle_levels.restype = ctypes.c_int
        _lib = lib
    return _lib


def jive_hash_rows(rows):
    """B12 row hash: digests (m, 4) of the rows (m, k) of a contiguous int64
    tensor of canonical elements."""
    rescue._check(rows, "jive_hash_rows")
    if not rows.is_contiguous():
        raise ValueError("jive_hash_rows: rows must be contiguous")
    m, k = rows.shape
    if k < 1:
        raise ValueError("jive_hash_rows: rows must hold at least one element")
    if rescue._device_kind(rows) == "cpu":
        return jive_hash_rows_plain(rows)
    out = torch.empty((m, 4), dtype=torch.int64, device=rows.device)
    if m == 0:
        return out
    lib = _kernels()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_jive_hash_rows(rows.data_ptr(), out.data_ptr(),
                                    table("ark", rows.device).data_ptr(), m, k,
                                    stream)
    rescue._raise_on(err, "jive_hash_rows")
    LAUNCHES["jive_hash_rows"] += 1
    return out


def jive_merkle_levels(leaves):
    """B12 over a whole tree: the internal Merkle levels over (n, 4) leaf
    digests (n a power of two), largest first, root last; on the card built
    as ``rescue.rp64_merkle_levels`` builds them."""
    rescue._check(leaves, "jive_merkle_levels")
    n = leaves.shape[0]
    if leaves.shape[1] != 4 or n < 1 or n & (n - 1) or \
            not leaves.is_contiguous():
        raise ValueError("jive_merkle_levels: expected contiguous (n, 4) "
                         f"leaves with n a power of two, got "
                         f"{tuple(leaves.shape)}")
    if rescue._device_kind(leaves) == "cpu":
        return jive_merkle_levels_plain(leaves)
    lib = _kernels()
    ark = table("ark", leaves.device).data_ptr()

    def launch(src, dst, lg, b, stream):
        rescue._raise_on(lib.wt_jive_merkle_levels(src, dst, ark, lg, b,
                                                   stream),
                         "jive_merkle_levels")
        LAUNCHES["jive_merkle_tree"] += 1

    return rescue.levels_by_plan(leaves, launch)
