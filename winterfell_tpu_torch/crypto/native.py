"""The native host helpers, built with the C compiler and loaded with ctypes:
the BLAKE3 of ``native/blake3.c``, and from ``native/f128.c`` the f128
Rescue chain builder, the width-6 Rescue sponge and batch digest (Lamport
keys) and the Lamport aggregate trace builder.

At first use a source is compiled alone with ``cc -O3 -fPIC -shared`` (and
``-fopenmp`` for ``f128.c``, whose Lamport loops are parallel, as the JAX
package's native/Makefile builds it) into ``_build/lib<name>-<hash>.so``
beside the package (``_build`` is not part of the repository), keyed by a
hash of the source and the flags as ``ops/_build.py`` keys the CUDA
libraries. Nothing is written into ``native/``. Without a C compiler
``available()`` (``f128_available()``) is False and the host hashers use
the pure-Python BLAKE3 of ``crypto/blake3_host.py``, the Rescue example its
Python chain (``examples/rescue.py``); both are these libraries' oracles,
and the device kernels never depend on them. The Lamport helpers have no
fallback: they raise without a compiler, and their Python versions
(``examples/lamport.py``) serve only as the tests' oracles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
SOURCE = os.path.join(NATIVE_DIR, "blake3.c")
F128_SOURCE = os.path.join(NATIVE_DIR, "f128.c")
BUILD_DIR = os.path.join(_PKG, "_build")
CFLAGS = ["-O3", "-fPIC", "-shared", "-std=c11"]

_libs: dict = {}  # source path -> the loaded library, or None if not built


def _target(source: str, flags: List[str]) -> str:
    with open(source, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(flags).encode())
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")


def _build(source: str, target: str, flags: List[str]) -> bool:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.run([cc, *flags, "-o", tmp, source],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        return False
    os.replace(tmp, target)  # atomic: concurrent builds race harmlessly
    return True


def _open(source: str, setup, flags: List[str]) -> Optional[ctypes.CDLL]:
    """The library of ``source``, built first with ``flags`` if needed and
    its entry points typed by ``setup``; None without a C compiler (decided
    once per process)."""
    if source in _libs:
        return _libs[source]
    lib = None
    if os.path.exists(source):
        target = _target(source, flags)
        if os.path.exists(target) or _build(source, target, flags):
            lib = ctypes.CDLL(target)
            setup(lib)
    _libs[source] = lib
    return lib


def _setup_blake3(lib) -> None:
    lib.wt_blake3.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.c_char_p]
    lib.wt_blake3.restype = None
    lib.wt_blake3_many.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_size_t, ctypes.c_char_p]
    lib.wt_blake3_many.restype = None
    lib.wt_blake3_grind.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_uint32, ctypes.c_uint64]
    lib.wt_blake3_grind.restype = ctypes.c_uint64


def _setup_f128(lib) -> None:
    u64x2, ptr, size = ctypes.c_uint64 * 2, ctypes.c_void_p, ctypes.c_size_t
    lib.wt_rescue128_trace.argtypes = [ptr, size, ptr, ptr, u64x2, ptr]
    lib.wt_rescue128_trace.restype = None
    lib.wt_rescue128w6_sponge.argtypes = [ptr, size, ptr, ptr, u64x2,
                                          ctypes.c_uint64 * 4]
    lib.wt_rescue128w6_sponge.restype = None
    lib.wt_rescue128w6_hash2_many.argtypes = [ptr, size, ptr, ptr, u64x2, ptr]
    lib.wt_rescue128w6_hash2_many.restype = None
    lib.wt_lamport_trace.argtypes = [ptr, ptr, ptr, ptr, ptr, size, ptr, ptr,
                                     u64x2, ptr]
    lib.wt_lamport_trace.restype = None


def _load() -> Optional[ctypes.CDLL]:
    return _open(SOURCE, _setup_blake3, CFLAGS)


def _load_f128() -> Optional[ctypes.CDLL]:
    return _open(F128_SOURCE, _setup_f128, [*CFLAGS, "-fopenmp"])


def available() -> bool:
    return _load() is not None


def f128_available() -> bool:
    return _load_f128() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native BLAKE3 library is not built (no C "
                           "compiler)")
    return lib


def blake3(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    _require().wt_blake3(data, len(data), out)
    return out.raw


def blake3_many(rows: bytes, num_rows: int, row_len: int) -> List[bytes]:
    """BLAKE3 of ``num_rows`` byte rows of ``row_len`` bytes in one call."""
    out = ctypes.create_string_buffer(32 * num_rows)
    _require().wt_blake3_many(rows, num_rows, row_len, out)
    raw = out.raw
    return [raw[32 * i : 32 * (i + 1)] for i in range(num_rows)]


def blake3_grind(seed: bytes, zeros: int, start: int = 1) -> int:
    """The serial first-found grinding nonce (prover/src/channel.rs:169-184):
    the smallest nonce >= start whose blake3(seed ‖ LE64(nonce)) has at least
    ``zeros`` trailing zero bits in its little-endian u64 head."""
    return int(_require().wt_blake3_grind(seed, len(seed), zeros, start))


def _pairs(values) -> np.ndarray:
    """Python ints -> (k, 2) uint64 (lo, hi) words."""
    m = (1 << 64) - 1
    return np.array([[int(v) & m, int(v) >> 64] for v in values],
                    dtype=np.uint64).reshape(-1, 2)


def _require_f128() -> ctypes.CDLL:
    lib = _load_f128()
    if lib is None:
        raise RuntimeError("the native f128 library is not built (no C "
                           "compiler)")
    return lib


def _u128(v: int):
    m = (1 << 64) - 1
    return (ctypes.c_uint64 * 2)(v & m, v >> 64)


def _consts(mds, ark):
    """The flat MDS matrix and the round-constant rows as (k, 2) words."""
    return _pairs(mds), _pairs([v for row in ark for v in row])


def rescue128_trace(seed, iterations: int, mds, ark,
                    inv_alpha: int) -> np.ndarray:
    """The Rescue hash-chain trace of examples/rescue.py built by
    native/f128.c ``wt_rescue128_trace``: a (16·iterations, 4, 2) uint64
    array of (lo, hi) element words. ``mds`` is the flat 16-entry MDS matrix,
    ``ark`` the 16x8 round constants, as Python ints."""
    lib = _require_f128()
    out = np.empty((16 * iterations, 4, 2), dtype=np.uint64)
    seed_arr = _pairs(seed)
    mds_arr, ark_arr = _consts(mds, ark)
    lib.wt_rescue128_trace(seed_arr.ctypes.data, iterations,
                           mds_arr.ctypes.data, ark_arr.ctypes.data,
                           _u128(inv_alpha), out.ctypes.data)
    return out


def rescue128w6_sponge(data, mds, ark, inv_alpha: int):
    """The width-6 Rescue sponge (rate 4, examples/src/utils/rescue.rs:
    81-101) over a list of f128 elements by ``wt_rescue128w6_sponge``: the
    (state[0], state[1]) digest as Python ints."""
    lib = _require_f128()
    data_arr = _pairs(data)
    mds_arr, ark_arr = _consts(mds, ark)
    out = (ctypes.c_uint64 * 4)()
    lib.wt_rescue128w6_sponge(data_arr.ctypes.data, len(data),
                              mds_arr.ctypes.data, ark_arr.ctypes.data,
                              _u128(inv_alpha), out)
    return (out[0] | (out[1] << 64), out[2] | (out[3] << 64))


def rescue128w6_hash2_many(pairs, mds, ark, inv_alpha: int):
    """The width-6 Rescue digest of each 2-element input (a Lamport key's 254
    per-bit public keys) by ``wt_rescue128w6_hash2_many``: a list of
    (d0, d1) digests."""
    lib = _require_f128()
    n = len(pairs)
    inp = _pairs([v for pair in pairs for v in pair]).reshape(n, 2, 2)
    mds_arr, ark_arr = _consts(mds, ark)
    out = np.empty((n, 2, 2), dtype=np.uint64)
    lib.wt_rescue128w6_hash2_many(inp.ctypes.data, n, mds_arr.ctypes.data,
                                  ark_arr.ctypes.data, _u128(inv_alpha),
                                  out.ctypes.data)
    return [(int(d[0, 0]) | (int(d[0, 1]) << 64),
             int(d[1, 0]) | (int(d[1, 1]) << 64)) for d in out]


def lamport_trace(msgs, sec1, sec2, pub1, pub2, mds, ark,
                  inv_alpha: int) -> np.ndarray:
    """The Lamport aggregate trace of examples/lamport.py built by
    ``wt_lamport_trace``: a (1024·nsig, 22, 2) uint64 array of (lo, hi)
    words. ``msgs`` holds each signature's (m0, m1); the four key
    schedules are nsig lists of 128 (k0, k1) pairs."""
    lib = _require_f128()
    nsig = len(msgs)

    def sched(s):
        return _pairs([v for sig in s for pair in sig for v in pair]).reshape(
            nsig, 128, 2, 2)

    msgs_arr = _pairs([v for m in msgs for v in m]).reshape(nsig, 2, 2)
    s1, s2, p1, p2 = map(sched, (sec1, sec2, pub1, pub2))
    mds_arr, ark_arr = _consts(mds, ark)
    out = np.empty((1024 * nsig, 22, 2), dtype=np.uint64)
    lib.wt_lamport_trace(msgs_arr.ctypes.data, s1.ctypes.data, s2.ctypes.data,
                         p1.ctypes.data, p2.ctypes.data, nsig,
                         mds_arr.ctypes.data, ark_arr.ctypes.data,
                         _u128(inv_alpha), out.ctypes.data)
    return out
