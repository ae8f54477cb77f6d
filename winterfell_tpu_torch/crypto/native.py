"""The native host helpers, built with the C compiler and loaded with ctypes:
the BLAKE3 of ``native/blake3.c`` and the f128 Rescue chain builder of
``native/f128.c``.

At first use a source is compiled alone with ``cc -O3 -fPIC -shared`` into
``_build/lib<name>-<hash>.so`` beside the package (``_build`` is not part of
the repository), keyed by a hash of the source and the flags as
``ops/_build.py`` keys the CUDA libraries. Nothing is written into
``native/``. Without a C compiler ``available()`` (``f128_available()``) is
False and the host hashers use the pure-Python BLAKE3 of
``crypto/blake3_host.py``, the Rescue example its Python chain
(``examples/rescue.py``); both are these libraries' oracles, and the device
kernels never depend on them.
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


def _target(source: str) -> str:
    with open(source, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(CFLAGS).encode())
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")


def _build(source: str, target: str) -> bool:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.run([cc, *CFLAGS, "-o", tmp, source],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        return False
    os.replace(tmp, target)  # atomic: concurrent builds race harmlessly
    return True


def _open(source: str, setup) -> Optional[ctypes.CDLL]:
    """The library of ``source``, built first if needed and its entry points
    typed by ``setup``; None without a C compiler (decided once per
    process)."""
    if source in _libs:
        return _libs[source]
    target = _target(source) if os.path.exists(source) else None
    lib = None
    if target is not None and (os.path.exists(target)
                               or _build(source, target)):
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
    lib.wt_rescue128_trace.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_uint64 * 2, ctypes.c_void_p]
    lib.wt_rescue128_trace.restype = None


def _load() -> Optional[ctypes.CDLL]:
    return _open(SOURCE, _setup_blake3)


def _load_f128() -> Optional[ctypes.CDLL]:
    return _open(F128_SOURCE, _setup_f128)


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


def rescue128_trace(seed, iterations: int, mds, ark,
                    inv_alpha: int) -> np.ndarray:
    """The Rescue hash-chain trace of examples/rescue.py built by
    native/f128.c ``wt_rescue128_trace``: a (16·iterations, 4, 2) uint64
    array of (lo, hi) element words. ``mds`` is the flat 16-entry MDS matrix,
    ``ark`` the 16x8 round constants, as Python ints."""
    lib = _load_f128()
    if lib is None:
        raise RuntimeError("the native f128 library is not built (no C "
                           "compiler)")
    out = np.empty((16 * iterations, 4, 2), dtype=np.uint64)
    seed_arr = _pairs(seed)
    mds_arr = _pairs(mds)
    ark_arr = _pairs([v for row in ark for v in row])
    m = (1 << 64) - 1
    lib.wt_rescue128_trace(seed_arr.ctypes.data, iterations,
                           mds_arr.ctypes.data, ark_arr.ctypes.data,
                           (ctypes.c_uint64 * 2)(inv_alpha & m,
                                                 inv_alpha >> 64),
                           out.ctypes.data)
    return out
