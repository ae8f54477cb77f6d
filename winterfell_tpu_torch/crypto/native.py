"""The native host BLAKE3 (``native/blake3.c``), built with the C compiler and
loaded with ctypes.

At first use the source is compiled alone with ``cc -O3 -fPIC -shared`` into
``_build/libblake3-<hash>.so`` beside the package (``_build`` is not part of
the repository), keyed by a hash of the source and the flags as
``ops/_build.py`` keys the CUDA libraries. Nothing is written into
``native/``. Without a C compiler ``available()`` is False and the host
hashers use the pure-Python BLAKE3 of ``crypto/blake3_host.py``, which is
this library's oracle; the device kernels never depend on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "blake3.c")
BUILD_DIR = os.path.join(_PKG, "_build")
CFLAGS = ["-O3", "-fPIC", "-shared", "-std=c11"]

_lib: Optional[ctypes.CDLL] = None
_failed = False


def _target() -> str:
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(CFLAGS).encode())
    return os.path.join(BUILD_DIR, f"libblake3-{key.hexdigest()[:16]}.so")


def _build(target: str) -> bool:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.run([cc, *CFLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        return False
    os.replace(tmp, target)  # atomic: concurrent builds race harmlessly
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    target = _target() if os.path.exists(SOURCE) else None
    if target is None or not (os.path.exists(target) or _build(target)):
        _failed = True
        return None
    lib = ctypes.CDLL(target)
    lib.wt_blake3.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.c_char_p]
    lib.wt_blake3.restype = None
    lib.wt_blake3_many.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_size_t, ctypes.c_char_p]
    lib.wt_blake3_many.restype = None
    lib.wt_blake3_grind.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_uint32, ctypes.c_uint64]
    lib.wt_blake3_grind.restype = ctypes.c_uint64
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


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
