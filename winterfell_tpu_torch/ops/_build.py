"""Builds the port's CUDA sources into plain-C shared libraries and loads them
with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
``_build/lib<name>-<hash>.so`` beside the package, keyed by a hash of the
source and the flags, at first use. ``build_all()`` starts one ``nvcc`` per
source at once and waits for all of them. No PyTorch header is included, so a
build takes seconds. The C entry points take raw device pointers, sizes and
a stream, and return ``cudaGetLastError()`` of their launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("rescue", "goldilocks")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")


def _start(name: str):
    """Starts nvcc for ``name`` unless its library exists; returns
    (process or None, temp path, target path)."""
    target = _target(name)
    if os.path.exists(target):
        return None, None, target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, proc, tmp: str, target: str) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builders race harmlessly


def build_all(names: List[str] = SOURCES) -> None:
    """Compiles every source not yet built, all nvcc processes at once."""
    started = [(name, *_start(name)) for name in names]
    for name, proc, tmp, target in started:
        _finish(name, proc, tmp, target)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        proc, tmp, target = _start(name)
        _finish(name, proc, tmp, target)
        lib = _libs[name] = ctypes.CDLL(target)
    return lib
