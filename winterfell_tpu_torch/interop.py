"""Carrying state between the JAX package and the port.

What defines a proof is the trace, the hasher's constants and the proof
options. Both packages hold field elements the same way at their numpy
boundary — uint64 arrays of canonical values — and BLAKE3 / SHA3 digests
and coin seeds the same way too — uint32 arrays of little-endian words — so
crossing over is a dtype view. f128 elements differ: the JAX engine holds
four 32-bit digits on a trailing axis of 4 (uint64 lanes), the port two
64-bit words (lo, hi) on a trailing axis of 2; the f128 helpers convert
between those, Python ints and tensors. So do f62 elements: the JAX engine
holds two 32-bit limbs on a trailing axis of 2, the port one int64 (the
canonical value, as a uint64 array of canonical values holds it:
``tensor_from_u64``); the f62 helpers convert. These helpers take plain
numpy arrays, ints and bytes only.
"""

from __future__ import annotations

import numpy as np
import torch

from .air.options import ProofOptions
from .math.fields import F64
from .ops import f128
from .prover import TraceTable
from .utils.serde import ByteReader, DeserializationError


def tensor_from_u64(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """uint64 array → int64 tensor with the same bits, on ``device``."""
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def u64_from_tensor(t: torch.Tensor) -> np.ndarray:
    """int64 tensor → uint64 array with the same bits, on the host."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64).copy()


def tensor_from_u32(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 word array (digests, seeds) → int32 tensor with the same
    bits, on ``device``."""
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def u32_from_tensor(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor → uint32 array with the same bits, on the host."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32).copy()


def tensor_from_ints(values, device="cpu") -> torch.Tensor:
    """Array (or nested list) of canonical f128 ints → (..., 2) int64 tensor
    of (lo, hi) words, on ``device``."""
    return f128.to_device(np.asarray(values, dtype=object), device)


def ints_from_tensor(t: torch.Tensor) -> np.ndarray:
    """(..., 2) int64 f128 tensor → object array of Python ints."""
    return f128.to_ints(t)


def tensor_from_limbs(limbs: np.ndarray, device="cpu") -> torch.Tensor:
    """The JAX f128 engine's (..., 4) uint64 digit array → (..., 2) int64
    tensor with the same element values."""
    d = np.ascontiguousarray(limbs, dtype=np.uint64)
    words = np.stack([d[..., 0] | (d[..., 1] << np.uint64(32)),
                      d[..., 2] | (d[..., 3] << np.uint64(32))], axis=-1)
    return torch.from_numpy(words.view(np.int64).copy()).to(device)


def limbs_from_tensor(t: torch.Tensor) -> np.ndarray:
    """(..., 2) int64 f128 tensor → the JAX engine's (..., 4) uint64 digit
    array."""
    w = f128.to_u64(t)
    m = np.uint64(0xFFFFFFFF)
    return np.stack([w[..., 0] & m, w[..., 0] >> np.uint64(32),
                     w[..., 1] & m, w[..., 1] >> np.uint64(32)], axis=-1)


def tensor_from_f62_limbs(limbs: np.ndarray, device="cpu") -> torch.Tensor:
    """The JAX f62 engine's (..., 2) uint64 limb array → int64 tensor of the
    same element values."""
    d = np.ascontiguousarray(limbs, dtype=np.uint64)
    values = d[..., 0] | (d[..., 1] << np.uint64(32))
    return torch.from_numpy(values.view(np.int64).copy()).to(device)


def f62_limbs_from_tensor(t: torch.Tensor) -> np.ndarray:
    """int64 f62 tensor → the JAX engine's (..., 2) uint64 limb array."""
    v = u64_from_tensor(t)
    return np.stack([v & np.uint64(0xFFFFFFFF), v >> np.uint64(32)], axis=-1)


def trace_from_numpy(rows_u64: np.ndarray, device=None) -> TraceTable:
    """An f64 TraceTable of the (n, w) uint64 rows. With ``device``, the rows
    are also uploaded there and cached for the port's GoldilocksProver."""
    rows = np.ascontiguousarray(rows_u64, dtype=np.uint64)
    trace = TraceTable(F64, rows.shape[1], rows.shape[0])
    trace.set_native_rows(rows.copy())
    if device is not None:
        dev = torch.device(device)
        trace.device_cache()[("torch", str(dev))] = tensor_from_u64(rows, dev)
    return trace


def options_from_bytes(data: bytes) -> ProofOptions:
    """Proof options serialized by either package (``write_into``), as the
    port's."""
    r = ByteReader(data)
    options = ProofOptions.read_from(r)
    if r.has_more_bytes():
        raise DeserializationError("unconsumed proof option bytes")
    return options
