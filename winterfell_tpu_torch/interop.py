"""Carrying state between the JAX package and the port.

What defines a proof is the trace, the hasher's constants and the proof
options. Both packages hold field elements the same way at their numpy
boundary — uint64 arrays of canonical values — and BLAKE3 / SHA3 digests
and coin seeds the same way too — uint32 arrays of little-endian words — so
crossing over is a dtype view. These helpers take plain numpy arrays, ints
and bytes only.
"""

from __future__ import annotations

import numpy as np
import torch

from .air.options import ProofOptions
from .math.fields import F64
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
