"""Elementwise Goldilocks multiply (K3): the port of the TPU's Pallas kernel
``gl_mul_pallas`` in winterfell_tpu/ops/pallas_kernels.py.

``ops/goldilocks.py:gl_mul`` routes every multiply here: a CUDA tensor goes
to the hand-written kernel of ``csrc/goldilocks.cu``, a CPU tensor to the
plain version. The parts:

- ``mul_layout(a, b)``: checks the operands and returns the layout the
  kernel reads (broadcast shape, dims of size 1 dropped, neighbouring dims
  merged where both operands allow it, and whether it ``fits`` the kernel's
  32-bit offsets: the product and each operand's extent at most
  ``INDEX_LIMIT`` elements). It runs on every device, so the CPU tests hold
  every caller to what the kernel takes;
- ``gl_mul_kernel(a, b)``: launches the kernel on the current stream,
  without synchronising, and adds one to ``LAUNCHES["gl_mul"]`` per launch.
  It reads broadcast operands (stride 0) and strided views in place and
  takes a Python int for ``b``; a product that does not fit is split along
  its outermost dim into halves, each launched into its part of the result
  (``mul_into``), as the JAX ``gl_mul`` computes any size; it raises for
  anything but CUDA tensors;
- ``gl_mul_plain(a, b)``: the same function in plain PyTorch (128-bit
  product from 32-bit halves, then the reduction), the CPU path and the
  version ``chip_smoke.py`` holds the kernel against.

Operands are int64 tensors holding u64 bit patterns. Both versions are exact
for every pair of u64 patterns, inputs >= p included, and return canonical
values.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from . import goldilocks as gl

MAX_DIMS = 8  # csrc/goldilocks.cu MAX_DIMS
# the kernel's offsets are 32-bit: the product's size and the largest
# element offset of each operand stay at or below this
INDEX_LIMIT = 2**31 - 1

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"gl_mul": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class MulLayout(NamedTuple):
    shape: Tuple[int, ...]    # broadcast shape of the result
    numel: int
    sizes: Tuple[int, ...]    # coalesced dims, outermost first
    a_strides: Tuple[int, ...]
    b_strides: Tuple[int, ...]  # () when b is a Python int
    fits: bool  # within the kernel's 32-bit offsets


def gl_mul_plain(a, b):
    """a·b mod p in plain PyTorch; ``b`` may be a tensor that broadcasts
    against ``a`` or a Python int (any u64 pattern)."""
    if isinstance(b, int):  # a 0-dim CPU tensor: a scalar on any device
        b = torch.tensor(gl._s64(b))
    return gl._reduce_128(*gl._mul_128(a, b))


def mul_layout(a, b) -> MulLayout:
    """The checked layout of a·b; raises on operands the kernel cannot take."""
    if not isinstance(a, torch.Tensor):
        raise TypeError("gl_mul: the first operand must be a tensor")
    if a.dtype != torch.int64:
        raise TypeError(f"gl_mul: expected int64 field elements, got {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gl_mul runs on cpu or cuda, not {a.device.type}")
    scalar = isinstance(b, int)
    if not scalar:
        if not isinstance(b, torch.Tensor):
            raise TypeError("gl_mul: the second operand must be a tensor or "
                            f"an int, got {type(b).__name__}")
        if b.dtype != torch.int64:
            raise TypeError(f"gl_mul: expected int64 field elements, got "
                            f"{b.dtype}")
        if b.device != a.device:
            raise ValueError(f"gl_mul: operands on {a.device} and {b.device}")
    shape = tuple(torch.broadcast_shapes(a.shape, () if scalar else b.shape))
    sa = a.expand(shape).stride()
    sb = (0,) * len(shape) if scalar else b.expand(shape).stride()
    merged = []  # [size, stride_a, stride_b], outermost first
    for size, x, y in zip(shape, sa, sb):
        if size == 1:
            continue
        if merged and merged[-1][1] == x * size and merged[-1][2] == y * size:
            merged[-1] = [merged[-1][0] * size, x, y]
        else:
            merged.append([size, x, y])
    if not merged:
        merged = [[1, 0, 0]]
    if len(merged) > MAX_DIMS:
        raise ValueError(f"gl_mul: {len(merged)} dims after merging, the "
                         f"kernel takes at most {MAX_DIMS}")
    numel = 1
    for size in shape:
        numel *= size
    reach = max(numel, 1 + sum((m[0] - 1) * m[1] for m in merged),
                1 + sum((m[0] - 1) * m[2] for m in merged))
    return MulLayout(shape, numel, tuple(m[0] for m in merged),
                     tuple(m[1] for m in merged),
                     () if scalar else tuple(m[2] for m in merged),
                     reach <= INDEX_LIMIT)


_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("goldilocks")
        vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        lib.wt_gl_mul.argtypes = [vp, vp, u64, vp, i64, ctypes.c_int, vp, vp,
                                  vp, vp]
        lib.wt_gl_mul.restype = ctypes.c_int
        _lib = lib
    return _lib


def gl_mul_kernel(a, b, layout: MulLayout = None):
    """K3 on CUDA tensors: a·b mod p, contiguous in the broadcast shape."""
    if layout is None:
        layout = mul_layout(a, b)
    if a.device.type != "cuda":
        raise ValueError("gl_mul_kernel: the kernel takes CUDA tensors, got "
                         f"{a.device}")
    out = torch.empty(layout.shape, dtype=torch.int64, device=a.device)
    mul_into(a, b, out, _launch, layout)
    return out


def mul_into(a, b, out, launch, layout: MulLayout = None) -> None:
    """out <- a·b for a contiguous ``out`` of the broadcast shape:
    ``launch(a, b, out, layout)`` where the layout fits the kernel's offsets,
    else the two halves of the outermost dim of size > 1 in turn (every dim
    before it has size 1, so each half of ``out`` is contiguous)."""
    if layout is None:
        layout = mul_layout(a, b)
    if layout.numel == 0:
        return
    if layout.fits:
        launch(a, b, out, layout)
        return
    shape = layout.shape
    d = next(i for i, size in enumerate(shape) if size > 1)
    half = shape[d] // 2
    a = a.expand(shape)
    if not isinstance(b, int):
        b = b.expand(shape)
    lead = (slice(None),) * d
    for part in (slice(0, half), slice(half, shape[d])):
        idx = lead + (part,)
        mul_into(a[idx], b if isinstance(b, int) else b[idx], out[idx],
                 launch)


def _launch(a, b, out, layout: MulLayout) -> None:
    """One K3 launch writing a·b into the contiguous ``out``."""
    nd = len(layout.sizes)
    arr = ctypes.c_int64 * nd
    scalar = isinstance(b, int)
    lib = _kernels()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_gl_mul(
            a.data_ptr(), None if scalar else b.data_ptr(),
            (b & 0xFFFFFFFFFFFFFFFF) if scalar else 0, out.data_ptr(),
            layout.numel, nd, arr(*layout.sizes), arr(*layout.a_strides),
            None if scalar else arr(*layout.b_strides), stream)
    if err != 0:
        raise RuntimeError(f"gl_mul: CUDA launch failed with error {err}")
    LAUNCHES["gl_mul"] += 1
