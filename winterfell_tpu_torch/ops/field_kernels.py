"""Elementwise Goldilocks kernels: K3, the multiply (the port of the TPU's
Pallas kernel ``gl_mul_pallas`` in winterfell_tpu/ops/pallas_kernels.py),
and B0 / B0x, the add, subtract and extension product (the ports of the jnp
programs ``gl_add``, ``gl_sub`` and ``ext_mul`` in
winterfell_tpu/ops/goldilocks.py), all in ``csrc/goldilocks.cu``.

``ops/goldilocks.py`` routes every such op here: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain version. The parts:

- ``mul_layout(a, b)``: checks the operands and returns the layout the
  kernel reads (broadcast shape, dims of size 1 dropped, neighbouring dims
  merged where both operands allow it, and whether it ``fits`` the kernel's
  32-bit offsets: the result and each operand's extent at most
  ``INDEX_LIMIT`` elements). ``ext_layout(a, b)`` is the same over the
  leading dims of two (..., D) extension operands, with each operand's
  component stride. Both run on every device, so the CPU tests hold every
  caller to what the kernels take;
- ``op_kernel(name, a, b)`` (name "gl_mul", "gl_add" or "gl_sub";
  ``gl_mul_kernel`` for K3) and ``ext_mul_kernel(a, b)``: launch the
  kernel on the current stream, without synchronising, and add one to
  ``LAUNCHES[name]`` per launch. They read broadcast operands (stride 0) and strided views in
  place (a Python int for ``b`` of the base ops); a result that does not
  fit is split along its outermost dim into halves, each launched into its
  part of the result (``mul_into``), as the JAX engine computes any size;
  they raise for anything but CUDA tensors;
- ``gl_mul_plain``, ``gl_add_plain``, ``gl_sub_plain``, ``ext_mul_plain``:
  the same functions in plain PyTorch (the JAX formulas on int64 bit
  patterns), the CPU path and the versions ``chip_smoke.py`` holds the
  kernels against.

Operands are int64 tensors holding u64 bit patterns. Both versions compute
the JAX formula for every pair of u64 patterns, inputs >= p included.

``LAUNCHES`` also counts B4 (``gl_ntt_stage``) and B5 (``gl_fri_fold``),
whose wrappers are in ``ops/goldilocks.py``; ``kernels()`` is the loaded
library for them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from . import goldilocks as gl

MAX_DIMS = 8  # csrc/goldilocks.cu MAX_DIMS
# the kernels' offsets are 32-bit: the result's size and the largest
# element offset of each operand stay at or below this
INDEX_LIMIT = 2**31 - 1

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"gl_mul": 0, "gl_add": 0, "gl_sub": 0,
                            "gl_ext_mul": 0, "gl_ntt_stage": 0,
                            "gl_fri_fold": 0}
_OPS = {"gl_add": 0, "gl_sub": 1, "gl_mul": 2}  # csrc/goldilocks.cu Op


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class MulLayout(NamedTuple):
    shape: Tuple[int, ...]    # broadcast shape of the result
    numel: int                # elements (of the leading dims for ext_layout)
    sizes: Tuple[int, ...]    # coalesced dims, outermost first
    a_strides: Tuple[int, ...]
    b_strides: Tuple[int, ...]  # () when b is a Python int
    fits: bool  # within the kernel's 32-bit offsets
    a_comp: int = 0  # component strides of ext_layout's operands
    b_comp: int = 0


# ================================================================================
# Plain versions
# ================================================================================


def _scalar(b):
    """A Python-int operand as a 0-dim CPU tensor (a scalar on any device)."""
    return torch.tensor(gl._s64(b)) if isinstance(b, int) else b


def gl_mul_plain(a, b):
    """a·b mod p in plain PyTorch; ``b`` may be a tensor that broadcasts
    against ``a`` or a Python int (any u64 pattern)."""
    return gl._reduce_128(*gl._mul_128(a, _scalar(b)))


def gl_add_plain(a, b):
    """(a + b) mod p (the JAX gl_add): on u64 overflow add 2^32 − 1, then
    subtract p once if the sum is >= p."""
    b = _scalar(b)
    s = torch.add(a, b)
    s = torch.where(gl._ult(s, a), torch.add(s, gl._T_EPS), s)
    return gl._canon(s)


def gl_sub_plain(a, b):
    """a − b (the JAX gl_sub): on a borrow subtract 2^32 − 1."""
    b = _scalar(b)
    d = torch.sub(a, b)
    return torch.where(gl._ult(a, b), torch.sub(d, gl._T_EPS), d)


def ext_mul_plain(a, b):
    """a·b of (..., D) extension elements, D in {2, 3} (quadratic x² =
    x − 2, cubic x³ = x + 1: the JAX ext_mul, its order of additions)."""
    mul, add, sub = gl_mul_plain, gl_add_plain, gl_sub_plain
    if a.shape[-1] == 2:
        a0, a1 = a[..., 0], a[..., 1]
        b0, b1 = b[..., 0], b[..., 1]
        t2 = mul(a1, b1)
        c0 = sub(mul(a0, b0), add(t2, t2))
        c1 = add(add(mul(a0, b1), mul(a1, b0)), t2)
        return torch.stack([c0, c1], dim=-1)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    t0 = mul(a0, b0)
    t1 = add(mul(a0, b1), mul(a1, b0))
    t2 = add(add(mul(a0, b2), mul(a1, b1)), mul(a2, b0))
    t3 = add(mul(a1, b2), mul(a2, b1))
    t4 = mul(a2, b2)
    # x³ = x + 1; x⁴ = x² + x
    return torch.stack([add(t0, t3), add(t1, add(t3, t4)), add(t2, t4)],
                       dim=-1)


_PLAIN = {"gl_mul": gl_mul_plain, "gl_add": gl_add_plain,
          "gl_sub": gl_sub_plain}


# ================================================================================
# Layouts
# ================================================================================


def _check_tensor(x, what: str, name: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: the {what} operand must be a tensor, got "
                        f"{type(x).__name__}")
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 field elements, got "
                        f"{x.dtype}")


def mul_layout(a, b, name: str = "gl_mul") -> MulLayout:
    """The checked layout of a ∘ b; raises on operands the kernel cannot
    take."""
    _check_tensor(a, "first", name)
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device.type}")
    scalar = isinstance(b, int)
    if not scalar:
        if not isinstance(b, torch.Tensor):
            raise TypeError(f"{name}: the second operand must be a tensor or "
                            f"an int, got {type(b).__name__}")
        _check_tensor(b, "second", name)
        if b.device != a.device:
            raise ValueError(f"{name}: operands on {a.device} and {b.device}")
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
        raise ValueError(f"{name}: {len(merged)} dims after merging, the "
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


def ext_layout(a, b) -> MulLayout:
    """The checked layout of the extension product a·b of (..., D) tensors
    (D 2 or 3, leading dims that broadcast): ``mul_layout`` of their first
    components, the shape with D after it, and each operand's component
    stride; raises on operands the kernel cannot take."""
    name = "gl_ext_mul"
    _check_tensor(a, "first", name)
    _check_tensor(b, "second", name)
    d = a.shape[-1] if a.dim() else 0
    if d not in (2, 3) or b.dim() == 0 or b.shape[-1] != d:
        raise ValueError(f"{name}: expected (..., 2) or (..., 3) operands "
                         f"of one degree, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    lead = mul_layout(a[..., 0], b[..., 0], name)
    ca, cb = a.stride(-1), b.stride(-1)
    reach = max(lead.numel * d,
                1 + sum((s - 1) * x for s, x in zip(lead.sizes,
                                                    lead.a_strides))
                + (d - 1) * ca,
                1 + sum((s - 1) * y for s, y in zip(lead.sizes,
                                                    lead.b_strides))
                + (d - 1) * cb)
    return lead._replace(shape=lead.shape + (d,), fits=reach <= INDEX_LIMIT,
                         a_comp=ca, b_comp=cb)


# ================================================================================
# The kernels (csrc/goldilocks.cu)
# ================================================================================


_lib = None


def kernels():
    """The loaded library of csrc/goldilocks.cu, built at first use."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("goldilocks")
        vp, i64, u64, cint = (ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_uint64, ctypes.c_int)
        lib.wt_gl_op.argtypes = [cint, vp, vp, u64, vp, i64, cint, vp, vp,
                                 vp, vp]
        lib.wt_gl_ext_mul.argtypes = [cint, vp, vp, vp, i64, cint, vp, vp,
                                      vp, i64, i64, vp]
        lib.wt_gl_ntt_stage.argtypes = [vp, vp, vp, i64, i64, cint, i64, vp]
        lib.wt_gl_fri_fold.argtypes = [vp, vp, vp, vp, i64, cint, cint, vp,
                                       u64, vp]
        for fn in (lib.wt_gl_op, lib.wt_gl_ext_mul, lib.wt_gl_ntt_stage,
                   lib.wt_gl_fri_fold):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require_cuda(a, name: str) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{name}_kernel: the kernel takes CUDA tensors, got "
                         f"{a.device}")


def op_kernel(name: str, a, b, layout: MulLayout = None):
    """K3 (name "gl_mul") or B0 ("gl_add", "gl_sub") on CUDA tensors: a ∘ b,
    contiguous in the broadcast shape."""
    if layout is None:
        layout = mul_layout(a, b, name)
    require_cuda(a, name)
    out = torch.empty(layout.shape, dtype=torch.int64, device=a.device)
    mul_into(a, b, out, _LAUNCH[name], layout)
    return out


def gl_mul_kernel(a, b, layout: MulLayout = None):
    return op_kernel("gl_mul", a, b, layout)


def op(name: str, a, b):
    """a ∘ b: the layout checked on every device, then the kernel for a
    CUDA tensor and the plain version for a CPU tensor."""
    layout = mul_layout(a, b, name)
    if a.device.type == "cpu":
        return _PLAIN[name](a, b)
    return op_kernel(name, a, b, layout)


def ext_mul_kernel(a, b, layout: MulLayout = None):
    """B0x on CUDA tensors: the extension product a·b, contiguous (..., D)."""
    if layout is None:
        layout = ext_layout(a, b)
    require_cuda(a, "gl_ext_mul")
    out = torch.empty(layout.shape, dtype=torch.int64, device=a.device)
    mul_into(a, b, out, _launch_ext, layout, ext_layout)
    return out


def ext_mul(a, b):
    """The extension product of (..., D) operands, D 2 or 3, routed as
    ``op``."""
    layout = ext_layout(a, b)
    if a.device.type == "cpu":
        return ext_mul_plain(a, b)
    return ext_mul_kernel(a, b, layout)


def mul_into(a, b, out, launch, layout: MulLayout = None,
             layout_of=mul_layout) -> None:
    """out <- a ∘ b for a contiguous ``out`` of the broadcast shape:
    ``launch(a, b, out, layout)`` where the layout (``layout_of(a, b)``)
    fits the kernel's offsets, else the two halves of the outermost dim of
    size > 1 in turn (every dim before it has size 1, so each half of
    ``out`` is contiguous)."""
    if layout is None:
        layout = layout_of(a, b)
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
                 launch, None, layout_of)


def _launcher(name: str):
    code = _OPS[name]

    def launch(a, b, out, layout: MulLayout) -> None:
        """One launch writing a ∘ b into the contiguous ``out``."""
        nd = len(layout.sizes)
        arr = ctypes.c_int64 * nd
        scalar = isinstance(b, int)
        lib = kernels()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.wt_gl_op(
                code, a.data_ptr(), None if scalar else b.data_ptr(),
                (b & 0xFFFFFFFFFFFFFFFF) if scalar else 0, out.data_ptr(),
                layout.numel, nd, arr(*layout.sizes), arr(*layout.a_strides),
                None if scalar else arr(*layout.b_strides), stream)
        raise_on(err, name)
        LAUNCHES[name] += 1

    return launch


_LAUNCH = {name: _launcher(name) for name in _OPS}


def _launch_ext(a, b, out, layout: MulLayout) -> None:
    """One B0x launch writing a·b into the contiguous ``out``."""
    nd = len(layout.sizes)
    arr = ctypes.c_int64 * nd
    lib = kernels()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_gl_ext_mul(
            layout.shape[-1], a.data_ptr(), b.data_ptr(), out.data_ptr(),
            layout.numel, nd, arr(*layout.sizes), arr(*layout.a_strides),
            arr(*layout.b_strides), layout.a_comp, layout.b_comp, stream)
    raise_on(err, "gl_ext_mul")
    LAUNCHES["gl_ext_mul"] += 1
