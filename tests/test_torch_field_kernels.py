"""K3, the port's elementwise Goldilocks multiply (winterfell_tpu_torch.ops.
field_kernels), against the TPU kernel it replaces
(winterfell_tpu/ops/pallas_kernels.py gl_mul_pallas, in interpret mode as
tests/test_pallas_kernels.py runs it) and the exact Python-int oracle; the
routing of ops/goldilocks.py:gl_mul on the CPU; and what the wrappers of
K3, B0 (add, subtract), B0x (extension product), B4 (NTT stage) and B5 (FRI
fold) refuse on the CPU: the layouts and dtypes their kernels cannot read,
and CPU tensors handed to a kernel entry."""

import random

import jax
import numpy as np
import pytest
import torch

from winterfell_tpu.ops.pallas_kernels import (
    P,
    gl_mul_pallas,
    join_limbs,
    split_limbs,
)
from winterfell_tpu_torch.ops import field_kernels as fk
from winterfell_tpu_torch.ops import goldilocks as gl
from winterfell_tpu_torch.ops import ntt_mxu

jax.config.update("jax_platforms", "cpu")

CORNERS = [0, 1, 2, P - 1, P - 2, 2**32, 2**32 - 1, 2**32 + 1, 2**63,
           2**63 - 1, P // 2, P // 2 + 1, 0xFFFFFFFF00000000 % P]
# u64 patterns >= p: the kernel and its plain version are exact for them too
ABOVE_P = [P, P + 1, 2**64 - 2**32, 2**64 - 2, 2**64 - 1]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64)
                            .view(np.int64))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint64)


def _oracle(a: np.ndarray, b) -> np.ndarray:
    return ((a.astype(object) * np.asarray(b, dtype=np.uint64).astype(object))
            % P).astype(np.uint64)


def _pallas(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ol, oh = gl_mul_pallas(*split_limbs(a), *split_limbs(b), True)
    return join_limbs(np.asarray(ol), np.asarray(oh))


def _pairs(vals, rows=8):
    pairs = [(x, y) for x in vals for y in vals]
    pairs += [(0, 0)] * ((-len(pairs)) % rows)
    a = np.array([x for x, _ in pairs], dtype=np.uint64).reshape(rows, -1)
    b = np.array([y for _, y in pairs], dtype=np.uint64).reshape(rows, -1)
    return a, b


def _near_p_multiples():
    """Products that land just above or below multiples of p (the Pallas
    test's set)."""
    rng = random.Random(7)
    vals = []
    for _ in range(512):
        x = rng.randrange(1, P)
        inv = pow(x, P - 2, P)
        vals.append((x, inv * rng.randrange(0, 4) % P))
        vals.append((x, inv * (P - 1 - rng.randrange(0, 4)) % P))
    a = np.array([v[0] for v in vals], dtype=np.uint64).reshape(8, -1)
    b = np.array([v[1] for v in vals], dtype=np.uint64).reshape(8, -1)
    return a, b


def _random_sweep():
    rng = np.random.default_rng(42)
    return (rng.integers(0, P, size=(16, 1024), dtype=np.uint64),
            rng.integers(0, P, size=(16, 1024), dtype=np.uint64))


def test_plain_equals_pallas_kernel_and_oracle():
    """The random sweep, the corner set and the near-multiples-of-p set of
    tests/test_pallas_kernels.py, and corners against u64 patterns >= p."""
    for a, b in (_random_sweep(), _pairs(CORNERS), _near_p_multiples(),
                 _pairs(CORNERS[:6] + ABOVE_P)):
        got = _u64(fk.gl_mul_plain(_t(a), _t(b)))
        assert np.array_equal(got, _pallas(a, b))
        assert np.array_equal(got, _oracle(a, b))
        # the routed entry point takes the plain version for CPU tensors
        assert np.array_equal(_u64(gl.gl_mul(_t(a), _t(b))), got)


def test_python_int_operand():
    """Python ints reach gl_mul as canonical constants (gl.const gives their
    int64 pattern) or as any other u64 pattern, signed or not."""
    a = np.random.default_rng(1).integers(0, 2**64, size=(5, 7),
                                          dtype=np.uint64)
    for c in (0, 3, P - 1, 2**64 - 1, gl.const(7), -(2**63)):
        got = _u64(gl.gl_mul(_t(a), c))
        assert np.array_equal(got, _oracle(a, c & (2**64 - 1))), c
        lay = fk.mul_layout(_t(a), c)
        assert (lay.sizes, lay.a_strides, lay.b_strides) == ((35,), (1,), ())


def test_broadcast_operands():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**64, size=(6, 4, 3), dtype=np.uint64)
    col = rng.integers(0, 2**64, size=(6, 1, 1), dtype=np.uint64)  # tinv[:, None]
    row = rng.integers(0, 2**64, size=(3,), dtype=np.uint64)       # ext coeff
    for b in (col, row):
        got = gl.gl_mul(_t(a), _t(b))
        assert got.shape == (6, 4, 3) and got.is_contiguous()
        assert np.array_equal(_u64(got), _oracle(a, np.broadcast_to(b, a.shape)))
    # the smaller operand first broadcasts too
    assert np.array_equal(_u64(gl.gl_mul(_t(col), _t(a))),
                          _oracle(np.broadcast_to(col, a.shape), a))
    lay = fk.mul_layout(_t(a), _t(col))
    assert lay.sizes == (6, 12) and lay.a_strides == (12, 1)
    assert lay.b_strides == (1, 0)


def test_strided_view_operands():
    """The NTT's butterfly halves, the prefix scan's shifted slices and
    one column of an extension array are views, read in place."""
    rng = np.random.default_rng(3)
    x = _t(rng.integers(0, 2**64, size=(8, 2, 4, 3), dtype=np.uint64))
    y = _t(rng.integers(0, 2**64, size=(4, 16), dtype=np.uint64))
    cases = [(x[:, 1], x[:, 0]),               # blk[:, 1] of an NTT stage
             (y[..., 5:], y[..., :-5]),        # _scan_mul step 5
             (x[..., 0], x[..., 2]),           # ext components
             (x[:, 1, :, 0:1], x[0, 0, 0])]    # column × broadcast ext elem
    for a, b in cases:
        expect = _oracle(_u64(a), np.broadcast_to(_u64(b),
                                                  torch.broadcast_shapes(
                                                      a.shape, b.shape)))
        assert np.array_equal(_u64(gl.gl_mul(a, b)), expect)
    lay = fk.mul_layout(x[:, 1], x[:, 0])
    assert lay.sizes == (8, 12) and lay.a_strides == (24, 1)


def test_zero_dim_and_empty_operands():
    z = torch.tensor(-1, dtype=torch.int64)  # the pattern 2^64 - 1
    assert gl.gl_mul(z, z).shape == ()
    assert int(_u64(gl.gl_mul(z, z))) == (2**64 - 1)**2 % P
    e = torch.zeros((0, 3), dtype=torch.int64)
    assert gl.gl_mul(e, 5).shape == (0, 3)


def test_layouts_the_kernel_cannot_take_raise(monkeypatch):
    a = torch.zeros((4, 3), dtype=torch.int64)
    with pytest.raises(TypeError):
        gl.gl_mul(a.to(torch.int32), a)
    with pytest.raises(TypeError):
        gl.gl_mul(a, a.to(torch.float64))
    with pytest.raises(TypeError):
        gl.gl_mul(a, 2.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        gl.gl_mul(a.to("meta"), 3)
    # nine dims that no neighbour can merge with (strides reversed)
    deep = torch.zeros((2,) * 9, dtype=torch.int64).permute(*range(8, -1, -1))
    with pytest.raises(ValueError, match="at most 8"):
        gl.gl_mul(deep, deep)

    # the kernel's offsets are 32-bit: a product of 2^31 elements (a
    # broadcast, so nothing that size is allocated) does not fit one launch,
    # nor does an operand whose strides reach past the limit (shown against
    # a lowered limit: the real one needs a 16 GiB tensor). Such a product
    # is split into launches that each fit, and the parts make the product
    assert not fk.mul_layout(a[:1, :1].expand(2, 2**30), 3).fits
    x = _t(np.random.default_rng(5).integers(0, 2**64, size=(64, 100),
                                            dtype=np.uint64))
    monkeypatch.setattr(fk, "INDEX_LIMIT", 1000)
    lay = fk.mul_layout(x[:10, :5], x[:10, 5:10])  # reach 905
    assert lay.fits and lay.numel == 50
    assert not fk.mul_layout(x[:11, :1], 3).fits  # a's extent 1001
    assert not fk.mul_layout(x[:10, :5], x[::2, 5:10][:10]).fits  # b's 1805
    leaves = []

    def leaf(a, b, out, layout):
        assert layout.fits and out.is_contiguous()
        leaves.append(layout.numel)
        out.copy_(fk.gl_mul_plain(a, b))

    for y, z in ((x[:11, :1], 3), (x[:10, :5], x[::2, 5:10][:10]),
                 (x[:, :40], x[:, 60:]), (x[:1, :1].expand(30, 100), x[0])):
        shape = torch.broadcast_shapes(y.shape, () if isinstance(z, int)
                                       else z.shape)
        out = torch.empty(shape, dtype=torch.int64)
        leaves.clear()
        fk.mul_into(y, z, out, leaf)
        assert len(leaves) > 1 and sum(leaves) == out.numel()
        assert torch.equal(out, fk.gl_mul_plain(y, z))

    # B0 and B0x check their operands as K3 does (on every device), B4 its
    # matrix and twiddles, B5 its evaluations, factor and α; a product
    # beyond the 32-bit offsets of B0x is split into launches that fit
    a = torch.zeros((4, 3), dtype=torch.int64)
    for op in (gl.gl_add, gl.gl_sub):
        with pytest.raises(TypeError):
            op(a.to(torch.int32), a)
        with pytest.raises(TypeError):
            op(a, 2.0)
        with pytest.raises(ValueError, match="cpu or cuda"):
            op(a.to("meta"), 3)
        deep = torch.zeros((2,) * 9, dtype=torch.int64).permute(
            *range(8, -1, -1))
        with pytest.raises(ValueError, match="at most 8"):
            op(deep, deep)
    # B0x: operands of one degree, 2 or 3, int64, leading dims that merge
    # into at most 8
    for x, y in ((a, a[:, :2]), (a.to(torch.int32), a),
                 (torch.zeros((4, 4), dtype=torch.int64),) * 2,
                 (a, torch.zeros((), dtype=torch.int64))):
        with pytest.raises((TypeError, ValueError)):
            fk.ext_layout(x, y)
    deep = torch.zeros((2,) * 9 + (3,), dtype=torch.int64).permute(
        *range(8, -1, -1), 9)
    with pytest.raises(ValueError, match="at most 8"):
        gl.ext_mul(deep, deep)
    with pytest.raises(ValueError, match="cpu or cuda"):
        gl.ext_mul(a.to("meta"), a.to("meta"))
    # B4: a power-of-two (n, cols) int64 matrix, a stage inside it, the
    # (n/2,) twiddle table on its device
    _, tw = gl.ntt_plan(8, False, "cpu")
    m = torch.zeros((8, 2), dtype=torch.int64)
    for x, t, half in ((m, tw, 3), (m, tw, 8), (m[:6], tw, 1),
                       (m.to(torch.int32), tw, 1), (m[:, 0], tw, 1),
                       (m, tw[:3], 1), (m, tw.to(torch.int32), 1)):
        with pytest.raises(ValueError):
            gl.ntt_stage(x, t, half)
    with pytest.raises(ValueError):
        gl.ntt_bitrev_stage(m[:6], tw)
    # B5: (n, d) int64 evaluations with d <= 3, a factor of 2, 4, 8 or 16
    # dividing n, α of d elements on their device
    ev = torch.zeros((32, 3), dtype=torch.int64)
    for e, nf, al in ((ev, 32, ev[0]), (ev, 3, ev[0]), (ev[:12], 8, ev[0]),
                      (torch.zeros((32, 4), dtype=torch.int64), 4,
                       torch.zeros(4, dtype=torch.int64)),
                      (ev.to(torch.int32), 4, ev[0]), (ev, 4, ev[0, :2]),
                      (ev, 4, ev[0].to(torch.int32)), (ev[:, 0], 4, ev[0])):
        with pytest.raises(ValueError):
            gl.fri_fold(e, nf, 7, al)
    # B0x above the 32-bit offsets (a lowered limit): the product is split
    # into launches that each fit, and the parts make the product
    rng = np.random.default_rng(11)
    x = _t(rng.integers(0, 2**64, size=(40, 6, 3), dtype=np.uint64))
    y = _t(rng.integers(0, 2**64, size=(6, 3), dtype=np.uint64))
    monkeypatch.setattr(fk, "INDEX_LIMIT", 100)
    assert not fk.ext_layout(x, y).fits
    assert fk.ext_layout(x[:5], y).fits  # 90 elements
    leaves.clear()

    def ext_leaf(a, b, out, layout):
        assert layout.fits and out.is_contiguous()
        leaves.append(layout.numel)
        out.copy_(fk.ext_mul_plain(a, b))

    out = torch.empty((40, 6, 3), dtype=torch.int64)
    fk.mul_into(x, y, out, ext_leaf, None, fk.ext_layout)
    assert len(leaves) > 1 and sum(leaves) == 240
    assert torch.equal(out, fk.ext_mul_plain(x, y))


def test_kernel_on_cpu_tensors_raises_instead_of_falling_back():
    """A call that asks for the kernel never drops to the plain version:
    without CUDA tensors (here: no card) it raises."""
    a = torch.ones((4,), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.gl_mul_kernel(a, a)
    for name in ("gl_add", "gl_sub"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fk.op_kernel(name, a, a)
    e = torch.ones((8, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.ext_mul_kernel(e, e)
    _, tw = gl.ntt_plan(8, False, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        gl.ntt_stage_kernel(e.clone(), tw, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gl.ntt_stage_kernel(torch.empty_like(e), tw, 1, src=e)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gl.fri_fold_kernel(e, 4, 7, e[0])
    # B16, the f128 leaf DFT: the digit product, the recombine, both
    x = torch.zeros((8, 5, 2), dtype=torch.int64)
    wt = ntt_mxu.leaf_matrix_dev(8, False, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ntt_mxu.digit_product_kernel(wt, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ntt_mxu.recombine_kernel(torch.zeros((37 * 8, 5), dtype=torch.int32),
                                 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ntt_mxu.leaf_dft_kernel(x, wt, 8)
