"""TorchOps and TorchOpsF128 — the tensor engine handles passed to
``Air.evaluate_transition``.

Same interface as :class:`winterfell_tpu_torch.ops.host.HostOps`, but arrays
are int64 tensors on the prover's device: Goldilocks or f62 elements shaped
(n_rows, degree) for :class:`TorchOps` (over ``ops/goldilocks.py`` or
``ops/f62.py``), f128 elements shaped (n_rows, degree, 2) for
:class:`TorchOpsF128`. The same AIR constraint code runs unchanged on any
engine.
"""

from __future__ import annotations

import torch

from ..math.fields import Field
from . import f62, f128
from . import goldilocks as gl

# the engines of the fields whose elements are one int64
_ENGINES = {"f64": gl, "f62": f62}


class TorchOps:
    is_device = True

    def __init__(self, field: Field, device):
        assert field.base.name in _ENGINES, (
            "TorchOps supports the Goldilocks and f62 fields")
        self.field = field
        self.device = torch.device(device)
        self.eng = _ENGINES[field.base.name]

    # -- construction -------------------------------------------------------

    # constants are made on the device (fills, no host copy), so an AIR's
    # constraints add no host synchronisation to the resident route

    def constant(self, v: int):
        return self.lift((v,) + (0,) * (self.field.degree - 1))

    def lift(self, e):
        if not isinstance(e, tuple):
            return e  # already a tensor (e.g. aux randomness)
        return torch.cat([torch.full((1, 1), gl._s64(self.eng.const(v)),
                                     dtype=gl.I64, device=self.device)
                          for v in e], dim=1)

    def zeros(self, n: int):
        return torch.zeros((n, self.field.degree), dtype=gl.I64,
                           device=self.device)

    # -- arithmetic ----------------------------------------------------------

    def add(self, a, b):
        a, b = self._broadcast(a, b)
        return self.eng.ext_add(a, b)

    def sub(self, a, b):
        a, b = self._broadcast(a, b)
        return self.eng.ext_sub(a, b)

    def neg(self, a):
        return self.eng.neg(a)

    def mul(self, a, b):
        a, b = self._broadcast(a, b)
        return self.eng.ext_mul(a, b)

    def exp(self, a, k: int):
        assert k >= 1
        result = None
        acc = a
        while k > 0:
            if k & 1:
                result = acc if result is None else self.mul(result, acc)
            k >>= 1
            if k:
                acc = self.mul(acc, acc)
        return result

    def mul_base(self, a, s):
        if isinstance(s, int):
            return self.eng.mul(a, self.eng.const(s))
        if s.ndim == a.ndim - 1:
            s = s[..., None]
        return self.eng.mul(a, s)

    @staticmethod
    def _broadcast(a, b):
        if a.shape == b.shape:
            return a, b
        return torch.broadcast_tensors(a, b)


class TorchOpsF128:
    """The engine handle for f128 AIRs (the port of the JAX JaxOpsF128,
    winterfell_tpu/ops/jax_ops.py:93-181): arrays are (n_rows, degree, 2)
    int64 tensors of (lo, hi) words (``ops/f128.py``)."""

    is_device = True

    def __init__(self, field: Field, device):
        assert field.base.name == "f128", (
            "TorchOpsF128 supports the f128 field")
        self.field = field
        self.device = torch.device(device)

    # -- construction (fills on the device, no host copy) --------------------

    def constant(self, v: int):
        return self.lift((v,) + (0,) * (self.field.degree - 1))

    def lift(self, e):
        if not isinstance(e, tuple):
            return e  # already a tensor
        return torch.cat([f128.fill(int(v), (1, 1), self.device) for v in e],
                         dim=1)

    def zeros(self, n: int):
        return torch.zeros((n, self.field.degree, 2), dtype=f128.I64,
                           device=self.device)

    # -- arithmetic ----------------------------------------------------------

    def add(self, a, b):
        return f128.ext_add(*self._broadcast(a, b))

    def sub(self, a, b):
        return f128.ext_sub(*self._broadcast(a, b))

    def neg(self, a):
        return f128.f128_neg(a)

    def mul(self, a, b):
        return f128.ext_mul(*self._broadcast(a, b))

    exp = TorchOps.exp

    def mul_base(self, a, s):
        if isinstance(s, int):
            return f128.f128_mul(a, f128.const(s))
        if s.ndim == a.ndim - 1:  # (n, 2) base elements under (n, d, 2)
            s = s[..., None, :]
        return f128.f128_mul(a, s)

    _broadcast = staticmethod(TorchOps._broadcast)


def ops_for(field: Field, device):
    """The engine handle for an AIR over ``field``'s base field."""
    cls = TorchOpsF128 if field.base.name == "f128" else TorchOps
    return cls(field, device)
