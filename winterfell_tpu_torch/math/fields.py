"""Host-side exact field arithmetic over Goldilocks (f64), f62 and f128 and
their extensions.

Mirrors the semantics (NOT the implementation) of the reference field layer
(math/src/field/{f64,f128}/mod.rs, math/src/field/extensions/*.rs):

- f64  "Goldilocks": p = 2^64 - 2^32 + 1, TWO_ADICITY = 32, GENERATOR = 7,
  quadratic extension poly x^2 - x + 2, cubic extension poly x^3 - x - 1
  (math/src/field/f64/mod.rs:251-267,398-499).
- f62: p = 2^62 - 111*2^39 + 1, TWO_ADICITY = 39, GENERATOR = 3, quadratic
  extension poly x^2 - x - 1, cubic extension poly x^3 + 2x + 2
  (math/src/field/f62/mod.rs).
- f128: p = 2^128 - 45*2^40 + 1, TWO_ADICITY = 40, GENERATOR = 3, quad poly
  x^2 - x - 1, cubic extension unsupported (math/src/field/f128/mod.rs:148-307).

Elements are canonical Python ints (tuples of ints for extensions); the
internal Montgomery representation of the reference is an implementation
detail that never escapes into proof bytes, so we do not replicate it here.
The tensor code in ``ops/goldilocks.py``, ``ops/f62.py`` and ``ops/f128.py``
is held against
this module, which also serves all host-side protocol math (transcript,
verifier, proof containers).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple


# ================================================================================
# Base field parameters
# ================================================================================


@dataclass(frozen=True)
class BaseField:
    name: str
    p: int
    two_adicity: int
    two_adic_root: int
    generator: int  # multiplicative group generator g
    element_bytes: int
    is_canonical: bool  # whether internal repr == canonical repr in the reference

    # x^2 reduction for the quadratic extension: x^2 = qa*x + qb
    quad_x2: Tuple[int, int] | None = None
    # x^3 reduction for the cubic extension: x^3 = ca2*x^2 + ca1*x + ca0
    cube_x3: Tuple[int, int, int] | None = None

    def get_root_of_unity(self, log_n: int) -> int:
        """2^log_n-th root of unity (math/src/field/traits.rs StarkField)."""
        if log_n == 0:
            return 1
        assert log_n <= self.two_adicity, f"no 2^{log_n} root of unity in {self.name}"
        return pow(self.two_adic_root, 1 << (self.two_adicity - log_n), self.p)

    @property
    def domain_offset(self) -> int:
        """LDE domain offset is hard-coded to GENERATOR (air/src/options.rs:249)."""
        return self.generator

    def inv(self, x: int) -> int:
        return pow(x, self.p - 2, self.p)

    def from_le_bytes(self, b: bytes) -> int:
        """Canonical LE bytes -> element; raises if value >= p."""
        v = int.from_bytes(b, "little")
        if v >= self.p:
            raise ValueError("value is not a canonical field element")
        return v

    def try_from_le_bytes(self, b: bytes) -> int | None:
        v = int.from_bytes(b, "little")
        return v if v < self.p else None

    def to_le_bytes(self, v: int) -> bytes:
        return v.to_bytes(self.element_bytes, "little")


GOLDILOCKS_P = 2**64 - 2**32 + 1

F64 = BaseField(
    name="f64",
    p=GOLDILOCKS_P,
    two_adicity=32,
    two_adic_root=7277203076849721926,  # f64/mod.rs:255-267
    generator=7,  # f64/mod.rs:251
    element_bytes=8,
    is_canonical=False,
    quad_x2=(1, GOLDILOCKS_P - 2),  # x^2 - x + 2 = 0  =>  x^2 = x - 2
    cube_x3=(1, 1, 0),  # x^3 - x - 1 = 0  =>  x^3 = 1 + x  (ca0, ca1, ca2)
)

F62_P = 2**62 - 111 * 2**39 + 1

F62 = BaseField(
    name="f62",
    p=F62_P,
    two_adicity=39,
    two_adic_root=4421547261963328785,  # f62/mod.rs
    generator=3,
    element_bytes=8,
    is_canonical=False,
    quad_x2=(1, 1),  # x^2 - x - 1 = 0  =>  x^2 = x + 1
    cube_x3=(F62_P - 2, F62_P - 2, 0),  # x^3 + 2x + 2 = 0  =>  x^3 = -2 - 2x
)

F128_P = 2**128 - 45 * 2**40 + 1

F128 = BaseField(
    name="f128",
    p=F128_P,
    two_adicity=40,
    two_adic_root=23953097886125630542083529559205016746,  # f128/mod.rs:148-162
    generator=3,
    element_bytes=16,
    is_canonical=True,
    quad_x2=(1, 1),  # x^2 - x - 1 = 0  =>  x^2 = x + 1
    cube_x3=None,  # cubic extension not supported (f128/mod.rs:290-307)
)

BASE_FIELDS = {"f64": F64, "f62": F62, "f128": F128}


# ================================================================================
# Field descriptor: a base field viewed at extension degree 1, 2 or 3
# ================================================================================


@dataclass(frozen=True)
class Field:
    """A (possibly extension) field. Elements are tuples of `degree` canonical
    base-field ints. Degree-1 tuples wrap base elements."""

    base: BaseField
    degree: int  # 1, 2, or 3

    def __post_init__(self):
        if self.degree == 2 and self.base.quad_x2 is None:
            raise ValueError(f"{self.base.name} has no quadratic extension")
        if self.degree == 3 and self.base.cube_x3 is None:
            raise ValueError(f"{self.base.name} has no cubic extension")

    # -- basics ------------------------------------------------------------

    @property
    def p(self) -> int:
        return self.base.p

    @property
    def element_bytes(self) -> int:
        return self.base.element_bytes * self.degree

    @property
    def name(self) -> str:
        return self.base.name + ("", "_quad", "_cube")[self.degree - 1]

    def zero(self) -> tuple:
        return (0,) * self.degree

    def one(self) -> tuple:
        return (1,) + (0,) * (self.degree - 1)

    def from_int(self, v: int) -> tuple:
        return (v % self.p,) + (0,) * (self.degree - 1)

    def from_base(self, b: int) -> tuple:
        return (b,) + (0,) * (self.degree - 1)

    def embed(self, parts) -> tuple:
        parts = tuple(int(x) % self.p for x in parts)
        assert len(parts) == self.degree
        return parts

    # -- arithmetic ---------------------------------------------------------

    def add(self, a: tuple, b: tuple) -> tuple:
        p = self.p
        return tuple((x + y) % p for x, y in zip(a, b))

    def sub(self, a: tuple, b: tuple) -> tuple:
        p = self.p
        return tuple((x - y) % p for x, y in zip(a, b))

    def neg(self, a: tuple) -> tuple:
        p = self.p
        return tuple((-x) % p for x in a)

    def mul(self, a: tuple, b: tuple) -> tuple:
        p = self.p
        d = self.degree
        if d == 1:
            return ((a[0] * b[0]) % p,)
        if d == 2:
            qa, qb = self.base.quad_x2
            a0, a1 = a
            b0, b1 = b
            t2 = a1 * b1
            c0 = (a0 * b0 + qb * t2) % p
            c1 = (a0 * b1 + a1 * b0 + qa * t2) % p
            return (c0, c1)
        # cubic: schoolbook then reduce x^3 = ca2 x^2 + ca1 x + ca0, and
        # x^4 = x * x^3
        ca0, ca1, ca2 = self.base.cube_x3
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0 = a0 * b0
        t1 = a0 * b1 + a1 * b0
        t2 = a0 * b2 + a1 * b1 + a2 * b0
        t3 = a1 * b2 + a2 * b1
        t4 = a2 * b2
        # reduce t4 x^4 = t4 (ca2 x^3 + ca1 x^2 + ca0 x) -> fold x^3 again
        # do it in two steps: first x^4, then x^3
        t3 += t4 * ca2
        t2 += t4 * ca1
        t1 += t4 * ca0
        t2 += t3 * ca2
        t1 += t3 * ca1
        t0 += t3 * ca0
        return (t0 % p, t1 % p, t2 % p)

    def mul_base(self, a: tuple, b: int) -> tuple:
        p = self.p
        return tuple((x * b) % p for x in a)

    def sqr(self, a: tuple) -> tuple:
        return self.mul(a, a)

    def exp(self, a: tuple, e: int) -> tuple:
        result = self.one()
        base = a
        while e > 0:
            if e & 1:
                result = self.mul(result, base)
            base = self.mul(base, base)
            e >>= 1
        return result

    def inv(self, a: tuple) -> tuple:
        if all(x == 0 for x in a):
            return self.zero()  # matches reference convention: inv(0) = 0
        d = self.degree
        if d == 1:
            return (pow(a[0], self.p - 2, self.p),)
        # norm trick: N(a) = prod of a's conjugates is in the base field
        conj = self.frobenius(a)
        if d == 2:
            na = self.mul(a, conj)  # in base field: na[1] == 0
            ninv = pow(na[0], self.p - 2, self.p)
            return self.mul_base(conj, ninv)
        conj2 = self.frobenius(conj)
        cc = self.mul(conj, conj2)
        na = self.mul(a, cc)
        ninv = pow(na[0], self.p - 2, self.p)
        return self.mul_base(cc, ninv)

    def div(self, a: tuple, b: tuple) -> tuple:
        return self.mul(a, self.inv(b))

    def frobenius(self, a: tuple) -> tuple:
        """a^p via precomputed images of basis powers of x."""
        if self.degree == 1:
            return a
        frob = self._frobenius_images()
        out = [a[0]] + [0] * (self.degree - 1)
        for i in range(1, self.degree):
            img = frob[i]
            for j in range(self.degree):
                out[j] = (out[j] + a[i] * img[j]) % self.p
        return tuple(out)

    @lru_cache(maxsize=None)
    def _frobenius_images(self):
        """Images (x^i)^p mod m(x) for i in 0..degree."""
        xp = self._poly_pow_x(self.p)
        images = [self.one(), xp]
        if self.degree == 3:
            images.append(self.mul(xp, xp))
        return tuple(images)

    def _poly_pow_x(self, e: int) -> tuple:
        """x^e in the extension (x = (0,1[,0]))."""
        x = (0, 1) if self.degree == 2 else (0, 1, 0)
        return self.exp(x, e)

    # -- serialization ------------------------------------------------------

    def to_le_bytes(self, a: tuple) -> bytes:
        eb = self.base.element_bytes
        return b"".join(x.to_bytes(eb, "little") for x in a)

    def elements_to_le_bytes(self, elems) -> bytes:
        return b"".join(self.to_le_bytes(a) for a in elems)

    def from_le_bytes(self, b: bytes) -> tuple:
        eb = self.base.element_bytes
        assert len(b) == self.element_bytes
        return tuple(
            self.base.from_le_bytes(b[i * eb : (i + 1) * eb]) for i in range(self.degree)
        )

    def try_from_random_bytes(self, b: bytes) -> tuple | None:
        """Rejection-sampling element decode (Randomizable::from_random_bytes):
        every base component must be canonical."""
        eb = self.base.element_bytes
        out = []
        for i in range(self.degree):
            v = self.base.try_from_le_bytes(b[i * eb : (i + 1) * eb])
            if v is None:
                return None
            out.append(v)
        return tuple(out)

    def base_elements(self, a: tuple) -> tuple:
        """Flatten into base elements (FieldElement::slice_as_base_elements)."""
        return a

    def rand(self, rng) -> tuple:
        return tuple(rng.randrange(self.p) for _ in range(self.degree))


# canonical degree-1 views
F64_1 = Field(F64, 1)
F64_QUAD = Field(F64, 2)
F64_CUBE = Field(F64, 3)
F62_1 = Field(F62, 1)
F62_QUAD = Field(F62, 2)
F62_CUBE = Field(F62, 3)
F128_1 = Field(F128, 1)
F128_QUAD = Field(F128, 2)


def extension_of(base: BaseField, degree: int) -> Field:
    return Field(base, degree)
