"""Execution traces (prover/src/trace/{mod,trace_table}.rs).

TraceTable is the default column-major trace container. Data is stored as an
(n, width) numpy object array of canonical base-field ints — the row-major
view of the reference's ColMatrix; the NTT layer operates on the leading axis
either way so the distinction is only naming.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..air.trace_info import TraceInfo
from ..math.fields import BaseField


class Trace:
    """Base trace interface (prover/src/trace/mod.rs:48-228)."""

    def info(self) -> TraceInfo:
        raise NotImplementedError

    def main_segment(self) -> np.ndarray:
        """(n, width) object array of base-field ints."""
        raise NotImplementedError

    def read_main_frame(self, row: int):
        """(current_row, next_row) lists of base ints, next wraps around."""
        seg = self.main_segment()
        n = seg.shape[0]
        return list(seg[row]), list(seg[(row + 1) % n])

    def validate(self, air, aux_trace=None, aux_rand_elements=None) -> None:
        """Full re-execution check of assertions and transition constraints
        (prover/src/trace/mod.rs:86-201) — expensive; debug use only."""
        from ..math import vecmath as vm
        from ..math.fields import Field
        from ..ops.host import HostOps
        from .evaluator import DefaultConstraintEvaluator  # noqa: F401

        info = self.info()
        n = info.length
        seg = self.main_segment()

        # assertions
        for assertion in air.get_assertions():
            assertion.validate_trace_width(info.main_segment_width)

            def check(step, value, col=assertion.column):
                actual = int(seg[step, col])
                assert actual == value[0], (
                    f"trace does not satisfy assertion main({col}, {step}) == "
                    f"{value[0]} (found {actual})"
                )

            assertion.apply(n, check)
        if aux_trace is not None:
            ext = air.ext_field
            for assertion in air.get_aux_assertions(aux_rand_elements):
                def check_aux(step, value, col=assertion.column):
                    actual = tuple(int(x) for x in aux_trace[step, col])
                    assert actual == value, (
                        f"trace does not satisfy aux assertion "
                        f"({col}, {step}) == {value} (found {actual})"
                    )

                assertion.apply(n, check_aux)

        # transition constraints over all non-exempt steps, vectorized
        from ..air.air import EvaluationFrame

        base_field = Field(air.base, 1)
        ops = HostOps(base_field)
        nxt = np.roll(seg, -1, axis=0)
        frame = EvaluationFrame(
            [seg[:, c : c + 1] for c in range(seg.shape[1])],
            [nxt[:, c : c + 1] for c in range(seg.shape[1])])
        # periodic values per trace step
        periodic = []
        for column in air.get_periodic_column_values():
            reps = n // len(column)
            periodic.append(np.array(column * reps, dtype=object)[:, None])
        evals = air.evaluate_transition(frame, periodic, ops)
        last = n - air.context.num_transition_exemptions
        for i, ev in enumerate(evals):
            bad = np.nonzero(ev[:last, 0])[0]
            assert bad.size == 0, (
                f"transition constraint {i} evaluated to a nonzero value at "
                f"step {int(bad[0])}"
            )


class TraceTable(Trace):
    def __init__(self, base: BaseField, width: int, length: int, meta: bytes = b""):
        assert 0 < width <= 255
        assert length >= 8 and length & (length - 1) == 0, (
            "trace length must be a power of two >= 8"
        )
        self.base = base
        self._info = TraceInfo(width, length, meta=meta)
        self._data: Optional[np.ndarray] = np.zeros((length, width),
                                                    dtype=object)
        self._native: Optional[np.ndarray] = None
        self._dev_cache: dict = {}

    # -- native backing ------------------------------------------------------
    #
    # Trace builders that make their rows in bulk (e.g. build_fib_trace, the
    # native Rescue chain of native/f128.c) store them as a uint64 array
    # instead of Python ints: (n, w) for f64, (n, w, 2) little-endian (lo,
    # hi) pairs for f128. Device provers upload this directly (a pure dtype
    # view); the object-array view for the host prover is materialized
    # lazily on first access.

    def set_native_rows(self, arr: np.ndarray) -> None:
        assert arr.shape[0] == self._info.length
        assert arr.shape[1] == self._info.main_segment_width
        self._native = arr
        self._data = None
        self._dev_cache.clear()

    # -- device residency ------------------------------------------------
    #
    # Device provers keep the uploaded main-segment array cached here, keyed
    # by engine, so a trace crosses the host↔device link once per process
    # (the reference prover likewise reads the trace from wherever the
    # builder left it — for a device prover that place is device memory). Every mutation
    # below invalidates the cache, so proof bytes cannot depend on it.

    def device_cache(self) -> dict:
        return self._dev_cache

    def native_rows(self) -> Optional[np.ndarray]:
        return self._native

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            nat = self._native
            if nat.ndim == 3:  # (n, w, 2) u64 pairs
                self._data = nat[..., 0].astype(object) + (
                    nat[..., 1].astype(object) << 64)
            else:
                self._data = nat.astype(object)
        return self._data

    @data.setter
    def data(self, value: np.ndarray) -> None:
        self._data = value
        self._native = None
        self._dev_cache.clear()

    # -- construction (trace_table.rs:81-252) -------------------------------

    @classmethod
    def init(cls, base: BaseField, columns: List[List[int]]) -> "TraceTable":
        length = len(columns[0])
        table = cls(base, len(columns), length)
        for c, col in enumerate(columns):
            assert len(col) == length, "all columns must have the same length"
            for r, v in enumerate(col):
                table.data[r, c] = v % base.p
        return table

    def fill(self, init: Callable[[list], None],
             update: Callable[[int, list], None]) -> None:
        """Sequential build: `init(state)` fills row 0; `update(step, state)`
        transforms the state into row step+1 (trace_table.rs:164)."""
        width = self._info.main_segment_width
        state = [0] * width
        init(state)
        self.update_row(0, state)
        for step in range(self._info.length - 1):
            update(step, state)
            self.update_row(step + 1, state)

    def update_row(self, step: int, state: List[int]) -> None:
        p = self.base.p
        self._dev_cache.clear()
        for c, v in enumerate(state):
            self.data[step, c] = v % p

    def set(self, column: int, step: int, value: int) -> None:
        self._dev_cache.clear()
        self.data[step, column] = value % self.base.p

    def get(self, column: int, step: int) -> int:
        if self._data is None:  # avoid materializing for point reads
            nat = self._native[step, column]
            if nat.ndim:  # (2,) u64 pair
                return int(nat[0]) | (int(nat[1]) << 64)
            return int(nat)
        return int(self.data[step, column])

    # -- accessors ----------------------------------------------------------

    @property
    def width(self) -> int:
        return self._info.main_segment_width

    @property
    def length(self) -> int:
        return self._info.length

    def info(self) -> TraceInfo:
        return self._info

    def main_segment(self) -> np.ndarray:
        return self.data

    def with_meta(self, meta: bytes) -> "TraceTable":
        self._info = TraceInfo(
            self._info.main_segment_width, self._info.length, meta=meta)
        return self

    def set_aux_shape(self, aux_width: int, num_rands: int) -> None:
        """Declare the auxiliary segment shape (for Randomized AIRs)."""
        self._info = TraceInfo(
            self._info.main_segment_width, self._info.length,
            aux_segment_width=aux_width, num_aux_segment_rands=num_rands,
            meta=self._info.meta)

    # -- fragments (trace_table.rs:196-252): parallel trace construction ----

    def fragments(self, fragment_length: int) -> List["TraceTableFragment"]:
        """Split the trace into independent row-range fragments, each filled
        with its own (init, update) pair — the API the reference uses for
        rayon-parallel trace building (e.g. one fragment per Lamport
        signature cycle). Fragments write directly into this table."""
        assert fragment_length >= 2 and fragment_length & (fragment_length - 1) == 0
        assert self.length % fragment_length == 0
        return [
            TraceTableFragment(self, i, i * fragment_length, fragment_length)
            for i in range(self.length // fragment_length)
        ]


class TraceTableFragment:
    """A mutable view over a contiguous row range (trace_table.rs:310-375)."""

    def __init__(self, table: TraceTable, index: int, offset: int, length: int):
        self.table = table
        self._index = index
        self.offset = offset
        self.length = length

    def index(self) -> int:
        return self._index

    def fill(self, init: Callable[[list], None],
             update: Callable[[int, list], None]) -> None:
        state = [0] * self.table.width
        init(state)
        self.table.update_row(self.offset, state)
        for step in range(self.length - 1):
            update(step, state)
            self.table.update_row(self.offset + step + 1, state)
