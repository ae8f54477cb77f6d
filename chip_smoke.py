"""Smoke run of the PyTorch/CUDA port (winterfell_tpu_torch) on one GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes on the CPU, no verdict

Phases, each printed with its elapsed seconds as it ends:

1. device: the card's name and power limit; build the CUDA kernels (one
   nvcc per source, all at once).
2. kernels: every kernel of the main path against its plain PyTorch version
   on the card, bit for bit (field elements are exact integers): K1 row hash,
   K2 merge per level and the Merkle tree kernel (leaf counts 2^0, 2^1, each
   side of the one-block tail, 2^21), K3 field multiply (contiguous,
   broadcast, strided, Python-int operands), and the device coin's
   permute_rows and draw kernels; the Rescue kernels on random values and on
   corner sets (0, 1, 2^32 - 1, 2^32, 2^63, p - 2^32, p - 2, p - 1).
3. card vs CPU: a fib proof at trace 2^10 on the card and on the CPU, on the
   resident route and on the phased route; the four Proof.to_bytes() must be
   equal and verify() must accept the proof.
4. main path: bench.py's default workload through the port — fib over f64,
   trace 2^18, cubic extension, Rp64_256 — proved and verified on the
   default (resident) route and on the phased route (WINTER_RESIDENT=0's,
   fused FRI): per route one warm-up, three timed proves with the phase
   barriers off (as bench.py times), then one prove with them on for the
   per-phase split. The resident proves run their device part under
   torch.cuda.set_sync_debug_mode("error"): any host synchronisation there
   fails the run. Each kernel must have launched during the first timed
   resident prove, and K2 (per-level and tree kernel together) at most 30
   times per prove on either route.
5. kernel times at the main path's shapes against their bounds: device time
   per launch from launches replayed in a CUDA graph, beside the time per
   call when the wrapper is called back to back from Python; the whole
   2^21-leaf tree, one-row K1 and K2 latency and K1 at the composition
   width.

The line before the last is the kernels' JSON record; the last line is the
run's verdict. Any failure exits non-zero before that verdict. Without a
CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

_T0 = time.perf_counter()
REHEARSAL = "--cpu-rehearsal" in sys.argv[1:]

# H100 SXM: 132 SMs × 64 32-bit integer multiply-adds (IMAD) per clock at the
# 1.98 GHz boost clock; 3.35 TB/s of HBM3 (NVIDIA data sheet, 700 W part).
IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# The fewest 32-bit IMADs one Rp64_256 permutation needs. A 32×32→64 partial
# product is 2 IMADs (low and high halves). Per lane and round the S-box x^7
# is 2 squarings + 2 multiplies and the inverse S-box's 72-multiply chain is
# 63 squarings + 9 multiplies: 65 squarings at 3 partial products (6 IMADs;
# the cross term is doubled by a shift) and 11 multiplies at 4 (8 IMADs).
# The reduction multiplies by 2^32 − 1 only, which is (x << 32) − x: no IMAD.
# Each of the 2 MDS per round is 144 small-constant products, one per 32-bit
# half of the input (2 × 2 IMADs). 7·12·(65·6 + 11·8) + 7·2·144·4 = 48,216.
IMAD_PER_PERM = 7 * 12 * (65 * 6 + 11 * 8) + 7 * 2 * 144 * 4
# K3: one 64×64→128-bit product is 4 partial products of 2 IMADs each; the
# reduction multiplies by 2^32 − 1 only (a shift and a subtract)
IMAD_PER_MUL = 8


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def phase(name: str, t0: float) -> None:
    log(f"phase {name} done in {time.perf_counter() - t0:.2f} s")


def _rng_field(rng, shape, device):
    from winterfell_tpu_torch.ops import goldilocks as gl

    a = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
    a.flat[0] = 0
    a.flat[-1] = gl.P - 1
    return torch.from_numpy(a.view(np.int64)).to(device)


def _corner_field(shape, device):
    """Canonical corner values only, near which a slip in a lazy reduction
    shows: rows 0..7 each one corner repeated, later rows mixes of them."""
    from winterfell_tpu_torch.ops import goldilocks as gl

    c = np.array([0, 1, 2**32 - 1, 2**32, 2**63, gl.P - 2**32, gl.P - 2,
                  gl.P - 1], dtype=np.uint64)
    r = np.arange(shape[0])[:, None]
    j = np.arange(shape[1])[None, :]
    idx = np.where(r < len(c), r, 3 * r + 5 * j) % len(c)
    return torch.from_numpy(c[idx].view(np.int64)).to(device)


def _max_abs_err(a, b) -> float:
    """Largest |a − b| over the elements, read as unsigned 64-bit values."""
    x = a.cpu().numpy().view(np.uint64).astype(object).ravel()
    y = b.cpu().numpy().view(np.uint64).astype(object).ravel()
    return float(max((abs(u - v) for u, v in zip(x, y)), default=0))


def _exact(a, b, what: str) -> float:
    """The kernel's error against its plain version; raises unless it is 0
    (the kernels compute exact integers)."""
    err = 0.0 if torch.equal(a, b) else _max_abs_err(a, b)
    if err != 0.0:
        bad = int((a != b).any(dim=-1).sum())
        raise AssertionError(f"{what}: {bad} rows differ from the plain "
                             f"version (max abs err {err})")
    return err


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after a warm-up)."""
    fn()
    if REHEARSAL:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1000 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, reps: int) -> float:
    """Mean milliseconds per launch of a kernel wrapper fn() on the card:
    reps calls captured in one CUDA graph and replayed once between CUDA
    events, so no host time sits between the launches (the wrapper's Python
    work can outlast a short kernel, and _time_ms would then time the host)."""
    if REHEARSAL:
        return _time_ms(fn, reps)
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_hash(m: int, k: int):
    """(bound ms, bound_by) of K1 on (m, k) rows: the larger of the IMAD time
    and the bytes time (each input read once, each output written once)."""
    ops_ms = m * -(-k // 8) * IMAD_PER_PERM / IMAD_PER_S * 1000
    bytes_ms = (m * k * 8 + m * 32) / HBM_BYTES_PER_S * 1000
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _bound(imads: float, nbytes: float):
    """(bound ms, bound_by): the larger of the IMAD time and the bytes time."""
    ops_ms = imads / IMAD_PER_S * 1000
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1000
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _bound_merge(m: int):
    return _bound(m * IMAD_PER_PERM, m * 96)


def _bound_tree(n: int):
    """The levels over n leaves: n - 1 merges; the leaves read once and the
    n - 1 nodes written once, 32 bytes each."""
    return _bound((n - 1) * IMAD_PER_PERM, (2 * n - 1) * 32)


def _bound_mul(x, y):
    """K3 on x·y (y a tensor that broadcasts against x, or an int): 8 IMADs
    per product; each element of the operands read once (a broadcast
    operand's own elements, not the broadcast ones; an int is no read) and
    each product written once, 8 bytes each."""
    y_shape, y_numel = ((y.shape, y.numel()) if isinstance(y, torch.Tensor)
                        else ((), 0))
    n = torch.broadcast_shapes(x.shape, y_shape).numel()
    return _bound(n * IMAD_PER_MUL, (x.numel() + y_numel + n) * 8)


def _bound_permute(m: int):
    """permute_rows on (m, 12): one permutation, 96 bytes in, 96 out."""
    return _bound(m * IMAD_PER_PERM, m * 192)


def _bound_draw(k: int, d: int):
    """The draw kernel for k draws from k canonical candidates (every
    candidate of this run's Rp64 digests is accepted, so it permutes
    nothing): it reads the seed and k digests and writes k·d elements and
    the counter."""
    return _bound(0, 32 + k * 32 + k * d * 8 + 8)


def _check_syncs(prover, on: bool) -> None:
    """With on, the prover's resident device run (_resident_run) runs under
    torch.cuda.set_sync_debug_mode("error"): any host synchronisation there
    raises. With on False, the class's own method again."""
    prover.__dict__.pop("_resident_run", None)
    if not on:
        return
    run = prover._resident_run

    def checked(*args, **kwargs):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    prover._resident_run = checked


def _launches():
    """Every kernel's launch count since the last _reset_launches()."""
    from winterfell_tpu_torch.ops import device_coin, field_kernels, rescue

    return {**rescue.LAUNCHES, **field_kernels.LAUNCHES,
            **device_coin.LAUNCHES}


def _reset_launches() -> None:
    from winterfell_tpu_torch.ops import device_coin, field_kernels, rescue

    for mod in (rescue, field_kernels, device_coin):
        mod.reset_launches()


def main() -> int:
    if not REHEARSAL and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from winterfell_tpu_torch.air import FieldExtension, ProofOptions, TraceInfo
    from winterfell_tpu_torch.crypto.hashers import Rp64_256
    from winterfell_tpu_torch.examples.fibonacci import (
        FibSmallAir,
        FibSmallProver,
        build_fib_trace,
        compute_fib_term,
    )
    from winterfell_tpu_torch.math.fields import F64
    from winterfell_tpu_torch.ops import _build, device_coin, field_kernels
    from winterfell_tpu_torch.ops import goldilocks as gl
    from winterfell_tpu_torch.ops import rescue
    from winterfell_tpu_torch.prover import device as prover_device
    from winterfell_tpu_torch.prover.device import GoldilocksProver
    from winterfell_tpu_torch.utils import tracing
    from winterfell_tpu_torch.verifier import verify

    dev = torch.device("cpu" if REHEARSAL else "cuda")
    rng = np.random.default_rng(20260817)
    # main path: trace rows, and a scale for the kernel-check shapes
    log2_trace = 6 if REHEARSAL else 18
    log2_cmp = 6 if REHEARSAL else 10  # both with FRI layers (resident)
    big = 1 << (log2_trace + 3)  # LDE rows (blowup 8)
    # the wrappers route CPU tensors to the plain versions; the kernel
    # entry points themselves take CUDA tensors only
    k3 = gl.gl_mul if REHEARSAL else field_kernels.gl_mul_kernel
    draw_k = device_coin.draw_plain if REHEARSAL else device_coin.draw_kernel

    # 1 ----- device ---------------------------------------------------------
    t0 = time.perf_counter()
    kind = "cpu" if REHEARSAL else torch.cuda.get_device_name(0)
    count = 0 if REHEARSAL else torch.cuda.device_count()
    log(f"device: {kind} (count {count}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    smi = "not run (rehearsal)"
    if not REHEARSAL:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        log(f"nvidia-smi: {smi}")
        tb = time.perf_counter()
        _build.build_all()
        log(f"kernels built in {time.perf_counter() - tb:.2f} s "
            f"({', '.join(_build.SOURCES)})")
    phase("1 device", t0)

    # 2 ----- kernels against their plain versions, on the card -------------
    t0 = time.perf_counter()
    errs = {"rp64_hash_rows": 0.0, "rp64_merge_rows": 0.0,
            "rp64_merkle_tree": 0.0, "gl_mul": 0.0, "rp64_permute_rows": 0.0,
            "rp64_coin_draw": 0.0}

    def check(name, got, plain, shape):
        errs[name] = max(errs[name], _exact(got, plain, f"{name} {shape}"))

    options = ProofOptions(num_queries=32, blowup_factor=8, grinding_factor=0,
                           field_extension=FieldExtension.CUBIC,
                           fri_folding_factor=8, fri_remainder_max_degree=31)
    # composition columns of the main path's AIR (its LDE rows are 3·that)
    comp_air = FibSmallAir(TraceInfo(2, 1 << log2_trace), 1, options)
    comp_cols = comp_air.context.num_constraint_composition_columns()
    # the Rescue kernels on random and corner values
    tail = 1 << rescue._TREE_TAIL_LOG
    chunk = 1 << rescue._TREE_CHUNK_LOG
    both = [_rng_field, lambda _, shape, where: _corner_field(shape, where)]
    cases = []  # (kernel name, wrapper, plain, inputs, shape)
    for k in (1, 2, 3, 7, 8, 9, 12, 16, 24):
        for m in (1, 255, 256, 768, 1000):
            for make in both:
                cases.append(("rp64_hash_rows", rescue.rp64_hash_rows,
                              rescue.rp64_hash_rows_plain,
                              (make(rng, (m, k), dev),), (m, k)))
    for m in (1, 3, 1 << 10):
        for make in both:
            level = make(rng, (2 * m, 4), dev)
            cases.append(("rp64_merge_rows", rescue.rp64_merge_rows,
                          rescue.rp64_merge_rows_plain,
                          (level[0::2], level[1::2]), (m, 4)))
    for n in (1, 2, 4, tail // 2, tail, 2 * tail, chunk, 2 * chunk):
        for make in both:
            cases.append(("rp64_merkle_tree", rescue.rp64_merkle_levels,
                          rescue.rp64_merkle_levels_plain,
                          (make(rng, (n, 4), dev),), ("leaves", n)))
    for m in (1, 5, 1000):
        for make in both:
            cases.append(("rp64_permute_rows", device_coin.permute_rows,
                          device_coin.permute_rows_plain,
                          (make(rng, (m, 12), dev),), (m, 12)))

    def flat(out):  # a tree's levels as one tensor
        if not isinstance(out, list):
            return out
        return (torch.cat(out) if out else
                torch.zeros((0, 4), dtype=torch.int64, device=dev))

    for name, fn, plain, args, shape in cases:
        check(name, flat(fn(*args)), flat(plain(*args)), shape)
    # the main path's shapes: a Merkle level of the LDE, the whole
    # 2^21-leaf tree, and the row hashes of the trace LDE, the composition
    # LDE, a FRI layer, and the 12-wide rows of the loop-variant experiment
    for make in both:
        level = make(rng, (big, 4), dev)
        check("rp64_merge_rows",
              rescue.rp64_merge_rows(level[0::2], level[1::2]),
              rescue.rp64_merge_rows_plain(level[0::2], level[1::2]),
              ("level", big, 4))
        check("rp64_merkle_tree", flat(rescue.rp64_merkle_levels(level)),
              flat(rescue.rp64_merkle_levels_plain(level)), ("leaves", big))
        for m, k in ((big, 2), (big, 3 * comp_cols), (big // 8, 24),
                     (big, 12)):
            x = make(rng, (m, k), dev)
            check("rp64_hash_rows", rescue.rp64_hash_rows(x),
                  rescue.rp64_hash_rows_plain(x), (m, k))
    log("K1 rp64_hash_rows, K2 rp64_merge_rows, the tree kernel and "
        "permute_rows equal their plain versions")

    # K3 at (LDE,) over all u64 patterns, the first elements the corner set
    # of tests/test_pallas_kernels.py and patterns >= p, paired every way
    p = gl.P
    corners = [0, 1, 2, p - 1, p - 2, 2**32, 2**32 - 1, 2**32 + 1, 2**63,
               2**63 - 1, p // 2, p // 2 + 1, 0xFFFFFFFF00000000 % p,
               p, p + 1, 2**64 - 2**32, 2**64 - 2, 2**64 - 1]
    a_np = rng.integers(0, 2**64, size=big, dtype=np.uint64)
    b_np = rng.integers(0, 2**64, size=big, dtype=np.uint64)
    pairs = [(x, y) for x in corners for y in corners]
    a_np[: len(pairs)] = [x for x, _ in pairs]
    b_np[: len(pairs)] = [y for _, y in pairs]
    a = torch.from_numpy(a_np.view(np.int64)).to(dev)
    b = torch.from_numpy(b_np.view(np.int64)).to(dev)
    got = k3(a, b)
    check("gl_mul", got, field_kernels.gl_mul_plain(a, b), (big,))
    head = got[: len(pairs)].cpu().numpy().view(np.uint64)
    if [int(v) for v in head] != [x * y % p for x, y in pairs]:
        raise AssertionError("gl_mul: corner products differ from the "
                             "Python-int oracle")
    # the operand layouts the main path passes: a Python int, broadcast
    # columns and extension coefficients, NTT butterfly halves with their
    # twiddles, the prefix scan's shifted slices, extension components
    ext = _rng_field(rng, (big, 3), dev)
    blk = _rng_field(rng, (big // 64, 2, 32, 3), dev)
    tw = _rng_field(rng, (1, 32, 1), dev)
    scan = _rng_field(rng, (big // 128, 128), dev)
    layouts = [("int", ext, gl.const(12345)), ("int>=p", ext, 2**64 - 1),
               ("column", ext, ext[:, :1]), ("ext coeff", ext, ext[0][None]),
               ("butterfly", blk[:, 1], tw), ("scan", scan[..., 5:],
                                               scan[..., :-5]),
               ("component", ext[..., 1], ext[..., 2])]
    # eight dims that no neighbour can merge with: the kernel's most
    deep = _rng_field(rng, (2, 3, 2, 3, 2, 3, 2, 2), dev).permute(
        *range(7, -1, -1))
    layouts.append(("8 dims", deep, deep[..., :1]))
    for name, x, y in layouts:
        check("gl_mul", k3(x, y), field_kernels.gl_mul_plain(x, y),
              (name, tuple(x.shape)))
    log("K3 gl_mul equals its plain version (and the oracle on the corners)")

    # the coin's draw kernel on candidates of the main path's draws, with
    # rejected candidates injected so the kernel's own continuation is held
    # against the serial loop too
    seed = _rng_field(rng, (4,), dev)
    _, next_candidates = device_coin.rp64_coin_ops()
    for k, d, reject in ((1, 3, ()), (5, 3, ()), (7, 1, ()), (3, 2, (1,)),
                         (2, 3, (0, 1))):
        cands = next_candidates(seed, 0, k).clone()
        for j in reject:  # an element >= p: that counter is rejected
            cands[j, 4] = -1
        got_e, got_c = draw_k(cands, seed, 0, k, d)
        want_e, want_c = device_coin.draw_plain(cands, seed, 0, k, d)
        check("rp64_coin_draw", torch.cat([got_e.reshape(-1), got_c]),
              torch.cat([want_e.reshape(-1), want_c]), (k, d, reject))
    log("the coin's draw kernel equals its plain version")
    phase("2 kernels", t0)

    # 3 ----- card vs CPU, both routes ---------------------------------------
    t0 = time.perf_counter()
    Prover = GoldilocksProver.accelerate(FibSmallProver)
    n_cmp = 1 << log2_cmp
    resident_default = prover_device._RESIDENT_ON_F64

    def routed(resident: bool):
        prover_device._RESIDENT_ON_F64 = resident
        return "resident_pipeline" if resident else "fri_layers_fused"

    ref_bytes = None
    for resident in (True, False):
        mark = routed(resident)
        for where in (dev, torch.device("cpu")):
            proof = Prover(options, Rp64_256, device=where).prove(
                build_fib_trace(F64, 2 * n_cmp, device=where))
            if mark not in [s["name"] for s in tracing.last_spans()]:
                raise AssertionError(f"the prove on {where} missed {mark}")
            if ref_bytes is None:
                ref_bytes = proof.to_bytes()
                verify(FibSmallAir, proof, compute_fib_term(F64, 2 * n_cmp),
                       Rp64_256)
            elif proof.to_bytes() != ref_bytes:
                raise AssertionError(f"{mark} proof bytes on {where} differ")
    routed(resident_default)
    log(f"fib 2^{log2_cmp}: card bytes == CPU bytes on the resident and the "
        f"phased route ({len(ref_bytes)} B), verified")
    phase("3 card vs cpu", t0)

    # 4 ----- the main path at full size, both routes ------------------------
    t0 = time.perf_counter()
    n = 1 << log2_trace
    trace = build_fib_trace(F64, 2 * n, device=dev)
    result = trace.get(1, n - 1)
    if result != compute_fib_term(F64, 2 * n):
        raise AssertionError("trace's last term differs from compute_fib_term")
    runs, warm_bytes = {}, None
    for route in ("resident", "phased"):
        mark = routed(route == "resident")
        prover = Prover(options, Rp64_256, device=dev)
        # any host synchronisation inside the resident device run raises
        _check_syncs(prover, not REHEARSAL)
        tracing.set_phase_sync(True)
        warm = prover.prove(trace)
        verify(FibSmallAir, warm, result, Rp64_256)
        if warm_bytes is None:
            warm_bytes = warm.to_bytes()
        elif warm.to_bytes() != warm_bytes:
            raise AssertionError("the phased proof differs from the resident")
        if not REHEARSAL:
            torch.cuda.reset_peak_memory_stats()
        # the timed proves run free, as bench.py times its proves: no barrier
        # at the phase marks, one synchronize at the end of each prove
        tracing.set_phase_sync(False)
        walls, launches = [], None
        for i in range(3):
            if i == 0:
                _reset_launches()
            t = time.perf_counter()
            proof = prover.prove(trace)
            if not REHEARSAL:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if i == 0:
                launches = _launches()
            if mark not in [s["name"] for s in tracing.last_spans()]:
                raise AssertionError(f"the {route} prove missed {mark}")
            if proof.to_bytes() != warm_bytes:
                raise AssertionError(f"{route} proves gave other bytes")
        verify(FibSmallAir, proof, result, Rp64_256)
        peak = 0 if REHEARSAL else torch.cuda.max_memory_allocated()
        unchecked = []
        if route == "resident":
            # three more with the sync check off: what the check costs
            _check_syncs(prover, False)
            for _ in range(3):
                t = time.perf_counter()
                if prover.prove(trace).to_bytes() != warm_bytes:
                    raise AssertionError("unchecked proves gave other bytes")
                if not REHEARSAL:
                    torch.cuda.synchronize()
                unchecked.append(time.perf_counter() - t)
            _check_syncs(prover, not REHEARSAL)
        # one more prove, untimed, with a barrier at every phase mark: its
        # marks are then the card's time per phase
        tracing.set_phase_sync(True)
        t = time.perf_counter()
        if prover.prove(trace).to_bytes() != warm_bytes:
            raise AssertionError("the phase-split prove gave other bytes")
        split_wall = time.perf_counter() - t
        spans = tracing.last_spans()
        runs[route] = launches
        log(f"{route}: fib 2^{log2_trace} prove wall s (phase barriers off): "
            f"min {min(walls):.4f} median {statistics.median(walls):.4f} "
            f"runs {[round(w, 4) for w in walls]}")
        if unchecked:
            log(f"{route}: the same with the sync check off: min "
                f"{min(unchecked):.4f} median "
                f"{statistics.median(unchecked):.4f} runs "
                f"{[round(w, 4) for w in unchecked]}")
        log(f"{route}: phases (one more prove, barriers on, wall "
            f"{split_wall:.4f} s; ms): " + ", ".join(
                f"{s['name']} {1000 * s['seconds']:.1f}" for s in spans))
        log(f"{route}: peak device memory {peak / 2**30:.3f} GiB; launches "
            f"per prove {launches}; proof {len(proof.to_bytes())} B, verified")
    routed(resident_default)
    tracing.set_phase_sync(True)
    if not REHEARSAL:
        for name, c in runs["resident"].items():
            if c <= 0:
                raise AssertionError(f"kernel {name} was not launched by a "
                                     "resident prove")
    for route, counts in runs.items():
        k2 = counts["rp64_merge_rows"] + counts["rp64_merkle_tree"]
        if k2 > 30:
            raise AssertionError(f"{route}: {k2} K2 launches per prove (per "
                                 "level and tree kernel), more than 30")
    log("resident and phased proofs have the same bytes" + (
        "" if REHEARSAL else "; the resident device run made no host "
        "synchronisation"))
    phase("4 main path", t0)

    # 5 ----- kernel times at the main path's shapes -------------------------
    t0 = time.perf_counter()
    reps = 2 if REHEARSAL else 20

    def entry(shape, fn, plain, bound):
        return {"shape": list(shape), "ms": _kernel_ms(fn, reps),
                "host_ms": _time_ms(fn, reps),
                "plain_ms": _time_ms(plain, 1), "bound_ms": bound[0],
                "bound_by": bound[1]}

    def hash_entry(m, k):
        x = _rng_field(rng, (m, k), dev)
        return entry((m, k), lambda: rescue.rp64_hash_rows(x),
                     lambda: rescue.rp64_hash_rows_plain(x), _bound_hash(m, k))

    def merge_entry(m):
        level = _rng_field(rng, (2 * m, 4), dev)
        l, r = level[0::2], level[1::2]
        return entry((m, 4), lambda: rescue.rp64_merge_rows(l, r),
                     lambda: rescue.rp64_merge_rows_plain(l, r),
                     _bound_merge(m))

    def tree_entry(n):
        leaves = _rng_field(rng, (n, 4), dev)
        return entry(("leaves", n), lambda: rescue.rp64_merkle_levels(leaves),
                     lambda: rescue.rp64_merkle_levels_plain(leaves),
                     _bound_tree(n))

    def mul_entry(x, y, shape):
        return entry(shape, lambda: k3(x, y),
                     lambda: field_kernels.gl_mul_plain(x, y),
                     _bound_mul(x, y))

    def permute_entry(m):
        st = _rng_field(rng, (m, 12), dev)
        return entry((m, 12), lambda: device_coin.permute_rows(st),
                     lambda: device_coin.permute_rows_plain(st),
                     _bound_permute(m))

    def draw_entry(k, d):
        cands = next_candidates(seed, 0, k)
        return entry((k, d), lambda: draw_k(cands, seed, 0, k, d),
                     lambda: device_coin.draw_plain(cands, seed, 0, k, d),
                     _bound_draw(k, d))

    # K3's second shape: an NTT butterfly stage of the composition LDE
    # (strided halves times broadcast twiddles)
    bfly = _rng_field(rng, (big // 64, 2, 32, 3), dev)
    tw = _rng_field(rng, (1, 32, 1), dev)
    n_ccs = comp_air.context.num_transition_constraints + \
        comp_air.context.num_assertions
    records = [
        ("rp64_hash_rows", "winterfell_tpu/ops/pallas_rescue.py:596",
         "winterfell_tpu_torch/csrc/rescue.cu",
         # the trace LDE, a FRI layer, K4's shape (scripts/pallas_loop_exp.py
         # runs K1's body on (2^21, 12) rows), the composition LDE, the
         # smaller FRI layers and the one-row OOD hash
         [hash_entry(big, 2), hash_entry(big // 8, 24), hash_entry(big, 12),
          hash_entry(big, 3 * comp_cols), hash_entry(big // 64, 24),
          hash_entry(big // 512, 24), hash_entry(1, 18)]),
        ("rp64_merge_rows", "winterfell_tpu/ops/pallas_rescue.py:632",
         "winterfell_tpu_torch/csrc/rescue.cu",
         # a level of the LDE tree, and the coin's one-row reseed
         [merge_entry(big // 2), merge_entry(1)]),
        ("rp64_merkle_tree", "winterfell_tpu/ops/pallas_rescue.py:632 (K2's "
         "kernel over every level of a tree)",
         "winterfell_tpu_torch/csrc/rescue.cu",
         [tree_entry(big), tree_entry(big // 8), tree_entry(big // 512)]),
        ("gl_mul", "winterfell_tpu/ops/pallas_kernels.py:129",
         "winterfell_tpu_torch/csrc/goldilocks.cu",
         [mul_entry(a, b, (big,)),
          mul_entry(bfly[:, 1], tw, (big // 64, 32, 3))]),
        ("rp64_permute_rows", "none: port-only (the JAX coin permutes in "
         "jnp, winterfell_tpu/ops/device_coin.py:140)",
         "winterfell_tpu_torch/csrc/rescue.cu",
         [permute_entry(n_ccs), permute_entry(1)]),
        ("rp64_coin_draw", "none: port-only (the JAX coin's lax.while_loop, "
         "winterfell_tpu/ops/device_coin.py:302)",
         "winterfell_tpu_torch/csrc/rescue.cu",
         [draw_entry(n_ccs, 3), draw_entry(1, 3)]),
    ]
    kernels = []
    for name, replaces, source, shapes in records:
        main = shapes[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": runs["resident"][name],
            "launches_phased": runs["phased"][name],
            "max_abs_err": errs[name], "max_diff": errs[name],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shape": main["shape"], "shapes": shapes})
    for kr in kernels:
        for s in kr["shapes"]:
            log(f"{kr['name']} {s['shape']}: {s['ms']:.4f} ms (launched "
                f"back to back from Python {s['host_ms']:.4f} ms), plain "
                f"{s['plain_ms']:.1f} ms, bound {s['bound_ms']:.4f} ms "
                f"({s['bound_by']})")
    phase("5 kernel times", t0)

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if REHEARSAL:
        log("rehearsal done (no verdict without a card)")
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
