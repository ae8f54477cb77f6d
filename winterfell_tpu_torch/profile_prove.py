"""Where the time of one GoldilocksProver proof goes on the card.

    python -m winterfell_tpu_torch.profile_prove [--log2 18] [--top 15]
        [--hasher rp64_256] [--walls N]

Proves fib over f64 (cubic, bench.py's options, Rp64_256 or another f64
hasher by its name in ``crypto.hashers.HASHERS``) once to warm up,
then once under ``torch.profiler`` with phase barriers off, and prints one
JSON object: the route the prove took (resident by default;
``WINTER_RESIDENT=0`` for the phased one), the wall time, the device time
summed over kernels, the share of the wall during which some kernel ran
(busy share, from the union of the kernel intervals), the number of kernel
launches, and the kernels with the most device time. With ``--walls N``,
N more proves run free (no profiler, phase barriers off) before the
profiled one, and their walls are printed too. Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (microseconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2", type=int, default=18, help="log2 trace rows")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--hasher", default="rp64_256",
                    help="name of the hasher (crypto.hashers.HASHERS)")
    ap.add_argument("--walls", type=int, default=0,
                    help="free-running proves timed before the profiled one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from .air import FieldExtension, ProofOptions
    from .crypto import hashers
    from .examples.fibonacci import FibSmallProver, build_fib_trace
    from .math.fields import F64
    from .prover.device import GoldilocksProver
    from .utils import tracing

    options = ProofOptions(32, 8, 0, FieldExtension.CUBIC, 8, 31)
    hasher = hashers.HASHERS[args.hasher]
    prover = GoldilocksProver.accelerate(FibSmallProver)(options, hasher)
    trace = build_fib_trace(F64, 2 << args.log2, device="cuda")
    prover.prove(trace)
    tracing.set_phase_sync(False)
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.walls):
        t = time.perf_counter()
        prover.prove(trace)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prover.prove(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_name = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[: args.top]
    marks = [s["name"] for s in tracing.last_spans()]
    route = ("resident" if "resident_pipeline" in marks else
             "phased, fused FRI" if "fri_layers_fused" in marks else
             "phased, host coin")
    device_us = sum(e - s for s, e in intervals)
    busy_us = _busy_us(intervals)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "trace_log2": args.log2,
        "hasher": args.hasher,
        "route": route,
        "wall_s": wall,
        "free_walls_s": walls,
        "kernel_launches": len(kernels),
        "device_kernel_ms": device_us / 1000 if kernels else None,
        "busy_share": busy_us / (wall * 1e6) if kernels else None,
        "top_kernels": [{"name": n[:90], "launches": c, "ms": us / 1000}
                        for n, (c, us) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
