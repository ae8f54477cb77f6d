"""Where the time of one proof goes on the card.

    python -m winterfell_tpu_torch.profile_prove [--log2 18] [--top 15]
        [--hasher rp64_256] [--walls N] [--path fib_small]

Proves fib over f64 (``--path fib_small``: cubic, bench.py's options,
Rp64_256 or another f64 hasher by its name in ``crypto.hashers.HASHERS``),
or one of the f128 paths with the F128Prover and Blake3_256 unless
``--hasher`` names BLAKE3 or SHA3 (``--path rescue_f128``: bench.py's Rescue
chain, ProofOptions(42, 4, 16, NONE, 8, 31); ``--path fib_f128``: the CLI's
fib, ``--path lamport``: bench.py's Lamport aggregate (2^(log2 - 10)
signatures), ``--path rescue_raps``: the CLI's rescue_raps (-n 2^(log2 - 4),
an aux segment), each with the CLI's ProofOptions(28, 8, 16, NONE, 8, 31);
keys, signatures and traces are built before any prove), or the f62 paths
with the F62Prover (``--path fib_f62``: fib over f62 with Blake3_256 or the
BLAKE3 or SHA3 hasher ``--hasher`` names, ProofOptions(28, 8, 16, CUBIC, 8,
31); ``--path fib_f62_rp62``: the same with Rp62_248 and no grinding,
ProofOptions(28, 8, 0, CUBIC, 8, 31), whose nonces the host would scan one
Rescue permutation at a time), once to warm up,
then once under ``torch.profiler`` with phase barriers off, and prints one
JSON object: the route the prove took (resident by default;
``WINTER_RESIDENT=0`` for the phased one), the wall time, the device time
summed over kernels, the share of the wall during which some kernel ran
(busy share, from the union of the kernel intervals), the number of kernel
launches, the host time per launch (the wall outside every kernel interval
over the launches), the kernels with the most device time, and each hand
kernel's launches as its wrapper counts them (``launches_by_kernel``: every
``LAUNCHES`` count above 0, B16's ``ntt_mxu_product`` and
``ntt_mxu_recombine`` among them when ``WINTER_MXU_NTT=1`` puts the f128
NTTs on int8 tensor cores; ``mxu_ntt`` says whether it did). On the f128
paths it also times one B13 multiply on 1024 elements called 2000 times in
a row, through its entry point (``f128_mul``: checks, layout, output
allocation and launch) and as the bare launch with the layout and output
made once, host microseconds per call. With ``--walls N``, N more proves
run free (no profiler, phase barriers off) before the profiled one, and
their walls are printed too. With ``--by-site``, one more prove runs under
``torch.profiler`` with ``with_stack=True`` (its wall is not reported: the
Python tracer slows the host), and its kernel launches and device time are
grouped by call site: each kernel is matched to its launch on the host
(the CUDA runtime call of the same correlation id) and the launch to the
Python frames open around it in the trace. ``by_site`` groups by the
innermost ``winterfell_tpu_torch`` frame (file, first line of the function
and its name: ``ops/goldilocks.py(…): gl_batch_inv`` for a torch chain's
launches there, a kernel wrapper for a hand kernel's), ``by_caller`` by the
innermost frame outside ``ops/`` and ``utils/`` (the prover's or AIR's code
that called the engine). Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

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


_PKG = "winterfell_tpu_torch/"


def _site(name: str) -> str:
    """A Python frame's trace name ('…/winterfell_tpu_torch/ops/x.py(12):
    fn') from the package on."""
    return name[name.index(_PKG) + len(_PKG):]


def _attribute(frames, launches):
    """For each launch (tid, ts, kernel name, device µs), the innermost
    package frame open around it on its thread and the innermost one
    outside ops/ and utils/; frames are (tid, start, end, name) of the
    package's Python functions. Returns {"by_site": ..., "by_caller": ...}:
    per group its launches, device ms and launches per kernel name, the
    groups with the most device time first."""
    events = sorted([(tid, ts, 0, end, name) for tid, ts, end, name in frames]
                    + [(tid, ts, 1, dur, name) for tid, ts, name, dur
                       in launches], key=lambda e: (e[0], e[1], e[2], -e[3]))
    groups = {"by_site": defaultdict(lambda: [0, 0.0, defaultdict(int)]),
              "by_caller": defaultdict(lambda: [0, 0.0, defaultdict(int)])}
    stack, tid_now = [], None
    for tid, ts, kind, val, name in events:
        if tid != tid_now:
            stack, tid_now = [], tid
        while stack and stack[-1][0] <= ts:
            stack.pop()
        if kind == 0:
            stack.append((val, name))
            continue
        site = stack[-1][1] if stack else "(no package frame)"
        caller = next((f for _, f in reversed(stack)
                       if not f.startswith(("ops/", "utils/"))),
                      "(no frame outside ops/, utils/)")
        for key, view in ((site, "by_site"), (caller, "by_caller")):
            rec = groups[view][key]
            rec[0] += 1
            rec[1] += val / 1000
            rec[2][name[:60]] += 1
    return {view: sorted(({"site": k, "launches": c, "ms": ms,
                           "kernels": dict(sorted(kn.items(),
                                                  key=lambda kv: -kv[1]))}
                          for k, (c, ms, kn) in g.items()),
                         key=lambda r: -r["ms"])
            for view, g in groups.items()}


def _by_site(prover, trace, top: int) -> dict:
    """One prove under the profiler with Python stacks; its kernels grouped
    by call site (``_attribute``), the ``top`` groups of each view."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        prover.prove(trace)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    frames, runtime, kernels = [], {}, []
    for e in events:
        cat = e.get("cat")
        if cat == "python_function" and _PKG in e.get("name", ""):
            frames.append((e["tid"], e["ts"], e["ts"] + e["dur"],
                           _site(e["name"])))
        elif cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            runtime[e["args"]["correlation"]] = (e["tid"], e["ts"])
        elif cat == "kernel":
            kernels.append(e)
    launches, unmatched = [], 0
    for k in kernels:
        at = runtime.get(k.get("args", {}).get("correlation"))
        if at is None:
            unmatched += 1
            continue
        launches.append((at[0], at[1], k["name"], k["dur"]))
    out = _attribute(frames, launches)
    return {"kernels": len(kernels), "unmatched": unmatched,
            **{view: rows[:top] for view, rows in out.items()}}


def _b13_host_us(calls: int = 2000) -> dict:
    """Host microseconds per B13 multiply on (1024, 2) CUDA elements: through
    ``f128_mul`` and as the bare launch (layout and output made once)."""
    from .ops import f128

    a = f128.power_series(3, 1024, "cuda")
    b = f128.power_series(5, 1024, "cuda")
    layout = f128.op_layout("f128_mul", a, b)
    out = torch.empty_like(a)
    launch = f128._LAUNCH["mul"]
    out_us = {}
    for name, call in (
            ("entry_point", lambda: f128.f128_mul(a, b)),
            ("bare_launch", lambda: launch(a[..., 0], b[..., 0],
                                           out[..., 0], layout))):
        call()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        out_us[name] = (time.perf_counter() - t) * 1e6 / calls
    return out_us


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2", type=int, default=18, help="log2 trace rows")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--hasher", default="rp64_256",
                    help="name of the hasher (crypto.hashers.HASHERS)")
    ap.add_argument("--walls", type=int, default=0,
                    help="free-running proves timed before the profiled one")
    ap.add_argument("--by-site", action="store_true",
                    help="one more prove, its kernels grouped by call site")
    ap.add_argument("--path", default="fib_small",
                    choices=("fib_small", "rescue_f128", "fib_f128",
                             "lamport", "rescue_raps", "fib_f62",
                             "fib_f62_rp62"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from .air import FieldExtension, ProofOptions
    from .crypto import hashers
    from .examples import lamport, rescue, rescue_raps
    from .examples.fib_f62 import FibF62Prover, build_fib_f62_trace
    from .examples.fibonacci import FibProver, FibSmallProver, build_fib_trace
    from .math.fields import F64, F128
    from .prover.device import GoldilocksProver
    from .prover.device_limb import F62Prover, F128Prover
    from .utils import tracing

    hasher = hashers.HASHERS[args.hasher]
    if args.path == "fib_small":
        options = ProofOptions(32, 8, 0, FieldExtension.CUBIC, 8, 31)
        prover = GoldilocksProver.accelerate(FibSmallProver)(options, hasher)
        trace = build_fib_trace(F64, 2 << args.log2, device="cuda")
    elif args.path.startswith("fib_f62"):
        rp = args.path == "fib_f62_rp62"
        if rp:
            hasher = hashers.Rp62_248
        elif args.hasher == "rp64_256":
            hasher = hashers.Blake3_256
        options = ProofOptions(28, 8, 0 if rp else 16, FieldExtension.CUBIC,
                               8, 31)
        prover = F62Prover.accelerate(FibF62Prover)(options, hasher)
        trace = build_fib_f62_trace(1 << args.log2)
    else:
        if args.hasher == "rp64_256":
            hasher = hashers.Blake3_256
        if args.path == "rescue_f128":
            options = ProofOptions(42, 4, 16, FieldExtension.NONE, 8, 31)
            prover = F128Prover.accelerate(rescue.RescueProver)(options,
                                                                hasher)
            trace = rescue.build_rescue_trace((42, 43), 1 << (args.log2 - 4))
        else:
            options = ProofOptions(28, 8, 16, FieldExtension.NONE, 8, 31)
            if args.path == "lamport":
                pks, msgs, sigs = lamport.sign_messages(1 << (args.log2 - 10))
                prover = F128Prover.accelerate(lamport.LamportAggregateProver)(
                    options, hasher, pks, msgs)
                trace = lamport.build_lamport_trace(msgs, sigs)
            elif args.path == "rescue_raps":
                seeds = [(i + 1, i + 2) for i in range(1 << (args.log2 - 4))]
                prover = F128Prover.accelerate(rescue_raps.RescueRapsProver)(
                    options, hasher)
                trace = rescue_raps.build_raps_trace(seeds,
                                                     seeds[2:] + seeds[:2])
            else:
                prover = F128Prover.accelerate(FibProver)(options, hasher)
                trace = build_fib_trace(F128, 2 << args.log2, device="cuda")
    from .ops import (blake3, device_coin, f62, f128, field_kernels, jive,
                      ntt_mxu, rp62, sha3)
    from .ops import rescue as rescue_ops

    counted = (rescue_ops, field_kernels, device_coin, blake3, sha3, jive,
               f128, f62, rp62, ntt_mxu)
    prover.prove(trace)
    tracing.set_phase_sync(False)
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.walls):
        t = time.perf_counter()
        prover.prove(trace)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    for mod in counted:
        mod.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prover.prove(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches_by_kernel = {k: v for mod in counted
                          for k, v in mod.LAUNCHES.items() if v}

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
    b13 = (_b13_host_us() if args.path not in ("fib_small", "fib_f62",
                                                "fib_f62_rp62") else None)
    by_site = _by_site(prover, trace, args.top) if args.by_site else None
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "trace_log2": args.log2,
        "path": args.path,
        "hasher": hasher.name,
        "route": route,
        "mxu_ntt": f128._USE_MXU,
        "wall_s": wall,
        "free_walls_s": walls,
        "kernel_launches": len(kernels),
        "device_kernel_ms": device_us / 1000 if kernels else None,
        "busy_share": busy_us / (wall * 1e6) if kernels else None,
        "host_us_per_launch": ((wall * 1e6 - busy_us) / len(kernels)
                               if kernels else None),
        "b13_mul_host_us": b13,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels": [{"name": n[:90], "launches": c, "ms": us / 1000}
                        for n, (c, us) in top],
        "launches_by_kernel": launches_by_kernel,
        "call_sites": by_site,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
