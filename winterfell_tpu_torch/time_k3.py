"""K3's time on the card at the main path's shape, as ``chip_smoke.py``
phase 5 times it, alone.

    python -m winterfell_tpu_torch.time_k3 [--reads 5] [--label NAME]

Multiplies two random (2^21,) u64 vectors (the seed of ``chip_smoke.py``)
with ``field_kernels.gl_mul_kernel``: 20 launches captured in a CUDA graph,
replayed between CUDA events, the mean per launch in ms, ``--reads`` times.
Prints one JSON line with the card's name. Run it from two checkouts in
one call, in turns (a, b, b, a), to compare two commits' K3 on one card.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def graph_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of fn() over reps calls replayed from a CUDA graph."""
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=5)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_k3: no CUDA device", file=sys.stderr)
        return 1
    from .ops import field_kernels

    rng = np.random.default_rng(20260817)
    a, b = (torch.from_numpy(rng.integers(0, 2**64, size=1 << 21,
                                          dtype=np.uint64).view(np.int64))
            .cuda() for _ in range(2))
    print(json.dumps({
        "label": args.label, "device": torch.cuda.get_device_name(0),
        "k3_ms": [graph_ms(lambda: field_kernels.gl_mul_kernel(a, b))
                  for _ in range(args.reads)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
