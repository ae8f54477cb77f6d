"""Builds the port's CUDA sources into plain-C shared libraries and loads them
with ctypes, and reports what the compiler made of a source.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
``_build/lib<name>-<hash>.so`` beside the package, keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, at first use. ``build_all()`` starts one ``nvcc`` per
source at once and waits for all of them. No PyTorch header is included, so a
build takes seconds. The C entry points take raw device pointers, sizes and
a stream, and return ``cudaGetLastError()`` of their launch.

    python -m winterfell_tpu_torch.ops._build --sass [FILE ...] [--out DIR]

prints, per source (every ``csrc/*.cu`` by default), one JSON line read from
the source built as ``load`` builds it, to a cubin, with ``-Xptxas -v`` (and
writes it, with the SASS listing and the ptxas output, under ``--out``). Per
kernel:

- the registers, stack frame, spill stores and loads and shared memory that
  ptxas reports;
- ``static``: the kernel's SASS instructions by class, each counted once;
- ``per_permutation``: the instructions that one thread issues for one
  permutation, by class: the round loop (the largest loop that runs one of
  ``ROUNDS``, 7 for Rescue or 24 for Keccak-f, times) with every loop inside
  it weighted by its trip count, plus the code outside every loop once
  (loads, stores, the canonical fix). A kernel whose rounds are unrolled
  (BLAKE3) has none: its ``static`` count is one compression where the
  kernel compresses once (the merge).
  A loop's trip count is the immediate of the compare that sets its
  branch's predicate; loops outside the round loop (the round-constant copy
  into shared memory, the K1 absorb loop) are left out. Where several
  threads share a permutation this is one thread's share.

The report needs the CUDA toolkit (nvcc, ptxas, cuobjdump), not a card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("rescue", "goldilocks", "blake3", "keccak", "jive", "f128", "f62",
           "rp62", "ntt_mxu")

_libs: Dict[str, ctypes.CDLL] = {}


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the CUDA toolkit is needed")
    return path


def _target(name: str) -> str:
    """The library's path, named by a hash of the source, every header of
    csrc/ and the flags."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            os.path.join(CSRC, f) for f in os.listdir(CSRC)
            if f.endswith(".cuh")):
        with open(path, "rb") as f:
            key.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")


def _start(name: str):
    """Starts nvcc for ``name`` unless its library exists; returns
    (process or None, temp path, target path)."""
    target = _target(name)
    if os.path.exists(target):
        return None, None, target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, proc, tmp: str, target: str) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builders race harmlessly


def build_all(names: List[str] = SOURCES) -> None:
    """Compiles every source not yet built, all nvcc processes at once."""
    started = [(name, *_start(name)) for name in names]
    for name, proc, tmp, target in started:
        _finish(name, proc, tmp, target)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        proc, tmp, target = _start(name)
        _finish(name, proc, tmp, target)
        lib = _libs[name] = ctypes.CDLL(target)
    return lib


# ================================================================================
# What the compiler made of a source
# ================================================================================

# opcode prefix -> class; the first that matches wins
CLASSES = [("IMAD.WIDE", "IMAD.WIDE"), ("IMAD.MOV", "IMAD.MOV/SHL/IADD"),
           ("IMAD.SHL", "IMAD.MOV/SHL/IADD"), ("IMAD.IADD", "IMAD.MOV/SHL/IADD"),
           ("IMAD", "IMAD"), ("IADD3", "IADD3"), ("ISETP", "ISETP"),
           ("SEL", "SEL"), ("LOP3", "LOP3"), ("SHFL", "SHFL"), ("SHF", "SHF"),
           ("LEA", "LEA"), ("LDG", "LDG"), ("LDS", "LDS"), ("LDC", "LDC"),
           ("STG", "STG"), ("STS", "STS"), ("MOV", "MOV"), ("BRA", "BRA"),
           ("BAR", "BAR")]
_SASS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
ROUNDS = (7, 24)


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _demangle(names):
    if not names:
        return {}
    try:
        out = _run([_tool("cu++filt"), *names]).splitlines()
    except RuntimeError:
        return {n: n for n in names}
    return dict(zip(names, out))


def _classify(opcodes) -> dict:
    counts = collections.Counter()
    for op in opcodes:
        for prefix, cls in CLASSES:
            if op.startswith(prefix):
                counts[cls] += 1
                break
        else:
            counts["other"] += 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def _sass_by_function(cubin: str):
    """{mangled name: [(address, predicate, opcode, operands)]}, listing."""
    listing = _run([_tool("cuobjdump"), "-sass", cubin])
    funcs, current = {}, None
    for line in listing.splitlines():
        m = _FUNC.search(line)
        if m:
            current = funcs.setdefault(m.group(1), [])
            continue
        m = _SASS.search(line)
        if m and current is not None and m.group(3) != "NOP":
            current.append((int(m.group(1), 16), (m.group(2) or "").strip(),
                            m.group(3), m.group(4)))
    return funcs, listing


def _loops(ins):
    """[(first index, last index, trip count or None)] of the loops: the
    conditional backward branches, with the immediate of the ISETP that sets
    the branch's predicate inside the body as the trip count (2 where the
    body clears the uniform predicate the branch reads)."""
    where = {a: i for i, (a, _, _, _) in enumerate(ins)}
    loops = []
    for i, (addr, pred, op, args) in enumerate(ins):
        m = re.search(r"0x([0-9a-f]+)", args)
        if not (op.startswith("BRA") and pred and m):
            continue
        target = int(m.group(1), 16)
        if target > addr or target not in where:
            continue
        reg = pred.lstrip("@!")
        trip = None
        for _, _, op2, args2 in reversed(ins[where[target]:i]):
            if args2.split(",")[0].strip() != reg:
                continue
            if op2.startswith(("ISETP", "UISETP")):
                imm = re.search(r",\s*(0x[0-9a-f]+|\d+)\s*,\s*U?PT", args2)
                trip = int(imm.group(1), 0) if imm else None
                break
            # a predicate copied from a uniform one: follow that
            up = re.search(r"\bUP\d\b", args2)
            if not (op2.startswith("PLOP3") and up):
                break
            reg = up.group(0)
        if trip is None and reg.startswith("UP") and any(
                op2.startswith("UPLOP3") and re.match(
                    rf"\s*{reg}, UPT, UPT, UPT, UPT, 0x40,", args2)
                for _, _, op2, args2 in ins[where[target]:i]):
            # a loop of two passes: the body clears the uniform predicate
            # that the entry set
            trip = 2
        loops.append((where[target], i, trip))
    return loops


def _per_permutation(ins):
    """Instructions by class that one thread issues for one permutation (see
    the module's notes), and the loops read; None without a round loop."""
    loops = _loops(ins)
    rounds = [lp for lp in loops if lp[2] in ROUNDS]
    if not rounds:
        return None
    r0, r1, trips = max(rounds, key=lambda lp: lp[1] - lp[0])
    counts = collections.Counter()
    for i, (_, _, op, _) in enumerate(ins):
        if r0 <= i <= r1:
            weight = trips
            for a, b, trip in loops:
                if r0 <= a and b <= r1 and (a, b) != (r0, r1) and a <= i <= b:
                    if trip is None:
                        return None
                    weight *= trip
        elif any(a <= i <= b for a, b, _ in loops):
            continue
        else:
            weight = 1
        counts[op] += weight
    ops = [op for op, n in counts.items() for _ in range(n)]
    inner = [(b - a + 1, trip) for a, b, trip in loops
             if r0 <= a and b <= r1 and (a, b) != (r0, r1)]
    return {"instructions": sum(counts.values()), "classes": _classify(ops),
            "round_loop_body": r1 - r0 + 1, "inner_loops": inner}


def _ptxas_info(text: str) -> dict:
    """Per function: registers, stack, spills and shared memory from -v."""
    info, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([^' ]+)'?", line)
        if m:
            name = m.group(1)
            info.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            info[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:, (\d+) bytes smem)?", line)
        if m:
            info[name].update(registers=int(m.group(1)),
                              smem=int(m.group(2) or 0))
    return info


def _arch_flags():
    flags = list(NVCC_FLAGS)
    for f in ("-shared", "-Xcompiler", "-fPIC"):
        flags.remove(f)
    return flags


def sass_report(source: str, work: str) -> dict:
    t0 = time.perf_counter()
    base = os.path.splitext(os.path.basename(source))[0]
    cubin = os.path.join(work, f"{base}.cubin")
    text = _run([_tool("nvcc"), *_arch_flags(), "-cubin", "-Xptxas", "-v",
                 "-o", cubin, source])
    with open(os.path.join(work, f"{base}.ptxas.txt"), "w") as f:
        f.write(text)
    info = _ptxas_info(text)
    funcs, listing = _sass_by_function(cubin)
    with open(os.path.join(work, f"{base}.sass"), "w") as f:
        f.write(listing)
    names = _demangle(sorted(funcs))
    kernels = {}
    for mangled, ins in funcs.items():
        rec = dict(info.get(mangled, {}))
        rec["static"] = {"instructions": len(ins),
                         "classes": _classify(op for _, _, op, _ in ins)}
        rec["per_permutation"] = _per_permutation(ins)
        kernels[names.get(mangled, mangled)] = rec
    return {"source": source, "kernels": kernels,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", nargs="*", required=True, metavar="FILE",
                    help="sources to report on (default every csrc/*.cu)")
    ap.add_argument("--out", default=None,
                    help="directory for the JSON lines and SASS listings")
    args = ap.parse_args()
    out = args.out or tempfile.mkdtemp(prefix="sass_report_")
    os.makedirs(out, exist_ok=True)
    default = [os.path.join(CSRC, f"{name}.cu") for name in SOURCES]
    for i, source in enumerate(args.sass or default):
        work = os.path.join(out, str(i))
        os.makedirs(work, exist_ok=True)
        rec = sass_report(os.path.abspath(source), work)
        line = json.dumps(rec)
        with open(os.path.join(out, "report.jsonl"), "a") as f:
            f.write(line + "\n")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
