"""Smoke run of the PyTorch/CUDA port (winterfell_tpu_torch) on one GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes on the CPU, no verdict

Phases, each printed with its elapsed seconds as it ends:

1. device: the card's name and power limit; build the CUDA kernels (one
   nvcc per source, all at once) and the native host BLAKE3.
2. kernels: every kernel against its plain PyTorch version on the card, bit
   for bit (field elements and digest words are exact integers): K1 row
   hash, K2 merge per level and the Merkle tree kernel (leaf counts 2^0,
   2^1, each side of the one-block tail, 2^21), K3 field multiply
   (contiguous, broadcast, strided, Python-int operands, and split into
   several launches above a lowered INDEX_LIMIT), the Rp64 coin's
   permute_rows and draw kernels; the f64 engine's B0 add and subtract
   and B0x quadratic and cubic products at (2^21,), (2^21, 3) and (2^20, 2)
   over random u64 patterns with every pair of the corner set (against the
   reference's add and subtract formulas on Python ints too), at the
   prover's operand layouts (a Python int, columns, butterfly halves, the
   sum tree's halves, z and α expanded, pows2 expanded over the columns,
   strided components) and split above a lowered INDEX_LIMIT, B4 (whole
   NTTs of its stages, the first reading bit-reversed) at 2 ... 2^21 rows,
   B5 (the FRI fold) at N = 2, 4, 8, 16 and d = 1, 2, 3 (the main path's
   first fold at 2^21 rows); B10 BLAKE3 (8 and 6 digest words), B11
   SHA3 and B12 Jive row hashes at 1 ... 40 elements a row, merges and trees
   of 1 ... 2^21 leaves; the byte coins' draw kernels with rejected
   candidates planted; the Rescue kernels on random values and on corner
   sets (0, 1, 2^32 - 1, 2^32, 2^63, p - 2^32, p - 2, p - 1), the byte
   hashes on random words and all-ones words. The f128 kernels: B13 add,
   subtract and multiply at (2^21,) over random values and every pair of an
   f128 corner set (0, 1, p - 1, values just under 2^128 reduced, products
   whose high half is near 2^128 mod p), at the operand layouts the f128
   prover passes and split above a lowered INDEX_LIMIT; B13n (whole NTTs of
   its stages) at sizes 2 ... 2^21; the f128 draw of each byte coin with
   rejected candidates planted. The f62 kernels: B14 add, subtract and
   multiply at (2^21,) over random values and every pair of an f62 corner
   set, at the f62 prover's operand layouts and split above a lowered
   INDEX_LIMIT; B14n (whole NTTs) at sizes 2 ... 2^21; B15 (Rp62_248) row
   hashes at the rate edges (1 ... 24 elements, random, mixed corners and
   rows of one corner value: p - 1, E = 2^62 mod p, E + 1, 2^61, p - E, ...)
   and at (2^21, 2), (2^18, 24), 1, 3, 5, 127 and 129 rows (no multiple of
   a thread group or a block), merges at those counts and of corner
   digests, trees of 1 ... 2^21 leaves (a block with fewer merges than a
   group's threads included), the coin's candidates below and above p62
   (1 ... 448, from p62 - 2 and up to 2^64 - 1, a seed of p - 1's); the
   f62 draws of the Rp62_248, BLAKE3 and SHA3 coins with rejected
   candidates planted. B16, the f128 leaf DFT under WINTER_MXU_NTT=1: the
   digit product, the recombine and whole leaf DFTs at leaf sizes 2 ...
   128, both directions, on random values with corners (digit 9, bits
   63-69, across the words), over batches that are no multiple of a block
   and the paths' (32, 2^17) and (64, 2^16), on diagonal sums at their
   maximum, in chunks with a ragged last one; whole NTTs of 2^10, 2^18 and
   2^21 rows under the switch against the radix-2 B13n NTT.
3. card vs CPU (the CPU's proofs come from a process of their own, started
   after phase 1, which proves while the card runs phase 2): a fib proof
   at trace 2^10 with each f64 hasher on the card,
   on each route the JAX dispatch gives it (resident, phased with fused
   FRI, phased with the host coin; RpJive64_256 only the last), against the
   CPU's bytes; verify() accepts each. The same for the f128 prover
   (Blake3_256): fib at trace 2^10 (no extension) and 2^8 (quadratic), the
   Rescue chain at trace 2^8. Then, on both phased routes (the dispatch
   never takes the resident one for them): rescue_raps -n 8 (aux segment,
   without and with the extension) and the f64 aux AIR (trace 2^10, cubic)
   with Rp64_256 and Blake3_256; and Lamport with one signature (trace
   1024 x 22, sequence assertions) on the three routes. The f62 prover:
   fib over f62 at trace 2^10 (cubic) with Blake3_256 and Rp62_248 on the
   three routes, Sha3_256 on the resident one, Rp62_248 with two
   partitions (quadratic) on the resident one. The f128 fib (no extension)
   and Rescue cases again under WINTER_MXU_NTT=1 on the resident and
   phased routes: B16 launched, no B13n, the CPU's bytes.
4. main path: fib over f64, trace 2^18, bench.py's options — with Rp64_256
   (bench.py's workload) and with Blake3_256 — on the resident and the
   phased route: per route one warm-up, its resident device run under
   torch.cuda.set_sync_debug_mode("error") (any host synchronisation fails
   the run), three proves timed with the phase barriers off (as bench.py
   times; the first one's launches counted), one with them on for the
   per-phase split; all equal and verified. Each path's kernels must have
   launched (its hasher's, and the f64 engine's B0, B0x, B4 and B5), and
   K2 at most 30 times per Rp64 prove. Then one 2^18 prove,
   verified, with the CLI's default options (Blake3_256, grinding 16, no
   extension) and one each with Blake3_192, Sha3_256 and RpJive64_256.
   Then the two f128 paths at trace 2^18, each timed as above with its
   kernels' launches and peak memory, verified: bench.py's rescue_f128 (the
   Rescue chain, Blake3_256, ProofOptions(42, 4, 16, NONE, 8, 31), LDE
   2^20: the resident route, its device run under the sync check) and the
   CLI's fib (Blake3_256, ProofOptions(28, 8, 16, NONE, 8, 31), LDE 2^21:
   the phased route with fused FRI); both again under WINTER_MXU_NTT=1
   (B16 leaves, no B13n stage and no gather launched), with the bytes of
   the proves without it; and one Rescue prove with Sha3_256.
   Then this slice's paths, timed the same way with the CLI's options:
   bench.py's lamport workload (256 signatures, trace 2^18 x 22, LDE 2^21;
   keys, signatures and trace built by native/f128.c before the proves) and
   the CLI's rescue_raps -n 1024 (trace 2^14 x (8 + 3 aux)), both phased
   with fused FRI. Then the f62 slice's paths, timed the same way: fib over
   f62 with the CLI's options and the cubic extension, Blake3_256
   (grinding 16) and Rp62_248 (no grinding), at trace 2^17 (LDE 2^20,
   resident, sync-checked) and 2^18 (LDE 2^21, phased with fused FRI); and
   one resident prove with Sha3_256.
4b. the port's CLI: each of its 13 examples at a small -n, proved on the
   card and verified.
5. kernel times at the main path's shapes against their bounds: device time
   per launch from launches replayed in a CUDA graph, beside the time per
   call when the wrapper is called back to back from Python; the whole
   2^21-leaf trees, one-row latencies (B15: one merge, one candidate, and
   the draw's own permutations, the warp running the draw loop in step and
   a group of 4 threads computing each further candidate), the composition
   width; B0, B0x, B4 and B5 at the f64 main path's shapes, each launch on
   the next of rotating copies of its inputs; B16's two kernels at the
   leaf shapes of the f128 paths under the switch, beside the whole leaf
   DFT, its bound (tensor-core operations, 32 bytes per element), the
   radix-2 transform of the same shape and torch._int_mm of the same digit
   product.

The line before the last is the kernels' JSON record; the last line is the
run's verdict. Any failure exits non-zero before that verdict. Without a
CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import itertools
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

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
# B12, RpJive64_256: the same count at width 8, whose MDS has 64
# small-constant products: 7·8·(65·6 + 11·8) + 7·2·64·4 = 30,352.
IMAD_PER_JIVE = 7 * 8 * (65 * 6 + 11 * 8) + 7 * 2 * 64 * 4
# The integer ALU pipe (adds, logic ops, shifts) takes a warp instruction
# every other cycle per SM quarter, as the IMAD pipe: 132 × 64 lanes per
# clock at 1.98 GHz.
ALU_PER_S = 132 * 64 * 1.98e9
# B10: one BLAKE3 compression is 7 rounds of 8 G functions, each 4
# three-input adds, 4 xors (LOP3) and 4 rotations (one funnel shift, SHF,
# each), then 8 xors. The adds may issue on the IMAD pipe as well (IMAD.IADD;
# the compiler puts about half of them there), the xors and rotations only on
# the ALU pipe: its floor is 7·8·8 + 8 = 456 instructions, more than half of
# all 680.
ALU_PER_BLAKE3 = 7 * 8 * 8 + 8
# B11: the fewest ALU instructions of one Keccak-f[1600] on 32-bit halves
# with three-input logic ops: per round θ's 5 column parities (2 LOP3 per
# half: 20), their 5 rotations by 1 (2 SHF: 10) and the 25 lanes' update
# (one LOP3 per half: 50), ρ's 24 rotations (2 SHF each: 48), χ's 25
# lanes (a ^ (~b & c), one LOP3 per half: 50), ι (2): 180 a round, ×24.
ALU_PER_KECCAK = 24 * 180
# B13 / B13n: one f128 product is four 64×64→128-bit partial products and
# three 64×46-bit products of the two folds by 2^128 mod p, each 8 IMADs
# (4 partial products of 2): 56. An add or subtract multiplies nothing.
IMAD_PER_F128_MUL = 7 * 8
P128 = 2**128 - 45 * 2**40 + 1
PHI128 = 45 * 2**40 - 1  # 2^128 mod p
# canonical f128 corner values: 0, 1, 2, p - 1, p - 2; 2^128 - 1 and 2^128
# - 2 reduced; the word edges; products of pairs that reach 2^128 (2^127·2,
# 2^100·2^28, 2^96·2^32, (2^64 - 1)(2^64 + 1)), whose high half is then
# near 2^128 mod p; and p - 2^128 mod p
F128_CORNERS = [0, 1, 2, P128 - 1, P128 - 2, (2**128 - 1) % P128,
                (2**128 - 2) % P128, 2**64 - 1, 2**64, 2**64 + 1, 2**127,
                2**100, 2**28, 2**96, 2**32, PHI128, PHI128 + 1,
                P128 - PHI128, P128 - 2**64]

# B16, the f128 leaf DFT under WINTER_MXU_NTT=1: the digit product's
# non-zero (l, j) blocks are 361 of 37 × 19, each an n × n s8 matrix, so a
# leaf DFT of n points over B columns is 2·361·n²·B int8 operations on the
# tensor cores (1,979 T/s dense on the H100 SXM, NVIDIA data sheet); the
# product reads 16 bytes and writes 37 int32 sums (148 bytes) per element,
# the recombine reads those and writes 16 bytes, two f128 products each
INT8_OPS_PER_S = 1979e12
MXU_BLOCKS = 361
SUMS_BYTES = 37 * 4
# f128 values whose 7-bit digit 9 (bits 63-69) spans the (lo, hi) words, or
# whose top digit (bits 126-127) is set, beside canonical corners
MXU_CORNERS = [0, 1, 2, P128 - 1, P128 - 2, 2**127, 2**63, 2**64,
               2**64 - 1, 0x7F << 63, 1 << 69, (1 << 69) | (1 << 63),
               2**126 + 2**63]


# B14 / B14n: one f62 product is a 64×64→128-bit product (4 partial
# products of 2 IMADs); its four folds multiply by 2^62 mod p = 111·2^39 −
# 1 only, which is (h << 46) − (h << 43) − (h << 39) − h: no IMAD. An add
# or subtract multiplies nothing.
IMAD_PER_F62_MUL = 8
# B15, Rp62_248, counted as Rp64_256 above: per lane and round the S-box x^3
# (a squaring and a multiply) and the inverse S-box's chain (62 squarings,
# 11 multiplies), 63 squarings at 6 IMADs and 12 multiplies at 8; each of
# the 14 MDS is 144 products of a lane by a 62-bit constant (8 IMADs), and
# the reductions of its 128-bit sums fold by 2^64 mod p = 4·E and 2^62 mod p
# = E, shifts and subtracts only: 7·12·(63·6 + 12·8) + 14·144·8 = 55,944.
IMAD_PER_RP62 = 7 * 12 * (63 * 6 + 12 * 8) + 14 * 144 * 8
P62 = 2**62 - 111 * 2**39 + 1
E62 = 111 * 2**39 - 1  # 2^62 mod p
# canonical f62 corner values: 0, 1, 2, p - 1, p - 2; 2^62 mod p and its
# neighbours; the 31- and 32-bit edges of the plain version's halves and
# the JAX engine's limbs; values whose products reach 2^124
F62_CORNERS = [0, 1, 2, P62 - 1, P62 - 2, E62, E62 + 1, 2**31 - 1, 2**31,
               2**32 - 1, 2**32, 2**61, P62 - 2**31, P62 - E62]


# the port's CLI at small sizes (its -n: sequence length, chain length,
# tree depth or signatures), each example once
CLI_SIZES = (("fib", 1024), ("fib2", 1024), ("fib8", 1024),
             ("fib_small", 1024), ("mulfib", 1024), ("mulfib8", 1024),
             ("vdf", 1024), ("vdfx", 1024), ("rescue", 64),
             ("rescue_raps", 8), ("merkle", 7), ("lamport", 2),
             ("lamport_threshold", 3))


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


def _rng_f128(rng, shape, device):
    """Random canonical f128 elements as a (*shape, 2) tensor of (lo, hi)
    words: a high word of all ones (the only one where a value can reach
    p) is lowered by one."""
    n = int(np.prod(shape, dtype=np.int64))
    w = rng.integers(0, 2**64, size=(n, 2), dtype=np.uint64)
    w[:, 1] = np.where(w[:, 1] == np.uint64(2**64 - 1),
                       np.uint64(2**64 - 2), w[:, 1])
    return torch.from_numpy(w.view(np.int64).reshape(tuple(shape) + (2,))).to(
        device)


def _rng_f62(rng, shape, device):
    """Random canonical f62 elements as an int64 tensor."""
    a = rng.integers(0, P62, size=shape, dtype=np.int64)
    return torch.from_numpy(a).to(device)


def _f62_of(values, device):
    return torch.tensor([int(v) for v in values], dtype=torch.int64,
                        device=device)


def _f128_of(values, device):
    from winterfell_tpu_torch.ops import f128

    return f128.to_device(np.array(values, dtype=object), device)


def _ntt_plain(x, n: int, inverse: bool, eng=None):
    """The NTT of ops/f128.py:_ntt_core (or ops/f62.py's, ``eng``) with
    every stage the plain version of B13n (B14n)."""
    from winterfell_tpu_torch.ops import f128

    eng = eng or f128
    perm, tw = eng.ntt_plan(n, inverse, x.device)
    y = x.index_select(0, perm).reshape((n, -1) + tuple(eng.ELEM))
    half = 1
    while half < n:
        y = eng.ntt_stage_plain(y, tw, half)
        half *= 2
    return y.reshape(x.shape)


def _gl_formula(name: str, x: int, y: int) -> int:
    """The reference's gl_add / gl_sub (winterfell_tpu/ops/goldilocks.py
    :81, :88) on u64 Python ints: a wrapped sum plus 2^32 − 1, then one
    subtract of p; a borrow minus 2^32 − 1."""
    p, m, eps = 2**64 - 2**32 + 1, 2**64, 2**32 - 1
    if name == "gl_add":
        s = (x + y) % m
        if s < x:
            s = (s + eps) % m
        return s - p if s >= p else s
    d = (x - y) % m
    return (d - eps) % m if x < y else d


def _max_abs_err(a, b) -> float:
    """Largest |a − b| over the elements, read as unsigned values (64-bit
    field elements, 32-bit digest words)."""
    kind = np.uint32 if a.dtype == torch.int32 else np.uint64
    x = a.cpu().numpy().view(kind).astype(object).ravel()
    y = b.cpu().numpy().view(kind).astype(object).ravel()
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


def _time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after a warm-up
    unless ``warm`` is False)."""
    if warm:
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


def _rotating(fn, *args):
    """fn() over copies of its tensor arguments, the next copy at each call:
    as many copies (at most 16) as hold four times the L2's 50 MiB, so that
    a timed launch reads its inputs from HBM, as on the prove path, and not
    from the L2 that the launch before it filled."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = min(16, -(-4 * 50 * 2**20 // max(nbytes, 1)))
    copies = itertools.cycle(
        [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args) for _ in range(n - 1)])
    return lambda: fn(*next(copies))


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


def _bound_blake3(m: int, byte_len: int, dw: int):
    """B10 row hash of m rows of byte_len bytes: one compression per 64-byte
    block; each row read once, each digest written once."""
    blocks = max(1, -(-byte_len // 64))
    return _bound_alu(m * blocks * ALU_PER_BLAKE3, m * (byte_len + 4 * dw))


def _bound_sha3(m: int, byte_len: int):
    """B11 row hash: byte_len // 136 + 1 permutations per row."""
    perms = byte_len // 136 + 1
    return _bound_alu(m * perms * ALU_PER_KECCAK, m * (byte_len + 32))


def _bound_alu(ops: float, nbytes: float):
    """(bound ms, bound_by): the larger of the ALU time and the bytes time."""
    ops_ms = ops / ALU_PER_S * 1000
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1000
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _bound_byte_merge(merges: int, dw: int, per_hash: int, reads: int):
    """merges one-block hashes of two dw-word digests: ``reads`` digests
    read (2 per merge of a level, 1 per node of a tree's input level) and
    one written per merge."""
    return _bound_alu(merges * per_hash, (reads + merges) * 4 * dw)


def _bound_jive(perms: int, nbytes: int):
    return _bound(perms * IMAD_PER_JIVE, nbytes)


def _bound_f128(x, y, mul: bool):
    """B13 on x ∘ y: each element of the operands read once (a broadcast
    operand's own, an int none) and each result written once, 16 bytes each;
    56 IMADs per product, none for an add or subtract."""
    y_shape, y_numel = ((y.shape[:-1], y.numel() // 2)
                        if isinstance(y, torch.Tensor) else ((), 0))
    n = torch.broadcast_shapes(x.shape[:-1], y_shape).numel()
    return _bound(n * IMAD_PER_F128_MUL if mul else 0,
                  (x.numel() // 2 + y_numel + n) * 16)


def _bound_ntt_stage(n: int, cols: int, half: int):
    """One B13n stage: n/2·cols butterflies of one product each; every
    element read and written once, the stage's half twiddles read once."""
    return _bound(n // 2 * cols * IMAD_PER_F128_MUL,
                  (2 * n * cols + half) * 16)


def _bound_mxu(n: int, cols: int, nbytes: float):
    """(bound ms, bound_by) of B16 work over (n, cols) elements: the larger
    of the tensor-core time of the 2·361·n²·cols int8 operations and the
    bytes time of ``nbytes`` per element."""
    ops_ms = 2 * MXU_BLOCKS * n * n * cols / INT8_OPS_PER_S * 1000
    bytes_ms = nbytes * n * cols / HBM_BYTES_PER_S * 1000
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _bound_f62(x, y, mul: bool):
    """B14 on x ∘ y: each element of the operands read once (a broadcast
    operand's own, an int none) and each result written once, 8 bytes
    each; 8 IMADs per product, none for an add or subtract."""
    y_shape, y_numel = ((y.shape, y.numel()) if isinstance(y, torch.Tensor)
                        else ((), 0))
    n = torch.broadcast_shapes(x.shape, y_shape).numel()
    return _bound(n * IMAD_PER_F62_MUL if mul else 0,
                  (x.numel() + y_numel + n) * 8)


def _bound_stage62(n: int, cols: int, half: int):
    """One B14n stage: n/2·cols butterflies of one product each; every
    element read and written once, the stage's half twiddles read once."""
    return _bound(n // 2 * cols * IMAD_PER_F62_MUL, (2 * n * cols + half) * 8)


def _own(t) -> int:
    """The elements a tensor view holds (a broadcast dim counted once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


# the base products of one extension product (ops/goldilocks.py ext_mul):
# quadratic 4, cubic 9
EXT_PRODUCTS = {1: 1, 2: 4, 3: 9}


def _bound_ext(x, y):
    """B0x on x·y of (..., d) operands: each operand's own elements read
    once and each result written once, 8 bytes each; d = 2: 4 products,
    d = 3: 9, each 8 IMADs."""
    d = x.shape[-1]
    lead = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1]).numel()
    return _bound(lead * EXT_PRODUCTS[d] * IMAD_PER_MUL,
                  (_own(x) + _own(y) + lead * d) * 8)


def _bound_fold(n: int, n_fold: int, d: int):
    """B5 on (n, d) evaluations: the evaluations and the (N, rows) offset
    powers read once, the (rows, d) fold written once, 8 bytes each; per
    row the N-point iNTT (N/2·log2 N products per component), the 1/N and
    offset scaling (2N per component) and N − 1 Horner steps (an extension
    product each), 8 IMADs a product."""
    rows = n // n_fold
    products = (d * (n_fold // 2 * (n_fold.bit_length() - 1) + 2 * n_fold)
                + (n_fold - 1) * EXT_PRODUCTS[d])
    return _bound(rows * products * IMAD_PER_MUL,
                  (n * d + n_fold * rows + rows * d) * 8)


def _bound_rp62(perms: int, nbytes: int):
    return _bound(perms * IMAD_PER_RP62, nbytes)


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


def _kernel_modules():
    from winterfell_tpu_torch.ops import (blake3, device_coin, f62, f128,
                                          field_kernels, jive, ntt_mxu,
                                          rescue, rp62, sha3)

    return (rescue, field_kernels, device_coin, blake3, sha3, jive, f128, f62,
            rp62, ntt_mxu)


def _launches():
    """Every kernel's launch count since the last _reset_launches()."""
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def _reset_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def _words(rng, shape, device):
    """Random u32 words as int32, the first row all ones."""
    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    a[0] = 2**32 - 1
    return torch.from_numpy(a.view(np.int32)).to(device)


def _phase3_cases(log2_cmp: int, rehearsal: bool):
    """The card-vs-CPU cases of phase 3: (label, prover on a device,
    trace on a device, AIR, route switch, routes, resident run sync-checked)
    for each hasher of the f64 prover on each of its routes (fib 2^10), the
    f128 prover (fib 2^10 and 2^8 quadratic, the Rescue chain at 2^8), aux
    segments on both phased routes (rescue_raps -n 8, the f64 aux AIR),
    Lamport with one signature on the three routes, and the f62 prover (fib
    2^10, cubic: Blake3_256 and Rp62_248 on the three routes, Sha3_256, and
    Rp62_248 with two partitions, quadratic). The parent proves each on the
    card; _cpu_references proves each on the CPU."""
    from winterfell_tpu_torch.air import FieldExtension, ProofOptions
    from winterfell_tpu_torch.air.options import PartitionOptions
    from winterfell_tpu_torch.crypto.hashers import (
        Blake3_192, Blake3_256, Rp62_248, Rp64_256, RpJive64_256, Sha3_256)
    from winterfell_tpu_torch.examples import fib_f62, lamport
    from winterfell_tpu_torch.examples import fibonacci as fib
    from winterfell_tpu_torch.examples import rescue as rescue128
    from winterfell_tpu_torch.examples import rescue_raps as raps
    from winterfell_tpu_torch.math.fields import F64, F128
    from winterfell_tpu_torch.prover.device import GoldilocksProver
    from winterfell_tpu_torch.prover.device_limb import F62Prover, F128Prover

    n = 1 << log2_cmp
    coin_routes = ("resident", "fused", "host")
    aux_routes = ("fused", "host")
    cases = []
    options = ProofOptions(32, 8, 0, FieldExtension.CUBIC, 8, 31)
    Fib64 = GoldilocksProver.accelerate(fib.FibSmallProver)
    # RpJive64_256 has no device coin: only the host-coin FRI loop
    for hasher, routes in ((Rp64_256, coin_routes), (Blake3_256, coin_routes),
                           (Blake3_192, coin_routes), (Sha3_256, coin_routes),
                           (RpJive64_256, ("host",))):
        cases.append((f"fib 2^{log2_cmp} {hasher.name}",
                      lambda d, h=hasher: Fib64(options, h, device=d),
                      lambda d: fib.build_fib_trace(F64, 2 * n, device=d),
                      fib.FibSmallAir, "f64", routes, False))
    fib_opts = {ext: ProofOptions(28, 8, 0, getattr(FieldExtension, ext), 8,
                                  31) for ext in ("NONE", "QUADRATIC")}
    rescue_opts = ProofOptions(42, 4, 0, FieldExtension.NONE, 8, 31)
    # log2 trace rows: fib without and with the extension, Rescue (each
    # with a FRI layer, so the routes differ)
    lf, lq, lr = (6, 6, 6) if rehearsal else (log2_cmp, log2_cmp - 2,
                                             log2_cmp - 2)
    Fib128 = F128Prover.accelerate(fib.FibProver)
    Rescue128 = F128Prover.accelerate(rescue128.RescueProver)
    for lg, ext in ((lf, "NONE"), (lq, "QUADRATIC")):
        cases.append((f"f128 fib trace {1 << lg} ({ext}, blake3_256)",
                      lambda d, o=fib_opts[ext]: Fib128(o, Blake3_256,
                                                        device=d),
                      lambda d, lg=lg: fib.build_fib_trace(F128, 2 << lg,
                                                           device=d),
                      fib.FibAir, "limb", coin_routes, False))
    cases.append((f"f128 rescue trace {1 << lr} (NONE, blake3_256)",
                  lambda d: Rescue128(rescue_opts, Blake3_256, device=d),
                  lambda d: rescue128.build_rescue_trace((1, 2),
                                                         1 << (lr - 4)),
                  rescue128.RescueAir, "limb", coin_routes, False))
    # aux segments (Randomized AIR) on each phased route: rescue_raps -n 8
    # without and with the extension and the f64 aux AIR with Rp64_256
    # (cubic) and Blake3_256; the widest AIR, Lamport with one signature
    # (trace 1024 x 22, sequence assertions), on all three
    raps_seeds = [(i + 1, i + 2) for i in range(8)]
    Raps = F128Prover.accelerate(raps.RescueRapsProver)
    for ext in ("NONE", "QUADRATIC"):
        cases.append((f"rescue_raps -n 8 ({ext}, blake3_256)",
                      lambda d, o=fib_opts[ext]: Raps(o, Blake3_256,
                                                      device=d),
                      lambda d: raps.build_raps_trace(
                          raps_seeds, raps_seeds[2:] + raps_seeds[:2]),
                      raps.RescueRapsAir, "aux128", aux_routes, True))
    pks1, msgs1, sigs1 = lamport.sign_messages(1)
    Lamport = F128Prover.accelerate(lamport.LamportAggregateProver)
    cases.append(("lamport 1 signature (NONE, blake3_256, trace 1024 x 22)",
                  lambda d: Lamport(fib_opts["NONE"], Blake3_256, pks1,
                                    msgs1, device=d),
                  lambda d: lamport.build_lamport_trace(msgs1, sigs1),
                  lamport.LamportAggregateAir, "limb", coin_routes, True))
    cube = ProofOptions(28, 8, 0, FieldExtension.CUBIC, 8, 31)
    AuxFib = GoldilocksProver.accelerate(fib.AuxFibProver)
    for hasher in (Rp64_256, Blake3_256):
        cases.append((f"f64 aux fib 2^{log2_cmp} (CUBIC, {hasher.name})",
                      lambda d, h=hasher: AuxFib(cube, h, device=d),
                      lambda d: fib.build_auxfib_trace(2 * n, device=d),
                      fib.AuxFibAir, "aux64", aux_routes, True))
    # the f62 prover: fib over f62 at trace 2^10 (the CLI's folding, no
    # grinding)
    F62Fib = F62Prover.accelerate(fib_f62.FibF62Prover)
    parts62 = ProofOptions(28, 8, 0, FieldExtension.QUADRATIC, 8, 31,
                           partition_options=PartitionOptions(2, 1))
    for hasher, opts, routes, what in (
            (Blake3_256, cube, coin_routes, "CUBIC"),
            (Rp62_248, cube, coin_routes, "CUBIC"),
            (Sha3_256, cube, ("resident",), "CUBIC"),
            (Rp62_248, parts62, ("resident",), "QUADRATIC, 2 partitions")):
        cases.append((f"f62 fib trace {n} ({what}, {hasher.name})",
                      lambda d, o=opts, h=hasher: F62Fib(o, h, device=d),
                      lambda d: fib_f62.build_fib_f62_trace(n),
                      fib_f62.FibF62Air, "limb", routes, True))
    return cases


def _cpu_references(log2_cmp: int, rehearsal: bool) -> dict:
    """The CPU's proof of every phase-3 case, each verified: {label: proof
    bytes}. Runs in a process of its own (four intra-op threads), started
    after phase 1, so that the CPU proves while the card runs phase 2."""
    from winterfell_tpu_torch.verifier import verify

    torch.set_num_threads(4)
    out = {}
    for label, make_prover, make_trace, air, _, _, _ in _phase3_cases(
            log2_cmp, rehearsal):
        prover, trace = make_prover("cpu"), make_trace("cpu")
        proof = prover.prove(trace)
        verify(air, proof, prover.get_pub_inputs(trace), prover.hasher)
        out[label] = proof.to_bytes()
    return out


def main() -> int:
    pool = []  # the process of _cpu_references, started after phase 1
    try:
        return _main(pool)
    finally:
        for executor in pool:
            executor.shutdown(wait=True, cancel_futures=True)


def _main(pool) -> int:
    if not REHEARSAL and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from winterfell_tpu_torch.air import FieldExtension, ProofOptions, TraceInfo
    from winterfell_tpu_torch.air.proof import Proof
    from winterfell_tpu_torch.crypto import native
    from winterfell_tpu_torch.crypto.hashers import (
        Blake3_192,
        Blake3_256,
        Rp62_248,
        Rp64_256,
        RpJive64_256,
        Sha3_256,
    )
    from winterfell_tpu_torch.examples.fibonacci import (
        FibSmallAir,
        FibSmallProver,
        build_fib_trace,
        compute_fib_term,
    )
    from winterfell_tpu_torch.math.fields import F64, F128
    from winterfell_tpu_torch.examples import cli as port_cli
    from winterfell_tpu_torch.examples import fib_f62
    from winterfell_tpu_torch.examples import fibonacci as fib128
    from winterfell_tpu_torch.examples import lamport
    from winterfell_tpu_torch.examples import rescue as rescue128
    from winterfell_tpu_torch.examples import rescue_raps as raps
    from winterfell_tpu_torch.ops import _build, device_coin, f128, field_kernels
    from winterfell_tpu_torch.ops import f62, ntt_mxu, rp62
    from winterfell_tpu_torch.ops import goldilocks as gl
    from winterfell_tpu_torch.ops import blake3, jive, rescue, sha3
    from winterfell_tpu_torch.ops.device_hashers import DEVICE_HASHERS
    from winterfell_tpu_torch.ops.words import rows_from_u64 as words_of
    from winterfell_tpu_torch.prover import device as prover_device
    from winterfell_tpu_torch.prover import device_limb
    from winterfell_tpu_torch.prover.device import GoldilocksProver
    from winterfell_tpu_torch.prover.device_limb import F62Prover, F128Prover
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
    byte_draw = ((lambda kind, *args: device_coin.draw_plain(
        *args[:5], kind, *args[5:])) if REHEARSAL
        else device_coin.byte_draw_kernel)

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
    # the host BLAKE3 of the transcript and the grinding scan: the native
    # library, built from native/blake3.c with the C compiler
    if not native.available():
        raise AssertionError("the native BLAKE3 library did not build")
    # and the Rescue chain's trace builder of the f128 paths (native/f128.c)
    if not native.f128_available():
        raise AssertionError("the native f128 library did not build")
    log("native BLAKE3 and f128 libraries built and loaded")
    # the CPU's reference proofs of phase 3, in a process of their own
    executor = ProcessPoolExecutor(max_workers=1,
                                   mp_context=multiprocessing.get_context(
                                       "spawn"))
    pool.append(executor)
    refs_future = executor.submit(_cpu_references, log2_cmp, REHEARSAL)
    phase("1 device", t0)

    # 2 ----- kernels against their plain versions, on the card -------------
    t0 = time.perf_counter()
    errs = {name: 0.0 for name in _launches()}

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

    # B10 (BLAKE3, 8 and 6 digest words), B11 (SHA3), B12 (Jive): row
    # hashes at the main path's widths in elements (and rows of 40, 320
    # bytes, over two SHA3 rate blocks), on random and corner values
    for k in (1, 2, 3, 8, 24, 40):
        for m in (1, 1000):
            for make in both:
                rows = make(rng, (m, k), dev)
                words, blen = words_of(rows)
                for dw in (8, 6):
                    check("blake3_hash_rows",
                          blake3.blake3_hash_words(words, blen, dw),
                          blake3.blake3_hash_words_plain(words, blen, dw),
                          (m, k, dw))
                check("sha3_hash_rows", sha3.sha3_hash_words(words, blen),
                      sha3.sha3_hash_words_plain(words, blen), (m, k))
                check("jive_hash_rows", jive.jive_hash_rows(rows),
                      jive.jive_hash_rows_plain(rows), (m, k))
    for m, k in ((big, 2), (big, 3 * comp_cols), (big // 8, 24)):
        rows = _rng_field(rng, (m, k), dev)
        words, blen = words_of(rows)
        check("blake3_hash_rows", blake3.blake3_hash_words(words, blen),
              blake3.blake3_hash_words_plain(words, blen), (m, k))
        check("sha3_hash_rows", sha3.sha3_hash_words(words, blen),
              sha3.sha3_hash_words_plain(words, blen), (m, k))
        check("jive_hash_rows", jive.jive_hash_rows(rows),
              jive.jive_hash_rows_plain(rows), (m, k))
    # merges of a level's sibling pairs and whole trees, 1 ... 2^21 leaves
    hash_trees = [
        ("blake3", 8, blake3.blake3_merge_rows, blake3.blake3_merge_rows_plain,
         blake3.blake3_merkle_levels, blake3.blake3_merkle_levels_plain),
        ("blake3", 6, blake3.blake3_merge_rows, blake3.blake3_merge_rows_plain,
         blake3.blake3_merkle_levels, blake3.blake3_merkle_levels_plain),
        ("sha3", 8, sha3.sha3_merge_rows, sha3.sha3_merge_rows_plain,
         sha3.sha3_merkle_levels, sha3.sha3_merkle_levels_plain),
        ("jive", 4, None, None, jive.jive_merkle_levels,
         jive.jive_merkle_levels_plain)]
    for family, w, merge, merge_plain, levels, levels_plain in hash_trees:
        for n in (1, 2, 4, tail // 2, tail, 2 * tail, chunk, 2 * chunk, big):
            makes = (both if w == 4 else
                     [lambda _, shape, where: _words(rng, shape, where)])
            for make in makes:
                leaves = make(rng, (n, w), dev)
                if n > 1 and merge is not None:
                    check(f"{family}_merge_rows",
                          merge(leaves[0::2], leaves[1::2]),
                          merge_plain(leaves[0::2], leaves[1::2]), (n, w))
                check(f"{family}_merkle_tree", flat(levels(leaves)),
                      flat(levels_plain(leaves)), ("leaves", n, w))
    log("B10 blake3, B11 sha3 and B12 jive row hashes, merges and trees "
        "(1 ... 2^%d leaves) equal their plain versions" % (big.bit_length() - 1))
    # the byte coins' draw kernels, with rejected candidates planted: the
    # kernel then hashes further counters itself
    for coin in ("blake3_256", "blake3_192", "sha3_256"):
        dw = DEVICE_HASHERS[coin].digest_words
        name = DEVICE_HASHERS[coin].draw
        _, next_byte = device_coin.byte_coin_ops(coin)
        for k, d, reject in ((1, 3, ()), (5, 3, ()), (7, 1, ()),
                             (3, 2, (1,)), (2, 3, (0, 1))):
            seed_w = _words(rng, (dw,), dev)
            cands = next_byte(seed_w, 0, k).clone()
            for j in reject:  # a u64 word >= p: that counter is rejected
                cands[j, :2] = -1
            got_e, got_c = byte_draw(coin, cands, seed_w, 0, k, d)
            want_e, want_c = device_coin.draw_plain(cands, seed_w, 0, k, d,
                                                    coin)
            check(name, torch.cat([got_e.reshape(-1), got_c]),
                  torch.cat([want_e.reshape(-1), want_c]),
                  (coin, k, d, reject))
    log("the byte coins' draw kernels equal their plain version, rejected "
        "candidates included")
    # K3 above its 32-bit offsets: under a lowered INDEX_LIMIT a product is
    # split into several launches that together give the plain product
    limit = field_kernels.INDEX_LIMIT
    field_kernels.INDEX_LIMIT = 1 << 16
    try:
        x, y = _rng_field(rng, (big // 8, 24), dev), _rng_field(rng, (24,), dev)
        before = field_kernels.LAUNCHES["gl_mul"]
        got = k3(x, y)
        splits = field_kernels.LAUNCHES["gl_mul"] - before
    finally:
        field_kernels.INDEX_LIMIT = limit
    check("gl_mul", got, field_kernels.gl_mul_plain(x, y), ("split", splits))
    if not REHEARSAL and splits < 2:
        raise AssertionError(f"gl_mul: {splits} launches for a product above "
                             "the lowered INDEX_LIMIT")
    log(f"K3 above INDEX_LIMIT: {splits} launches equal the plain product")

    # B0 (add, subtract), B0x (quadratic and cubic products), B4 (NTT
    # stages) and B5 (the FRI fold) of the f64 engine. B0 at (LDE,) over
    # the same u64 patterns as K3 (every ordered pair of its corner set
    # first); B0x at (LDE, 3) and (LDE / 2, 2) over random u64 patterns with
    # the corner pairs in every component; then the layouts the prover
    # passes, splits above a lowered INDEX_LIMIT, whole NTTs and folds
    b0 = {name: ((getattr(gl, name) if REHEARSAL else
                  functools.partial(field_kernels.op_kernel, name)),
                 getattr(field_kernels, f"{name}_plain"))
          for name in ("gl_add", "gl_sub")}
    ext_k = gl.ext_mul if REHEARSAL else field_kernels.ext_mul_kernel
    fold_k = gl.fri_fold if REHEARSAL else gl.fri_fold_kernel
    for name, (op, plain) in b0.items():
        got = op(a, b)
        check(name, got, plain(a, b), (big,))
        head = got[: len(pairs)].cpu().numpy().view(np.uint64)
        want = [_gl_formula(name, x, y) for x, y in pairs]
        if [int(v) for v in head] != want:
            raise AssertionError(f"{name}: corner results differ from the "
                                 "reference's formula on Python ints")
    ext3 = torch.stack([a, b.roll(7), a.roll(13)], dim=-1)
    ext3b = torch.stack([b, a.roll(5), b.roll(11)], dim=-1)
    for d, x, y in ((3, ext3, ext3b),
                    (2, ext3[: big // 2, :2], ext3b[: big // 2, 1:])):
        check("gl_ext_mul", ext_k(x, y), field_kernels.ext_mul_plain(x, y),
              (tuple(x.shape), d))
    # the prover's layouts: B0 with a Python int, a column broadcast, the
    # butterfly halves, the sum tree's halves, DEEP's x − z with z expanded
    # over the domain (_deep_combine); B0x with α expanded over a layer,
    # pows2 expanded over the columns (_eval_cols_pair), a coefficient
    # expanded over an aux column, and strided operands
    zs = _rng_field(rng, (1, 3), dev)
    lay_b0 = layouts + [("sum0", ext[: big // 2], ext[big // 2:]),
                        ("z expanded", ext, zs.expand_as(ext)),
                        ("neg", torch.zeros((), dtype=torch.int64,
                                            device=dev), ext)]
    for lname, x, y in lay_b0:
        for name, (op, plain) in b0.items():
            check(name, op(x, y), plain(x, y), (lname, tuple(x.shape)))
    polys = _rng_field(rng, (big // 8, 2, 3), dev)
    pows2 = _rng_field(rng, (big // 8, 2, 3), dev)
    lay_ext = [("alpha expanded", ext, zs[0].reshape(1, 3).expand_as(ext)),
               ("pows2", polys[:, :, None],
                pows2[:, None].expand(polys.shape[:2] + pows2.shape[1:])),
               ("coefficient", ext, zs),
               ("strided", ext3[::2], ext3b[1::2]),
               ("components", torch.stack([ext[:, 2], ext[:, 0]], -1),
                ext3b[:, 1:])]
    for lname, x, y in lay_ext:
        check("gl_ext_mul", ext_k(x, y), field_kernels.ext_mul_plain(x, y),
              (lname, tuple(x.shape)))
    field_kernels.INDEX_LIMIT = 1 << 16
    try:
        before = dict(field_kernels.LAUNCHES)
        got_add = b0["gl_add"][0](ext, ext[:, :1])
        got_ext = ext_k(polys[:, :, None],
                        pows2[:, None].expand(polys.shape[:2]
                                              + pows2.shape[1:]))
        split = {k: field_kernels.LAUNCHES[k] - before[k]
                 for k in ("gl_add", "gl_ext_mul")}
    finally:
        field_kernels.INDEX_LIMIT = limit
    check("gl_add", got_add, field_kernels.gl_add_plain(ext, ext[:, :1]),
          ("split", split["gl_add"]))
    check("gl_ext_mul", got_ext, field_kernels.ext_mul_plain(
        polys[:, :, None], pows2[:, None].expand(polys.shape[:2]
                                                 + pows2.shape[1:])),
          ("split", split["gl_ext_mul"]))
    if not REHEARSAL and min(split.values()) < 2:
        raise AssertionError(f"B0 / B0x: {split} launches for results "
                             "above the lowered INDEX_LIMIT")
    log(f"B0 gl_add, gl_sub and B0x gl_ext_mul equal their plain versions "
        f"(and the reference's formula on {len(pairs)} corner pairs; "
        f"{split} launches above INDEX_LIMIT)")
    # B4: whole NTTs (the first stage reading bit-reversed, then the
    # stages in place) against the plain gather and stages, both ways
    for n_, cols in ((2, 1), (8, 3), (1024, 4), (1 << 16, 2), (big // 2, 3),
                     (big, 2)):
        x = _rng_field(rng, (n_, cols), dev)
        for inverse in (False, True):
            check("gl_ntt_stage", gl._ntt_core(x, n_, inverse),
                  _ntt_plain(x, n_, inverse, gl), (n_, cols, inverse))
    # B5: every folding factor and degree, and the main path's first fold
    # (the DEEP evaluations of the 2^21-row LDE, by 8, cubic)
    for n_fold in (2, 4, 8, 16):
        for d in (1, 2, 3):
            rows_ = big if (n_fold, d) == (8, 3) else 1 << 16
            x = _rng_field(rng, (rows_, d), dev)
            al = _rng_field(rng, (d,), dev)
            check("gl_fri_fold", fold_k(x, n_fold, F64.generator, al),
                  gl.fri_fold_plain(x, n_fold, F64.generator, al),
                  (rows_, n_fold, d))
    log("B4 gl_ntt_stage (2 ... 2^%d rows) and B5 gl_fri_fold (N 2 ... 16, "
        "d 1 ... 3) equal their plain versions" % (big.bit_length() - 1))

    # B13: the f128 add, subtract and multiply at (LDE,) over random values,
    # the first rows every ordered pair of the corner set; then the operand
    # layouts the f128 prover passes
    pairs = [(x, y) for x in F128_CORNERS for y in F128_CORNERS]
    a128 = _rng_f128(rng, (big,), dev)
    b128 = _rng_f128(rng, (big,), dev)
    a128[: len(pairs)] = _f128_of([x for x, _ in pairs], dev)
    b128[: len(pairs)] = _f128_of([y for _, y in pairs], dev)
    ops128 = {"add": (f128.f128_add, f128.add_plain, lambda x, y: x + y),
              "sub": (f128.f128_sub, f128.sub_plain, lambda x, y: x - y),
              "mul": (f128.f128_mul, f128.mul_plain, lambda x, y: x * y)}
    for name, (op, plain, oracle) in ops128.items():
        got = op(a128, b128)
        check(f"f128_{name}", got, plain(a128, b128), (big,))
        head = f128.to_ints(got[: len(pairs)])
        if [int(v) for v in head] != [oracle(x, y) % P128 for x, y in pairs]:
            raise AssertionError(f"f128_{name}: corner results differ from "
                                 "the Python-int oracle")
    ext128 = _rng_f128(rng, (big // 2, 2), dev)
    col128 = _rng_f128(rng, (big // 2,), dev)
    blk128 = _rng_f128(rng, (big // 64, 2, 16, 2), dev)
    tw128 = _rng_f128(rng, (1, 16, 1), dev)
    deep128 = _rng_f128(rng, (2, 3, 2, 3, 2, 3, 2, 2), dev).permute(
        *range(7, -1, -1), 8)
    layouts128 = [("int", ext128, 12345), ("int near p", ext128, P128 - 1),
                  ("column", ext128, col128[:, None]),
                  ("ext coeff", ext128, ext128[0][None]),
                  ("butterfly", blk128[:, 1], tw128),
                  ("component", ext128[..., 0, :], ext128[..., 1, :]),
                  ("8 dims", deep128, deep128[..., :1, :])]
    for lname, x, y in layouts128:
        for name, (op, plain, _) in ops128.items():
            check(f"f128_{name}", op(x, y), plain(x, y),
                  (lname, tuple(x.shape)))
    # above the 32-bit offsets: a product split into several launches
    field_kernels.INDEX_LIMIT = 1 << 16
    try:
        before = f128.LAUNCHES["f128_mul"]
        got = f128.f128_mul(ext128, col128[:, None])
        splits = f128.LAUNCHES["f128_mul"] - before
    finally:
        field_kernels.INDEX_LIMIT = limit
    check("f128_mul", got, f128.mul_plain(ext128, col128[:, None]),
          ("split", splits))
    if not REHEARSAL and splits < 2:
        raise AssertionError(f"f128_mul: {splits} launches for a product "
                             "above the lowered INDEX_LIMIT")
    log(f"B13 f128 add, sub and mul equal their plain versions (and the "
        f"oracle on {len(pairs)} corner pairs; {splits} launches above "
        "INDEX_LIMIT)")
    # B13n: whole NTTs of kernel stages against plain stages, both ways
    for n_, cols in ((2, 1), (8, 3), (1024, 4), (1 << 16, 2),
                     (big // 2, 4), (big, 2)):
        x = _rng_f128(rng, (n_, cols), dev)
        for inverse in (False, True):
            got = f128._ntt_core(x, n_, inverse)
            check("f128_ntt_stage", got, _ntt_plain(x, n_, inverse),
                  (n_, cols, inverse))
    log("B13n f128 NTT stages equal their plain version (2 ... 2^%d rows)"
        % (big.bit_length() - 1))
    # B16, the f128 leaf DFT under WINTER_MXU_NTT=1: the digit product, the
    # recombine and whole leaf DFTs against their plain versions, bit for
    # bit, at leaf sizes 2 ... 128 in both directions: random canonical
    # values with MXU_CORNERS in the first columns, over batches that are no
    # multiple of a block (1, 77, 1000) and over the paths' (32, 2^17) and
    # (64, 2^16); diagonal sums at their maximum 127²·19n; a leaf DFT in
    # chunks with a ragged last one; then whole NTTs under the switch (2^10,
    # 2^18, 2^21 rows) against the radix-2 B13n NTT, with no B13n launch
    prod_k, rec_k, leaf_k = ((ntt_mxu.digit_product_plain,
                              ntt_mxu.recombine_plain, ntt_mxu.leaf_dft)
                             if REHEARSAL else
                             (ntt_mxu.digit_product_kernel,
                              ntt_mxu.recombine_kernel,
                              ntt_mxu.leaf_dft_kernel))

    def mxu_x(n_, cols):
        x = _rng_f128(rng, (n_, cols), dev)
        k = min(cols, len(MXU_CORNERS))
        x[:, :k] = _f128_of(MXU_CORNERS[:k], dev)[None]
        return x

    def check_leaf(n_, cols, inverse):
        wt = ntt_mxu.leaf_matrix_dev(n_, inverse, dev)
        x = mxu_x(n_, cols)
        d = prod_k(wt, x)
        check("ntt_mxu_product", d, ntt_mxu.digit_product_plain(wt, x),
              (n_, cols, inverse))
        check("ntt_mxu_recombine", rec_k(d, n_),
              ntt_mxu.recombine_plain(d, n_), (n_, cols, inverse))
        check("ntt_mxu_recombine", leaf_k(x, wt, n_),
              ntt_mxu.leaf_dft_plain(x, wt, n_), ("leaf", n_, cols, inverse))

    for n_ in (2, 4, 8, 16, 32, 64, 128):
        for inverse in (False, True):
            for cols in (1, 77, 1000):
                check_leaf(n_, cols, inverse)
        top = torch.full((37 * n_, 33), 127 * 127 * 19 * n_,
                         dtype=torch.int32, device=dev)
        check("ntt_mxu_recombine", rec_k(top, n_),
              ntt_mxu.recombine_plain(top, n_), ("maximum sums", n_))
    for n_, cols in ((32, big // 16), (64, big // 32)):
        check_leaf(n_, cols, False)
    chunk_elems = ntt_mxu._CHUNK_ELEMS
    ntt_mxu._CHUNK_ELEMS = 1 << 12
    try:
        before = ntt_mxu.LAUNCHES["ntt_mxu_product"]
        x, wt = mxu_x(32, 1000), ntt_mxu.leaf_matrix_dev(32, True, dev)
        got = leaf_k(x, wt, 32)
        chunks = ntt_mxu.LAUNCHES["ntt_mxu_product"] - before
    finally:
        ntt_mxu._CHUNK_ELEMS = chunk_elems
    check("ntt_mxu_recombine", got, ntt_mxu.leaf_dft_plain(x, wt, 32),
          ("chunks", chunks))
    if not REHEARSAL and chunks != 8:
        raise AssertionError(f"leaf_dft: {chunks} chunks of 128 columns for "
                             "1000")
    for n_, cols in ((1 << 10, 4), (1 << (log2_trace), 2), (big, 2)):
        x = _rng_f128(rng, (n_, cols), dev)
        for inverse in (False, True):
            want = f128._ntt_core(x, n_, inverse)
            before = _launches()
            f128._USE_MXU = True
            try:
                got = f128._ntt_core(x, n_, inverse)
            finally:
                f128._USE_MXU = False
            after = _launches()
            check("ntt_mxu_recombine", got, want, ("ntt", n_, cols, inverse))
            if not REHEARSAL and (
                    after["f128_ntt_stage"] != before["f128_ntt_stage"] or
                    after["ntt_mxu_product"] == before["ntt_mxu_product"]):
                raise AssertionError(f"the NTT of {n_} rows under the switch "
                                     "launched B13n or no B16")
    log("B16 ntt_mxu_product and ntt_mxu_recombine equal their plain "
        f"versions (leaves 2 ... 128, both directions, up to (32, {big // 16}) "
        f"columns; {chunks} chunks); the NTT under WINTER_MXU_NTT=1 equals "
        f"the radix-2 one at 2^10, 2^{log2_trace}, 2^{big.bit_length() - 1} "
        "rows")
    # the f128 draws of the byte coins, rejected candidates planted (an
    # element >= p: 2^128 - 1)
    for coin in ("blake3_256", "blake3_192", "sha3_256"):
        dw = DEVICE_HASHERS[coin].digest_words
        name = DEVICE_HASHERS[coin].draw + "_f128"
        _, next_byte = device_coin.byte_coin_ops(coin)
        for k, d, reject in ((1, 1, ()), (5, 2, ()), (7, 1, ()),
                             (3, 2, (1,)), (2, 1, (0, 1)), (4, 2, (0, 2))):
            seed_w = _words(rng, (dw,), dev)
            cands = next_byte(seed_w, 0, k).clone()
            for j in reject:
                cands[j, :4] = -1
            got_e, got_c = byte_draw(coin, cands, seed_w, 0, k, d, "f128")
            want_e, want_c = device_coin.draw_plain(cands, seed_w, 0, k, d,
                                                    coin, "f128")
            check(name, torch.cat([got_e.reshape(-1), got_c]),
                  torch.cat([want_e.reshape(-1), want_c]),
                  (coin, k, d, reject))
    log("the byte coins' f128 draw kernels equal their plain version, "
        "rejected candidates included")

    # B14: the f62 add, subtract and multiply at (LDE,) over random values,
    # the first rows every ordered pair of the f62 corner set; then the
    # operand layouts of the f62 prover, and above a lowered INDEX_LIMIT
    pairs = [(x, y) for x in F62_CORNERS for y in F62_CORNERS]
    a62, b62 = _rng_f62(rng, (big,), dev), _rng_f62(rng, (big,), dev)
    a62[: len(pairs)] = _f62_of([x for x, _ in pairs], dev)
    b62[: len(pairs)] = _f62_of([y for _, y in pairs], dev)
    ops62 = {"add": (f62.f62_add, f62.add_plain, lambda x, y: x + y),
             "sub": (f62.f62_sub, f62.sub_plain, lambda x, y: x - y),
             "mul": (f62.f62_mul, f62.mul_plain, lambda x, y: x * y)}
    for name, (op, plain, oracle) in ops62.items():
        got = op(a62, b62)
        check(f"f62_{name}", got, plain(a62, b62), (big,))
        head = got[: len(pairs)].cpu().tolist()
        if head != [oracle(x, y) % P62 for x, y in pairs]:
            raise AssertionError(f"f62_{name}: corner results differ from "
                                 "the Python-int oracle")
    ext62, col62 = _rng_f62(rng, (big // 2, 3), dev), _rng_f62(rng, (big // 2,),
                                                                dev)
    blk62 = _rng_f62(rng, (big // 64, 2, 16, 3), dev)
    tw62 = _rng_f62(rng, (1, 16, 1), dev)
    deep62 = _rng_f62(rng, (2, 3, 2, 3, 2, 3, 2, 2), dev).permute(
        *range(7, -1, -1))
    layouts62 = [("int", ext62, 12345), ("int near p", ext62, P62 - 1),
                 ("column", ext62, col62[:, None]),
                 ("ext coeff", ext62, ext62[0][None]),
                 ("butterfly", blk62[:, 1], tw62),
                 ("component", ext62[..., 0], ext62[..., 1]),
                 ("8 dims", deep62, deep62[..., :1])]
    for lname, x, y in layouts62:
        for name, (op, plain, _) in ops62.items():
            check(f"f62_{name}", op(x, y), plain(x, y),
                  (lname, tuple(x.shape)))
    field_kernels.INDEX_LIMIT = 1 << 16
    try:
        before = f62.LAUNCHES["f62_mul"]
        got = f62.f62_mul(ext62, col62[:, None])
        splits = f62.LAUNCHES["f62_mul"] - before
    finally:
        field_kernels.INDEX_LIMIT = limit
    check("f62_mul", got, f62.mul_plain(ext62, col62[:, None]),
          ("split", splits))
    if not REHEARSAL and splits < 2:
        raise AssertionError(f"f62_mul: {splits} launches for a product "
                             "above the lowered INDEX_LIMIT")
    log(f"B14 f62 add, sub and mul equal their plain versions (and the "
        f"oracle on {len(pairs)} corner pairs; {splits} launches above "
        "INDEX_LIMIT)")
    # B14n: whole NTTs of kernel stages against plain stages, both ways
    for n_, cols in ((2, 1), (8, 3), (1024, 4), (1 << 16, 2), (big // 2, 2),
                     (big, 2)):
        x = _rng_f62(rng, (n_, cols), dev)
        for inverse in (False, True):
            check("f62_ntt_stage", f62._ntt_core(x, n_, inverse),
                  _ntt_plain(x, n_, inverse, f62), (n_, cols, inverse))
    log("B14n f62 NTT stages equal their plain version (2 ... 2^%d rows)"
        % (big.bit_length() - 1))
    # B15: Rp62_248 row hashes (1 ... 24 elements on random and corner
    # rows, and the f62 paths' widths at the LDE's rows: the trace, a FRI
    # layer), merges, trees of 1 ... 2^21 leaves (random words, and packed
    # digests of corner elements), the coin's candidates below and above
    # p62. The plain permutation is some 30k small launches, so each plain
    # call takes a whole batch: a tree's levels are held against the plain
    # merge of the kernel's level below, all levels in one call (level 1
    # against the leaves': by induction the kernel's tree is the plain one)
    corner62 = _f62_of(F62_CORNERS, dev)

    def corners62(m, k):
        idx = (torch.arange(m, device=dev)[:, None] * 3
               + torch.arange(k, device=dev)[None, :] * 5) % len(F62_CORNERS)
        return corner62[idx].contiguous()

    # rows of one corner value in every element (p - 1, E, E + 1, 2^61, p -
    # E, ... in every rate lane), at the rate edges; row counts that are no
    # multiple of a thread group or a block
    uniform62 = corner62[:, None]
    for k in (1, 2, 3, 7, 8, 9, 16, 17, 24):
        rows = torch.cat([_rng_f62(rng, (500, k), dev), corners62(500, k),
                          uniform62.expand(-1, k)]).contiguous()
        check("rp62_hash_rows", rp62.rp62_hash_rows(rows),
              rp62.rp62_hash_rows_plain(rows), (rows.shape[0], k))
    for m in (1, 3, 5, 127, 129):
        rows = corners62(m, 9)
        check("rp62_hash_rows", rp62.rp62_hash_rows(rows),
              rp62.rp62_hash_rows_plain(rows), (m, 9))
        level = rp62.pack(corners62(2 * m, 4))
        check("rp62_merge_rows",
              rp62.rp62_merge_rows(level[0::2], level[1::2]),
              rp62.rp62_merge_rows_plain(level[0::2], level[1::2]), (m, 8))
    for m, k in ((big, 2), (big // 8, 24)):
        rows = _rng_f62(rng, (m, k), dev)
        check("rp62_hash_rows", rp62.rp62_hash_rows(rows),
              rp62.rp62_hash_rows_plain(rows), (m, k))
    for n_, leaves in [(n_, _words(rng, (n_, 8), dev)) for n_ in (
            1, 2, 4, 8, tail // 2, tail, 2 * tail, chunk, 2 * chunk, big)] + [
            (2 * chunk, rp62.pack(corners62(2 * chunk, 4))),
            (16, rp62.pack(corner62[[3, 3, 5, 5, 6, 6, 11, 11, 13, 13, 4, 4,
                                     0, 0, 1, 1]][:, None].expand(
                                         -1, 4).contiguous()))]:
        if n_ in (2, 2 * chunk, big):
            check("rp62_merge_rows",
                  rp62.rp62_merge_rows(leaves[0::2], leaves[1::2]),
                  rp62.rp62_merge_rows_plain(leaves[0::2], leaves[1::2]),
                  (n_, 8))
        levels = rp62.rp62_merkle_levels(leaves)
        if len(levels) != n_.bit_length() - 1:
            raise AssertionError(f"rp62_merkle_tree: {len(levels)} levels "
                                 f"over {n_} leaves")
        if levels:
            below = [leaves] + levels[:-1]
            check("rp62_merkle_tree", torch.cat(levels),
                  rp62.rp62_merge_rows_plain(
                      torch.cat([x[0::2] for x in below]),
                      torch.cat([x[1::2] for x in below])), ("leaves", n_))
    seed62 = rp62.pack(_rng_f62(rng, (1, 4), dev))[0]
    for s62, c0, t in ((seed62, 0, 5), (seed62, P62 - 3, 5),
                       (seed62, 2**64 - 9, 8), (seed62, 0, 448),
                       (seed62, 0, 1), (seed62, 2**64 - 130, 129),
                       (seed62, 0, 127),
                       (rp62.pack(uniform62[[3, 3, 3, 3], 0][None])[0],
                        P62 - 2, 3)):
        check("rp62_coin_candidates", rp62.coin_candidates(s62, c0, t),
              rp62.coin_candidates_plain(s62, c0, t), (c0, t))
    log("B15 rp62 row hashes, merges, trees (1 ... 2^%d leaves) and the "
        "coin's candidates equal their plain versions"
        % (big.bit_length() - 1))
    # the f62 draws: the Rp62_248 coin's and the byte coins' instance over
    # the f62 modulus; too few candidates launched and rejected ones
    # planted (a first u64 of 2^64 - 1), so the kernel computes further
    # candidates itself
    for coin in ("rp62_248", "blake3_256", "blake3_192", "sha3_256"):
        dw = DEVICE_HASHERS[coin].digest_words
        name = DEVICE_HASHERS[coin].draw + "_f62"
        _, next_word = device_coin.byte_coin_ops(coin)
        for k, d, reject in ((1, 1, ()), (1, 3, ()), (5, 3, ()), (7, 1, ()),
                             (3, 2, (1,)), (2, 3, (0, 1))):
            seed_w = seed62 if coin == "rp62_248" else _words(rng, (dw,), dev)
            cands = next_word(seed_w, 0, k).clone()
            for j in reject:
                cands[j, :2] = -1
            got_e, got_c = byte_draw(coin, cands, seed_w, 0, k, d, "f62")
            want_e, want_c = device_coin.draw_plain(cands, seed_w, 0, k, d,
                                                    coin, "f62")
            check(name, torch.cat([got_e.reshape(-1), got_c]),
                  torch.cat([want_e.reshape(-1), want_c]),
                  (coin, k, d, reject))
    log("the f62 draws (Rp62_248, BLAKE3, SHA3 coins) equal their plain "
        "version, rejected candidates included")
    phase("2 kernels", t0)

    # 3 ----- card vs CPU, every hasher on each of its routes ----------------
    # (the CPU's proofs were made by the reference process started after
    # phase 1, _cpu_references, while the card ran phase 2)
    t0 = time.perf_counter()
    Prover = GoldilocksProver.accelerate(FibSmallProver)
    defaults = (prover_device._RESIDENT_ON_F64, prover_device._FUSED_FRI_ON)
    defaults128 = (device_limb._RESIDENT_ON, device_limb._FUSED_FRI_ON)
    marks = {"resident": "resident_pipeline", "fused": "fri_layers_fused"}

    def routed(route: str) -> None:
        prover_device._RESIDENT_ON_F64 = route == "resident"
        prover_device._FUSED_FRI_ON = route != "host"

    def routed128(route: str) -> None:
        device_limb._RESIDENT_ON = route == "resident"
        device_limb._FUSED_FRI_ON = route != "host"

    # the aux segments' phased routes, with the resident switch left on
    # (the dispatch never takes it for an aux segment)
    def aux128(route: str) -> None:
        device_limb._RESIDENT_ON = True
        device_limb._FUSED_FRI_ON = route == "fused"

    def aux64(route: str) -> None:
        prover_device._RESIDENT_ON_F64 = True
        prover_device._FUSED_FRI_ON = route == "fused"

    switches = {"f64": routed, "limb": routed128, "aux128": aux128,
                "aux64": aux64}

    def check_route(route: str, what: str) -> None:
        names = [s["name"] for s in tracing.last_spans()]
        taken = ("resident" if marks["resident"] in names else
                 "fused" if marks["fused"] in names else "host")
        if taken != route:
            raise AssertionError(f"{what}: took the {taken} route, not {route}")

    tb = time.perf_counter()
    refs = refs_future.result()
    log(f"the CPU's {len(refs)} reference proofs waited for "
        f"{time.perf_counter() - tb:.2f} s")
    for (label, make_prover, make_trace, _, switch, routes,
         sync) in _phase3_cases(log2_cmp, REHEARSAL):
        cpu = refs[label]
        for route in routes:
            switches[switch](route)
            prover = make_prover(dev)
            _check_syncs(prover, sync and not REHEARSAL
                         and route == "resident")
            proof = prover.prove(make_trace(dev))
            check_route(route, f"{label} on {dev}")
            if proof.to_bytes() != cpu:
                raise AssertionError(f"{label}: {route} proof bytes on {dev} "
                                     "differ from the CPU's")
        mxu_routes = ()
        if label.startswith(("f128 fib", "f128 rescue")) and "NONE" in label:
            # and under WINTER_MXU_NTT=1 (B16 leaves, no B13n), the bytes of
            # the CPU's proof without the switch
            mxu_routes = ("resident", "fused")
            f128._USE_MXU = True
            try:
                for route in mxu_routes:
                    switches[switch](route)
                    prover = make_prover(dev)
                    _check_syncs(prover, sync and not REHEARSAL
                                 and route == "resident")
                    _reset_launches()
                    proof = prover.prove(make_trace(dev))
                    counts = _launches()
                    check_route(route, f"{label} on {dev}, mxu")
                    if proof.to_bytes() != cpu:
                        raise AssertionError(
                            f"{label}: {route} proof bytes on {dev} under "
                            "WINTER_MXU_NTT=1 differ from the CPU's")
                    if not REHEARSAL and (counts["f128_ntt_stage"] or min(
                            counts[k] for k in ntt_mxu.LAUNCHES) == 0):
                        raise AssertionError(f"{label}: {route} under "
                                             "WINTER_MXU_NTT=1 launched B13n "
                                             "or no B16")
            finally:
                f128._USE_MXU = False
        prover_device._RESIDENT_ON_F64, prover_device._FUSED_FRI_ON = defaults
        device_limb._RESIDENT_ON, device_limb._FUSED_FRI_ON = defaults128
        log(f"{label}: card bytes == CPU bytes on {', '.join(routes)} "
            f"({len(cpu)} B)" + (f", and on {', '.join(mxu_routes)} under "
                                 "WINTER_MXU_NTT=1" if mxu_routes else "")
            + "; the CPU's verified")
    phase("3 card vs cpu", t0)

    # 4 ----- the main path at full size, both routes ------------------------
    t0 = time.perf_counter()
    n = 1 << log2_trace
    trace = build_fib_trace(F64, 2 * n, device=dev)
    result = trace.get(1, n - 1)
    if result != compute_fib_term(F64, 2 * n):
        raise AssertionError("trace's last term differs from compute_fib_term")
    runs = {}  # (hasher name, route) -> kernel launches of one prove

    def timed_path(prover, route: str, key, label: str, air, pub, tr):
        """One warm-up (its resident device run under the sync check,
        untimed), three proves timed free-running (phase barriers off, as
        bench.py times; the first one's launches counted under ``key``), one
        more with a barrier at every phase mark for the card's time per
        phase. All proofs equal and verified; ``route`` is the route the
        proves must take."""
        _check_syncs(prover, not REHEARSAL and route == "resident")
        tracing.set_phase_sync(True)
        warm = prover.prove(tr)
        check_route(route, label)
        verify(air, warm, pub, prover.hasher)
        _check_syncs(prover, False)
        if not REHEARSAL:
            torch.cuda.reset_peak_memory_stats()
        tracing.set_phase_sync(False)
        walls = []
        for i in range(3):
            _reset_launches()
            t = time.perf_counter()
            proof = prover.prove(tr)
            if not REHEARSAL:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if i == 0:
                runs[key] = _launches()
            if proof.to_bytes() != warm.to_bytes():
                raise AssertionError(f"{label}: proves gave other bytes")
        peak = 0 if REHEARSAL else torch.cuda.max_memory_allocated()
        tracing.set_phase_sync(True)
        t = time.perf_counter()
        if prover.prove(tr).to_bytes() != warm.to_bytes():
            raise AssertionError("the phase-split prove gave other bytes")
        split_wall = time.perf_counter() - t
        spans = tracing.last_spans()
        log(f"{label}: prove wall s (phase barriers off): min "
            f"{min(walls):.4f} median {statistics.median(walls):.4f} runs "
            f"{[round(w, 4) for w in walls]}")
        log(f"{label}: phases (one more prove, barriers on, wall "
            f"{split_wall:.4f} s; ms): " + ", ".join(
                f"{s['name']} {1000 * s['seconds']:.1f}" for s in spans))
        used = {k: v for k, v in runs[key].items() if v}
        log(f"{label}: peak device memory {peak / 2**30:.3f} GiB; launches "
            f"per prove {used}; proof {len(warm.to_bytes())} B, verified")
        return warm.to_bytes()

    def one_prove(hasher, opts, what: str):
        """One prove on the default route, its launches counted, verified."""
        routed("resident")
        tracing.set_phase_sync(True)
        _reset_launches()
        t = time.perf_counter()
        proof = Prover(opts, hasher, device=dev).prove(trace)
        wall = time.perf_counter() - t
        runs[hasher.name, what] = _launches()
        verify(FibSmallAir, proof, result, hasher)
        spans = {s["name"]: s["seconds"] for s in tracing.last_spans()}
        used = {k: v for k, v in runs[hasher.name, what].items() if v}
        log(f"{hasher.name} {what}: fib 2^{log2_trace} prove {wall:.4f} s "
            f"(barriers on), query positions with grinding "
            f"{1000 * spans['determine_query_positions']:.1f} ms, nonce "
            f"{proof.pow_nonce}; launches {used}; verified")

    # the f64 engine's kernels: B0, B4, B5, and B0x with an extension
    f64_kernels = ("gl_add", "gl_sub", "gl_ntt_stage", "gl_fri_fold",
                   "gl_ext_mul")

    def must_launch(key, ext: bool = True) -> None:
        """Every kernel of the hasher's record and of the f64 engine was
        launched by that prove (B0x only where the proof has an
        extension)."""
        for name in tuple(DEVICE_HASHERS[key[0]].launches) + f64_kernels[
                : None if ext else -1]:
            if not REHEARSAL and runs[key][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by the "
                                     f"{key} prove")

    # bench.py's default workload (Rp64_256) and the same with Blake3_256,
    # each on the resident and the phased (fused FRI) route
    for hasher in (Rp64_256, Blake3_256):
        by_route = {}
        for route in ("resident", "fused"):
            routed(route)
            by_route[route] = timed_path(
                Prover(options, hasher, device=dev), route,
                (hasher.name, route),
                f"{hasher.name} {route}: fib 2^{log2_trace}", FibSmallAir,
                result, trace)
        if by_route["resident"] != by_route["fused"]:
            raise AssertionError(f"{hasher.name}: the phased proof differs "
                                 "from the resident")
        must_launch((hasher.name, "resident"))
        must_launch((hasher.name, "fused"))
    for route in ("resident", "fused"):
        counts = runs["rp64_256", route]
        k2 = counts["rp64_merge_rows"] + counts["rp64_merkle_tree"]
        if k2 > 30:
            raise AssertionError(f"{route}: {k2} K2 launches per prove (per "
                                 "level and tree kernel), more than 30")
    log("resident and phased proofs have the same bytes" + (
        "" if REHEARSAL else "; the resident device runs made no host "
        "synchronisation"))
    # the CLI's default options (examples/cli.py: 28 queries, blowup 8,
    # grinding 16, no extension, folding 8, remainder degree 31, Blake3_256)
    cli = ProofOptions(num_queries=28, blowup_factor=8, grinding_factor=16,
                       field_extension=FieldExtension.NONE,
                       fri_folding_factor=8, fri_remainder_max_degree=31)
    one_prove(Blake3_256, cli, "cli_default")
    must_launch(("blake3_256", "cli_default"), ext=False)
    # the other hashers, one prove each on the route the dispatch gives it
    for hasher, route in ((Blake3_192, "resident"), (Sha3_256, "resident"),
                          (RpJive64_256, "host")):
        one_prove(hasher, options, route)
        must_launch((hasher.name, route))
    prover_device._RESIDENT_ON_F64, prover_device._FUSED_FRI_ON = defaults

    # the f128 paths at the same trace size: bench.py's rescue_f128 (the
    # Rescue chain, 16 rows per hash, LDE 2^20 on the card: the resident
    # route) and the CLI's fib (LDE 2^21: phased with fused FRI); every
    # kernel of the f128 prover must have launched
    f128_kernels = ("f128_add", "f128_sub", "f128_mul", "f128_ntt_stage")

    def must_launch128(key, hasher_name: str, mxu: bool = False) -> None:
        """The f128 engine's kernels, the hasher's and its f128 draw were
        launched, K3 not; under WINTER_MXU_NTT=1 (``mxu``) B16's in place
        of B13n, which must not have launched."""
        h = DEVICE_HASHERS[hasher_name]
        engine = (f128_kernels[:-1] + tuple(ntt_mxu.LAUNCHES) if mxu
                  else f128_kernels)
        for name in engine + tuple(
                k for k in h.launches if k not in ("gl_mul", h.draw)) + (
                h.draw + "_f128",):
            if not REHEARSAL and runs[key][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by the "
                                     f"{key} prove")
        if not REHEARSAL and runs[key]["gl_mul"]:
            raise AssertionError(f"the {key} prove launched K3")
        if not REHEARSAL and mxu and runs[key]["f128_ntt_stage"]:
            raise AssertionError(f"the {key} prove launched B13n")

    device_limb._RESIDENT_ON = device_limb._FUSED_FRI_ON = True
    tb = time.perf_counter()
    rtrace = rescue128.build_rescue_trace((42, 43), n // 16)
    log(f"Rescue chain trace of {n} rows (native/f128.c) built in "
        f"{time.perf_counter() - tb:.2f} s")
    rescue_f128 = ProofOptions(42, 4, 16, FieldExtension.NONE, 8, 31)
    Rescue128 = F128Prover.accelerate(rescue128.RescueProver)
    rprover = Rescue128(rescue_f128, Blake3_256, device=dev)
    rpub = rprover.get_pub_inputs(rtrace)
    r_bytes = timed_path(
        rprover, "resident", ("rescue_f128", "resident"),
        f"rescue_f128 resident: Rescue chain, trace 2^{log2_trace}",
        rescue128.RescueAir, rpub, rtrace)
    must_launch128(("rescue_f128", "resident"), "blake3_256")
    ftrace = fib128.build_fib_trace(F128, 2 * n, device=dev)
    fpub = ftrace.get(1, n - 1)
    if fpub != fib128.compute_fib_term(F128, 2 * n):
        raise AssertionError("the f128 fib trace's last term differs from "
                             "compute_fib_term")
    level_fuse = device_limb._LEVEL_FUSE
    if REHEARSAL:  # the card's LDE (2^21) is above the resident limit
        device_limb._LEVEL_FUSE = big // 2
    fprover = F128Prover.accelerate(fib128.FibProver)(cli, Blake3_256,
                                                      device=dev)
    f_bytes = timed_path(fprover, "fused", ("fib_cli_f128", "fused"),
                         f"fib_cli_f128 fused: fib, trace 2^{log2_trace}",
                         fib128.FibAir, fpub, ftrace)
    must_launch128(("fib_cli_f128", "fused"), "blake3_256")
    # this slice: both paths again under WINTER_MXU_NTT=1 (every NTT six-step
    # over B16 leaves: no B13n stage, no gather), timed the same way; their
    # bytes must be the switch-off ones (which equal the CPU's, phase 3)
    f128._USE_MXU = True
    try:
        for prover, route, key, label, air, pub, tr, want in (
                (rprover, "resident", "rescue_f128_mxu",
                 f"rescue_f128 resident, WINTER_MXU_NTT=1: trace "
                 f"2^{log2_trace}", rescue128.RescueAir, rpub, rtrace,
                 r_bytes),
                (fprover, "fused", "fib_cli_f128_mxu",
                 f"fib_cli_f128 fused, WINTER_MXU_NTT=1: trace "
                 f"2^{log2_trace}", fib128.FibAir, fpub, ftrace, f_bytes)):
            device_limb._LEVEL_FUSE = (big // 2 if REHEARSAL and
                                       route == "fused" else level_fuse)
            got = timed_path(prover, route, (key, route), label, air, pub,
                             tr)
            if got != want:
                raise AssertionError(f"{label}: the proof differs from the "
                                     "one without the switch")
            must_launch128((key, route), "blake3_256", mxu=True)
    finally:
        f128._USE_MXU = False
    device_limb._LEVEL_FUSE = level_fuse
    # one Rescue prove with Sha3_256: the SHA3 coin's f128 draw
    tracing.set_phase_sync(True)
    _reset_launches()
    t = time.perf_counter()
    proof = Rescue128(rescue_f128, Sha3_256, device=dev).prove(rtrace)
    wall = time.perf_counter() - t
    check_route("resident", "rescue_f128 sha3_256")
    runs["rescue_f128_sha3", "resident"] = _launches()
    verify(rescue128.RescueAir, proof, rpub, Sha3_256)
    must_launch128(("rescue_f128_sha3", "resident"), "sha3_256")
    log(f"rescue_f128 sha3_256 resident: prove {wall:.4f} s (barriers on), "
        "verified")
    # this slice's paths with the CLI's options: bench.py's lamport workload
    # (Lamport aggregate, BENCH_SIGS = 256 signatures: trace 2^18 x 22, LDE
    # 2^21, the phased route with fused FRI) and the CLI's rescue_raps at its
    # default -n 1024 (trace 2^14 x (8 + 3 aux), phased with fused FRI); the
    # keys, signatures and main traces are built before the timed proves
    # (the rehearsal's one-signature LDE is below the resident limit)
    device_limb._RESIDENT_ON, device_limb._FUSED_FRI_ON = not REHEARSAL, True
    n_sigs = 1 if REHEARSAL else 256
    tb = time.perf_counter()
    pks, msgs, sigs = lamport.sign_messages(n_sigs)
    t_keys = time.perf_counter() - tb
    tb = time.perf_counter()
    ltrace = lamport.build_lamport_trace(msgs, sigs)
    log(f"lamport: {n_sigs} keys and signatures (native/f128.c) built in "
        f"{t_keys:.2f} s, the trace of {ltrace.length} x {ltrace.width} "
        f"(native/f128.c) in {time.perf_counter() - tb:.2f} s")
    lprover = F128Prover.accelerate(lamport.LamportAggregateProver)(
        cli, Blake3_256, pks, msgs, device=dev)
    timed_path(lprover, "fused", ("lamport", "fused"),
               f"lamport fused: {n_sigs} signatures, trace {ltrace.length} x "
               f"{ltrace.width}", lamport.LamportAggregateAir,
               lprover.get_pub_inputs(ltrace), ltrace)
    must_launch128(("lamport", "fused"), "blake3_256")
    del ltrace, lprover
    raps_n = 4 if REHEARSAL else 1024
    seeds = [(i + 1, i + 2) for i in range(raps_n)]
    tb = time.perf_counter()
    rr_trace = raps.build_raps_trace(seeds, seeds[2:] + seeds[:2])
    log(f"rescue_raps: the main trace of {rr_trace.length} x 8 (Python "
        f"Rescue rounds) built in {time.perf_counter() - tb:.2f} s; its aux "
        "columns are built inside each prove (phase build_aux_trace)")
    rr_prover = F128Prover.accelerate(raps.RescueRapsProver)(cli, Blake3_256,
                                                             device=dev)
    timed_path(rr_prover, "fused", ("rescue_raps", "fused"),
               f"rescue_raps fused: -n {raps_n}, trace {rr_trace.length} x "
               "(8 + 3)", raps.RescueRapsAir,
               rr_prover.get_pub_inputs(rr_trace), rr_trace)
    must_launch128(("rescue_raps", "fused"), "blake3_256")
    device_limb._RESIDENT_ON, device_limb._FUSED_FRI_ON = defaults128
    # this slice's paths: fib over f62 with the CLI's options and the cubic
    # extension, Blake3_256 (grinding 16, scanned by the native BLAKE3) and
    # Rp62_248 (no grinding: the host would scan one Rescue permutation per
    # nonce), at trace 2^17 (LDE 2^20: resident) and 2^18 (LDE 2^21: phased
    # with fused FRI); then one resident prove with Sha3_256
    f62_kernels = ("f62_add", "f62_sub", "f62_mul", "f62_ntt_stage")
    F62Fib = F62Prover.accelerate(fib_f62.FibF62Prover)

    def must_launch62(key, hasher_name: str) -> None:
        h = DEVICE_HASHERS[hasher_name]
        names = f62_kernels + tuple(
            k for k in h.launches if k not in ("gl_mul", h.draw)) + (
            h.draw + "_f62",)
        for name in names:
            if not REHEARSAL and runs[key][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by the "
                                     f"{key} prove")
        if not REHEARSAL and runs[key]["gl_mul"]:
            raise AssertionError(f"the {key} prove launched K3")

    # log2 trace rows of the resident and the fused path (in the rehearsal
    # the smallest with a FRI layer, and a resident limit between them)
    lg_res, lg_fused = (6, 7) if REHEARSAL else (log2_trace - 1, log2_trace)
    if REHEARSAL:
        device_limb._LEVEL_FUSE = 1 << (lg_res + 3)
    f62_traces = {}
    for lg in (lg_res, lg_fused):
        tb = time.perf_counter()
        f62_traces[lg] = fib_f62.build_fib_f62_trace(1 << lg)
        log(f"f62 fib trace 2^{lg} built in {time.perf_counter() - tb:.2f} s")
    for hasher, grinding in ((Blake3_256, 16), (Rp62_248, 0)):
        opts62 = ProofOptions(28, 8, grinding, FieldExtension.CUBIC, 8, 31)
        for lg, route in ((lg_res, "resident"), (lg_fused, "fused")):
            tr = f62_traces[lg]
            p62 = F62Fib(opts62, hasher, device=dev)
            key = (f"fib_f62_{hasher.name}", route)
            timed_path(p62, route, key,
                       f"fib_f62 {hasher.name} {route}: trace 2^{lg}, LDE "
                       f"2^{lg + 3}, grinding {grinding}",
                       fib_f62.FibF62Air, p62.get_pub_inputs(tr), tr)
            must_launch62(key, hasher.name)
    device_limb._LEVEL_FUSE = level_fuse
    tr = f62_traces[lg_res]
    tracing.set_phase_sync(True)
    _reset_launches()
    t = time.perf_counter()
    proof = F62Fib(ProofOptions(28, 8, 0, FieldExtension.CUBIC, 8, 31),
                   Sha3_256, device=dev).prove(tr)
    wall = time.perf_counter() - t
    check_route("resident", "fib_f62 sha3_256")
    runs["fib_f62_sha3_256", "resident"] = _launches()
    verify(fib_f62.FibF62Air, proof, tr.get(1, tr.length - 1), Sha3_256)
    must_launch62(("fib_f62_sha3_256", "resident"), "sha3_256")
    log(f"fib_f62 sha3_256 resident: trace 2^{lg_res}, prove "
        f"{wall:.4f} s (barriers on), verified")
    del f62_traces, tr
    tracing.set_phase_sync(True)
    phase("4 main path", t0)

    # 4b ----- the port's CLI: every example proves on the card, verifies ---
    t0 = time.perf_counter()
    for name, size in CLI_SIZES:
        log(f"cli: {name} -n {size}")
        port_cli.main([name, "-n", str(size)]
                      + (["--cpu"] if REHEARSAL else []))
    phase("4b cli", t0)

    # 5 ----- kernel times at the main path's shapes -------------------------
    t0 = time.perf_counter()
    reps = 2 if REHEARSAL else 20

    def entry(shape, fn, plain, bound, plain_warm=True):
        """The kernel's and its plain version's times at one shape; a plain
        version that takes seconds (B15's) is timed once, cold."""
        return {"shape": list(shape), "ms": _kernel_ms(fn, reps),
                "host_ms": _time_ms(fn, reps),
                "plain_ms": _time_ms(plain, 1, plain_warm),
                "bound_ms": bound[0], "bound_by": bound[1]}

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

    def b3_hash_entry(m, k, dw=8):
        words, blen = words_of(_rng_field(rng, (m, k), dev))
        return entry((m, k, dw),
                     lambda: blake3.blake3_hash_words(words, blen, dw),
                     lambda: blake3.blake3_hash_words_plain(words, blen, dw),
                     _bound_blake3(m, blen, dw))

    def sha3_hash_entry(m, k):
        words, blen = words_of(_rng_field(rng, (m, k), dev))
        return entry((m, k), lambda: sha3.sha3_hash_words(words, blen),
                     lambda: sha3.sha3_hash_words_plain(words, blen),
                     _bound_sha3(m, blen))

    def jive_hash_entry(m, k):
        x = _rng_field(rng, (m, k), dev)
        return entry((m, k), lambda: jive.jive_hash_rows(x),
                     lambda: jive.jive_hash_rows_plain(x),
                     _bound_jive(m * -(-k // 4), m * (8 * k + 32)))

    def byte_merge_entry(m, dw, merge, plain, per_hash):
        level = _words(rng, (2 * m, dw), dev)
        l, r = level[0::2], level[1::2]
        return entry((m, dw), lambda: merge(l, r), lambda: plain(l, r),
                     _bound_byte_merge(m, dw, per_hash, 2 * m))

    def byte_tree_entry(n, dw, levels, plain, per_hash):
        leaves = _words(rng, (n, dw), dev)
        return entry(("leaves", n, dw), lambda: levels(leaves),
                     lambda: plain(leaves),
                     _bound_byte_merge(n - 1, dw, per_hash, n))

    def jive_tree_entry(n):
        leaves = _rng_field(rng, (n, 4), dev)
        return entry(("leaves", n), lambda: jive.jive_merkle_levels(leaves),
                     lambda: jive.jive_merkle_levels_plain(leaves),
                     _bound_jive(n - 1, (2 * n - 1) * 32))

    def byte_draw_entry(coin, k, d):
        dw = DEVICE_HASHERS[coin].digest_words
        seed_w = _words(rng, (dw,), dev)
        cands = device_coin.byte_coin_ops(coin)[1](seed_w, 0, k)
        # every candidate of these inputs is accepted (checked against the
        # plain loop's counter), so the kernel hashes nothing: it reads the
        # seed and k digests and writes k·d elements and the counter
        want_c = device_coin.draw_plain(cands, seed_w, 0, k, d, coin)[1]
        if int(want_c[0]) != k:
            raise AssertionError(f"{coin}: a timed candidate was rejected")
        return entry((k, d), lambda: byte_draw(coin, cands, seed_w, 0, k, d),
                     lambda: device_coin.draw_plain(cands, seed_w, 0, k, d,
                                                    coin),
                     _bound_alu(0, 4 * dw * (k + 1) + 8 * k * d + 8))

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
        # B10-B12 and the byte coins' draw kernels: the trace LDE, the
        # composition LDE, a FRI layer, a level of the LDE tree and the
        # coin's one-row reseed, the whole trees
        ("blake3_hash_rows", "winterfell_tpu/ops/blake3_device.py:62 "
         "(_compress_rows under blake3_hash_words :142; jnp program, no "
         "Pallas kernel)", "winterfell_tpu_torch/csrc/blake3.cu",
         [b3_hash_entry(big, 2), b3_hash_entry(big, 3 * comp_cols),
          b3_hash_entry(big // 8, 24), b3_hash_entry(big, 2, 6),
          b3_hash_entry(1, 18),
          # a row of the Lamport trace LDE: 22 f128 elements, 352 bytes
          b3_hash_entry(big, 44)]),
        ("blake3_merge_rows", "winterfell_tpu/ops/blake3_device.py:153 "
         "(blake3_merge_rows; jnp program, no Pallas kernel)",
         "winterfell_tpu_torch/csrc/blake3.cu",
         [byte_merge_entry(big // 2, 8, blake3.blake3_merge_rows,
                           blake3.blake3_merge_rows_plain, ALU_PER_BLAKE3),
          byte_merge_entry(1, 8, blake3.blake3_merge_rows,
                           blake3.blake3_merge_rows_plain, ALU_PER_BLAKE3)]),
        ("blake3_merkle_tree", "winterfell_tpu/ops/blake3_device.py:186 "
         "(merkle_levels_blake3; jnp programs, no Pallas kernel)",
         "winterfell_tpu_torch/csrc/blake3.cu",
         [byte_tree_entry(n_, dw_, blake3.blake3_merkle_levels,
                          blake3.blake3_merkle_levels_plain, ALU_PER_BLAKE3)
          for n_, dw_ in ((big, 8), (big // 8, 8), (big // 512, 8),
                          (big, 6))]),
        ("blake3_coin_draw", "none: port-only (the JAX coin's "
         "lax.while_loop over byte_coin_ops, "
         "winterfell_tpu/ops/device_coin.py:106, :302)",
         "winterfell_tpu_torch/csrc/blake3.cu (byte_coin.cuh)",
         [byte_draw_entry("blake3_256", n_ccs, 3),
          byte_draw_entry("blake3_256", 1, 3)]),
        ("sha3_hash_rows", "winterfell_tpu/ops/sha3_device.py:57 (_keccak_f "
         "under sha3_hash_words :92; jnp program, no Pallas kernel)",
         "winterfell_tpu_torch/csrc/keccak.cu",
         [sha3_hash_entry(big, 2), sha3_hash_entry(big, 3 * comp_cols),
          sha3_hash_entry(big // 8, 24), sha3_hash_entry(1, 18)]),
        ("sha3_merge_rows", "winterfell_tpu/ops/sha3_device.py:135 "
         "(sha3_merge_rows; jnp program, no Pallas kernel)",
         "winterfell_tpu_torch/csrc/keccak.cu",
         [byte_merge_entry(big // 2, 8, sha3.sha3_merge_rows,
                           sha3.sha3_merge_rows_plain, ALU_PER_KECCAK),
          byte_merge_entry(1, 8, sha3.sha3_merge_rows,
                           sha3.sha3_merge_rows_plain, ALU_PER_KECCAK)]),
        ("sha3_merkle_tree", "winterfell_tpu/ops/sha3_device.py:160 "
         "(merkle_levels_sha3; jnp programs, no Pallas kernel)",
         "winterfell_tpu_torch/csrc/keccak.cu",
         [byte_tree_entry(n_, 8, sha3.sha3_merkle_levels,
                          sha3.sha3_merkle_levels_plain, ALU_PER_KECCAK)
          for n_ in (big, big // 8, big // 512)]),
        ("sha3_coin_draw", "none: port-only (the JAX coin's lax.while_loop "
         "over byte_coin_ops, winterfell_tpu/ops/device_coin.py:106, :302)",
         "winterfell_tpu_torch/csrc/keccak.cu (byte_coin.cuh)",
         [byte_draw_entry("sha3_256", n_ccs, 3),
          byte_draw_entry("sha3_256", 1, 3)]),
        ("jive_hash_rows", "winterfell_tpu/ops/jive_device.py:84 "
         "(jive_hash_rows over jive_permutation_rows :65; jnp program, no "
         "Pallas kernel)", "winterfell_tpu_torch/csrc/jive.cu",
         [jive_hash_entry(big, 2), jive_hash_entry(big, 3 * comp_cols),
          jive_hash_entry(big // 8, 24)]),
        ("jive_merkle_tree", "winterfell_tpu/ops/jive_device.py:153 "
         "(merkle_levels_jive over jive_merge_rows :120; jnp programs, no "
         "Pallas kernel)", "winterfell_tpu_torch/csrc/jive.cu",
         [jive_tree_entry(big), jive_tree_entry(big // 8),
          jive_tree_entry(big // 512)]),
    ]
    # B13, B13n and the f128 draws at the f128 paths' shapes: the LDE's
    # elements, an extension column times base elements, a Python-int
    # constant; the first and last NTT stages of the Rescue LDE (2^20 rows,
    # 4 columns) and the last of the fib LDE (2^21, 2); the coefficient draw
    # of the Rescue AIR and a one-element draw
    def f128_entry(name, x, y, shape):
        op, plain, _ = ops128[name]
        return entry(shape, lambda: op(x, y), lambda: plain(x, y),
                     _bound_f128(x, y, name == "mul"))

    def stage_entry(n_, cols, half):
        x = _rng_f128(rng, (n_, cols), dev)
        _, tw = f128.ntt_plan(n_, False, dev)
        return entry((n_, cols, half), lambda: f128.ntt_stage(x, tw, half),
                     lambda: f128.ntt_stage_plain(x, tw, half),
                     _bound_ntt_stage(n_, cols, half))

    def draw128_entry(coin, k, d):
        dw = DEVICE_HASHERS[coin].digest_words
        seed_w = _words(rng, (dw,), dev)
        cands = device_coin.byte_coin_ops(coin)[1](seed_w, 0, k)
        want_c = device_coin.draw_plain(cands, seed_w, 0, k, d, coin,
                                        "f128")[1]
        if int(want_c[0]) != k:
            raise AssertionError(f"{coin}: a timed f128 candidate was "
                                 "rejected")
        return entry((k, d), lambda: byte_draw(coin, cands, seed_w, 0, k, d,
                                               "f128"),
                     lambda: device_coin.draw_plain(cands, seed_w, 0, k, d,
                                                    coin, "f128"),
                     _bound_alu(0, 4 * dw * (k + 1) + 16 * k * d + 8))

    # B16 at the leaf shapes the two f128 paths launch under the switch:
    # (32, 2^17), rescue_f128's LDE levels (and the CLI fib's 2^10 level);
    # (64, 2^16), the CLI fib's 2^11 level; (16, 2^16), rescue_f128's trace
    # iNTT; (8, 2^18), the CLI fib's first FRI fold. Beside each: the two
    # kernels' whole leaf DFT (leaf_ms) against the bound of its 32 bytes
    # per element and its tensor-core operations (leaf_bound_ms), the
    # radix-2 transform of the same (n, B) (the gather and the B13n stages,
    # radix2_ms), and torch._int_mm of the same (37n × 19n) · (19n × B)
    # digit product (the product's library_ms: the digits made beforehand)
    mxu_shapes = ((32, big // 16), (64, big // 32), (16, big // 32),
                  (8, big // 8))

    def mxu_entry(kind, n_, cols):
        x = _rng_f128(rng, (n_, cols), dev)
        wt = ntt_mxu.leaf_matrix_dev(n_, False, dev)
        if kind == "product":
            e = entry((n_, cols), _rotating(prod_k, wt, x),
                      lambda: ntt_mxu.digit_product_plain(wt, x),
                      _bound_mxu(n_, cols, 16 + SUMS_BYTES))
            a8 = wt[: 37 * n_, : 19 * n_].contiguous()
            b8 = ntt_mxu.digitize_plain(x)
            e["library_ms"] = _kernel_ms(lambda: torch._int_mm(a8, b8), reps)
            e["leaf_ms"] = _kernel_ms(
                _rotating(lambda x_: leaf_k(x_, wt, n_), x), reps)
            e["leaf_bound_ms"], e["leaf_bound_by"] = _bound_mxu(n_, cols, 32)
            e["radix2_ms"] = _kernel_ms(
                _rotating(lambda x_: f128._ntt_core(x_, n_, False), x), reps)
            return e
        d = prod_k(wt, x)  # two f128 products an element
        return entry((n_, cols), _rotating(lambda d_: rec_k(d_, n_), d),
                     lambda: ntt_mxu.recombine_plain(d, n_),
                     _bound(2 * IMAD_PER_F128_MUL * n_ * cols,
                            (SUMS_BYTES + 16) * n_ * cols))

    mxu_paths = (("rescue_f128_mxu", "resident"), ("fib_cli_f128_mxu", "fused"))
    mxu_src = "winterfell_tpu_torch/csrc/ntt_mxu.cu (f128.cuh)"
    records_mxu = [
        ("ntt_mxu_product", "winterfell_tpu/ops/ntt_mxu.py:162 (_leaf_dft_jit "
         "under leaf_dft :189: the s8 digit product on the MXU, _digitize :93 "
         "fused; jnp program, no Pallas kernel)", mxu_src,
         [mxu_entry("product", n_, c_) for n_, c_ in mxu_shapes], mxu_paths),
        ("ntt_mxu_recombine", "winterfell_tpu/ops/ntt_mxu.py:108 (_recombine "
         "under _leaf_dft_jit :162; jnp program, no Pallas kernel)", mxu_src,
         [mxu_entry("recombine", n_, c_) for n_, c_ in mxu_shapes],
         mxu_paths),
    ]
    x128, y128 = _rng_f128(rng, (big,), dev), _rng_f128(rng, (big,), dev)
    e128, c128 = (_rng_f128(rng, (big // 2, 2), dev),
                  _rng_f128(rng, (big // 2, 1), dev))
    r_ctx = rescue128.RescueAir(rtrace.info(), rpub, rescue_f128).context
    r_ccs = r_ctx.num_transition_constraints + r_ctx.num_assertions
    both128 = (("rescue_f128", "resident"), ("fib_cli_f128", "fused"))
    f128_src = "winterfell_tpu_torch/csrc/f128.cu (f128.cuh)"
    records128 = [
        ("f128_add", "winterfell_tpu/ops/f128.py:161 (f128_add; jnp "
         "program, no Pallas kernel)", f128_src,
         [f128_entry("add", x128, y128, (big,)),
          f128_entry("add", e128, c128, (big // 2, 2, "column"))], both128),
        ("f128_sub", "winterfell_tpu/ops/f128.py:170 (f128_sub; jnp "
         "program, no Pallas kernel)", f128_src,
         [f128_entry("sub", x128, y128, (big,))], both128),
        ("f128_mul", "winterfell_tpu/ops/f128.py:246 (f128_mul over "
         "_mul_limbs_4x4 / _fold_256 :182-243; jnp program, no Pallas "
         "kernel)", f128_src,
         [f128_entry("mul", x128, y128, (big,)),
          f128_entry("mul", e128, c128, (big // 2, 2, "column")),
          f128_entry("mul", x128, 12345, (big, "int"))], both128),
        ("f128_ntt_stage", "winterfell_tpu/ops/f128.py:555 (the radix-2 "
         "stages of _ntt_small under _ntt_core :571; jnp program, no "
         "Pallas kernel)", f128_src,
         [stage_entry(big // 2, 4, big // 4), stage_entry(big // 2, 4, 1),
          stage_entry(big, 2, big // 2)], both128),
        ("blake3_coin_draw_f128", "none: port-only (the JAX coin's "
         "lax.while_loop with limb_ext_decoder, "
         "winterfell_tpu/ops/device_coin.py:248, :302)",
         "winterfell_tpu_torch/csrc/blake3.cu (byte_coin.cuh)",
         [draw128_entry("blake3_256", r_ccs, 1),
          draw128_entry("blake3_256", 1, 1)], both128),
        ("sha3_coin_draw_f128", "none: port-only (the JAX coin's "
         "lax.while_loop with limb_ext_decoder, "
         "winterfell_tpu/ops/device_coin.py:248, :302)",
         "winterfell_tpu_torch/csrc/keccak.cu (byte_coin.cuh)",
         [draw128_entry("sha3_256", r_ccs, 1),
          draw128_entry("sha3_256", 1, 1)],
         (("rescue_f128_sha3", "resident"), None)),
    ]
    # B14, B14n, B15 and the f62 draws at the f62 paths' shapes: the LDE's
    # elements, an extension column times base elements, a Python int; the
    # last and first NTT stages of the fused path's LDE (2^21, 2) and the
    # last of the resident path's (2^20, 2); the row hashes of the trace
    # LDE, the composition LDE, a FRI layer and the OOD row, a level's
    # merges and the coin's reseed, whole trees; the coin's candidates and
    # draws for three cubic coefficients and for one element
    # (B14 and B14n read their inputs from rotating copies: one matrix of
    # 16-48 MiB would stay in the L2 between the graph's launches)
    def f62_entry(name, x, y, shape):
        op, plain, _ = ops62[name]
        return entry(shape, _rotating(op, x, y), lambda: plain(x, y),
                     _bound_f62(x, y, name == "mul"))

    def stage62_entry(n_, cols, half):
        x = _rng_f62(rng, (n_, cols), dev)
        _, tw = f62.ntt_plan(n_, False, dev)
        return entry((n_, cols, half),
                     _rotating(lambda x_, tw_: f62.ntt_stage(x_, tw_, half),
                               x, tw),
                     lambda: f62.ntt_stage_plain(x, tw, half),
                     _bound_stage62(n_, cols, half))

    def rp62_hash_entry(m, k):
        x = _rng_f62(rng, (m, k), dev)
        return entry((m, k), lambda: rp62.rp62_hash_rows(x),
                     lambda: rp62.rp62_hash_rows_plain(x),
                     _bound_rp62(m * -(-k // 8), m * (8 * k + 32)), False)

    def rp62_merge_entry(m):
        level = _words(rng, (2 * m, 8), dev)
        l, r = level[0::2], level[1::2]
        return entry((m, 8), lambda: rp62.rp62_merge_rows(l, r),
                     lambda: rp62.rp62_merge_rows_plain(l, r),
                     _bound_rp62(m, m * 96), False)

    def rp62_tree_entry(n_):
        leaves = _words(rng, (n_, 8), dev)
        return entry(("leaves", n_), lambda: rp62.rp62_merkle_levels(leaves),
                     lambda: rp62.rp62_merkle_levels_plain(leaves),
                     _bound_rp62(n_ - 1, (2 * n_ - 1) * 32), False)

    def cand62_entry(t):
        return entry((t, 8), lambda: rp62.coin_candidates(seed62, 0, t),
                     lambda: rp62.coin_candidates_plain(seed62, 0, t),
                     _bound_rp62(t, 32 + 32 * t), False)

    def draw62_entry(coin, k, d, own=False):
        """The draw from the candidates one launch gives it (``own``: from
        one planted rejection, so the kernel computes every further
        candidate itself: for Rp62_248 the warp runs the draw loop in step
        and a group of 4 threads computes each further candidate); the
        bound counts
        what these inputs need: the candidates read up to the last accepted
        one, and any computed past the launched ones."""
        dw = DEVICE_HASHERS[coin].digest_words
        seed_w = seed62 if coin == "rp62_248" else _words(rng, (dw,), dev)
        t = 1 if own else device_coin.candidates_for(k, d, "f62")
        cands = device_coin.byte_coin_ops(coin)[1](seed_w, 0, t)
        if own:
            cands[0, :2] = -1
        used = int(device_coin.draw_plain(cands, seed_w, 0, k, d, coin,
                                          "f62")[1][0])
        extra = max(0, used - t)
        nbytes = 4 * dw * (min(used, t) + 1) + 8 * k * d + 8
        bound = (_bound_rp62(extra, nbytes) if coin == "rp62_248" else
                 _bound_alu(extra * (ALU_PER_KECCAK if coin == "sha3_256"
                                     else ALU_PER_BLAKE3), nbytes))
        return entry((k, d, "candidates read", used) + (
            ("computed", extra) if own else ()),
                     lambda: byte_draw(coin, cands, seed_w, 0, k, d, "f62"),
                     lambda: device_coin.draw_plain(cands, seed_w, 0, k, d,
                                                    coin, "f62"), bound)

    x62, y62 = _rng_f62(rng, (big,), dev), _rng_f62(rng, (big,), dev)
    e62, c62 = (_rng_f62(rng, (big // 2, 3), dev),
                _rng_f62(rng, (big // 2, 1), dev))
    f62_src = "winterfell_tpu_torch/csrc/f62.cu (f62.cuh)"
    rp62_src = "winterfell_tpu_torch/csrc/rp62.cu (f62.cuh)"
    rp62_paths = (("fib_f62_rp62_248", "resident"),
                  ("fib_f62_rp62_248", "fused"))
    jax62 = "jnp program, no Pallas kernel"
    records62 = [
        ("f62_add", f"winterfell_tpu/ops/f62.py:132 (base_add; {jax62})",
         f62_src, [f62_entry("add", x62, y62, (big,)),
                   f62_entry("add", e62, c62, (big // 2, 3, "column"))],
         rp62_paths),
        ("f62_sub", f"winterfell_tpu/ops/f62.py:140 (base_sub; {jax62})",
         f62_src, [f62_entry("sub", x62, y62, (big,))], rp62_paths),
        ("f62_mul", "winterfell_tpu/ops/f62.py:188 (base_mul over _fold62 "
         f":155; {jax62})", f62_src,
         [f62_entry("mul", x62, y62, (big,)),
          f62_entry("mul", e62, c62, (big // 2, 3, "column")),
          f62_entry("mul", x62, 12345, (big, "int"))], rp62_paths),
        ("f62_ntt_stage", "winterfell_tpu/ops/f62.py:512 (the radix-2 "
         f"stages of _ntt_small under _ntt_core :528; {jax62})", f62_src,
         [stage62_entry(big, 2, big // 2), stage62_entry(big, 2, 1),
          stage62_entry(big // 2, 2, big // 4)], rp62_paths),
        ("rp62_hash_rows", "winterfell_tpu/ops/rp62_device.py:100 "
         "(rp62_permutation_rows under _sponge_elem_rows :169; "
         f"{jax62})", rp62_src,
         [rp62_hash_entry(big, 2), rp62_hash_entry(big, 3),
          rp62_hash_entry(big // 8, 24), rp62_hash_entry(1, 18)], rp62_paths),
        ("rp62_merge_rows", "winterfell_tpu/ops/rp62_device.py:213 "
         f"(rp62_merge_rows; {jax62})", rp62_src,
         [rp62_merge_entry(big // 2), rp62_merge_entry(1)], rp62_paths),
        ("rp62_merkle_tree", "winterfell_tpu/ops/rp62_device.py:261 "
         "(merkle_levels_rp62 over rp62_merge_rows; jnp programs, no Pallas "
         "kernel)", rp62_src,
         [rp62_tree_entry(big), rp62_tree_entry(big // 8),
          rp62_tree_entry(big // 512)], rp62_paths),
        ("rp62_coin_candidates", "none: port-only (the JAX Rp62 coin's "
         "next_candidate, winterfell_tpu/ops/device_coin.py:186)", rp62_src,
         [cand62_entry(device_coin.candidates_for(k, 3, "f62"))
          for k in (3, 1)] + [cand62_entry(1)], rp62_paths),
        ("rp62_coin_draw_f62", "none: port-only (the JAX coin's "
         "lax.while_loop with rp62_ext_decoder, "
         "winterfell_tpu/ops/device_coin.py:209, :302)",
         "winterfell_tpu_torch/csrc/rp62.cu (byte_coin.cuh)",
         [draw62_entry("rp62_248", 3, 3), draw62_entry("rp62_248", 1, 3),
          draw62_entry("rp62_248", 1, 1, own=True)], rp62_paths),
        ("blake3_coin_draw_f62", "none: port-only (the JAX coin's "
         "lax.while_loop with limb_ext_decoder over f62, "
         "winterfell_tpu/ops/device_coin.py:248, :302)",
         "winterfell_tpu_torch/csrc/blake3.cu (byte_coin.cuh)",
         [draw62_entry("blake3_256", 3, 3), draw62_entry("blake3_256", 1, 3)],
         (("fib_f62_blake3_256", "resident"),
          ("fib_f62_blake3_256", "fused"))),
        ("sha3_coin_draw_f62", "none: port-only (the JAX coin's "
         "lax.while_loop with limb_ext_decoder over f62, "
         "winterfell_tpu/ops/device_coin.py:248, :302)",
         "winterfell_tpu_torch/csrc/keccak.cu (byte_coin.cuh)",
         [draw62_entry("sha3_256", 3, 3), draw62_entry("sha3_256", 1, 3)],
         (("fib_f62_sha3_256", "resident"), None)),
    ]

    # B0, B0x, B4 and B5 at the main path's shapes (fib 2^18, LDE 2^21,
    # cubic): the LDE's elements, an extension matrix plus a column; the
    # DEEP products over the LDE and the OOD products of the composition
    # columns with pows2 expanded over them; the last and the bit-reversed
    # first stage of the trace LDE and the last of the composition LDE; the
    # first and second FRI folds (by 8). Each launch reads the next of
    # rotating copies of its inputs (HBM, not the L2); B4's bound is
    # _bound_stage62's, which counts 8-byte elements and 8-IMAD products.
    def b0_entry(name, x, y, shape):
        op, plain = b0[name]
        return entry(shape, _rotating(op, x, y), lambda: plain(x, y),
                     _bound_f62(x, y, False))

    def ext_entry(x, y, shape):
        return entry(shape, _rotating(ext_k, x, y),
                     lambda: field_kernels.ext_mul_plain(x, y),
                     _bound_ext(x, y))

    def stage64_entry(n_, cols, half):
        x = _rng_field(rng, (n_, cols), dev)
        _, tw = gl.ntt_plan(n_, False, dev)
        if half == 1:  # the first stage, reading bit-reversed
            return entry((n_, cols, "first, bit-reversed"),
                         _rotating(gl.ntt_bitrev_stage, x, tw),
                         lambda: gl.ntt_stage_plain(
                             x.index_select(0, gl.bitrev_perm(n_, dev)), tw,
                             1), _bound_stage62(n_, cols, half))
        return entry((n_, cols, half),
                     _rotating(lambda x_, tw_: gl.ntt_stage(x_, tw_, half),
                               x, tw),
                     lambda: gl.ntt_stage_plain(x, tw, half),
                     _bound_stage62(n_, cols, half))

    def fold_entry(n_, n_fold, d):
        ev, al = _rng_field(rng, (n_, d), dev), _rng_field(rng, (d,), dev)
        off = F64.generator
        return entry((n_, d, "by", n_fold),
                     _rotating(lambda e_, a_: fold_k(e_, n_fold, off, a_), ev,
                               al),
                     lambda: gl.fri_fold_plain(ev, n_fold, off, al),
                     _bound_fold(n_, n_fold, d))

    x64, y64 = _rng_field(rng, (big,), dev), _rng_field(rng, (big,), dev)
    e64, c64 = _rng_field(rng, (big, 3), dev), _rng_field(rng, (big, 1), dev)
    f64_ = _rng_field(rng, (big, 3), dev)
    cp = _rng_field(rng, (n, comp_cols, 1, 3), dev)
    p2 = _rng_field(rng, (n, 1, 2, 3), dev).expand(n, comp_cols, 2, 3)
    paths64 = (("rp64_256", "resident"), ("rp64_256", "fused"))
    gl_src = "winterfell_tpu_torch/csrc/goldilocks.cu"
    jax64 = "jnp program, no Pallas kernel"
    records64 = [
        ("gl_add", f"winterfell_tpu/ops/goldilocks.py:81 (gl_add; {jax64})",
         gl_src, [b0_entry("gl_add", x64, y64, (big,)),
                  b0_entry("gl_add", e64, c64, (big, 3, "column"))],
         paths64),
        ("gl_sub", f"winterfell_tpu/ops/goldilocks.py:88 (gl_sub; {jax64})",
         gl_src, [b0_entry("gl_sub", x64, y64, (big,))], paths64),
        ("gl_ext_mul", "winterfell_tpu/ops/goldilocks.py:191 (ext_mul, "
         f"quadratic and cubic; {jax64})", gl_src,
         [ext_entry(e64, f64_, (big, 3)),
          ext_entry(cp, p2, (n, comp_cols, 2, 3, "pows2 expanded"))],
         paths64),
        ("gl_ntt_stage", "winterfell_tpu/ops/goldilocks.py:386 (the radix-2 "
         f"stages of _ntt_small under _ntt_core :340, ntt_lde_body :432; "
         f"{jax64})", gl_src,
         [stage64_entry(big, 2, big // 2), stage64_entry(big, 2, 1),
          stage64_entry(big, 3 * comp_cols, big // 2)], paths64),
        ("gl_fri_fold", "winterfell_tpu/ops/goldilocks.py:625 "
         f"(fri_fold_body; {jax64})", gl_src,
         [fold_entry(big, 8, 3), fold_entry(big // 8, 8, 3)], paths64),
    ]

    def by_path(name):
        """The kernel's launches in one prove of every timed path that
        launched it."""
        return {"/".join(key): counts[name] for key, counts in runs.items()
                if counts.get(name)}

    kernels = []
    for name, replaces, source, shapes in records:
        main = shapes[0]
        # the launches of the first hasher's prove that launches the kernel
        # (its default route), and of its phased prove where one was timed
        # (RpJive64_256's one route is phased); else null
        hasher_name = next(h.name for h in DEVICE_HASHERS.values()
                           if name in h.launches)
        route = ("resident" if DEVICE_HASHERS[hasher_name].coin else "host")
        phased = (runs[hasher_name, route] if route == "host" else
                  runs.get((hasher_name, "fused")))
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": runs[hasher_name, route][name],
            "launches_phased": None if phased is None else phased[name],
            "path": [hasher_name, route], "launches_by_path": by_path(name),
            "max_abs_err": errs[name], "max_diff": errs[name],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shape": main["shape"], "shapes": shapes})
    for name, replaces, source, shapes, (key, phased_key) in (
            records64 + records128 + records62 + records_mxu):
        main = shapes[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": runs[key][name],
            "launches_phased": (None if phased_key is None
                                else runs[phased_key][name]),
            "path": list(key), "launches_by_path": by_path(name),
            "max_abs_err": errs[name], "max_diff": errs[name],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"), "shape": main["shape"],
            "shapes": shapes})
    for kr in kernels:
        for s in kr["shapes"]:
            extra = "".join(
                f", {k} {s[k]:.4f}" for k in ("library_ms", "leaf_ms",
                                              "leaf_bound_ms", "radix2_ms")
                if k in s)
            log(f"{kr['name']} {s['shape']}: {s['ms']:.4f} ms (launched "
                f"back to back from Python {s['host_ms']:.4f} ms), plain "
                f"{s['plain_ms']:.1f} ms, bound {s['bound_ms']:.4f} ms "
                f"({s['bound_by']}){extra}")
    phase("5 kernel times", t0)

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if REHEARSAL:
        log("rehearsal done (no verdict without a card)")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
