"""The Fiat-Shamir coin on the device for the f64, f62 and f128 provers: the
port of winterfell_tpu/ops/device_coin.py.

The host :class:`~winterfell_tpu_torch.crypto.random_coin.DefaultRandomCoin`
(crypto/src/random/default.rs:82-247) needs a host round trip at every
commit -> reseed -> draw step. Here the coin state lives on the device, so a
whole proof runs with no device-to-host read between the trace upload and the
result pulls (prover/device.py, resident route):

- the seed is a (4,) int64 tensor, the digest's field elements (the digest
  byte layout, so the host coin resumes from ``u64_to_seed`` of it);
- reseed is one Rp64_256 merge, the K2 kernel on one row;
- a draw permutes the candidate states ``merge_with_int(seed, counter)``
  (``permute_rows``, one launch for all candidates of the draws) and the
  draw kernel runs the rejection loop.

For the byte hashers (Blake3_256, Blake3_192, Sha3_256) the seed is the
digest's little-endian u32 words, a (dw,) int32 tensor (``words_to_seed``
gives the host coin's bytes back); reseed is one merge launch of the
hasher's kernel (``ops/blake3.py``, ``ops/sha3.py``); the candidates
hash(seed ‖ LE64(counter)) of the draws come from one row-hash launch, and
the hasher's draw kernel (``csrc/byte_coin.cuh``) runs the rejection loop,
hashing further counters itself past a rejected candidate. Over f128
(``eng_name="f128"``, the byte hashers only) a candidate's first 16·d bytes
are the d base elements of a draw, each accepted when < p (the JAX
limb_ext_decoder, device_coin.py:235-270), and the draw kernel is the f128
instance of the same loop (``wt_<draw>_f128``); the elements come out as
(k, d, 2) tensors of (lo, hi) words. Over f62 (``eng_name="f62"``) a draw's
elements are a candidate's first d little-endian u64 values, each accepted
when < p62 (about one in four of each), by the f62 instance
(``wt_<draw>_f62``): an f62 element has f64's two words, but not its p.

The Rp62_248 coin (the f62 prover's Rescue hasher) is a word coin too: its
seed is the (8,) int32 packed digest (the 31 digest bytes and a zero pad
byte), reseed is one merge of ``ops/rp62.py`` (B15), the candidates
merge_with_int(seed, c) come from one B15 launch (``coin_candidates``,
counters at or above p included: count 6 and c div p in lane 5), and its
draw is the same loop over the f62 modulus, computing merge_with_int itself
past the launched candidates (``wt_rp62_coin_draw_f62``,
device_coin.py:168-230). The packed digest's bytes are what the host coin's
draw reads, so decoding them as words is the reference's decoding.

The Rp64_256 kernels are in ``csrc/rescue.cu`` beside K1 and K2, and share
their permutation. Each has a wrapper (for a CUDA tensor it launches the kernel on
the current stream without synchronising and adds one to its count in
``LAUNCHES``; a CPU tensor goes to the plain version) and a plain PyTorch
version, like the kernels of ``ops/rescue.py``. The counter is a Python
int going in (every draw of a proof starts from a fresh reseed) and a (1,)
tensor coming out.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from ..math.fields import F62, GOLDILOCKS_P
from . import f128
from . import goldilocks as gl
from . import rescue
from .device_hashers import DEVICE_HASHERS

P = GOLDILOCKS_P
MAX_TRIES = 1000  # a draw gives up after this many candidates, as the host coin

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"rp64_permute_rows": 0, "rp64_coin_draw": 0,
                            "blake3_coin_draw": 0, "sha3_coin_draw": 0,
                            "blake3_coin_draw_f128": 0,
                            "sha3_coin_draw_f128": 0,
                            "blake3_coin_draw_f62": 0, "sha3_coin_draw_f62": 0,
                            "rp62_coin_draw_f62": 0}
# each engine's modulus, which a draw's elements must stay below
_P_OF = {"f64": P, "f62": F62.p}
# candidates the plain draw loop computes at a time past the given ones
_PLAIN_BATCH = 256


def candidates_for(k: int, degree: int, eng_name: str) -> int:
    """The candidates one launch computes for k draws of degree-``degree``
    elements: k where nearly every candidate is accepted (f64, f128). Over
    f62 a component is accepted with probability p/2^64 ≈ 1/4, so a draw
    takes 4^degree candidates on average, and the launch computes
    8·k·4^degree + 256: past them the draw kernel computes candidates one
    by one in its single thread, an Rp62_248 permutation about 0.7 ms each,
    while a launch of a few thousand costs what one of them costs (with
    2·k·4^d + 64, the seven draws of a 2^17 Rp62_248 prove took 86 ms on an
    H100, PERF.md). The plain loop continues past them in batches of
    ``_PLAIN_BATCH``; the draws are the same for any count."""
    return 8 * k * 4**degree + 256 if eng_name == "f62" else k


def _byte_coin(kind: str):
    """The record of a word coin (``ops/device_hashers.py``): a byte hasher's
    or Rp62_248's, whose seed and candidates are int32 digest words; None
    for Rp64_256 and for a kind with no device coin."""
    h = DEVICE_HASHERS.get(kind)
    return h if h is not None and h.coin and h.words else None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ================================================================================
# Seed conversion (host side)
# ================================================================================


def seed_to_u64(seed: bytes) -> np.ndarray:
    """Digest bytes -> little-endian uint64 vector (Rp64 digest elements)."""
    return np.frombuffer(seed, dtype="<u8").copy()


def u64_to_seed(vals) -> bytes:
    """uint64 digest elements (numpy) -> digest bytes."""
    return np.ascontiguousarray(np.asarray(vals).astype("<u8")).tobytes()


def seed_to_words(seed: bytes) -> np.ndarray:
    """Digest bytes -> little-endian uint32 word vector (byte hashers)."""
    return np.frombuffer(seed, dtype="<u4").copy()


def words_to_seed(words) -> bytes:
    """uint32 (or int32) digest words (numpy) -> digest bytes."""
    return np.ascontiguousarray(np.asarray(words)).astype("<u4").tobytes()


def seed_tensor(seed: bytes, device, kind: str = "rp64_256") -> torch.Tensor:
    """Host coin seed bytes -> the device seed of coin ``kind``: (4,) int64
    digest elements for Rp64_256, (dw,) int32 digest words for a word coin
    (Rp62_248's 31 bytes with the zero pad byte)."""
    if _byte_coin(kind) is not None:
        seed = seed + bytes(-len(seed) % 4)
        return torch.from_numpy(seed_to_words(seed).view(np.int32)).to(device)
    return torch.from_numpy(seed_to_u64(seed).view(np.int64)).to(device)


# ================================================================================
# permute_rows: the permutation of given states
# ================================================================================


def permute_rows_plain(states):
    """The Rp64_256 permutation of each (m, 12) state row, plain PyTorch."""
    return rescue._perm_plain(states)


def permute_rows(states):
    """The permutation of each row of a contiguous (m, 12) state tensor."""
    rescue._check(states, "permute_rows")
    if states.shape[1] != 12 or not states.is_contiguous():
        raise ValueError("permute_rows: expected a contiguous (m, 12) "
                         f"tensor, got {tuple(states.shape)}")
    if rescue._device_kind(states) == "cpu":
        return permute_rows_plain(states)
    out = torch.empty_like(states)
    if states.shape[0] == 0:
        return out
    lib = rescue._kernels()
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_rp64_permute_rows(states.data_ptr(), out.data_ptr(),
                                       rescue._table("ark",
                                                     states.device).data_ptr(),
                                       states.shape[0], stream)
    rescue._raise_on(err, "rp64_permute_rows")
    LAUNCHES["rp64_permute_rows"] += 1
    return out


# ================================================================================
# Rp64_256 coin ops
# ================================================================================


def _candidate_states(seed, counter0: int, t: int):
    """(t, 12) merge_with_int states of ``seed`` for counters counter0 + 1 ..
    counter0 + t (rp64_256/mod.rs merge_with_int: state[0] = 5, the seed in
    lanes 4..8, the counter in lane 8; the counter stays below p, so the
    state[0] = 6 / state[9] branch of counters >= p never arises). Built
    on the device from the seed tensor: no host copy."""
    if counter0 + t >= P:
        raise ValueError("coin counter reaches p")
    dev = seed.device
    ctr = torch.arange(counter0 + 1, counter0 + t + 1, dtype=gl.I64,
                       device=dev)[:, None]
    zeros = torch.zeros((t, 3), dtype=gl.I64, device=dev)
    five = torch.full((t, 1), 5, dtype=gl.I64, device=dev)
    return torch.cat([five, zeros, seed.reshape(1, 4).expand(t, 4), ctr,
                      zeros], dim=1)


def rp64_coin_ops():
    """``(merge, next_candidates)`` for the Rescue-Prime sponge coin
    (rp64_256/mod.rs:208-254):

    - ``merge(seed, other)``: the reseed, merge(seed ‖ other) of two (4,)
      digests, K2 on one row;
    - ``next_candidates(seed, counter0, t)``: the permuted states of
      ``merge_with_int(seed, c)`` for c = counter0 + 1 .. counter0 + t,
      (t, 12), one permute_rows launch; digest = lanes 4..8."""

    def merge(seed, other):
        return rescue.rp64_merge_rows(seed.reshape(1, 4),
                                      other.reshape(1, 4)).reshape(4)

    def next_candidates(seed, counter0: int, t: int):
        return permute_rows(_candidate_states(seed, counter0, t))

    return merge, next_candidates


def byte_coin_ops(kind: str):
    """``(merge, next_candidates)`` for a word coin
    (winterfell_tpu/ops/device_coin.py:106, :168):

    - ``merge(seed, other)``: the reseed, merge(seed, other) of two (dw,)
      digests (hash(seed ‖ other) for a byte hasher), one merge launch;
    - ``next_candidates(seed, counter0, t)``: the record's ``candidates``,
      the (t, dw) candidate digests merge_with_int(seed, c) for c =
      counter0 + 1 .. counter0 + t (hash(seed ‖ LE64(c)) for a byte
      hasher), one launch."""
    bk = _byte_coin(kind)
    dw = bk.digest_words

    def merge(seed, other):
        return bk.merge_rows(seed.reshape(1, dw),
                             other.reshape(1, dw)).reshape(dw)

    return merge, bk.candidates


def u64_ext_decoder(p: int, degree: int, from_words: bool = False):
    """Decoder of a candidate digest -> ``(ok, elem (degree,))``: its first
    ``degree`` little-endian u64 values, ok iff each is < p
    (Field.try_from_random_bytes). ``from_words``: the digest is (dw,) int32
    words, read as u64 from word pairs and zero-padded past a truncated
    digest (device_coin.py:272-289); else (4,) Rp64 digest elements, which
    are canonical, so ok always holds there (the check stays for
    exactness)."""

    def decode(cand):
        if from_words:
            need = 2 * degree
            if cand.shape[0] < need:
                cand = torch.cat([cand, cand.new_zeros(need - cand.shape[0])])
            vals = cand[:need].contiguous().view(torch.int64)
        else:
            vals = cand[:degree]
        ok = bool(gl._ult(vals, gl._s64(p)).all())
        return ok, vals

    return decode


def f128_ext_decoder(degree: int):
    """Decoder of a candidate digest of (dw,) int32 words -> ``(ok, elem
    (degree, 2))``: its first 16·degree bytes (zero-padded past a truncated
    digest) as little-endian f128 elements, ok iff each is < p
    (device_coin.py:235-270)."""

    p_lo, p_hi = f128.P_WORDS  # p's high word is all ones

    def decode(cand):
        need = 4 * degree
        if cand.shape[0] < need:
            cand = torch.cat([cand, cand.new_zeros(need - cand.shape[0])])
        vals = cand[:need].contiguous().view(torch.int64).reshape(degree, 2)
        lo, hi = vals[:, 0], vals[:, 1]
        ok = bool(((hi != p_hi) | gl._ult(lo, p_lo)).all())
        return ok, vals

    return decode


# ================================================================================
# The draw kernel, its plain version, and the draw functions
# ================================================================================


def draw_plain(cands, seed, counter0: int, k: int, d: int,
               kind: str = "rp64_256", eng_name: str = "f64"):
    """The serial loop of the draw kernels in plain PyTorch (reads the device
    to test each candidate): (elems (k, d) for f64 and f62, (k, d, 2) for
    f128, counter (1,)). ``cands`` are the permuted candidate states (t, 12)
    for Rp64_256, the candidate digests (t, dw) for a word coin."""
    bk = _byte_coin(kind)
    byte = bk is not None
    decode = (f128_ext_decoder(d) if eng_name == "f128" else
              u64_ext_decoder(_P_OF[eng_name], d, from_words=byte))

    def more(c0: int, t: int):
        """The candidates of counters c0 + 1 .. c0 + t (the kernel computes
        them one by one; the plain loop in batches, to the same values)."""
        if byte:
            return bk.candidates_plain(seed, c0, t)
        return permute_rows_plain(_candidate_states(seed, c0, t))

    elems, ctr, j = [], counter0, 0
    for _ in range(k):
        for _ in range(MAX_TRIES):
            ctr += 1
            if j == cands.shape[0]:
                cands = torch.cat([cands, more(ctr - 1, _PLAIN_BATCH)])
            digest = cands[j] if byte else cands[j, 4:8]
            j += 1
            ok, vals = decode(digest)
            if ok:
                elems.append(vals)
                break
        else:
            raise RuntimeError(f"no field element after {MAX_TRIES} "
                               "candidates")
    return (torch.stack(elems), torch.full((1,), ctr, dtype=gl.I64,
                                           device=seed.device))


def draw_kernel(cands, seed, counter0: int, k: int, d: int):
    """The draw kernel on CUDA tensors: k draws of degree-d elements from the
    permuted candidate states ``cands`` (t, 12) of counters counter0 + 1 ..,
    continuing past them on the card if candidates are rejected. Returns
    (elems (k, d), counter (1,)); the counter is 2^64 − 1 (−1 as int64) if a
    draw found nothing in 1000 candidates."""
    for t, name in ((cands, "cands"), (seed, "seed")):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"draw_kernel: {name} must be a contiguous int64 "
                             "tensor")
    if cands.dim() != 2 or cands.shape[1] != 12 or seed.shape != (4,):
        raise ValueError("draw_kernel: expected cands (t, 12) and seed (4,)")
    if not 1 <= d <= 4 or k < 1:
        raise ValueError("draw_kernel: needs k >= 1 and 1 <= d <= 4")
    if seed.device.type != "cuda" or cands.device != seed.device:
        raise ValueError("draw_kernel: the kernel takes CUDA tensors")
    dev = seed.device
    elems = torch.empty((k, d), dtype=gl.I64, device=dev)
    counter = torch.empty((1,), dtype=gl.I64, device=dev)
    lib = rescue._kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wt_rp64_coin_draw(cands.data_ptr(), seed.data_ptr(),
                                    rescue._table("ark", dev).data_ptr(),
                                    elems.data_ptr(), counter.data_ptr(),
                                    counter0, cands.shape[0], k, d, stream)
    rescue._raise_on(err, "rp64_coin_draw")
    LAUNCHES["rp64_coin_draw"] += 1
    return elems, counter


def byte_draw_kernel(kind: str, cands, seed, counter0: int, k: int, d: int,
                     eng_name: str = "f64"):
    """A word coin's draw kernel on CUDA tensors: k draws of degree-d
    elements from the candidate digests ``cands`` (t, dw) of counters
    counter0 + 1 .., computing further candidates on the card if candidates
    are rejected. Returns (elems (k, d), counter (1,)), elems (k, d, 2) with
    ``eng_name="f128"`` (d <= 2); the counter is 2^64 − 1 (−1 as int64) if a
    draw found nothing in 1000 candidates. Rp62_248's draw is over f62
    only."""
    bk = _byte_coin(kind)
    dw = bk.digest_words
    wide = eng_name == "f128"
    if eng_name not in ("f64", "f128", "f62") or bk.field not in (None,
                                                                   eng_name):
        raise ValueError(f"byte_draw_kernel: no {kind} draw over "
                         f"{eng_name!r}")
    for t, what in ((cands, "cands"), (seed, "seed")):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"byte_draw_kernel: {what} must be contiguous "
                             "int32 words")
    if cands.dim() != 2 or cands.shape[1] != dw or seed.shape != (dw,):
        raise ValueError(f"byte_draw_kernel: expected cands (t, {dw}) and "
                         f"seed ({dw},)")
    if not 1 <= d <= (2 if wide else 4) or k < 1:
        raise ValueError("byte_draw_kernel: needs k >= 1 and 1 <= d <= "
                         f"{2 if wide else 4}")
    if seed.device.type != "cuda" or cands.device != seed.device:
        raise ValueError("byte_draw_kernel: the kernel takes CUDA tensors")
    dev = seed.device
    elems = torch.empty((k, d, 2) if wide else (k, d), dtype=gl.I64,
                        device=dev)
    counter = torch.empty((1,), dtype=gl.I64, device=dev)
    name = bk.draw if eng_name == "f64" else f"{bk.draw}_{eng_name}"
    entry = getattr(bk.library(dev), f"wt_{name}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(cands.data_ptr(), seed.data_ptr(), elems.data_ptr(),
                    counter.data_ptr(), counter0, cands.shape[0], k, d, dw,
                    stream)
    rescue._raise_on(err, name)
    LAUNCHES[name] += 1
    return elems, counter


def make_draw(next_candidates, degree: int, kind: str = "rp64_256",
              eng_name: str = "f64"):
    """``draw(seed, k=1, counter=0) -> (elems (k, degree[, 2]), counter
    (1,))``: k consecutive draws with the host coin's counter semantics; the
    candidates (``candidates_for``) come from one launch, the rejection loop
    runs in the draw kernel on the card (its plain version on the CPU)."""

    def draw(seed, k: int = 1, counter: int = 0):
        cands = next_candidates(seed, counter,
                                candidates_for(k, degree, eng_name))
        if seed.device.type == "cpu":
            return draw_plain(cands, seed, counter, k, degree, kind, eng_name)
        if _byte_coin(kind) is not None:
            return byte_draw_kernel(kind, cands, seed, counter, k, degree,
                                    eng_name)
        return draw_kernel(cands, seed, counter, k, degree)

    return draw


def make_draw_k(draw, eng):
    """``draw_k(seed, k, method) -> (elems (k, d[, 2]), counter)``: the
    composition-coefficient draw (air/src/air/coefficients.rs): 'linear' = k
    independent draws, 'algebraic' = powers 1, a, a², ... of one draw,
    'horner' = those powers reversed. The powers are the field engine
    ``eng``'s (f64 and f62 elements have the same layout, not the same
    field)."""

    def draw_k(seed, k: int, method: str = "linear"):
        if method == "linear":
            return draw(seed, k)
        if method not in ("algebraic", "horner"):
            raise ValueError(f"unknown batching method {method!r}")
        alpha, counter = draw(seed, 1)
        elems = eng.ext_power_table(alpha[0], k)
        return (elems.flip(0) if method == "horner" else elems), counter

    return draw_k


@lru_cache(maxsize=None)
def coin_bundle(kind: str, degree: int, eng_name: str = "f64"):
    """(merge, draw) for a prover configuration: Rp64_256 over f64,
    Rp62_248 over f62, the byte hashers over f64, f62 and f128 (at degree 1
    or 2: f128 has no cubic extension)."""
    h = DEVICE_HASHERS.get(kind)
    if (h is None or not h.coin or eng_name not in ("f64", "f62", "f128")
            or h.field not in (None, eng_name)
            or (eng_name == "f128" and degree > 2)):
        raise ValueError(f"no device coin for {kind!r} over {eng_name!r}")
    if kind == "rp64_256":
        merge, next_candidates = rp64_coin_ops()
    else:
        merge, next_candidates = byte_coin_ops(kind)
    return merge, make_draw(next_candidates, degree, kind, eng_name)
