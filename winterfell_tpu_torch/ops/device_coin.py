"""The Fiat-Shamir coin on the device for the f64 and f128 provers: the port
of winterfell_tpu/ops/device_coin.py (its Rp64_256 and byte-hasher parts).

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
(k, d, 2) tensors of (lo, hi) words.

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

from ..math.fields import GOLDILOCKS_P
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
                            "sha3_coin_draw_f128": 0}



def _byte_coin(kind: str):
    """The record of a byte-hasher coin (``ops/device_hashers.py``), or
    None for Rp64_256 and for a kind with no device coin."""
    h = DEVICE_HASHERS.get(kind)
    return h if h is not None and h.coin and h.kind == "bytes" else None


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
    digest elements for Rp64_256, (dw,) int32 digest words for a byte
    hasher."""
    if _byte_coin(kind) is not None:
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


def _candidate_messages(seed, counter0: int, t: int):
    """(t, dw + 2) int32 messages seed ‖ LE64(c) for c = counter0 + 1 ..
    counter0 + t (blake/mod.rs:41-46 merge_with_int), built on the device
    from the seed tensor: no host copy."""
    ctr = torch.arange(counter0 + 1, counter0 + t + 1, dtype=torch.int64,
                       device=seed.device)
    return torch.cat([seed.reshape(1, -1).expand(t, seed.shape[0]),
                      ctr.view(torch.int32).reshape(t, 2)], dim=1)


def byte_coin_ops(kind: str):
    """``(merge, next_candidates)`` for a byte-hasher coin
    (winterfell_tpu/ops/device_coin.py:106):

    - ``merge(seed, other)``: the reseed, hash(seed ‖ other) of two (dw,)
      digests, one merge launch;
    - ``next_candidates(seed, counter0, t)``: the (t, dw) candidate digests
      hash(seed ‖ LE64(c)) for c = counter0 + 1 .. counter0 + t, one
      row-hash launch."""
    bk = _byte_coin(kind)
    dw = bk.digest_words

    def merge(seed, other):
        return bk.merge_rows(seed.reshape(1, dw),
                             other.reshape(1, dw)).reshape(dw)

    def next_candidates(seed, counter0: int, t: int):
        return bk.hash_rows(_candidate_messages(seed, counter0, t),
                            4 * dw + 8, dw)

    return merge, next_candidates


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
    to test each candidate): (elems (k, d) for f64, (k, d, 2) for f128,
    counter (1,)). ``cands`` are the permuted candidate states (t, 12) for
    Rp64_256, the candidate digests (t, dw) for a byte hasher."""
    bk = _byte_coin(kind)
    byte = bk is not None
    decode = (f128_ext_decoder(d) if eng_name == "f128" else
              u64_ext_decoder(P, d, from_words=byte))
    elems, ctr, j = [], counter0, 0
    for _ in range(k):
        for _ in range(MAX_TRIES):
            ctr += 1
            if j < cands.shape[0]:
                digest = cands[j] if byte else cands[j, 4:8]
            elif byte:
                dw = bk.digest_words
                digest = bk.hash_rows_plain(
                    _candidate_messages(seed, ctr - 1, 1), 4 * dw + 8, dw)[0]
            else:
                digest = permute_rows_plain(
                    _candidate_states(seed, ctr - 1, 1))[0, 4:8]
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
    """The byte hasher's draw kernel on CUDA tensors: k draws of degree-d
    elements from the candidate digests ``cands`` (t, dw) of counters
    counter0 + 1 .., hashing further counters on the card if candidates are
    rejected. Returns (elems (k, d), counter (1,)), elems (k, d, 2) with
    ``eng_name="f128"`` (d <= 2); the counter is 2^64 − 1 (−1 as int64) if a
    draw found nothing in 1000 candidates."""
    bk = _byte_coin(kind)
    dw = bk.digest_words
    wide = eng_name == "f128"
    if eng_name not in ("f64", "f128"):
        raise ValueError(f"byte_draw_kernel: no draw over {eng_name!r}")
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
    name = f"{bk.draw}_f128" if wide else bk.draw
    entry = getattr(bk.library(), f"wt_{name}")
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
    k candidates come from one launch, the rejection loop runs in the draw
    kernel on the card (its plain version on the CPU)."""

    def draw(seed, k: int = 1, counter: int = 0):
        cands = next_candidates(seed, counter, k)
        if seed.device.type == "cpu":
            return draw_plain(cands, seed, counter, k, degree, kind, eng_name)
        if _byte_coin(kind) is not None:
            return byte_draw_kernel(kind, cands, seed, counter, k, degree,
                                    eng_name)
        return draw_kernel(cands, seed, counter, k, degree)

    return draw


def make_draw_k(draw):
    """``draw_k(seed, k, method) -> (elems (k, d[, 2]), counter)``: the
    composition-coefficient draw (air/src/air/coefficients.rs): 'linear' = k
    independent draws, 'algebraic' = powers 1, a, a², ... of one draw,
    'horner' = those powers reversed. The field is read off the draw: f128
    elements carry a trailing axis of (lo, hi) words."""

    def draw_k(seed, k: int, method: str = "linear"):
        if method == "linear":
            return draw(seed, k)
        if method not in ("algebraic", "horner"):
            raise ValueError(f"unknown batching method {method!r}")
        alpha, counter = draw(seed, 1)
        power_table = (f128.ext_power_table if alpha.ndim == 3 else
                       gl.ext_power_table)
        elems = power_table(alpha[0], k)
        return (elems.flip(0) if method == "horner" else elems), counter

    return draw_k


@lru_cache(maxsize=None)
def coin_bundle(kind: str, degree: int, eng_name: str = "f64"):
    """(merge, draw) for a prover configuration: Rp64_256 and the byte
    hashers over f64, the byte hashers over f128 at degree 1 or 2 (f128
    has no cubic extension; Rp62_248 and f62 come with their slice)."""
    h = DEVICE_HASHERS.get(kind)
    if (h is None or not h.coin or eng_name not in ("f64", "f128")
            or (eng_name == "f128" and (h.kind != "bytes" or degree > 2))):
        raise ValueError(f"no device coin for {kind!r} over {eng_name!r}")
    if kind == "rp64_256":
        merge, next_candidates = rp64_coin_ops()
    else:
        merge, next_candidates = byte_coin_ops(kind)
    return merge, make_draw(next_candidates, degree, kind, eng_name)
