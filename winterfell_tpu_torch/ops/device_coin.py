"""The Fiat-Shamir coin on the device, for Rp64_256 over f64: the port of
winterfell_tpu/ops/device_coin.py (its Rp64_256 part).

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

Both kernels are in ``csrc/rescue.cu`` beside K1 and K2, and share their
permutation. Each has a wrapper (for a CUDA tensor it launches the kernel on
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
from . import goldilocks as gl
from . import rescue

P = GOLDILOCKS_P
MAX_TRIES = 1000  # a draw gives up after this many candidates, as the host coin

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"rp64_permute_rows": 0, "rp64_coin_draw": 0}


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


def seed_tensor(seed: bytes, device) -> torch.Tensor:
    """Host coin seed bytes -> the (4,) device seed."""
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


def u64_ext_decoder(p: int, degree: int):
    """Decoder of an Rp64 candidate digest (4,) -> ``(ok, elem (degree,))``:
    the first ``degree`` digest elements, ok iff each is < p
    (Field.try_from_random_bytes). Rp64 digest elements are canonical, so ok
    always holds; the check stays for exactness. (The JAX decoder's
    ``from_words`` form, for byte-hasher digests, comes with those hashers.)"""

    def decode(cand):
        vals = cand[:degree]
        ok = bool(gl._ult(vals, gl._s64(p)).all())
        return ok, vals

    return decode


# ================================================================================
# The draw kernel, its plain version, and the draw functions
# ================================================================================


def draw_plain(cands, seed, counter0: int, k: int, d: int):
    """The serial loop of ``draw_kernel`` in plain PyTorch (reads the
    device to test each candidate): (elems (k, d), counter (1,))."""
    decode = u64_ext_decoder(P, d)
    elems, ctr, j = [], counter0, 0
    for _ in range(k):
        for _ in range(MAX_TRIES):
            ctr += 1
            if j < cands.shape[0]:
                digest = cands[j, 4:8]
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


def make_draw(next_candidates, degree: int):
    """``draw(seed, k=1, counter=0) -> (elems (k, degree), counter (1,))``:
    k consecutive draws with the host coin's counter semantics; the k
    candidates are permuted in one launch, the rejection loop runs in the
    draw kernel on the card (its plain version on the CPU)."""

    def draw(seed, k: int = 1, counter: int = 0):
        cands = next_candidates(seed, counter, k)
        if seed.device.type == "cpu":
            return draw_plain(cands, seed, counter, k, degree)
        return draw_kernel(cands, seed, counter, k, degree)

    return draw


def make_draw_k(draw):
    """``draw_k(seed, k, method) -> (elems (k, d), counter)``: the
    composition-coefficient draw (air/src/air/coefficients.rs): 'linear' = k
    independent draws, 'algebraic' = powers 1, a, a², ... of one draw,
    'horner' = those powers reversed."""

    def draw_k(seed, k: int, method: str = "linear"):
        if method == "linear":
            return draw(seed, k)
        if method not in ("algebraic", "horner"):
            raise ValueError(f"unknown batching method {method!r}")
        alpha, counter = draw(seed, 1)
        elems = gl.ext_power_table(alpha[0], k)
        return (elems.flip(0) if method == "horner" else elems), counter

    return draw_k


@lru_cache(maxsize=None)
def coin_bundle(kind: str, degree: int, eng_name: str = "f64"):
    """(merge, draw) for a prover configuration; only Rp64_256 over f64 has a
    device coin in the port so far (the byte hashers and Rp62_248 come with
    their slices)."""
    if kind != "rp64_256" or eng_name != "f64":
        raise ValueError(f"no device coin for {kind!r} over {eng_name!r}")
    merge, next_candidates = rp64_coin_ops()
    return merge, make_draw(next_candidates, degree)
