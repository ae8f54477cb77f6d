"""The port's device coin (winterfell_tpu_torch.ops.device_coin) on CPU tensors
against the JAX package's host DefaultRandomCoin for Rp64_256: reseed then
draw sequences, and the composition-coefficient draws (linear, algebraic,
horner) for extension degrees 1, 2 and 3, with the counters. The JAX device
coin is pinned to the same host coin by tests/test_device_coin.py."""

import numpy as np
import pytest
import torch

from winterfell_tpu.air.coefficients import _draw
from winterfell_tpu.air.options import BatchingMethod
from winterfell_tpu.crypto.hashers import Rp64_256, rp64_permutation
from winterfell_tpu.crypto.random_coin import DefaultRandomCoin
from winterfell_tpu.math.fields import F64, Field
from winterfell_tpu_torch.ops import device_coin as dc
from winterfell_tpu_torch.ops import goldilocks as gl

P = F64.p
BASE = Field(F64, 1)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint64)


def _rows(t: torch.Tensor):
    return [tuple(int(v) for v in row) for row in _u64(t)]


def _coin(tag: int) -> DefaultRandomCoin:
    return DefaultRandomCoin(Rp64_256, [(tag,), (tag + 1,)], BASE)


def _root(i: int) -> bytes:
    return Rp64_256.hash_elements([(i,), (i * i,)], BASE)


def test_reseed_then_draw_sequences_match_host_coin():
    for d in (1, 2, 3):
        ext = Field(F64, d)
        coin = _coin(d)
        merge, draw = dc.coin_bundle("rp64_256", d, "f64")
        seed = dc.seed_tensor(coin.seed, "cpu")
        assert dc.u64_to_seed(_u64(seed)) == coin.seed
        for i, k in ((0, 1), (1, 2)):
            coin.reseed(_root(i))
            seed = merge(seed, dc.seed_tensor(_root(i), "cpu"))
            assert dc.u64_to_seed(_u64(seed)) == coin.seed
            expected = [coin.draw(ext) for _ in range(k)]
            elems, counter = draw(seed, k)
            assert _rows(elems) == expected, (d, i)
            assert counter.tolist() == [coin.counter] == [k]


def test_draw_k_matches_host_coefficient_draws():
    """air/src/air/coefficients.rs: k independent draws, or the powers of
    one draw (reversed for horner), for degrees 1, 2, 3; the counter after
    the draw too."""
    for d in (1, 2, 3):
        ext = Field(F64, d)
        merge, draw = dc.coin_bundle("rp64_256", d, "f64")
        seed = merge(dc.seed_tensor(_coin(10 + d).seed, "cpu"),
                     dc.seed_tensor(_root(d), "cpu"))
        for method in ("linear", "algebraic", "horner"):
            coin = _coin(10 + d)
            coin.reseed(_root(d))
            expected = _draw(coin, ext, 5, BatchingMethod[method.upper()])
            elems, counter = dc.make_draw_k(draw, gl)(seed, 5, method)
            assert _rows(elems) == expected, (d, method)
            assert counter.tolist() == [coin.counter]


def test_candidates_are_merge_with_int():
    """next_candidates permutes the states of merge_with_int(seed, c) for
    c = counter0 + 1 .. counter0 + t (rp64_256/mod.rs:235-254)."""
    seed_bytes = _coin(3).seed
    _, next_candidates = dc.rp64_coin_ops()
    states = next_candidates(dc.seed_tensor(seed_bytes, "cpu"), 6, 3)
    got = [dc.u64_to_seed(_u64(states[j, 4:8])) for j in range(3)]
    assert got == [Rp64_256.merge_with_int(seed_bytes, c) for c in (7, 8, 9)]


def test_permute_rows_plain_matches_host_permutation():
    rng = np.random.default_rng(5)
    states = rng.integers(0, P, size=(3, 12), dtype=np.uint64)
    states[0] = P - 1
    got = _u64(dc.permute_rows(torch.from_numpy(states.view(np.int64))))
    for row, out in zip(states, got):
        assert [int(v) for v in out] == rp64_permutation(
            [int(v) for v in row])


def test_draw_plain_rejects_and_continues_like_the_serial_loop():
    """A rejected candidate (an element >= p) is skipped with its counter
    spent, and draws past the given candidates compute their own: the
    result equals the host coin's serial loop over the same candidates."""
    d, k = 2, 3
    seed_bytes = _coin(4).seed
    seed = dc.seed_tensor(seed_bytes, "cpu")
    _, next_candidates = dc.rp64_coin_ops()
    cands = next_candidates(seed, 0, k).clone()
    cands[1, 5] = -1  # 2^64 - 1 in the second element: counter 2 rejected
    elems, counter = dc.draw_plain(cands, seed, 0, k, d)

    def elem(c):
        digest = np.frombuffer(Rp64_256.merge_with_int(seed_bytes, c), "<u8")
        return tuple(int(v) for v in digest[:d])

    assert _rows(elems) == [elem(1), elem(3), elem(4)]
    assert counter.tolist() == [4]
    # the host coin's draws over the unmodified candidates
    coin = _coin(4)
    assert [coin.draw(Field(F64, d)) for _ in range(2)] == [elem(1), elem(2)]


def test_draw_kernel_takes_only_cuda_tensors():
    seed = torch.zeros(4, dtype=torch.int64)
    cands = torch.zeros((1, 12), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dc.draw_kernel(cands, seed, 0, 1, 3)


def test_only_the_rp64_coin_is_ported():
    """The f64 coins are ported (Rp64_256 and, since the byte hashers came,
    Blake3_256, Blake3_192 and Sha3_256); Rp62_248 and the limb engines'
    coins are not yet, and RpJive64_256 has none, as in the reference."""
    for kind in ("rp64_256", "blake3_256", "blake3_192", "sha3_256"):
        dc.coin_bundle(kind, 3, "f64")
    for kind in ("rp62_248", "rp_jive64_256"):
        with pytest.raises(ValueError):
            dc.coin_bundle(kind, 3, "f64")
    with pytest.raises(ValueError):
        dc.coin_bundle("rp64_256", 3, "f128")
    with pytest.raises(ValueError):
        dc.coin_bundle("blake3_256", 3, "f128")
