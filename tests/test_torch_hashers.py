"""The f64 hashers of the port against the JAX package: the host hashers
(Blake3_256, Blake3_192, Sha3_256, Rp64_256, RpJive64_256) against
winterfell_tpu.crypto.hashers, the native BLAKE3 against its pure-Python
copy, the plain row hashes, merges and Merkle trees of ops/blake3.py,
ops/sha3.py and ops/jive.py against the JAX device functions on XLA:CPU, and
the byte-hasher device coin against the host DefaultRandomCoin. Exact
equality throughout: every value is an integer. One test item runs the four
checks in turn (the tier-1 run's xdist chunks are sized from the item
count)."""

import jax
import numpy as np
import pytest
import torch

from winterfell_tpu.crypto import hashers as jax_hashers
from winterfell_tpu.math.fields import F64 as JAX_F64
from winterfell_tpu.math.fields import Field as JaxField
from winterfell_tpu.ops import blake3_device, jive_device, sha3_device
from winterfell_tpu_torch.crypto import blake3_host, native
from winterfell_tpu_torch.crypto import hashers as port_hashers
from winterfell_tpu_torch.crypto.random_coin import DefaultRandomCoin
from winterfell_tpu_torch.math.fields import F64, Field
from winterfell_tpu_torch.ops import blake3, device_coin, jive, sha3
from winterfell_tpu_torch.ops.words import rows_from_u64

jax.config.update("jax_platforms", "cpu")

P = F64.p
# row widths in elements: the trace (2), the composition at CUBIC (3), a
# FRI layer at folding 8 (8·3 = 24: 192 bytes, more than one SHA3 rate
# block), and the widths between
WIDTHS = (1, 2, 3, 8, 24)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for torch: small tensors, shared cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64)
                            .view(np.int64))


def _t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _elements(rng, shape) -> np.ndarray:
    """Canonical elements with the corners 0 and p − 1 in the first row."""
    a = rng.integers(0, P, size=shape, dtype=np.uint64)
    a[0, 0] = P - 1
    a.flat[-1] = 0
    return a


def _host_hashers_equal_jax_host_hashers():
    """hash, merge, merge_many, merge_with_int and hash_elements of every
    hasher (Rp62_248's as well; its f62 pins are in test_torch_f62.py), on
    random bytes, digests, counters (both sides of p) and element lists of
    each extension degree."""
    rng = np.random.default_rng(11)
    assert set(port_hashers.HASHERS) == set(jax_hashers.HASHERS)
    for name, port in port_hashers.HASHERS.items():
        ref = jax_hashers.HASHERS[name]
        assert (port.digest_size, port.collision_resistance, port.name) == \
            (ref.digest_size, ref.collision_resistance, ref.name)
        for n in (0, 1, 7, 8, 13, 64, 65, 136, 137, 1025):
            data = rng.bytes(n)
            assert port.hash(data) == ref.hash(data), (name, n)
        digests = [rng.bytes(port.digest_size) for _ in range(5)]
        assert port.merge(digests[0], digests[1]) == \
            ref.merge(digests[0], digests[1])
        for k in (1, 2, 5):
            assert port.merge_many(digests[:k]) == ref.merge_many(digests[:k])
        for v in (0, 1, 2**32, P - 1, P, P + 7, 2**64 - 1):
            assert port.merge_with_int(digests[2], v) == \
                ref.merge_with_int(digests[2], v), (name, v)
        for d in (1, 2, 3):
            for k in (1, 3, 4, 5, 9):
                elems = [tuple(int(x) for x in row)
                         for row in _elements(rng, (k, d))]
                assert port.hash_elements(elems, Field(F64, d)) == \
                    ref.hash_elements(elems, JaxField(JAX_F64, d)), \
                    (name, d, k)


def _native_blake3_equals_python_blake3():
    """The library built from native/blake3.c against the pure-Python
    BLAKE3: one-shot hashes (one chunk and several), many rows in one call,
    and the grinding scan against the serial Python loop."""
    assert native.available(), "the C compiler did not build native/blake3.c"
    rng = np.random.default_rng(12)
    for n in (0, 1, 63, 64, 65, 1023, 1024, 1025, 4096, 5000):
        data = rng.bytes(n)
        assert native.blake3(data) == blake3_host.blake3(data), n
    rows = rng.bytes(7 * 48)
    assert native.blake3_many(rows, 7, 48) == \
        [blake3_host.blake3(rows[48 * i : 48 * (i + 1)]) for i in range(7)]
    for seed_len, zeros in ((32, 6), (24, 5), (32, 0)):
        seed = rng.bytes(seed_len)
        nonce = 1
        while True:
            head = int.from_bytes(blake3_host.blake3(
                seed + nonce.to_bytes(8, "little"))[:8], "little")
            if head and (head & -head).bit_length() - 1 >= zeros:
                break
            nonce += 1
        assert native.blake3_grind(seed, zeros) == nonce


def _plain_row_hashes_equal_jax_device_functions():
    """The plain row hash, merge and Merkle levels of each new hasher (the
    CPU path of the kernel wrappers) against blake3_device, sha3_device and
    jive_device at the widths of the main path (the widest over two SHA3
    rate blocks), and a row over one BLAKE3 chunk (refused on both
    sides)."""
    rng = np.random.default_rng(13)
    for k in WIDTHS:
        rows = _elements(rng, (6, k))
        words, byte_len = rows_from_u64(_t64(rows))
        j_words, j_len = blake3_device.rows_from_u64(rows)
        assert byte_len == j_len and (_u32(words) == np.asarray(j_words)).all()
        for dw in (8, 6) if k == 2 else (8,):  # 6: Blake3_192's truncation
            assert (_u32(blake3.blake3_hash_words(words, byte_len, dw))
                    == np.asarray(blake3_device.blake3_hash_words(
                        j_words, j_len, dw))).all(), (k, dw)
        assert (_u32(sha3.sha3_hash_words(words, byte_len))
                == np.asarray(sha3_device.sha3_hash_words(j_words, j_len,
                                                          8))).all(), k
        assert (jive.jive_hash_rows(_t64(rows)).numpy().view(np.uint64)
                == np.asarray(jive_device.jive_hash_rows(rows))).all(), k
    with pytest.raises(AssertionError, match="one chunk"):
        blake3_device.blake3_hash_words(np.zeros((2, 260), np.uint32), 1040)
    with pytest.raises(ValueError, match="one chunk"):
        blake3.blake3_hash_words(torch.zeros((2, 260), dtype=torch.int32),
                                 1040)

    # merges of a level's sibling pairs (strided views), and whole trees
    for dw, merge, levels, j_merge, j_levels in (
            (8, blake3.blake3_merge_rows, blake3.blake3_merkle_levels,
             blake3_device.blake3_merge_rows,
             blake3_device.merkle_levels_blake3),
            (6, blake3.blake3_merge_rows, blake3.blake3_merkle_levels,
             blake3_device.blake3_merge_rows,
             blake3_device.merkle_levels_blake3),
            (8, sha3.sha3_merge_rows, sha3.sha3_merkle_levels,
             sha3_device.sha3_merge_rows, sha3_device.merkle_levels_sha3)):
        leaves = rng.integers(0, 2**32, size=(16, dw), dtype=np.uint32)
        leaves[0] = 2**32 - 1
        t = _t32(leaves)
        assert (_u32(merge(t[0::2], t[1::2])) == np.asarray(
            j_merge(leaves[0::2], leaves[1::2]))).all(), dw
        got = [_u32(lv) for lv in levels(t)]
        want = [np.asarray(lv) for lv in j_levels(leaves)]
        assert len(got) == len(want) == 4
        assert all((a == b).all() for a, b in zip(got, want)), dw
    leaves = _elements(rng, (16, 4))
    assert (jive.jive_merge_rows_plain(_t64(leaves[0::2]),
                                       _t64(leaves[1::2]))
            .numpy().view(np.uint64) == np.asarray(jive_device.jive_merge_rows(
                leaves[0::2], leaves[1::2]))).all()
    got = [lv.numpy().view(np.uint64) for lv in jive.jive_merkle_levels(
        _t64(leaves))]
    want = [np.asarray(lv) for lv in jive_device.merkle_levels_jive(leaves)]
    assert len(got) == len(want) == 4
    assert all((a == b).all() for a, b in zip(got, want))


def _byte_coin_equals_host_coin():
    """coin_bundle of each byte kind on the CPU against the host
    DefaultRandomCoin: reseed, k draws of each extension degree and the
    counter after them; then the rejection path, with a candidate >= p
    planted, against the host coin's own rejection (a seed whose candidate
    is rejected, found by scanning seeds)."""
    rng = np.random.default_rng(14)
    for kind in ("blake3_256", "blake3_192", "sha3_256"):
        hasher = port_hashers.HASHERS[kind]
        for d in (1, 2, 3):
            coin = DefaultRandomCoin(hasher, [(3,), (d,)], Field(F64, 1))
            root = rng.bytes(hasher.digest_size)
            merge, draw = device_coin.coin_bundle(kind, d)
            seed = merge(device_coin.seed_tensor(coin.seed, "cpu", kind),
                         device_coin.seed_tensor(root, "cpu", kind))
            coin.reseed(root)
            assert device_coin.words_to_seed(seed.numpy()) == coin.seed
            elems, counter = draw(seed, 4)
            want = [coin.draw(Field(F64, d)) for _ in range(4)]
            assert [tuple(int(x) for x in row)
                    for row in elems.numpy().view(np.uint64)] == want
            assert int(counter[0]) == coin.counter == 4
        # a planted rejection: the candidate for counter 2 becomes >= p, so
        # the draw loop hashes counters past the given candidates itself
        _, next_candidates = device_coin.byte_coin_ops(kind)
        seed = device_coin.seed_tensor(rng.bytes(hasher.digest_size), "cpu",
                                       kind)
        cands = next_candidates(seed, 0, 3).clone()
        cands[1, :2] = -1
        elems, counter = device_coin.draw_plain(cands, seed, 0, 3, 2, kind)
        host = DefaultRandomCoin(hasher, [], Field(F64, 1))
        host.seed = device_coin.words_to_seed(seed.numpy())
        ok = [host.draw(Field(F64, 2)) for _ in range(4)]
        assert int(counter[0]) == 4
        assert [tuple(int(x) for x in row)
                for row in elems.numpy().view(np.uint64)] == \
            [ok[0], ok[2], ok[3]]


def test_port_hashers_equal_jax():
    """Host hashers, native BLAKE3, the plain B10-B12 functions and the byte
    coin, each against its JAX or host counterpart."""
    _host_hashers_equal_jax_host_hashers()
    _native_blake3_equals_python_blake3()
    _plain_row_hashes_equal_jax_device_functions()
    _byte_coin_equals_host_coin()
