"""Plain versions of the port's Rescue kernels (K1 row hash, K2 merge, in
winterfell_tpu_torch.ops.rescue) and the Merkle levels built from them,
against the JAX package: its jnp engine (winterfell_tpu.ops.goldilocks, the
path its CPU runs take) and its exact host hasher and Merkle tree."""

import jax
import numpy as np
import pytest
import torch

from winterfell_tpu.crypto.hashers import Rp64_256
from winterfell_tpu.crypto.merkle import MerkleTree
from winterfell_tpu.math.fields import F64, Field
from winterfell_tpu.ops import goldilocks as jgl
from winterfell_tpu_torch.ops import goldilocks as tgl
from winterfell_tpu_torch.ops import rescue

jax.config.update("jax_platforms", "cpu")

P = F64.p
WIDTHS = [1, 2, 3, 7, 8, 9, 12, 16, 24]


def _rows(seed, m, k):
    rows = np.random.default_rng(seed).integers(0, P, size=(m, k),
                                                dtype=np.uint64)
    rows[0, :] = P - 1  # every carry path
    rows[1, :] = 0
    return rows


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _u64(t):
    return t.numpy().view(np.uint64)


def _digest(row_u64) -> bytes:
    return np.ascontiguousarray(row_u64.astype("<u8")).tobytes()


@pytest.mark.parametrize("k", WIDTHS)
def test_hash_rows_plain_matches_host_hasher(k):
    rows = _rows(k, 6, k)
    got = _u64(rescue.rp64_hash_rows_plain(_t(rows)))
    f = Field(F64, 1)
    for i in range(rows.shape[0]):
        expected = Rp64_256.hash_elements([(int(v),) for v in rows[i]], f)
        assert _digest(got[i]) == expected


@pytest.mark.parametrize("k", WIDTHS)
def test_hash_rows_plain_matches_jax_engine(k):
    rows = _rows(50 + k, 40, k)
    expected = np.asarray(jgl.rp64_hash_rows(jgl.jnp.asarray(rows)))
    assert np.array_equal(_u64(rescue.rp64_hash_rows_plain(_t(rows))),
                          expected)
    # the wrapper takes the plain version for a CPU tensor
    assert np.array_equal(_u64(tgl.rp64_hash_rows(_t(rows))), expected)


def test_merge_rows_plain_matches_jax_engine_and_host():
    left, right = _rows(7, 40, 4), _rows(8, 40, 4)
    expected = np.asarray(jgl.rp64_merge_rows(jgl.jnp.asarray(left),
                                              jgl.jnp.asarray(right)))
    got = _u64(rescue.rp64_merge_rows_plain(_t(left), _t(right)))
    assert np.array_equal(got, expected)
    assert np.array_equal(_u64(rescue.rp64_merge_rows(_t(left), _t(right))),
                          expected)
    for i in range(4):
        assert _digest(got[i]) == Rp64_256.merge(_digest(left[i]),
                                                 _digest(right[i]))


@pytest.mark.parametrize("log_leaves", range(1, 9))
def test_merkle_levels_match_host_tree(log_leaves):
    m = 1 << log_leaves
    leaves = _rows(70 + log_leaves, m, 4)
    levels = tgl.merkle_levels_rp64(_t(leaves))
    tree = MerkleTree([_digest(r) for r in leaves], Rp64_256)
    assert [lvl.shape[0] for lvl in levels] == [m >> i for i in
                                                range(1, log_leaves + 1)]
    for lvl in levels:
        size = lvl.shape[0]
        nodes = [_digest(r) for r in _u64(lvl)]
        assert nodes == tree.nodes[size : 2 * size]
    # a single leaf is its own root: no internal level
    assert rescue.rp64_merkle_levels(_t(leaves[:1])) == []


def test_merkle_levels_match_jax_engine():
    leaves = _rows(99, 16, 4)
    nodes = jgl.merkle_build_rp64(jgl.jnp.asarray(leaves))
    levels = tgl.merkle_levels_rp64(_t(leaves))
    plain = rescue.rp64_merkle_levels_plain(_t(leaves))
    assert len(levels) == len(plain) == 4
    for lvl, want in zip(levels, plain):
        size = lvl.shape[0]
        assert np.array_equal(_u64(lvl), nodes[size : 2 * size])
        assert torch.equal(lvl, want)
    # the launches of the tree kernel on a card merge every level once,
    # largest first, each from the level the one before left; all but the
    # last leave at least the tail's nodes, and the last is one block
    tail = 1 << rescue._TREE_TAIL_LOG
    for log_n in range(0, 26):
        plan = rescue._tree_plan(log_n)
        lg = log_n
        for i, (src, b) in enumerate(plan):
            assert src == lg and 1 <= b <= rescue._TREE_CHUNK_LOG
            lg -= b
            if i < len(plan) - 1:
                assert 1 << lg >= tail
            else:
                assert lg == 0 and (1 << src) <= tail
        assert lg == 0 and (log_n > 0) == bool(plan)
    # the trees of a resident 2^18 fib prove (LDE 2^21, five FRI layers)
    assert sum(len(rescue._tree_plan(n)) for n in (21, 21, 18, 15, 12, 9, 6)) \
        == 15


def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError):
        rescue.rp64_hash_rows(torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        rescue.rp64_hash_rows(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        rescue.rp64_merge_rows(torch.zeros((4, 4), dtype=torch.int64),
                               torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        rescue.rp64_hash_rows(torch.zeros((4, 2), dtype=torch.int64,
                                          device="meta"))
    # the tree: power-of-two leaf counts of (n, 4) int64 rows, contiguous,
    # on the CPU or a card
    for bad in (_z(3, 4), _z(0, 4), _z(4, 3), _z(4), _z(8, 4)[0::2],
                torch.zeros((4, 4), dtype=torch.int64, device="meta")):
        with pytest.raises(ValueError):
            rescue.rp64_merkle_levels(bad)
    with pytest.raises(TypeError):
        rescue.rp64_merkle_levels(torch.zeros((4, 4), dtype=torch.int32))


def _z(*shape):
    return torch.zeros(shape, dtype=torch.int64)


# layouts the kernels cannot read; the wrappers refuse them on every device
@pytest.mark.parametrize("call", [
    lambda: rescue.rp64_merge_rows(_z(1, 8)[:, ::2], _z(1, 4)),
    lambda: rescue.rp64_merge_rows(_z(1, 4), _z(1, 8)[:, ::2]),
    lambda: rescue.rp64_merge_rows(_z(3, 4), _z(3, 8)[:, ::2]),
    lambda: rescue.rp64_merge_rows(_z(4, 4), _z(8, 4)[0::2]),
    lambda: rescue.rp64_hash_rows(_z(4, 4)[:, ::2]),
    lambda: rescue.rp64_hash_rows(_z(4, 0)),
], ids=["merge-m1-left", "merge-m1-right", "merge-elem-stride",
        "merge-row-strides", "hash-noncontiguous", "hash-empty-rows"])
def test_wrappers_refuse_layouts_the_kernels_cannot_read(call):
    with pytest.raises(ValueError):
        call()


def test_merge_rows_takes_sibling_views_of_one_level():
    level = _t(_rows(4, 16, 4))
    got = rescue.rp64_merge_rows(level[0::2], level[1::2])
    want = rescue.rp64_merge_rows_plain(level[0::2].contiguous(),
                                        level[1::2].contiguous())
    assert torch.equal(got, want)


def test_launch_counts_only_count_kernel_launches():
    rescue.reset_launches()
    rescue.rp64_hash_rows(_t(_rows(1, 8, 3)))
    rescue.rp64_merge_rows(_t(_rows(2, 8, 4)), _t(_rows(3, 8, 4)))
    rescue.rp64_merkle_levels(_t(_rows(4, 8, 4)))
    assert rescue.LAUNCHES == {"rp64_hash_rows": 0, "rp64_merge_rows": 0,
                               "rp64_merkle_tree": 0}
