"""The port's CUDA kernels and prover on the card. Every test here needs a
CUDA device and skips without one (decided in the fixture, at run time).

Run on a machine with the card:

    python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from winterfell_tpu_torch import FieldExtension, ProofOptions, Rp64_256, F64
from winterfell_tpu_torch import F128
from winterfell_tpu_torch.crypto.hashers import Blake3_256, RpJive64_256
from winterfell_tpu_torch.examples import fibonacci as tfib
from winterfell_tpu_torch.examples import rescue_raps
from winterfell_tpu_torch.ops import blake3, device_coin, field_kernels, jive
from winterfell_tpu_torch.ops import rescue, sha3
from winterfell_tpu_torch.ops import goldilocks as gl
from winterfell_tpu_torch.prover import device as prover_device
from winterfell_tpu_torch.ops.device_hashers import DEVICE_HASHERS
from winterfell_tpu_torch.ops.words import rows_from_u64
from winterfell_tpu_torch.prover import device_limb
from winterfell_tpu_torch.prover.device import GoldilocksProver
from winterfell_tpu_torch.prover.device_limb import F128Prover
from winterfell_tpu_torch.utils import tracing

pytestmark = pytest.mark.gpu

P = F64.p


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(seed, shape, device, high=P):
    a = np.random.default_rng(seed).integers(0, high, size=shape,
                                             dtype=np.uint64)
    a.flat[0], a.flat[-1] = P - 1, 0
    return torch.from_numpy(a.view(np.int64)).to(device)


# canonical values next to which a slip in a lazy reduction shows
CORNERS = [0, 1, 2**32 - 1, 2**32, 2**63, P - 2**32, P - 2, P - 1]


def _corners(rows, k, device):
    """(rows, k) of corner values only: rows 0..7 each one corner repeated,
    later rows mixes of them."""
    r, j = np.arange(rows)[:, None], np.arange(k)[None, :]
    idx = np.where(r < len(CORNERS), r, 3 * r + 5 * j) % len(CORNERS)
    a = np.array(CORNERS, dtype=np.uint64)[idx]
    return torch.from_numpy(a.view(np.int64)).to(device)


def _words(seed, shape, device):
    """Random u32 words as int32, the first row all ones."""
    a = np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                             dtype=np.uint32)
    a[0] = 2**32 - 1
    return torch.from_numpy(a.view(np.int32)).to(device)


@pytest.mark.parametrize("k", [1, 2, 3, 7, 8, 9, 12, 16, 24])
@pytest.mark.parametrize("m", [1, 256, 1000])
def test_hash_rows_kernel_equals_plain(cuda, m, k):
    """K1 and the row hashes of B10 (BLAKE3, 8 and 6 digest words), B11
    (SHA3; 24 elements are more than one rate block) and B12 (Jive), on
    random and corner rows."""
    rows = _rand(m * 31 + k, (m, k), cuda)
    corners = _corners(m, k, cuda)
    for x in (rows, corners):
        assert torch.equal(rescue.rp64_hash_rows(x),
                           rescue.rp64_hash_rows_plain(x))
        assert torch.equal(jive.jive_hash_rows(x), jive.jive_hash_rows_plain(x))
        words, byte_len = rows_from_u64(x)
        assert torch.equal(sha3.sha3_hash_words(words, byte_len),
                           sha3.sha3_hash_words_plain(words, byte_len))
        for dw in (8, 6):
            assert torch.equal(
                blake3.blake3_hash_words(words, byte_len, dw),
                blake3.blake3_hash_words_plain(words, byte_len, dw)), dw


@pytest.mark.parametrize("m", [1, 3, 1 << 10, 1 << 16])
def test_merge_rows_kernel_equals_plain(cuda, m):
    left, right = _rand(m, (m, 4), cuda), _rand(m + 1, (m, 4), cuda)
    assert torch.equal(rescue.rp64_merge_rows(left, right),
                       rescue.rp64_merge_rows_plain(left, right))
    level = _rand(m + 2, (2 * m, 4), cuda)  # sibling pairs of one level
    assert torch.equal(rescue.rp64_merge_rows(level[0::2], level[1::2]),
                       rescue.rp64_merge_rows_plain(level[0::2], level[1::2]))
    corners = _corners(2 * m, 4, cuda)
    assert torch.equal(rescue.rp64_merge_rows(corners[0::2], corners[1::2]),
                       rescue.rp64_merge_rows_plain(corners[0::2],
                                                    corners[1::2]))
    # the tree kernel at leaf counts near m: each side of the one-block tail
    # and of a multi-level block, random and corner leaves
    tail, chunk = 1 << rescue._TREE_TAIL_LOG, 1 << rescue._TREE_CHUNK_LOG
    sizes = {1: (1, 2, 4), 3: (tail // 2, tail, 2 * tail),
             1 << 10: (chunk, 2 * chunk, tail * chunk),
             1 << 16: (2 * tail * chunk, 1 << 21)}[m]
    for n in sizes:
        for leaves in (_rand(n + 7, (n, 4), cuda), _corners(n, 4, cuda)):
            for levels, plain in (
                    (rescue.rp64_merkle_levels,
                     rescue.rp64_merkle_levels_plain),
                    (jive.jive_merkle_levels, jive.jive_merkle_levels_plain)):
                got, want = levels(leaves), plain(leaves)
                assert len(got) == len(want), n
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (n, a.shape[0])
    # B10 (8 and 6 digest words) and B11: a level's sibling merges and the
    # tree at the same leaf counts, on random words (the first all ones)
    for w, merge, merge_plain, levels, levels_plain in (
            (8, blake3.blake3_merge_rows, blake3.blake3_merge_rows_plain,
             blake3.blake3_merkle_levels, blake3.blake3_merkle_levels_plain),
            (6, blake3.blake3_merge_rows, blake3.blake3_merge_rows_plain,
             blake3.blake3_merkle_levels, blake3.blake3_merkle_levels_plain),
            (8, sha3.sha3_merge_rows, sha3.sha3_merge_rows_plain,
             sha3.sha3_merkle_levels, sha3.sha3_merkle_levels_plain)):
        level = _words(m + 3, (2 * m, w), cuda)
        assert torch.equal(merge(level[0::2], level[1::2]),
                           merge_plain(level[0::2], level[1::2])), (w, m)
        for n in sizes:
            leaves = _words(n, (n, w), cuda)
            got, want = levels(leaves), levels_plain(leaves)
            assert len(got) == len(want), (w, n)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (w, n, a.shape[0])


def test_gl_mul_kernel_equals_plain_over_all_u64(cuda):
    for n in (1, 1000, 1 << 21):
        a, b = _rand(n, (n,), cuda, 2**64), _rand(n + 1, (n,), cuda, 2**64)
        got = field_kernels.gl_mul_kernel(a, b)
        assert torch.equal(got, field_kernels.gl_mul_plain(a, b)), n
        assert torch.equal(gl.gl_mul(a, b), got)  # the routed entry point
        head = got[:64].cpu().numpy().view(np.uint64)
        a_h = a[:64].cpu().numpy().view(np.uint64)
        b_h = b[:64].cpu().numpy().view(np.uint64)
        assert [int(v) for v in head] == [int(x) * int(y) % P
                                          for x, y in zip(a_h, b_h)]


def test_gl_mul_kernel_reads_broadcast_strided_and_int_operands(cuda,
                                                               monkeypatch):
    x = _rand(7, (64, 2, 16, 3), cuda, 2**64)
    y = _rand(8, (4, 256), cuda, 2**64)
    cases = [(x[:, 1], x[:, 0]), (x[:, 1], x[0, :1, :, :1]),
             (y[..., 9:], y[..., :-9]), (x[..., 2], x[..., 0]),
             (x, x[0, 0, 0]), (y, 2**64 - 1), (y, gl.const(3)),
             (y[:, 5], y[:, 6])]
    # eight dims that no neighbour can merge with: the kernel's most
    deep = _rand(9, (2, 3, 2, 3, 2, 3, 2, 2), cuda, 2**64).permute(
        *range(7, -1, -1))
    cases.append((deep, deep[..., :1]))
    for a, b in cases:
        assert torch.equal(field_kernels.gl_mul_kernel(a, b),
                           field_kernels.gl_mul_plain(a, b))
    # a product above a lowered INDEX_LIMIT is split into several launches
    x, y = _rand(3, (64, 100), cuda, 2**64), _rand(4, (100,), cuda, 2**64)
    monkeypatch.setattr(field_kernels, "INDEX_LIMIT", 1000)
    field_kernels.reset_launches()
    got = field_kernels.gl_mul_kernel(x, y)
    assert field_kernels.LAUNCHES["gl_mul"] > 1
    assert torch.equal(got, field_kernels.gl_mul_plain(x, y))


def test_f64_engine_kernels_equal_plain(cuda, monkeypatch):
    """B0 (add, subtract) and B0x (quadratic and cubic products) over random
    u64 patterns with every pair of the corner set and patterns >= p, at
    the prover's operand layouts and split above a lowered INDEX_LIMIT; B4
    (whole NTTs of its stages, the first reading bit-reversed) at 2 ...
    2^12 rows; B5 (the FRI fold) at N = 2, 4, 8, 16 and D = 1, 2, 3."""
    corners = CORNERS + [P, P + 1, 2**64 - 2**32, 2**64 - 1]
    pairs = [(x, y) for x in corners for y in corners]
    n = 1 << 16
    a, b = _rand(21, (n,), cuda, 2**64), _rand(22, (n,), cuda, 2**64)
    for t, vals in ((a, [x for x, _ in pairs]), (b, [y for _, y in pairs])):
        t[: len(pairs)] = torch.from_numpy(
            np.array(vals, dtype=np.uint64).view(np.int64)).to(cuda)
    x = _rand(23, (64, 2, 16, 3), cuda, 2**64)
    for name in ("gl_add", "gl_sub"):
        plain = getattr(field_kernels, f"{name}_plain")
        for u, v in ((a, b), (a, 2**64 - 1), (a, gl.const(3)),
                     (x[:, 1], x[:, 0]), (x, x[0, :1, :, :1]),
                     (x[..., 2], x[..., 0])):
            assert torch.equal(field_kernels.op_kernel(name, u, v),
                               plain(u, v))
    assert torch.equal(gl.gl_neg(a), field_kernels.gl_sub_plain(
        torch.zeros((), dtype=torch.int64, device=cuda), a))
    for d in (2, 3):
        e = a[: n // d * d].reshape(-1, d)
        f = b[: n // d * d].reshape(-1, d)
        polys, pows2 = e[:1024].reshape(128, 8, d), f[:256].reshape(128, 2, d)
        for u, v in ((e, f), (e, f[5].expand_as(e)),
                     (polys[:, :, None], pows2[:, None].expand(128, 8, 2, d)),
                     (e[::2][:1000], f[1::2][:1000]), (e, f[7][None])):
            assert torch.equal(field_kernels.ext_mul_kernel(u, v),
                               field_kernels.ext_mul_plain(u, v)), d
    for logn in range(1, 13):
        for cols in (1, 3):
            y = _rand(logn + cols, (1 << logn, cols), cuda)
            for inverse in (False, True):
                assert torch.equal(gl._ntt_core(y, 1 << logn, inverse),
                                   gl.ntt_plain(y, 1 << logn, inverse))
    for n_fold in (2, 4, 8, 16):
        for d in (1, 2, 3):
            ev = _rand(n_fold + d, (4096, d), cuda)
            alpha = _rand(d, (d,), cuda)
            assert torch.equal(gl.fri_fold_kernel(ev, n_fold, 7, alpha),
                               gl.fri_fold_plain(ev, n_fold, 7, alpha))
    monkeypatch.setattr(field_kernels, "INDEX_LIMIT", 1000)
    field_kernels.reset_launches()
    e3 = a[:3000].reshape(1000, 3)
    for fn in (lambda: field_kernels.op_kernel("gl_add", a[:3000], b[:3000]),
               lambda: field_kernels.ext_mul_kernel(e3, e3.flip(0))):
        before = sum(field_kernels.LAUNCHES.values())
        fn()
        assert sum(field_kernels.LAUNCHES.values()) - before > 1
    assert torch.equal(field_kernels.ext_mul_kernel(e3, e3.flip(0)),
                       field_kernels.ext_mul_plain(e3, e3.flip(0)))


def test_permute_rows_kernel_equals_plain(cuda):
    for m in (1, 7, 1000):
        states = _rand(m + 5, (m, 12), cuda)
        assert torch.equal(device_coin.permute_rows(states),
                           device_coin.permute_rows_plain(states)), m


def test_coin_draw_kernel_equals_plain(cuda):
    _, next_candidates = device_coin.rp64_coin_ops()
    for k, d, reject in ((1, 3, ()), (6, 3, ()), (4, 1, (2,)), (2, 2, (0, 1))):
        seed = _rand(k, (4,), cuda)
        cands = next_candidates(seed, 0, k).clone()
        for j in reject:  # an element >= p: that counter is rejected
            cands[j, 4] = -1
        got = device_coin.draw_kernel(cands, seed, 0, k, d)
        want = device_coin.draw_plain(cands, seed, 0, k, d)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the byte coins' draw kernels, which hash the counters past a rejected
    # candidate themselves
    for kind in ("blake3_256", "blake3_192", "sha3_256"):
        dw = DEVICE_HASHERS[kind].digest_words
        _, next_candidates = device_coin.byte_coin_ops(kind)
        for k, d, reject in ((1, 3, ()), (6, 3, ()), (4, 1, (2,)),
                             (2, 2, (0, 1))):
            seed = _words(k + dw, (dw,), cuda)
            cands = next_candidates(seed, 0, k).clone()
            for j in reject:  # a u64 word >= p: that counter is rejected
                cands[j, :2] = -1
            got = device_coin.byte_draw_kernel(kind, cands, seed, 0, k, d)
            want = device_coin.draw_plain(cands, seed, 0, k, d, kind)
            assert torch.equal(got[0], want[0]), (kind, k, d, reject)
            assert torch.equal(got[1], want[1]), (kind, k, d, reject)


def test_resident_and_phased_card_proofs_equal_cpu_proof(cuda, monkeypatch):
    """Trace 2^10 (two FRI layers with bench_fib's options): every route of
    Rp64_256 and Blake3_256 (resident, phased + fused FRI, phased + host
    coin) and RpJive64_256's one (host coin) on the card give the CPU's
    bytes; the resident device runs make no host synchronisation. And the
    f128 prover's aux segment (rescue_raps) on both phased routes."""
    opts = ProofOptions(32, 8, 0, FieldExtension.CUBIC, 8, 31)
    prover_cls = GoldilocksProver.accelerate(tfib.FibSmallProver)
    checked_runs = []
    routes = ("resident", "fused", "host")
    for hasher, hasher_routes in ((Rp64_256, routes), (Blake3_256, routes),
                                  (RpJive64_256, ("host",))):
        cpu = prover_cls(opts, hasher, device="cpu").prove(
            tfib.build_fib_trace(F64, 2048))
        for route in hasher_routes:
            monkeypatch.setattr(prover_device, "_RESIDENT_ON_F64",
                                route == "resident")
            monkeypatch.setattr(prover_device, "_FUSED_FRI_ON",
                                route != "host")
            prover = prover_cls(opts, hasher)
            run = prover._resident_run

            def checked(*args, run=run, tag=(hasher.name, route), **kwargs):
                checked_runs.append(tag)
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return run(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)

            prover._resident_run = checked
            card = prover.prove(tfib.build_fib_trace(F64, 2048, device=cuda))
            assert card.to_bytes() == cpu.to_bytes(), (hasher.name, route)
    assert checked_runs == [("rp64_256", "resident"),
                            ("blake3_256", "resident")]
    # an aux segment (rescue_raps -n 8, quadratic extension) through the
    # f128 prover on both phased routes; the resident switch stays on, and
    # the dispatch must not take it
    seeds = [(i + 1, i + 2) for i in range(8)]
    raps_opts = ProofOptions(28, 8, 0, FieldExtension.QUADRATIC, 8, 31)
    raps_cls = F128Prover.accelerate(rescue_raps.RescueRapsProver)

    def raps_trace():
        return rescue_raps.build_raps_trace(seeds, seeds[2:] + seeds[:2])

    cpu = raps_cls(raps_opts, Blake3_256, device="cpu").prove(raps_trace())
    for fused in (True, False):
        monkeypatch.setattr(device_limb, "_RESIDENT_ON", True)
        monkeypatch.setattr(device_limb, "_FUSED_FRI_ON", fused)
        card = raps_cls(raps_opts, Blake3_256).prove(raps_trace())
        names = [s["name"] for s in tracing.last_spans()]
        assert "resident_pipeline" not in names
        assert ("fri_layers_fused" in names) == fused
        assert card.to_bytes() == cpu.to_bytes(), ("rescue_raps", fused)


def test_card_proof_equals_cpu_proof_and_launches_kernels(cuda):
    opts = ProofOptions(32, 8, 0, FieldExtension.CUBIC, 8, 31)
    prover_cls = GoldilocksProver.accelerate(tfib.FibSmallProver)
    rescue.reset_launches()
    field_kernels.reset_launches()
    card = prover_cls(opts, Rp64_256).prove(
        tfib.build_fib_trace(F64, 64, device=cuda))
    launches = {**rescue.LAUNCHES, **field_kernels.LAUNCHES}
    cpu = prover_cls(opts, Rp64_256, device="cpu").prove(
        tfib.build_fib_trace(F64, 64))
    assert card.to_bytes() == cpu.to_bytes()
    # a trace this small has no FRI layer (host coin): no one-row reseed
    assert launches["rp64_hash_rows"] > 0 and launches["rp64_merkle_tree"] > 0
    for name in ("gl_mul", "gl_add", "gl_sub", "gl_ext_mul", "gl_ntt_stage"):
        assert launches[name] > 0, name


def test_f62_kernels_equal_plain(cuda):
    """B14 (f62 add, subtract, multiply: random and corner values, a Python
    int, a broadcast column), B14n (whole NTTs of kernel stages), B15 (row
    hashes of 1 ... 24 elements and rows of one corner value, 1 ... 129
    rows, merges, trees of 1 ... 2^11 leaves, the coin's candidates below
    and above p62) and the f62 draws of
    the Rp62_248, BLAKE3 and SHA3 coins (rejected candidates planted: the
    kernel computes further ones itself) against their plain versions."""
    from winterfell_tpu_torch.ops import f62, rp62

    p = f62.P
    rng = np.random.default_rng(62)

    def rand(shape):
        return torch.from_numpy(rng.integers(0, p, size=shape,
                                             dtype=np.int64)).to(cuda)

    corners = [0, 1, 2, p - 2, p - 1, 2**31, 2**32 - 1, 2**61, f62.E]
    a, b = rand((4096,)), rand((4096,))
    a[:81] = torch.tensor([x for x in corners for _ in corners], device=cuda)
    b[:81] = torch.tensor([y for _ in corners for y in corners], device=cuda)
    col, ext = rand((512,)), rand((512, 3))
    for op, plain in ((f62.f62_add, f62.add_plain),
                      (f62.f62_sub, f62.sub_plain),
                      (f62.f62_mul, f62.mul_plain)):
        assert torch.equal(op(a, b), plain(a, b)), op.__name__
        assert torch.equal(op(a, 12345), plain(a, torch.tensor(12345)))
        assert torch.equal(op(ext, col[:, None]), plain(ext, col[:, None]))
    for n, cols in ((2, 1), (1024, 3), (1 << 14, 2)):
        x = rand((n, cols))
        for inverse in (False, True):
            perm, tw = f62.ntt_plan(n, inverse, cuda)
            y = x.index_select(0, perm).contiguous()
            z = y.clone()
            half = 1
            while half < n:
                y = f62.ntt_stage(y, tw, half)
                z = f62.ntt_stage_plain(z, tw, half)
                half *= 2
            assert torch.equal(y, z), (n, cols, inverse)
    # rows of one corner value in every element (p - 1, E, E + 1, 2^61,
    # p - E) at the rate edges; row counts that are no multiple of a thread
    # group or a block
    edges = torch.tensor([p - 1, f62.E, f62.E + 1, 2**61, p - f62.E],
                         device=cuda)
    for k in (1, 7, 8, 9, 16, 17, 24):
        rows = torch.cat([rand((300, k)), edges[:, None].expand(-1, k)])
        rows[0] = p - 1
        assert torch.equal(rp62.rp62_hash_rows(rows),
                           rp62.rp62_hash_rows_plain(rows)), k
    for m in (1, 3, 5, 127, 129):
        rows = rand((m, 9))
        assert torch.equal(rp62.rp62_hash_rows(rows),
                           rp62.rp62_hash_rows_plain(rows)), m
        level = rp62.pack(rand((2 * m, 4)))
        assert torch.equal(rp62.rp62_merge_rows(level[0::2], level[1::2]),
                           rp62.rp62_merge_rows_plain(level[0::2],
                                                      level[1::2])), m
    leaves = rp62.rp62_hash_rows(rand((2048, 2)))
    assert torch.equal(rp62.rp62_merge_rows(leaves[0::2], leaves[1::2]),
                       rp62.rp62_merge_rows_plain(leaves[0::2], leaves[1::2]))
    # sibling digests of equal corner elements: every rate lane of a merge
    # at p - 1, E, ...
    level = rp62.pack(edges.repeat_interleave(2)[:8, None].expand(-1, 4)
                      .contiguous())
    assert torch.equal(rp62.rp62_merge_rows(level[0::2], level[1::2]),
                       rp62.rp62_merge_rows_plain(level[0::2], level[1::2]))
    for n in (1, 2, 4, 8, 256, 512, 2048):
        got = rp62.rp62_merkle_levels(leaves[:n].contiguous())
        want = rp62.rp62_merkle_levels_plain(leaves[:n])
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), n
    seed = leaves[5]
    for c0, t in ((0, 5), (p - 2, 5), (2**64 - 8, 5), (0, 1), (p - 3, 129),
                  (2**64 - 130, 127)):
        assert torch.equal(rp62.coin_candidates(seed, c0, t),
                           rp62.coin_candidates_plain(seed, c0, t)), c0
    for kind in ("rp62_248", "blake3_256", "sha3_256"):
        _, next_candidates = device_coin.byte_coin_ops(kind)
        for k, d, reject in ((1, 3, ()), (4, 1, ()), (3, 2, (0, 1))):
            s = seed if kind == "rp62_248" else _words(k + d, (8,), cuda)
            cands = next_candidates(s, 0, k).clone()
            for j in reject:
                cands[j, :2] = -1
            got = device_coin.byte_draw_kernel(kind, cands, s, 0, k, d, "f62")
            want = device_coin.draw_plain(cands, s, 0, k, d, kind, "f62")
            assert torch.equal(got[0], want[0]), (kind, k, d, reject)
            assert torch.equal(got[1], want[1]), (kind, k, d, reject)


def test_f62_card_proofs_equal_cpu_proofs(cuda, monkeypatch):
    """f62 fib, 64 rows, cubic: Blake3_256 and Rp62_248 on the three routes
    on the card give the CPU's bytes; the resident device runs make no host
    synchronisation."""
    from winterfell_tpu_torch.crypto.hashers import Rp62_248
    from winterfell_tpu_torch.examples import fib_f62
    from winterfell_tpu_torch.prover.device_limb import F62Prover

    opts = ProofOptions(28, 8, 0, FieldExtension.CUBIC, 4, 7)
    prover_cls = F62Prover.accelerate(fib_f62.FibF62Prover)
    checked = []
    for hasher in (Blake3_256, Rp62_248):
        cpu = prover_cls(opts, hasher, device="cpu").prove(
            fib_f62.build_fib_f62_trace(64)).to_bytes()
        for route in ("resident", "fused", "host"):
            monkeypatch.setattr(device_limb, "_RESIDENT_ON",
                                route == "resident")
            monkeypatch.setattr(device_limb, "_FUSED_FRI_ON", route != "host")
            prover = prover_cls(opts, hasher)
            run = prover._resident_run

            def sync_checked(*args, run=run, tag=hasher.name, **kwargs):
                checked.append(tag)
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return run(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)

            prover._resident_run = sync_checked
            card = prover.prove(fib_f62.build_fib_f62_trace(64))
            assert card.to_bytes() == cpu, (hasher.name, route)
    assert checked == ["blake3_256", "rp62_248"]


def test_ntt_mxu_kernels_equal_plain_and_card_proof_launches_them(
        cuda, monkeypatch):
    """B16 (the f128 leaf DFT under WINTER_MXU_NTT=1): the digit product and
    the recombine against their plain versions at leaf sizes 2 ... 128, both
    directions, on random canonical values with corners in the first
    columns (digit 9, bits 63-69, across the words) and on diagonal sums at
    their maximum, batches that are no multiple of a block and chunks with
    a ragged last one; a whole NTT under the switch equals the radix-2 one;
    and an f128 fib proof under the switch on the resident (sync-checked)
    and phased routes gives the CPU's bytes, launching B16 and no B13n."""
    from winterfell_tpu_torch.ops import f128, ntt_mxu

    p = f128.P
    rng = np.random.default_rng(16)
    corners = [0, 1, p - 1, p - 2, 2**127, 2**63, 2**64, 2**64 - 1,
               0x7F << 63, 1 << 69, (1 << 69) | (1 << 63)]

    def rand(n, cols):
        w = rng.integers(0, 2**64, size=(n, cols, 2), dtype=np.uint64)
        w[..., 1] = np.minimum(w[..., 1], np.uint64(2**64 - 2))
        x = torch.from_numpy(w.view(np.int64)).to(cuda)
        k = min(cols, len(corners))
        x[:, :k] = f128.to_device(np.array(corners[:k], dtype=object),
                                  cuda)[None]
        return x

    for n in (2, 4, 8, 16, 32, 64, 128):
        for inverse in (False, True):
            wt = ntt_mxu.leaf_matrix_dev(n, inverse, cuda)
            for cols in (1, 77, 1000):
                x = rand(n, cols)
                d = ntt_mxu.digit_product_kernel(wt, x)
                assert torch.equal(d, ntt_mxu.digit_product_plain(wt, x)), \
                    (n, inverse, cols)
                assert torch.equal(ntt_mxu.recombine_kernel(d, n),
                                   ntt_mxu.recombine_plain(d, n))
                assert torch.equal(ntt_mxu.leaf_dft_kernel(x, wt, n),
                                   ntt_mxu.leaf_dft_plain(x, wt, n))
        top = torch.full((37 * n, 33), 127 * 127 * 19 * n, dtype=torch.int32,
                         device=cuda)
        assert torch.equal(ntt_mxu.recombine_kernel(top, n),
                           ntt_mxu.recombine_plain(top, n)), n
    monkeypatch.setattr(ntt_mxu, "_CHUNK_ELEMS", 1 << 12)
    x = rand(32, 1000)
    wt = ntt_mxu.leaf_matrix_dev(32, False, cuda)
    ntt_mxu.reset_launches()
    assert torch.equal(ntt_mxu.leaf_dft_kernel(x, wt, 32),
                       ntt_mxu.leaf_dft_plain(x, wt, 32))
    assert ntt_mxu.LAUNCHES["ntt_mxu_product"] == 8
    monkeypatch.undo()
    x = rand(1 << 12, 3)
    want = f128._ntt_core(x, 1 << 12, False)
    # the f128 prover under the switch: the card's bytes the CPU's without
    opts = ProofOptions(28, 8, 0, FieldExtension.NONE, 4, 7)
    prover_cls = F128Prover.accelerate(tfib.FibProver)
    cpu = prover_cls(opts, Blake3_256, device="cpu").prove(
        tfib.build_fib_trace(F128, 512)).to_bytes()
    monkeypatch.setattr(f128, "_USE_MXU", True)
    assert torch.equal(f128._ntt_core(x, 1 << 12, False), want)
    for route in ("resident", "fused"):
        monkeypatch.setattr(device_limb, "_RESIDENT_ON", route == "resident")
        prover = prover_cls(opts, Blake3_256)
        run = prover._resident_run

        def sync_checked(*args, run=run, **kwargs):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return run(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(prev)

        prover._resident_run = sync_checked
        f128.reset_launches()
        ntt_mxu.reset_launches()
        card = prover.prove(tfib.build_fib_trace(F128, 512, device=cuda))
        assert card.to_bytes() == cpu, route
        assert f128.LAUNCHES["f128_ntt_stage"] == 0, route
        assert min(ntt_mxu.LAUNCHES.values()) > 0, route
