"""GoldilocksProver — the tensor prove() pipeline for f64 AIRs, with the
hashers the JAX package's GoldilocksProver takes: Rp64_256, RpJive64_256,
Blake3_256, Blake3_192 and Sha3_256 — and ``DeviceProver``, that pipeline over
any field's engine, which the f128 and f62 provers
(``prover/device_limb.py``) share.

Same 8-step protocol as the host :class:`winterfell_tpu_torch.prover.Prover`
(prover/src/lib.rs:282-492), with every domain-sized step on a torch device
through the field's engine (``ops/goldilocks.py``, ``ops/f62.py``,
``ops/f128.py``: the same names over int64 elements or (lo, hi) word
pairs):

- trace and composition interpolation + coset LDE: tensor NTT;
- row hashing and Merkle levels: the hasher's kernels (``ops/rescue.py``,
  ``ops/jive.py``, ``ops/blake3.py``, ``ops/sha3.py``, ``ops/rp62.py``);
  Rp64 and Jive digests are (m, 4) int64 field elements, BLAKE3, SHA3 and
  Rp62_248 digests (m, 8) or (m, 6) int32 words (their ``<u4`` bytes are
  the digest bytes; Rp62_248's 31 and a zero pad byte, which the proof
  drops);
- constraint evaluation: the AIR's own ``evaluate_transition`` run with
  the engine's :mod:`~winterfell_tpu_torch.ops.torch_ops` handle over the
  whole CE domain; sequence assertions evaluate their value polynomials
  with one batched NTT (prover/src/constraints/evaluator/boundary.rs:29-445);
- DEEP composition: pointwise rational evaluation over the LDE domain,
  C_z(x)/(x−z) + C_gz(x)/(x−z·g), with one batched extension inversion. The
  numerators vanish at z and z·g, so this equals the reference's synthetic
  division (prover/src/composer/mod.rs:186-199) value for value;
- FRI: per-layer transpose, hash, Merkle levels and fold.

Three routes, dispatched as winterfell_tpu/prover/device.py dispatches them
(``prove``), all giving the host prover's proof bytes
(tests/test_torch_prover.py):

- **resident** (the default): steps 1-6 run on the device with the
  Fiat–Shamir coin there too (``ops/device_coin.py``); between the trace
  upload and the result pulls nothing is read back to the host. Taken for a
  single-segment trace with at least one FRI layer, a remainder of at least
  2 and an LDE of at most ``_RESIDENT_LIMIT_F64`` rows, and a hasher with a
  device coin (every one but RpJive64_256) whose OOD reseed fits one BLAKE3
  chunk (1024 bytes) for the byte hashers, unless ``WINTER_RESIDENT=0``;
- **phased + fused FRI**: the host coin between phases, then the whole FRI
  commit phase with the coin on the device (``WINTER_RESIDENT=0``, or an
  LDE above the resident limit; a hasher with a device coin);
- **phased + host coin**: one host round trip per FRI layer
  (``WINTER_FUSED_FRI=0`` as well, no FRI layer, or RpJive64_256).

Grinding, query positions and the batched query gathers stay on the host
in every route. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

from ..air.air import EvaluationFrame
from ..air.divisor import ConstraintDivisor
from ..air.proof import FriProof, FriProofLayer, OodFrame, Proof, Queries
from ..crypto.hashers import HASHERS
from ..crypto.merkle import MerkleTree
from ..fri import FriOptions, fold_positions
from ..math import ntt as host_ntt
from ..math.fields import Field
from ..ops import device_coin as dc
from ..ops import goldilocks as gl
from ..ops.device_hashers import DEVICE_HASHERS, DeviceHasher
from ..ops.torch_ops import ops_for
from ..ops.words import rows_from_u64
from ..utils import tracing
from . import Prover
from .channel import ProverChannel

I64 = gl.I64

# The JAX package's route switches and limits (winterfell_tpu/prover/
# device.py:973-985), read from the same variables: WINTER_FUSED_FRI=0 forces
# the per-layer host-coin FRI phase, WINTER_RESIDENT=0 the phased pipeline.
_FUSED_FRI_ON = os.environ.get("WINTER_FUSED_FRI", "1") not in ("", "0")
_RESIDENT_ON_F64 = os.environ.get("WINTER_RESIDENT", "1") not in ("", "0")
_FRI_FUSE_LIMIT_F64 = 1 << 22
_RESIDENT_LIMIT_F64 = 1 << 22
# BatchingMethod -> device draw mode (air/src/options.rs:479-505)
_BATCH_NAMES = {0: "linear", 1: "algebraic", 2: "horner"}
# the byte hashers' OOD reseed hashes one row on the device; the resident
# route takes it only within one BLAKE3 chunk (device.py:1111-1118)
_OOD_BYTES_LIMIT = 1024


def _device_hasher(hasher) -> DeviceHasher:
    """The device record of an f64 hasher (``ops/device_hashers.py``); any
    other hasher fails the JAX GoldilocksProver's assertion."""
    h = DEVICE_HASHERS.get(getattr(hasher, "name", None))
    # a hasher of another field's elements (Rp62_248: f62's) is refused
    if (h is None or h.field not in (None, "f64")
            or HASHERS[h.name] is not hasher):
        raise AssertionError(
            "GoldilocksProver requires a Rp64_256, RpJive64_256, BLAKE3 or "
            "SHA3 hasher (device row hashing)")
    return h


def resolve_device(device) -> torch.device:
    """torch.device for ``device``, a CUDA device with its index (tables are
    cached per ``str(tensor.device)``, which always names it); raises when
    CUDA is asked for and absent (an entry point never drops to the CPU on
    its own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _digest_bytes(row: np.ndarray, hasher) -> bytes:
    """A digest's bytes from its uint64 lanes: the hasher's digest size of
    them (Rp62_248's packed words end in a zero pad byte, which proofs and
    the transcript leave out, winterfell_tpu/prover/device.py:255-262)."""
    lanes = np.ascontiguousarray(row.view(np.uint64).astype("<u8"))
    return lanes.tobytes()[: hasher.digest_size]


def _as_i64(t: torch.Tensor) -> torch.Tensor:
    """A digest tensor as int64 lanes with the same bytes: int32 word
    digests (an even number of words) as their little-endian word pairs, so
    that one host copy and ``<u8`` bytes serve every hasher's digests."""
    return t if t.dtype == torch.int64 else t.contiguous().view(torch.int64)


class _GatherBatch:
    """Row gathers of the query phase: every (tensor, indexes) pair is taken
    with ``index_select`` and all results cross to the host in ONE copy."""

    def __init__(self):
        self._items, self._host = [], None

    def add(self, t: torch.Tensor, indexes) -> int:
        assert self._host is None, "gather batch already executed"
        self._items.append((t, list(indexes)))
        return len(self._items) - 1

    def get(self, slot: int) -> np.ndarray:
        """Gathered rows of ``slot`` as a numpy uint64 array."""
        if self._host is None:
            parts, shapes = [], []
            for t, idx in self._items:
                ix = torch.tensor(idx, dtype=torch.int64).to(t.device)
                rows = _as_i64(t.index_select(0, ix))
                shapes.append(tuple(rows.shape))
                parts.append(rows.reshape(-1))
            flat = gl.to_u64(torch.cat(parts)) if parts else np.zeros(0, np.uint64)
            self._host, pos = [], 0
            for shape in shapes:
                size = int(np.prod(shape, dtype=np.int64))
                self._host.append(flat[pos : pos + size].reshape(shape))
                pos += size
        return self._host[slot]


class _RecordingView:
    """Index-recording stand-in: logs which digests a proof pass touches."""

    def __init__(self, n: int):
        self.indexes = set()
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i) -> bytes:
        self.indexes.add(int(i))
        return b""


class _DictView:
    def __init__(self, data: dict, n: int):
        self.data = data
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i) -> bytes:
        return self.data[int(i)]


class PrehashedMerkleTree(MerkleTree):
    """MerkleTree over digests hashed on the device; reuses the host proof
    logic. ``leaves`` is an (m, 4) int64 tensor of Rescue digest elements or
    an (m, 8) / (m, 6) int32 tensor of byte-hasher digest words (gathered
    as int64 lanes of the same bytes, ``_as_i64``), ``levels`` the internal
    levels (level of size s holds heap nodes [s, 2s)).

    ``prove_batch`` runs twice over the host Octopus algorithm: a recording
    pass learns which leaf and node digests it touches (the pattern depends
    only on the indexes), the digests are gathered into the shared query
    batch, and the real pass runs over the fetched bytes."""

    def __init__(self, leaves: torch.Tensor, levels: List[torch.Tensor], hasher,
                 root: bytes = None):
        self.leaf_digests = leaves
        self.levels: Dict[int, torch.Tensor] = {l.shape[0]: l for l in levels}
        self.hasher = hasher
        self._n = leaves.shape[0]
        if root is None:  # pull it now (callers that batch pulls pass it)
            root = _digest_bytes(gl.to_u64(_as_i64(self.levels[1]))[0],
                                 hasher)
        self._root = root
        self.leaves = _RecordingView(self._n)
        self.nodes = _RecordingView(self._n)

    @property
    def root(self) -> bytes:
        return self._root

    @property
    def depth(self) -> int:
        return self._n.bit_length() - 1

    def prove_batch_start(self, indexes, batch: _GatherBatch):
        rec_leaves, rec_nodes = _RecordingView(self._n), _RecordingView(self._n)
        self.leaves, self.nodes = rec_leaves, rec_nodes
        super().prove_batch(indexes)
        leaf_idx = sorted(rec_leaves.indexes)
        node_idx = sorted(rec_nodes.indexes)
        by_size: Dict[int, List[int]] = {}
        for i in node_idx:
            by_size.setdefault(1 << (i.bit_length() - 1), []).append(i)
        slots = {size: batch.add(self.levels[size], [i - size for i in nodes])
                 for size, nodes in by_size.items()}
        return (list(indexes), leaf_idx, batch.add(self.leaf_digests, leaf_idx),
                by_size, slots, batch)

    def prove_batch_finish(self, state):
        indexes, leaf_idx, leaf_slot, by_size, slots, batch = state
        leaf_rows = batch.get(leaf_slot)
        leaf_map = {i: _digest_bytes(leaf_rows[k], self.hasher)
                    for k, i in enumerate(leaf_idx)}
        node_map = {}
        for size, nodes in by_size.items():
            rows = batch.get(slots[size])
            node_map.update({i: _digest_bytes(rows[k], self.hasher)
                             for k, i in enumerate(nodes)})
        self.leaves = _DictView(leaf_map, self._n)
        self.nodes = _DictView(node_map, self._n)
        return super().prove_batch(indexes)


# ================================================================================
# Pipeline pieces, over either field's engine (``eng``: ops/goldilocks.py or
# ops/f128.py). An element is an int64 scalar (f64) or a (lo, hi) word pair on
# a trailing axis (f128, ``eng.ELEM``); extension elements add an axis of
# degree d before it.
# ================================================================================


def _ext_tensor(eng, values, device) -> torch.Tensor:
    """(k, d, *ELEM) tensor from a list of extension tuples."""
    return eng.to_device(np.array([list(e) for e in values], dtype=object),
                         device)


def _eval_cols_pair(eng, polys, pows2):
    """All column polynomials at z and z·g at once: polys (n, k) base or
    (n, k, d) ext, pows2 (n, 2, d) → (k, 2, d) (each with ELEM after)."""
    if polys.ndim == 2 + len(eng.ELEM):
        prod = eng.mul(polys[:, :, None, None], pows2[:, None])
    else:
        prod = eng.ext_mul(
            polys[:, :, None],
            pows2[:, None].expand(polys.shape[:2] + pows2.shape[1:]))
    return eng.sum0(prod)


def _ood_pairs(eng, matrices, z, g_trace: int):
    """OOD evaluations of every column of each coefficient matrix (main,
    aux if any, composition) at z and z·g for a (d,) device z: one (k, 2, d)
    pair per matrix. The power tables are built on the device from z
    (winterfell_tpu/prover/device.py:1551-1563)."""
    n = matrices[0].shape[0]
    zg = eng.mul(z, eng.const(g_trace))
    pows2 = torch.stack([eng.ext_power_table(z, n),
                         eng.ext_power_table(zg, n)], dim=1)
    return [_eval_cols_pair(eng, m, pows2) for m in matrices]


def _transition_divisor_inv(eng, xs, n: int, exemptions):
    """1/(x^n − 1) · Π(x − e) over the CE domain."""
    out = eng.batch_inv(eng.sub(eng.pow_const(xs, n), 1))
    for e in exemptions:
        out = eng.mul(out, eng.sub(xs, eng.const(e)))
    return out


def _boundary_divisor_inv(eng, xs, a: int, b0: int):
    """1/(x^a − b0) over the CE domain."""
    return eng.batch_inv(eng.sub(eng.pow_const(xs, a), eng.const(b0)))


def _hash_rows_bytes(rows_2d, psize: int, h: DeviceHasher):
    """Byte-hasher (BLAKE3, SHA3) row hashing of (m, k) int64 word rows with
    PartitionOptions column chunking by psize words: each chunk's
    little-endian bytes are hashed, the chunk digests combined with
    merge_many = the hash of their concatenated bytes
    (winterfell_tpu/prover/device.py:671-687)."""
    hash_fn, dw = h.hash_rows, h.digest_words
    words, byte_len = rows_from_u64(rows_2d.contiguous())
    k = rows_2d.shape[1]
    if psize >= k:
        return hash_fn(words, byte_len, dw)
    digests = []
    for i in range(0, 2 * k, 2 * psize):
        chunk = words[:, i : i + 2 * psize]
        digests.append(hash_fn(chunk, 4 * chunk.shape[1], dw))
    joined = torch.cat(digests, dim=1)
    return hash_fn(joined, 4 * joined.shape[1], dw)


def _hash_rows_part(eng, rows, psize: int, h: DeviceHasher):
    """Row hashing of (m, ...) element rows with PartitionOptions column
    chunking: each chunk of psize base elements is hashed separately and the
    chunk digests combined with merge_many (row_matrix.rs:184-229)."""
    rows_2d = rows.reshape(rows.shape[0], -1)
    psize *= math.prod(eng.ELEM)  # in int64 words
    if h.kind == "bytes":
        return _hash_rows_bytes(rows_2d, psize, h)
    hash_fn = h.hash_rows
    k = rows_2d.shape[1]
    if psize >= k:
        return hash_fn(rows_2d)
    digests = [hash_fn(rows_2d[:, i : i + psize].contiguous())
               for i in range(0, k, psize)]
    if h.combine is not None:  # Rp62_248: merge_many of the packed digests
        return h.combine(digests)
    return hash_fn(torch.cat(digests, dim=1))


def _commit_pipeline(eng, matrix, n: int, offset: int, blowup: int,
                     psize: int, h: DeviceHasher):
    """Interpolate → coset LDE → row hash → Merkle levels."""
    polys = eng.ntt_interpolate(matrix, n)
    lde = eng.ntt_evaluate_with_offset(polys, n, offset, blowup)
    leaves = _hash_rows_part(eng, lde, psize, h)
    return polys, lde, leaves, h.merkle_levels(leaves)


def _comp_commit_pipeline(eng, ce_column, ce: int, n: int, offset: int,
                          blowup: int, num_cols: int, psize: int,
                          h: DeviceHasher):
    """Composition commitment: iNTT the CE column over its coset, split the
    first num_cols trace-length coefficient chunks into columns
    (composition_poly.rs:55-85), then LDE, hash and Merkle levels."""
    coeffs = eng.ntt_interpolate_with_offset(ce_column, ce, offset)
    comp_columns = coeffs[: num_cols * n].reshape(
        (num_cols, n) + coeffs.shape[1:]).transpose(0, 1).contiguous()
    lde = eng.ntt_evaluate_with_offset(comp_columns, n, offset, blowup)
    leaves = _hash_rows_part(eng, lde, psize, h)
    return comp_columns, lde, leaves, h.merkle_levels(leaves)


def _fri_layer_commit(eng, evaluations, n_fold: int, h: DeviceHasher):
    """Transpose a FRI layer into N-value rows, hash, Merkle levels
    (fri/src/prover/mod.rs:202-222)."""
    n, d = evaluations.shape[:2]
    rows = n // n_fold
    transposed = evaluations.reshape(
        (n_fold, rows) + evaluations.shape[1:]).transpose(0, 1).contiguous()
    leaves = _hash_rows_part(eng, transposed, n_fold * d, h)
    return transposed, leaves, h.merkle_levels(leaves)


def _fri_phase_body(eng, deep_evals, seed, merge, draw, h: DeviceHasher,
                    n_fold: int, n_layers: int, offset: int):
    """The FRI commit phase with the coin on the device
    (winterfell_tpu/prover/device.py:_fri_phase_body_f64): per layer
    transpose, hash, Merkle levels, reseed with the root, draw α, fold; then
    the remainder interpolation (fri/src/prover/mod.rs:179-239). Returns
    ((transposed, leaves, levels) per layer, remainder coefficients, seed)."""
    evaluations = deep_evals
    outs = []
    for _ in range(n_layers):
        transposed, leaves, levels = _fri_layer_commit(eng, evaluations,
                                                       n_fold, h)
        seed = merge(seed, levels[-1])
        alpha, _ = draw(seed)
        evaluations = eng.fri_fold(evaluations, n_fold, offset, alpha[0])
        outs.append((transposed, leaves, levels))
    rem = eng.ntt_interpolate_with_offset(evaluations, evaluations.shape[0],
                                          offset)
    return outs, rem, seed


def _pull_small(tensors) -> List[np.ndarray]:
    """Every small device result in ONE device-to-host copy, as numpy uint64
    arrays (int32 word tensors as their little-endian word pairs)."""
    tensors = [_as_i64(t) for t in tensors]
    flat = gl.to_u64(torch.cat([t.reshape(-1) for t in tensors]))
    out, pos = [], 0
    for t in tensors:
        size = t.numel()
        out.append(flat[pos : pos + size].reshape(tuple(t.shape)))
        pos += size
    return out


def _ood_lists(eng, pair: np.ndarray):
    """(k, 2, d) uint64 OOD pair -> (values at z, values at z·g) as tuples."""
    return ([eng.elements(row[0]) for row in pair],
            [eng.elements(row[1]) for row in pair])


def _deep_combine(eng, comp_z, comp_gz, z_arr, zg_arr, xs):
    """comp_z/(x−z) + comp_gz/(x−z·g) with one paired extension inversion."""
    d = comp_z.shape[1]
    xs_ext = torch.cat([xs[:, None],
                        torch.zeros((xs.shape[0], d - 1) + xs.shape[1:],
                                    dtype=I64, device=xs.device)], dim=1)
    den_z = eng.ext_sub(xs_ext, z_arr.expand_as(xs_ext))
    den_gz = eng.ext_sub(xs_ext, zg_arr.expand_as(xs_ext))
    # 1/a = inv(ab)·b, 1/b = inv(ab)·a
    inv_prod = eng.ext_batch_inv(eng.ext_mul(den_z, den_gz))
    inv_z = eng.ext_mul(inv_prod, den_gz)
    inv_gz = eng.ext_mul(inv_prod, den_z)
    return eng.ext_add(eng.ext_mul(comp_z, inv_z), eng.ext_mul(comp_gz, inv_gz))


class DeviceProver(Prover):
    """The tensor prove() pipeline over one field's engine (``engine``), the
    part the f64 and f128 provers share. A concrete prover sets ``engine``
    and gives its hasher check (``_device_hasher``) and its route switches
    and limits (``_routes``); pass ``device=`` (default "cuda") to choose
    where the pipeline runs."""

    engine = None  # ops/goldilocks.py or ops/f128.py

    def __init__(self, *args, device="cuda", **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)

    @classmethod
    def accelerate(cls, prover_cls):
        """Builds a tensor-pipeline subclass of a host Prover class."""
        return type(f"{cls.__name__[:-6]}{prover_cls.__name__}",
                    (cls, prover_cls), {})

    def _device_hasher(self) -> DeviceHasher:
        raise NotImplementedError

    def _routes(self):
        """(resident route on, fused FRI on, the resident route's largest
        LDE, the fused FRI phase's largest LDE), read at each prove."""
        raise NotImplementedError

    def _ood_limited(self, h: DeviceHasher) -> bool:
        """Whether the resident route takes the hasher only for an OOD row
        of at most ``_OOD_BYTES_LIMIT`` bytes (its one-row OOD hash)."""
        raise NotImplementedError

    def _upload_trace(self, trace) -> torch.Tensor:
        eng = self.engine
        cache = trace.device_cache() if hasattr(trace, "device_cache") else {}
        key = ("torch", str(self.device))
        main_dev = cache.get(key)
        if main_dev is None:
            rows = trace.native_rows() if hasattr(trace, "native_rows") else None
            if rows is not None and rows.ndim == 2 + len(eng.ELEM):
                # the engine's u64 words already: (n, w) or (n, w, 2)
                main_dev = torch.from_numpy(np.ascontiguousarray(
                    rows, dtype=np.uint64).view(np.int64)).to(self.device)
            else:
                main_dev = eng.to_device(trace.main_segment(), self.device)
            cache[key] = main_dev
        return main_dev

    def prove(self, trace) -> Proof:
        eng = self.engine
        pub_inputs = self.get_pub_inputs(trace)
        air = self.air_class(trace.info(), pub_inputs, self.options)
        assert air.base.p == eng.P, (
            f"{type(self).__name__} requires the {eng.NAME} base field")
        h = self._device_hasher()
        channel = ProverChannel(air, air.pub_inputs_to_elements(), self.hasher)
        phases = tracing.Phases("device_prove")
        fri_opts = FriOptions(air.options.blowup_factor,
                              air.options.fri_folding_factor,
                              air.options.fri_remainder_max_degree)
        lde_size = air.lde_domain_size
        n_layers = fri_opts.num_fri_layers(lde_size)
        rem_n = lde_size // fri_opts.folding_factor**n_layers
        # the JAX package's dispatch (winterfell_tpu/prover/device.py:
        # 1105-1118, device_limb.py:606-616) for one segment and no mesh
        resident_on, _, resident_limit, _ = self._routes()
        coin_kind = h.name if h.coin else None
        ood_bytes = (2 * (air.trace_info.width
                          + air.context.num_constraint_composition_columns())
                     * air.ext_field.degree * air.base.element_bytes)
        if (resident_on and coin_kind is not None
                and not air.trace_info.is_multi_segment and n_layers > 0
                and rem_n >= 2 and lde_size <= resident_limit
                and (not self._ood_limited(h)
                     or ood_bytes <= _OOD_BYTES_LIMIT)):
            return self._prove_resident(air, trace, channel, phases, fri_opts,
                                        n_layers, rem_n, coin_kind)
        return self._prove_phased(air, trace, channel, phases, fri_opts,
                                  n_layers, rem_n)

    def _prove_phased(self, air, trace, channel, phases, fri_opts,
                      n_layers: int, rem_n: int) -> Proof:
        """Steps 1-6 with the host coin between phases; the FRI phase runs
        fused with the coin on the device where the JAX package fuses it."""
        eng = self.engine
        dev = self.device
        h = self._device_hasher()
        ext = air.ext_field
        d = ext.degree
        n = air.trace_length
        blowup = air.options.blowup_factor
        offset = air.domain_offset
        lde_size = air.lde_domain_size
        ce = air.context.ce_domain_size
        part = air.options.partition_options

        # 1 ----- trace commitment ------------------------------------------
        main_dev = tracing.sync(self._upload_trace(trace))
        phases.mark("commit_main_upload")
        w = main_dev.shape[1]
        main_polys, main_lde, leaves, levels = _commit_pipeline(
            eng, main_dev, n, offset, blowup, part.partition_size(w, 1), h)
        main_tree = PrehashedMerkleTree(leaves, levels, self.hasher)
        channel.commit_trace(main_tree.root)
        phases.mark("commit_to_main_trace_segment", lde_domain_size=lde_size)
        traces = [(main_tree, main_lde)]

        # the aux segment of a Randomized AIR: its random elements drawn
        # after the main commitment, its (n, w_aux, d) extension columns
        # built on the host and committed like the main ones
        # (winterfell_tpu/prover/device.py:1158-1175)
        aux, aux_rands, polys = None, None, [main_polys]
        if air.trace_info.is_multi_segment:
            aux_rands = air.get_aux_rand_elements(channel.public_coin)
            aux_obj = self.build_aux_trace(trace, aux_rands)
            phases.mark("build_aux_trace")
            aux_dev = eng.to_device(aux_obj, dev)
            del aux_obj
            w_aux = aux_dev.shape[1]
            aux_polys, aux_lde, leaves, levels = _commit_pipeline(
                eng, aux_dev, n, offset, blowup,
                part.partition_size(w_aux, d) * d, h)
            del aux_dev
            aux_tree = PrehashedMerkleTree(leaves, levels, self.hasher)
            channel.commit_trace(aux_tree.root)
            traces.append((aux_tree, aux_lde))
            polys.append(aux_polys)
            aux = (aux_lde, _ext_tensor(eng, aux_rands, dev))
            phases.mark("commit_to_aux_trace_segment")

        # 2 ----- constraint evaluation -------------------------------------
        ccs = channel.get_constraint_composition_coeffs()
        boundary = air.get_boundary_constraints(
            aux_rands, list(range(air.context.num_assertions)))
        ce_column = tracing.sync(self._evaluate_constraints(
            air, main_lde,
            _ext_tensor(eng, ccs.transition + ccs.boundary, dev),
            boundary, self._seq_coeffs(air, boundary), aux))
        phases.mark("evaluate_constraints", ce_domain_size=ce)

        # 3 ----- composition commitment ------------------------------------
        num_cols = air.context.num_constraint_composition_columns()
        comp_columns, comp_lde, leaves, levels = _comp_commit_pipeline(
            eng, ce_column, ce, n, offset, blowup, num_cols,
            part.partition_size(num_cols, d) * d, h)
        del ce_column
        comp_tree = PrehashedMerkleTree(leaves, levels, self.hasher)
        channel.commit_constraints(comp_tree.root)
        phases.mark("commit_to_constraint_evaluations")

        # 4 ----- OOD evaluations + DEEP ------------------------------------
        z = _ext_tensor(eng, [channel.get_ood_point()], dev)[0]
        g_trace = air.base.get_root_of_unity(n.bit_length() - 1)
        pairs = torch.cat(_ood_pairs(eng, polys + [comp_columns], z, g_trace))
        # every matrix's evaluations cross to the host in one copy; the
        # trace columns (main, then aux) come first
        pairs_np = _pull_small([pairs])[0]
        w_all = air.trace_info.width
        trace_cur, trace_nxt = _ood_lists(eng, pairs_np[:w_all])
        quot_cur, quot_nxt = _ood_lists(eng, pairs_np[w_all:])
        channel.send_ood_evaluations(trace_cur, trace_nxt, quot_cur, quot_nxt)
        phases.mark("ood_evaluations")
        deep_ccs = channel.get_deep_composition_coeffs()
        deep_evaluations = tracing.sync(self._deep_evaluations(
            air, main_lde, [lde for _, lde in traces[1:]] + [comp_lde], z,
            g_trace, pairs,
            _ext_tensor(eng, deep_ccs.trace + deep_ccs.constraints, dev)))
        phases.mark("build_deep_composition_poly")

        # 6 ----- FRI layers -------------------------------------------------
        n_fold = fri_opts.folding_factor
        fri_layers = []  # (tree, transposed (rows, N, d))
        _, fused_on, _, fuse_limit = self._routes()
        coin_kind = h.name if h.coin else None
        if (fused_on and coin_kind is not None and n_layers > 0
                and rem_n >= 2 and lde_size <= fuse_limit):
            # the whole commit phase with the coin on the device; the roots
            # and the seed cross to the host in one copy at its end
            merge, draw = dc.coin_bundle(coin_kind, d, eng.NAME)
            outs, rem_coeffs, seed = _fri_phase_body(
                eng, deep_evaluations,
                dc.seed_tensor(channel.public_coin.seed, dev, coin_kind),
                merge, draw, h, n_fold, n_layers, offset)
            pulled = _pull_small([lv[-1] for _, _, lv in outs] + [seed])
            for (transposed, leaves, levels), root in zip(outs, pulled):
                tree = PrehashedMerkleTree(leaves, levels, self.hasher,
                                           _digest_bytes(root[0], self.hasher))
                channel.commitments.raw += tree.root  # reseeded on the device
                fri_layers.append((tree, transposed))
            channel.public_coin.seed = _digest_bytes(pulled[-1], self.hasher)
            channel.public_coin.counter = 0
            phases.mark("fri_layers_fused", num_layers=n_layers)
        else:
            evaluations = deep_evaluations
            for _ in range(n_layers):
                transposed, leaves, levels = _fri_layer_commit(
                    eng, evaluations, n_fold, h)
                tree = PrehashedMerkleTree(leaves, levels, self.hasher)
                channel.commit_fri_layer(tree.root)
                alpha = _ext_tensor(eng, [channel.draw_fri_alpha()], dev)[0]
                evaluations = eng.fri_fold(evaluations, n_fold, offset, alpha)
                fri_layers.append((tree, transposed))
            rem_coeffs = eng.ntt_interpolate_with_offset(evaluations, rem_n,
                                                         offset)
        return self._finish_proof(air, channel, phases, rem_n, rem_coeffs,
                                  fri_layers, traces, comp_tree, comp_lde)

    # ------------------------------------------------------------------
    # whole-proof resident route (winterfell_tpu/prover/device.py:1382-1626)
    # ------------------------------------------------------------------

    def _prove_resident(self, air, trace, channel, phases, fri_opts,
                        n_layers: int, rem_n: int, coin_kind: str) -> Proof:
        """Steps 1-6 (trace commit, coefficient draws, constraint
        evaluation, composition commit, OOD, DEEP, every FRI layer) on the
        device with the Fiat–Shamir coin there too. The host uploads the
        trace and the per-proof constants, then pulls the results in one
        copy and resumes the channel exactly where the phased route would
        stand: roots appended to the commitments, the OOD frame set, the
        seed taken from the device, the counter at 0."""
        eng = self.engine
        ext = air.ext_field
        dev = self.device
        main_dev = tracing.sync(self._upload_trace(trace))
        phases.mark("commit_main_upload")

        boundary = air.get_boundary_constraints(
            None, list(range(air.context.num_assertions)))
        seq = self._resident_consts(air, boundary, fri_opts, n_layers)
        seed0 = dc.seed_tensor(channel.public_coin.seed, dev, coin_kind)
        (main_lde, m_leaves, m_levels, comp_lde, c_leaves, c_levels,
         main_pair, comp_pair, fri_outs, rem_coeffs, seed) = \
            self._resident_run(air, boundary, seq, main_dev, seed0,
                               fri_opts.folding_factor, n_layers, coin_kind)

        pulled = _pull_small([m_levels[-1], c_levels[-1]]
                             + [lv[-1] for _, _, lv in fri_outs]
                             + [main_pair, comp_pair, seed])
        roots = [_digest_bytes(r[0], self.hasher)
                 for r in pulled[: 2 + n_layers]]
        main_tree = PrehashedMerkleTree(m_leaves, m_levels, self.hasher,
                                        roots[0])
        channel.commitments.raw += main_tree.root  # reseeds ran on device
        comp_tree = PrehashedMerkleTree(c_leaves, c_levels, self.hasher,
                                        roots[1])
        channel.commitments.raw += comp_tree.root
        trace_cur, trace_nxt = _ood_lists(eng, pulled[2 + n_layers])
        quot_cur, quot_nxt = _ood_lists(eng, pulled[3 + n_layers])
        channel.ood_frame = OodFrame.new(ext, trace_cur, trace_nxt, quot_cur,
                                         quot_nxt)
        fri_layers = []
        for (transposed, leaves, levels), root in zip(fri_outs, roots[2:]):
            tree = PrehashedMerkleTree(leaves, levels, self.hasher, root)
            channel.commitments.raw += tree.root
            fri_layers.append((tree, transposed))
        channel.public_coin.seed = _digest_bytes(pulled[-1], self.hasher)
        channel.public_coin.counter = 0
        phases.mark("resident_pipeline", lde_domain_size=air.lde_domain_size)
        return self._finish_proof(air, channel, phases, rem_n, rem_coeffs,
                                  fri_layers, [(main_tree, main_lde)],
                                  comp_tree, comp_lde)

    def _resident_consts(self, air, boundary, fri_opts, n_layers: int):
        """Builds, before the device run, every table the run reads that
        needs a host-to-device copy or is fixed per proof shape (as the JAX
        make_consts does, device.py:1589-1620): the NTT plans (under
        WINTER_MXU_NTT=1 the f128 engine's whole six-step plans: the leaf
        matrices of every leaf size and the mid twiddles of every level),
        the offset powers, the CE and DEEP domain constants, the FRI inverse
        offset powers, the Frobenius and Rescue tables; returns the
        per-proof sequence-assertion coefficients (boundary values)."""
        from ..ops import rescue

        eng = self.engine
        dev = self.device
        n = air.trace_length
        lde_size = air.lde_domain_size
        ce = air.context.ce_domain_size
        offset = air.domain_offset
        n_fold = fri_opts.folding_factor
        rem_n = lde_size // n_fold**n_layers
        for size, inverse in ((n, True), (lde_size, False), (ce, True),
                              (ce, False), (n_fold, True), (rem_n, True)):
            eng.ntt_plan(size, inverse, dev)
        eng.lde_offset_powers(n, offset, dev)
        eng.interp_offset_powers(ce, offset, dev)
        eng.interp_offset_powers(rem_n, offset, dev)
        for i in range(n_layers):
            eng.fri_inv_offset_powers(lde_size // n_fold**i, n_fold, offset,
                                      dev)
        if air.ext_field.degree == 3:  # f64 and f62
            eng.frobenius_table(3, dev)
        h = self._device_hasher()
        if h.name == "rp64_256":  # the coin's permutation reads the ARK table
            rescue._table("ark", dev)
        elif h.library is not None and dev.type == "cuda":
            h.library(dev)  # loaded, with its constant tables on the card
        self._ce_consts(air, boundary)
        self._lde_xs(air)
        return self._seq_coeffs(air, boundary)

    def _resident_run(self, air, boundary, seq, main_dev, seed0, n_fold: int,
                      n_layers: int, coin_kind: str):
        """The device part of the resident route: only launches, no host
        read (winterfell_tpu/prover/device.py:1522-1585)."""
        eng = self.engine
        d = air.ext_field.degree
        n = air.trace_length
        w = air.trace_info.width
        blowup = air.options.blowup_factor
        offset = air.domain_offset
        ce = air.context.ce_domain_size
        part = air.options.partition_options
        num_cols = air.context.num_constraint_composition_columns()
        n_t = air.context.num_transition_constraints
        n_b = air.context.num_assertions
        h = self._device_hasher()
        merge, draw = dc.coin_bundle(coin_kind, d, eng.NAME)
        draw_k = dc.make_draw_k(draw, eng)
        method_c = _BATCH_NAMES[int(air.options.batching_constraints)]
        method_d = _BATCH_NAMES[int(air.options.batching_deep)]

        # 1 -- trace commit
        main_polys, main_lde, m_leaves, m_levels = _commit_pipeline(
            eng, main_dev, n, offset, blowup, part.partition_size(w, 1), h)
        seed = merge(seed0, m_levels[-1])
        # 2 -- constraint composition coefficients, constraint evaluation
        ccs_all, _ = draw_k(seed, n_t + n_b, method_c)
        ce_column = self._evaluate_constraints(air, main_lde, ccs_all,
                                               boundary, seq)
        # 3 -- composition commitment
        comp_columns, comp_lde, c_leaves, c_levels = _comp_commit_pipeline(
            eng, ce_column, ce, n, offset, blowup, num_cols,
            part.partition_size(num_cols, d) * d, h)
        del ce_column
        seed = merge(seed, c_levels[-1])
        # 4 -- OOD point, evaluations, reseed with their hash
        z_row, _ = draw(seed)
        z = z_row[0]
        g_trace = air.base.get_root_of_unity(n.bit_length() - 1)
        main_pair, comp_pair = _ood_pairs(eng, [main_polys, comp_columns], z,
                                          g_trace)
        merged = torch.cat([main_pair[:, 0], comp_pair[:, 0],
                            main_pair[:, 1], comp_pair[:, 1]])
        flat = merged.reshape(1, -1)
        if h.kind == "field":
            ood_digest = h.hash_rows(flat)[0]
        else:  # the one-row hash of the elements' bytes (device.py:1515-1520)
            ood_digest = h.hash_rows(*rows_from_u64(flat), h.digest_words)[0]
        seed = merge(seed, ood_digest)
        # 5 -- DEEP composition, 6 -- FRI layers
        deep_all, _ = draw_k(seed, w + num_cols, method_d)
        deep_evals = self._deep_evaluations(
            air, main_lde, [comp_lde], z, g_trace,
            torch.cat([main_pair, comp_pair]), deep_all)
        fri_outs, rem_coeffs, seed = _fri_phase_body(
            eng, deep_evals, seed, merge, draw, h, n_fold, n_layers, offset)
        return (main_lde, m_leaves, m_levels, comp_lde, c_leaves, c_levels,
                main_pair, comp_pair, fri_outs, rem_coeffs, seed)

    def _finish_proof(self, air, channel, phases, rem_n: int, rem_coeffs,
                      fri_layers, traces, comp_tree, comp_lde) -> Proof:
        """Remainder commit, grinding, query positions, and the batched
        query gathers + proof assembly. ``traces`` holds (tree, LDE) of each
        trace segment: the main one, then the aux one if any
        (winterfell_tpu/prover/device.py:1346-1348)."""
        eng = self.engine
        ext = air.ext_field
        lde_size = air.lde_domain_size
        n_fold = air.options.fri_folding_factor

        keep = rem_n // air.options.blowup_factor
        rem_np = eng.to_u64(rem_coeffs[:keep])[::-1]
        remainder_poly = [eng.elements(row) for row in rem_np]
        channel.commit_fri_layer(self.hasher.hash_elements(remainder_poly, ext))
        phases.mark("compute_fri_layers")

        # 7 ----- query positions -------------------------------------------
        channel.grind_query_seed()
        query_positions = channel.get_query_positions()
        phases.mark("determine_query_positions")

        # 8 ----- proof assembly: every gather in one batch, one host copy --
        gb = _GatherBatch()
        layer_starts = []
        positions = list(query_positions)
        domain_size = lde_size
        for tree, transposed in fri_layers:
            positions = fold_positions(positions, domain_size, n_fold)
            layer_starts.append((tree, tree.prove_batch_start(positions, gb),
                                 gb.add(transposed, positions)))
            domain_size //= n_fold
        fields = [Field(air.base, 1)] + [ext] * len(traces)
        q_starts = [(tree, field, tree.prove_batch_start(query_positions, gb),
                     gb.add(lde, query_positions))
                    for (tree, lde), field in zip(
                        traces + [(comp_tree, comp_lde)], fields)]

        proof_layers = []
        for tree, st, rows_slot in layer_starts:
            _, batch_proof = tree.prove_batch_finish(st)
            query_values = [list(eng.elements(row))
                            for row in gb.get(rows_slot)]
            proof_layers.append(
                FriProofLayer.new(ext, query_values, batch_proof.to_bytes()))
        fri_proof = FriProof.new(ext, proof_layers, remainder_poly, 1)

        queries = []
        for tree, field, st, rows_slot in q_starts:
            _, batch_proof = tree.prove_batch_finish(st)
            rows = []
            for row in gb.get(rows_slot):
                if row.ndim == 1 + len(eng.ELEM):  # base field row (w,)
                    rows.append([(v,) for v in eng.elements(row)])
                else:  # (w, d)
                    rows.append(list(eng.elements(row)))
            queries.append(Queries.new(batch_proof.to_bytes(), rows, field))

        proof = channel.build_proof(queries[:-1], queries[-1], fri_proof,
                                    len(query_positions))
        phases.mark("build_proof_object")
        return proof

    # ------------------------------------------------------------------

    def _evaluate_constraints(self, air, main_lde, ccs_all, boundary, seq,
                              aux=None):
        """Tensor mirror of prover/evaluator.py over the whole CE domain.
        ``ccs_all`` (n_t + n_b, d) holds the composition coefficients on the
        device (transition first, main before aux in each kind);
        ``boundary`` was built with each constraint's ``cc`` the index of
        its coefficient among the boundary ones; ``seq`` holds each group's
        sequence coefficients (``_seq_coeffs``); ``aux`` is (aux LDE, the
        aux random elements as a (k, d) device tensor) for a Randomized
        AIR (winterfell_tpu/prover/device.py:1676-1920)."""
        eng = self.engine
        dev = self.device
        d = air.ext_field.degree
        ce_blowup = air.ce_blowup_factor
        stride = air.options.blowup_factor // ce_blowup
        n_t = air.context.num_transition_constraints
        n_main = len(air.context.main_degrees)

        main_ce = main_lde[::stride]
        main_ce_next = torch.roll(main_ce, -ce_blowup, dims=0)
        t_ccs, b_ccs = ccs_all[:n_t], ccs_all[n_t:]
        t_div_inv, group_consts, periodic, ce = self._ce_consts(air, boundary)

        cur = [main_ce[:, c : c + 1] for c in range(main_ce.shape[1])]
        nxt = [main_ce_next[:, c : c + 1] for c in range(main_ce.shape[1])]
        main_evals = air.evaluate_transition(
            EvaluationFrame(cur, nxt), periodic,
            ops_for(Field(air.base, 1), dev))
        combined = torch.zeros((ce, d) + eng.ELEM, dtype=I64, device=dev)
        for i, ev in enumerate(main_evals):
            combined = eng.ext_add(combined, eng.mul(ev, t_ccs[i][None]))

        aux_ce = None
        if aux is not None:
            aux_lde, rands = aux
            aux_ce = aux_lde[::stride]
            aux_ce_next = torch.roll(aux_ce, -ce_blowup, dims=0)

            def lift(a):  # (ce, 1) base columns as (ce, d) extension ones
                pad = torch.zeros((a.shape[0], d - 1) + a.shape[2:],
                                  dtype=I64, device=dev)
                return torch.cat([a, pad], dim=1)

            aux_evals = air.evaluate_aux_transition(
                EvaluationFrame([lift(a) for a in cur], [lift(a) for a in nxt]),
                EvaluationFrame([aux_ce[:, c] for c in range(aux_ce.shape[1])],
                                [aux_ce_next[:, c]
                                 for c in range(aux_ce.shape[1])]),
                [lift(pv) for pv in periodic],
                [rands[i][None] for i in range(rands.shape[0])],
                ops_for(air.ext_field, dev))
            for i, ev in enumerate(aux_evals):
                combined = eng.ext_add(combined, eng.ext_mul(
                    ev, t_ccs[n_main + i][None].expand_as(ev)))
        result = eng.ext_mul_base(combined, t_div_inv)

        groups = ([(g, main_ce, False) for g in boundary.main_groups]
                  + [(g, aux_ce, True) for g in boundary.aux_groups])
        for (g, trace, is_ext), (div_inv, scales), q in zip(
                groups, group_consts, seq):
            numer = torch.zeros((ce, d) + eng.ELEM, dtype=I64, device=dev)

            def add_term(col, value, cc):
                """numer += (T(x) − b(x)) · cc for a column of ``trace``."""
                nonlocal numer
                if is_ext:
                    diff = eng.ext_sub(trace[:, col], value.expand(
                        trace[:, col].shape))
                    term = eng.ext_mul(diff, b_ccs[cc][None].expand_as(diff))
                else:
                    term = eng.mul(eng.sub(trace[:, col], value)[:, None],
                                   b_ccs[cc][None])
                numer = eng.ext_add(numer, term)

            singles = [c for c in g.constraints if len(c.poly) == 1]
            seqs = [c for c in g.constraints if len(c.poly) > 1]
            for c in singles:
                add_term(c.column, _ext_tensor(eng, c.poly, dev) if is_ext
                         else eng.const(c.poly[0][0]), c.cc)
            if seqs:
                # batched sequence value polys: the (L, k) coefficient block
                # zero-padded to the CE size on the device, each column
                # scaled by its (offset·poly_offset)^i series, one NTT
                q = torch.cat([q, torch.zeros((ce - q.shape[0],) + q.shape[1:],
                                              dtype=I64, device=dev)])
                b_vals = eng.ntt_evaluate(
                    eng.mul(q, scales.unsqueeze(2) if is_ext else scales), ce)
                for j, c in enumerate(seqs):
                    add_term(c.column, b_vals[:, j], c.cc)
            result = eng.ext_add(result, eng.ext_mul_base(numer, div_inv))
        return result

    def _seq_coeffs(self, air, boundary):
        """Per boundary group (main, then aux), its sequence assertions'
        value-polynomial coefficients as an (L, k) device tensor, L the
        longest polynomial, shorter ones zero-padded ((L, k, d) for an aux
        group; None without sequences): per-proof values, copied to the
        device before the run. The CE pads them to its domain on the
        device: no host array of the CE domain's size is built."""
        d = air.ext_field.degree
        out = []
        for g, is_ext in ([(g, False) for g in boundary.main_groups]
                          + [(g, True) for g in boundary.aux_groups]):
            seqs = [c for c in g.constraints if len(c.poly) > 1]
            if not seqs:
                out.append(None)
                continue
            q = np.zeros((max(len(c.poly) for c in seqs), len(seqs))
                         + ((d,) if is_ext else ()), dtype=object)
            for j, c in enumerate(seqs):
                for i, v in enumerate(c.poly):
                    if is_ext:
                        q[i, j, : len(v)] = list(v)
                    else:
                        q[i, j] = int(v[0])
            out.append(self.engine.to_device(q, self.device))
        return out

    def _ce_consts(self, air, boundary):
        """Per-structure CE-domain constants (divisor inverses and sequence
        scales of every boundary group, main then aux; periodic columns),
        built once per AIR shape and device."""
        eng = self.engine
        ce = air.context.ce_domain_size
        n = air.trace_length
        offset = air.domain_offset
        p = eng.P
        periodic_polys = air.get_periodic_column_polys()
        groups = boundary.main_groups + boundary.aux_groups
        key = (type(air), n, ce, air.context.num_transition_exemptions,
               len(boundary.main_groups),
               tuple((tuple(g.divisor.numerator),
                      tuple((c.column, len(c.poly), c.poly_offset)
                            for c in g.constraints))
                     for g in groups),
               tuple(tuple(poly) for poly in periodic_polys), str(self.device))
        cache = self.__dict__.setdefault("_ce_cache", {})
        if key in cache:
            return cache[key]
        dev = self.device
        periodic = []
        for poly in periodic_polys:
            coeffs = np.array(poly, dtype=object)[:, None]
            vals = host_ntt.evaluate_poly_with_offset(
                air.base, coeffs, pow(offset, n // len(poly), p),
                air.ce_blowup_factor)
            col = eng.to_device(vals, dev)  # (len·ce_blowup, 1)
            periodic.append(col.repeat((ce // col.shape[0],)
                                       + (1,) * (col.ndim - 1)))
        xs = eng.power_series(air.base.get_root_of_unity(ce.bit_length() - 1),
                              ce, dev, offset)
        divisor = ConstraintDivisor.from_transition(
            air.base, n, air.context.num_transition_exemptions)
        t_div_inv = _transition_divisor_inv(eng, xs, n, divisor.exemptions)
        group_consts = []
        for g in groups:
            div_inv = _boundary_divisor_inv(eng, xs, *g.divisor.numerator[0])
            seqs = [c for c in g.constraints if len(c.poly) > 1]
            scales = (torch.stack([eng.power_series(offset * c.poly_offset % p,
                                                    ce, dev) for c in seqs],
                                  dim=1) if seqs else None)
            group_consts.append((div_inv, scales))
        cache[key] = (t_div_inv, group_consts, periodic, ce)
        return cache[key]

    def _lde_xs(self, air):
        """The LDE domain offset·h^i on the device (built once per size)."""
        eng = self.engine
        dev = self.device
        lde_size = air.lde_domain_size
        h = air.base.get_root_of_unity(lde_size.bit_length() - 1)
        return eng._cached(("pows", h, lde_size, air.domain_offset, str(dev)),
                           lambda: eng.power_series(h, lde_size, dev,
                                                    air.domain_offset))

    def _deep_evaluations(self, air, main_lde, ext_ldes, z, g_trace: int,
                          pairs, deep_ccs):
        """DEEP over the LDE domain: C_z(x)/(x−z) + C_gz(x)/(x−z·g), with z,
        the OOD pairs of every column and the coefficients ((k, d): the main
        columns, then those of ``ext_ldes``, the extension matrices in
        proof order: the aux segment's if any, then the composition's) on
        the device."""
        eng = self.engine
        dev = self.device
        d = air.ext_field.degree
        lde_size = main_lde.shape[0]
        xs = self._lde_xs(air)
        # adjusted OOD constants: cc_i · T_i(z), cc_i · T_i(z·g)
        adj_z = eng.ext_mul(pairs[:, 0], deep_ccs)
        adj_gz = eng.ext_mul(pairs[:, 1], deep_ccs)

        comp_z = torch.zeros((lde_size, d) + eng.ELEM, dtype=I64, device=dev)
        comp_gz = torch.zeros((lde_size, d) + eng.ELEM, dtype=I64, device=dev)
        terms = [eng.mul(main_lde[:, c : c + 1], deep_ccs[c][None])
                 for c in range(main_lde.shape[1])]
        for lde in ext_ldes:
            for j in range(lde.shape[1]):
                terms.append(eng.ext_mul(
                    lde[:, j], deep_ccs[len(terms)].expand_as(lde[:, j])))
        for idx, term in enumerate(terms):
            comp_z = eng.ext_add(comp_z, eng.ext_sub(term, adj_z[idx]))
            comp_gz = eng.ext_add(comp_gz, eng.ext_sub(term, adj_gz[idx]))
        zg = eng.mul(z, eng.const(g_trace))
        return _deep_combine(eng, comp_z, comp_gz, z[None], zg[None], xs)


class GoldilocksProver(DeviceProver):
    """Drop-in Prover for f64 AIRs with Rp64_256, RpJive64_256, BLAKE3 or
    SHA3 commitments. Subclass or wrap an existing prover class via
    ``accelerate``; pass ``device=`` (default "cuda") to choose where the
    pipeline runs."""

    engine = gl

    def _device_hasher(self) -> DeviceHasher:
        return _device_hasher(self.hasher)

    def _routes(self):
        return (_RESIDENT_ON_F64, _FUSED_FRI_ON, _RESIDENT_LIMIT_F64,
                _FRI_FUSE_LIMIT_F64)

    def _ood_limited(self, h: DeviceHasher) -> bool:
        # the JAX f64 dispatch limits the byte hashers' OOD row only
        return h.kind == "bytes"
