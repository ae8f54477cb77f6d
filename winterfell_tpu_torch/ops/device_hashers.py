"""The hashers of the provers' device path, one record each: what the
prover's commitments (``prover/device.py``), the device coin
(``ops/device_coin.py``) and ``chip_smoke.py`` need of a hasher's kernels.
The JAX package keeps the same knowledge in winterfell_tpu/prover/
device.py (``_f64_hasher_entry`` :690-710, ``_FRI_COIN_KINDS_F64``
:974-997) and device_limb.py (``_DEVICE_HASHERS`` :80-89).

Records are keyed by the host hasher's name (``crypto.hashers.HASHERS``),
which is also the kind of its device coin.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import blake3, jive, rescue, rp62, sha3
from . import goldilocks as gl


class DeviceHasher(NamedTuple):
    """One hasher on the device.

    - ``kind``: "field" hashes (m, k) int64 element rows into
      (m, digest_words) digests, called ``hash_rows(rows)``; "bytes" hashes
      (m, W) int32 word rows of ``byte_len`` bytes (``words.rows_from_u64``)
      into (m, digest_words) int32 digests, and is called
      ``hash_rows(words, byte_len, digest_words)``;
    - ``words``: the digests are int32 words whose little-endian bytes are
      the digest (the byte hashers, and Rp62_248's packed digests, whose
      last byte is a zero pad), not (m, 4) int64 field elements (Rp64_256,
      RpJive64_256); the coin's seed has the same layout;
    - ``hash_rows`` / ``hash_rows_plain``: the row hash's wrapper and its
      plain version;
    - ``merge_rows``: one level of sibling merges, the coin's reseed (None
      where nothing merges outside the tree kernel);
    - ``merkle_levels``: every internal level of a tree;
    - ``digest_words``: the digest's width: int64 elements or u32 words;
    - ``combine``: the merge_many of a partitioned commitment's chunk
      digests (a list of digest tensors), where it is not the row hash of
      their concatenation;
    - ``coin``: whether the hasher has a device coin (every hasher but
      RpJive64_256), so the resident and fused-FRI routes;
    - ``draw``: the coin's draw kernel (its ``LAUNCHES`` key over f64; over
      f128 and f62 ``<draw>_f128``, ``<draw>_f62``; for a word coin also
      the entry point ``wt_<key>`` of ``library(device)``, the loaded
      library, ready on that device);
    - ``launches``: the ``LAUNCHES`` keys of the kernels one prove with the
      hasher launches on its default route;
    - ``field``: the field whose elements the hasher hashes ("f64", "f62"),
      the only one its provers and its coin take; None for the byte
      hashers, which hash any field's element bytes;
    - ``candidates`` / ``candidates_plain``: a word coin's candidate
      digests ``(seed, counter0, t) -> (t, digest_words)``, merge_with_int
      (seed, c) for c = counter0 + 1 .. counter0 + t, one launch, and
      their plain version (None for the Rp64_256 coin, whose candidates are
      permuted states, ``device_coin.rp64_coin_ops``).
    """

    name: str
    kind: str
    words: bool
    hash_rows: Callable
    hash_rows_plain: Callable
    merge_rows: Optional[Callable]
    merkle_levels: Callable
    digest_words: int
    combine: Optional[Callable]
    coin: bool
    draw: Optional[str]
    library: Optional[Callable]
    launches: Tuple[str, ...]
    field: Optional[str] = None
    candidates: Optional[Callable] = None
    candidates_plain: Optional[Callable] = None


def _ready(kernels):
    """``library(device)`` of a source whose kernels need no set-up per
    device."""
    return lambda device: kernels()


def _candidate_messages(seed, counter0: int, t: int):
    """(t, dw + 2) int32 messages seed ‖ LE64(c) for c = counter0 + 1 ..
    counter0 + t (blake/mod.rs:41-46 merge_with_int), built on the device
    from the seed tensor: no host copy."""
    ctr = torch.arange(counter0 + 1, counter0 + t + 1, dtype=torch.int64,
                       device=seed.device)
    return torch.cat([seed.reshape(1, -1).expand(t, seed.shape[0]),
                      ctr.view(torch.int32).reshape(t, 2)], dim=1)


def _hashed(hash_rows, dw: int):
    """A byte coin's candidates: the digests hash(seed ‖ LE64(c)), one
    row-hash launch (``hash_rows`` or its plain version)."""
    return lambda seed, counter0, t: hash_rows(
        _candidate_messages(seed, counter0, t), 4 * dw + 8, dw)


def _blake3(name: str, dw: int) -> DeviceHasher:
    return DeviceHasher(
        name, "bytes", True, blake3.blake3_hash_words,
        blake3.blake3_hash_words_plain, blake3.blake3_merge_rows,
        blake3.blake3_merkle_levels, dw, None, True, "blake3_coin_draw",
        _ready(blake3._kernels),
        ("blake3_hash_rows", "blake3_merge_rows", "blake3_merkle_tree",
         "blake3_coin_draw", "gl_mul"), None,
        _hashed(blake3.blake3_hash_words, dw),
        _hashed(blake3.blake3_hash_words_plain, dw))


DEVICE_HASHERS: Dict[str, DeviceHasher] = {
    h.name: h for h in (
        DeviceHasher(
            "rp64_256", "field", False, gl.rp64_hash_rows,
            rescue.rp64_hash_rows_plain, rescue.rp64_merge_rows,
            gl.merkle_levels_rp64, 4, None, True, "rp64_coin_draw", None,
            ("rp64_hash_rows", "rp64_merge_rows", "rp64_merkle_tree",
             "gl_mul", "rp64_permute_rows", "rp64_coin_draw"), "f64"),
        _blake3("blake3_256", 8),
        _blake3("blake3_192", 6),
        DeviceHasher(
            "sha3_256", "bytes", True, sha3.sha3_hash_words,
            sha3.sha3_hash_words_plain, sha3.sha3_merge_rows,
            sha3.sha3_merkle_levels, 8, None, True, "sha3_coin_draw",
            _ready(sha3._kernels),
            ("sha3_hash_rows", "sha3_merge_rows", "sha3_merkle_tree",
             "sha3_coin_draw", "gl_mul"), None,
            _hashed(sha3.sha3_hash_words, 8),
            _hashed(sha3.sha3_hash_words_plain, 8)),
        DeviceHasher(
            "rp_jive64_256", "field", False, jive.jive_hash_rows,
            jive.jive_hash_rows_plain, None, jive.jive_merkle_levels, 4,
            None, False, None, None,
            ("jive_hash_rows", "jive_merkle_tree", "gl_mul"), "f64"),
        # the f62 prover's Rescue hasher: f62 element rows in, packed digests
        # out; its coin's candidates and draw are rp62.cu's too
        DeviceHasher(
            "rp62_248", "field", True, rp62.rp62_hash_rows,
            rp62.rp62_hash_rows_plain, rp62.rp62_merge_rows,
            rp62.rp62_merkle_levels, 8, rp62.rp62_combine, True,
            "rp62_coin_draw", rp62.prepare,
            ("rp62_hash_rows", "rp62_merge_rows", "rp62_merkle_tree",
             "rp62_coin_candidates", "rp62_coin_draw_f62"), "f62",
            rp62.coin_candidates, rp62.coin_candidates_plain),
    )}
