"""The hashers of the f64 prover's device path, one record each: what the
prover's commitments (``prover/device.py``), the device coin
(``ops/device_coin.py``) and ``chip_smoke.py`` need of a hasher's kernels.
The JAX package keeps the same knowledge in winterfell_tpu/prover/
device.py (``_f64_hasher_entry`` :690-710, ``_FRI_COIN_KINDS_F64``
:974-997).

Records are keyed by the host hasher's name (``crypto.hashers.HASHERS``),
which is also the kind of its device coin.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

from . import blake3, jive, rescue, sha3
from . import goldilocks as gl


class DeviceHasher(NamedTuple):
    """One hasher on the device.

    - ``kind``: "field" hashes (m, k) int64 element rows into (m, 4) int64
      digests; "bytes" hashes (m, W) int32 word rows of ``byte_len`` bytes
      (``words.rows_from_u64``) into (m, digest_words) int32 digests, and is
      called ``hash_rows(words, byte_len, digest_words)``;
    - ``hash_rows`` / ``hash_rows_plain``: the row hash's wrapper and its
      plain version;
    - ``merge_rows``: one level of sibling merges, the coin's reseed (None
      where nothing merges outside the tree kernel);
    - ``merkle_levels``: every internal level of a tree;
    - ``digest_words``: digest elements ("field") or u32 words ("bytes");
    - ``coin``: whether the hasher has a device coin (every f64 hasher but
      RpJive64_256), so the resident and fused-FRI routes;
    - ``draw``: the coin's draw kernel (its ``LAUNCHES`` key; for a byte
      coin also the entry point ``wt_<draw>`` of ``library()``);
    - ``launches``: the ``LAUNCHES`` keys of the kernels one prove with the
      hasher launches on its default route.
    """

    name: str
    kind: str
    hash_rows: Callable
    hash_rows_plain: Callable
    merge_rows: Optional[Callable]
    merkle_levels: Callable
    digest_words: int
    coin: bool
    draw: Optional[str]
    library: Optional[Callable]
    launches: Tuple[str, ...]


def _blake3(name: str, dw: int) -> DeviceHasher:
    return DeviceHasher(
        name, "bytes", blake3.blake3_hash_words,
        blake3.blake3_hash_words_plain, blake3.blake3_merge_rows,
        blake3.blake3_merkle_levels, dw, True, "blake3_coin_draw",
        blake3._kernels,
        ("blake3_hash_rows", "blake3_merge_rows", "blake3_merkle_tree",
         "blake3_coin_draw", "gl_mul"))


DEVICE_HASHERS: Dict[str, DeviceHasher] = {
    h.name: h for h in (
        DeviceHasher(
            "rp64_256", "field", gl.rp64_hash_rows,
            rescue.rp64_hash_rows_plain, rescue.rp64_merge_rows,
            gl.merkle_levels_rp64, 4, True, "rp64_coin_draw", None,
            ("rp64_hash_rows", "rp64_merge_rows", "rp64_merkle_tree",
             "gl_mul", "rp64_permute_rows", "rp64_coin_draw")),
        _blake3("blake3_256", 8),
        _blake3("blake3_192", 6),
        DeviceHasher(
            "sha3_256", "bytes", sha3.sha3_hash_words,
            sha3.sha3_hash_words_plain, sha3.sha3_merge_rows,
            sha3.sha3_merkle_levels, 8, True, "sha3_coin_draw",
            sha3._kernels,
            ("sha3_hash_rows", "sha3_merge_rows", "sha3_merkle_tree",
             "sha3_coin_draw", "gl_mul")),
        DeviceHasher(
            "rp_jive64_256", "field", jive.jive_hash_rows,
            jive.jive_hash_rows_plain, None, jive.jive_merkle_levels, 4,
            False, None, None,
            ("jive_hash_rows", "jive_merkle_tree", "gl_mul")),
    )}
