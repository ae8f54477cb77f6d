"""LimbFieldProver, F128Prover and F62Prover — the tensor prove() pipeline
for f128 AIRs with BLAKE3 or SHA3 commitments and for f62 AIRs with BLAKE3,
SHA3 or Rp62_248 commitments: the port of winterfell_tpu/prover/
device_limb.py for its f128 and f62 engines.

The reference runs 12 of its 13 CLI examples over f128 with BLAKE3
commitments (winterfell_tpu/examples/cli.py:41-140). The pipeline is the f64
prover's (:class:`~winterfell_tpu_torch.prover.device.DeviceProver`) over the
f128 engine ``ops/f128.py``: elements are (..., 2) int64 tensors of (lo, hi)
words, extension elements (..., d, 2); every field op is one B13 launch and
every NTT stage one B13n launch (csrc/f128.cu). Row hashing reads each LDE
row of w elements in place as 4w u32 words, the elements' little-endian
bytes, with the f64 prover's BLAKE3 / SHA3 kernels (B10, B11).

The f62 pipeline is the same over ``ops/f62.py``: an element is one int64
holding its canonical value (f64's layout, so row hashing reads the LDE
rows as f64 rows), every field op one B14 launch and every NTT stage one
B14n launch (csrc/f62.cu); with Rp62_248 the rows are hashed as elements by
B15 (csrc/rp62.cu) into packed 31-byte digests, and the coin is Rp62_248's
(``ops/device_coin.py``).

Routes, dispatched exactly as the JAX LimbFieldProver.prove does
(device_limb.py:606-616), under the same switches, all giving the host
prover's proof bytes (tests/test_torch_f128_prover.py):

- **resident**: steps 1-6 on the device with the Fiat–Shamir coin there
  (``ops/device_coin.py``, the f128 draw); no host read between the trace
  upload and the result pulls. Taken for one segment, at least one FRI
  layer, a remainder of at least 2, an LDE of at most ``_LEVEL_FUSE`` rows
  and an OOD row of at most 1024 bytes (for every hasher, Rp62_248
  included), unless ``WINTER_RESIDENT=0``;
- **phased + fused FRI**: the host coin between phases, then the FRI commit
  phase with the coin on the device (``WINTER_RESIDENT=0``, or a larger
  LDE, up to ``_FRI_FUSE_LIMIT``);
- **phased + host coin** (``WINTER_FUSED_FRI=0`` as well, or no FRI layer).
"""

from __future__ import annotations

import os

from ..crypto.hashers import HASHERS
from ..ops import f62, f128
from ..ops.device_hashers import DEVICE_HASHERS, DeviceHasher
from .device import DeviceProver

# The JAX package's route switches and limits (winterfell_tpu/prover/
# device_limb.py:96, :459-465), read from the same variables.
_LEVEL_FUSE = 1 << 20     # the resident route's largest LDE
_FRI_FUSE_LIMIT = 1 << 22
_FUSED_FRI_ON = os.environ.get("WINTER_FUSED_FRI", "1") not in ("", "0")
_RESIDENT_ON = os.environ.get("WINTER_RESIDENT", "1") not in ("", "0")


class LimbFieldProver(DeviceProver):
    """Drop-in Prover for limb-engine fields with BLAKE3, SHA3 or Rp62_248
    commitments. Wrap a host prover class with ``accelerate`` on a concrete
    subclass (:class:`F128Prover`, :class:`F62Prover`); pass ``device=``
    (default "cuda") to choose where the pipeline runs."""

    def _device_hasher(self) -> DeviceHasher:
        """The device record of the hasher: BLAKE3, SHA3 or Rp62_248 (which
        hashes f62 elements: with F62Prover only); any other fails the JAX
        LimbFieldProver's assertions (device_limb.py:583-587)."""
        h = DEVICE_HASHERS.get(getattr(self.hasher, "name", None))
        if (h is None or h.field not in (None, "f62")
                or HASHERS[h.name] is not self.hasher):
            raise AssertionError(
                f"{type(self).__name__} requires a BLAKE3, SHA3 or Rp62_248 "
                "hasher (device row hashing)")
        if h.field not in (None, self.engine.NAME):
            raise AssertionError(
                "Rp62_248 hashes f62 elements — pair it with F62Prover")
        return h

    def _routes(self):
        return _RESIDENT_ON, _FUSED_FRI_ON, _LEVEL_FUSE, _FRI_FUSE_LIMIT

    def _ood_limited(self, h: DeviceHasher) -> bool:
        return True  # the JAX limb dispatch limits every hasher's OOD row


class F128Prover(LimbFieldProver):
    """Drop-in Prover for f128 AIRs (the reference's default field)."""

    engine = f128


class F62Prover(LimbFieldProver):
    """Drop-in Prover for f62 AIRs with BLAKE3, SHA3 or Rp62_248
    commitments."""

    engine = f62
