"""LimbFieldProver and F128Prover — the tensor prove() pipeline for f128 AIRs
with BLAKE3 or SHA3 commitments: the port of winterfell_tpu/prover/
device_limb.py for its f128 engine.

The reference runs 12 of its 13 CLI examples over f128 with BLAKE3
commitments (winterfell_tpu/examples/cli.py:41-140). The pipeline is the f64
prover's (:class:`~winterfell_tpu_torch.prover.device.DeviceProver`) over the
f128 engine ``ops/f128.py``: elements are (..., 2) int64 tensors of (lo, hi)
words, extension elements (..., d, 2); every field op is one B13 launch and
every NTT stage one B13n launch (csrc/f128.cu). Row hashing reads each LDE
row of w elements in place as 4w u32 words, the elements' little-endian
bytes, with the f64 prover's BLAKE3 / SHA3 kernels (B10, B11).

Routes, dispatched exactly as the JAX LimbFieldProver.prove does
(device_limb.py:606-616), under the same switches, all giving the host
prover's proof bytes (tests/test_torch_f128_prover.py):

- **resident**: steps 1-6 on the device with the Fiat–Shamir coin there
  (``ops/device_coin.py``, the f128 draw); no host read between the trace
  upload and the result pulls. Taken for one segment, at least one FRI
  layer, a remainder of at least 2, an LDE of at most ``_LEVEL_FUSE`` rows
  and an OOD row of at most 1024 bytes, unless ``WINTER_RESIDENT=0``;
- **phased + fused FRI**: the host coin between phases, then the FRI commit
  phase with the coin on the device (``WINTER_RESIDENT=0``, or a larger
  LDE, up to ``_FRI_FUSE_LIMIT``);
- **phased + host coin** (``WINTER_FUSED_FRI=0`` as well, or no FRI layer).
"""

from __future__ import annotations

import os

from ..crypto.hashers import HASHERS
from ..ops import f128
from ..ops.device_hashers import DEVICE_HASHERS, DeviceHasher
from .device import DeviceProver

# The JAX package's route switches and limits (winterfell_tpu/prover/
# device_limb.py:96, :459-465), read from the same variables.
_LEVEL_FUSE = 1 << 20     # the resident route's largest LDE
_FRI_FUSE_LIMIT = 1 << 22
_FUSED_FRI_ON = os.environ.get("WINTER_FUSED_FRI", "1") not in ("", "0")
_RESIDENT_ON = os.environ.get("WINTER_RESIDENT", "1") not in ("", "0")


class LimbFieldProver(DeviceProver):
    """Drop-in Prover for limb-engine fields with BLAKE3 or SHA3
    commitments. Wrap a host prover class with ``accelerate`` on a concrete
    subclass (:class:`F128Prover`); pass ``device=`` (default "cuda") to
    choose where the pipeline runs."""

    def _device_hasher(self) -> DeviceHasher:
        """The device record of the hasher: BLAKE3 or SHA3 (Rp62_248, the
        JAX limb prover's third, hashes f62 elements and comes with f62);
        any other fails the JAX LimbFieldProver's assertion."""
        h = DEVICE_HASHERS.get(getattr(self.hasher, "name", None))
        if h is None or h.kind != "bytes" or HASHERS[h.name] is not self.hasher:
            raise AssertionError(
                f"{type(self).__name__} requires a BLAKE3, SHA3 or Rp62_248 "
                "hasher (device row hashing)")
        return h

    def _routes(self):
        return _RESIDENT_ON, _FUSED_FRI_ON, _LEVEL_FUSE, _FRI_FUSE_LIMIT


class F128Prover(LimbFieldProver):
    """Drop-in Prover for f128 AIRs (the reference's default field)."""

    engine = f128
