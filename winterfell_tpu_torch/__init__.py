"""winterfell_tpu_torch — the PyTorch and CUDA port of winterfell_tpu.

The same STARK protocol and proof bytes as the JAX package, with the compute
path on torch tensors (exact int64 Goldilocks arithmetic, radix-2 NTT) and the
row hashes and Merkle merges of every hasher as hand-written CUDA kernels
for Hopper (``csrc/``). The transcript and proof wire format are the same
byte-exact mirrors of the reference (facebook/winterfell).

This port covers the f64 path with the hashers of the JAX package's f64
prover (Rp64_256, RpJive64_256, Blake3_256, Blake3_192, Sha3_256) and the
f128 path with BLAKE3 and SHA3: the host prover and verifier,
:class:`prover.device.GoldilocksProver` and
:class:`prover.device_limb.F128Prover`, which run on a CUDA card by default
(``device="cpu"`` runs the same tensor code on the CPU).
"""

from .air import (
    Air,
    AirContext,
    Assertion,
    BatchingMethod,
    EvaluationFrame,
    FieldExtension,
    PartitionOptions,
    ProofOptions,
    TraceInfo,
    TransitionConstraintDegree,
)
from .air.proof import Proof
from .crypto.hashers import (
    HASHERS,
    Blake3_192,
    Blake3_256,
    Rp64_256,
    RpJive64_256,
    Sha3_256,
)
from .crypto.merkle import BatchMerkleProof, MerkleTree
from .crypto.random_coin import DefaultRandomCoin
from .math.fields import F64, F128, Field
from .prover import Prover, ProverError, Trace, TraceTable
from .verifier import AcceptableOptions, VerifierError, verify

__version__ = "0.1.0"

__all__ = [
    "AcceptableOptions",
    "Air",
    "AirContext",
    "Assertion",
    "BatchMerkleProof",
    "BatchingMethod",
    "Blake3_192",
    "Blake3_256",
    "DefaultRandomCoin",
    "EvaluationFrame",
    "F64",
    "F128",
    "Field",
    "FieldExtension",
    "HASHERS",
    "MerkleTree",
    "PartitionOptions",
    "Proof",
    "ProofOptions",
    "Prover",
    "ProverError",
    "Rp64_256",
    "RpJive64_256",
    "Sha3_256",
    "Trace",
    "TraceInfo",
    "TraceTable",
    "TransitionConstraintDegree",
    "VerifierError",
    "verify",
]
