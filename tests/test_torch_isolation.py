"""The port stands alone: no file of winterfell_tpu_torch/ (nor chip_smoke.py)
imports jax or the JAX package, and the state that defines a proof — Rescue,
Jive and Rp62 constants, proof options, traces, digest words — crosses
between the packages unchanged."""

import os
import re

import jax
import numpy as np
import pytest
import torch

from winterfell_tpu.air import FieldExtension, ProofOptions
from winterfell_tpu.crypto import rescue_constants as jax_rc
from winterfell_tpu.crypto import rescue_jive_rp62_constants as jax_jive
from winterfell_tpu.examples.fibonacci import build_fib_trace
from winterfell_tpu.math.fields import F64
from winterfell_tpu.utils.serde import ByteWriter
from winterfell_tpu_torch import interop
from winterfell_tpu_torch.crypto import rescue_constants as port_rc
from winterfell_tpu_torch.crypto import rescue_jive_constants as port_jive

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# an import of jax, or of winterfell_tpu itself (not winterfell_tpu_torch)
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|winterfell_tpu(?!_torch)\b)",
    re.M)


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "winterfell_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_forbidden_import_regex():
    assert _FORBIDDEN.search("import jax.numpy as jnp\n")
    assert _FORBIDDEN.search("    from winterfell_tpu.ops import goldilocks\n")
    assert _FORBIDDEN.search("from winterfell_tpu import verify\n")
    assert not _FORBIDDEN.search("from winterfell_tpu_torch.ops import x\n")
    assert not _FORBIDDEN.search("import winterfell_tpu_torch\n")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert not _FORBIDDEN.search(src), path


@pytest.mark.parametrize("name", ["RP64_256_MDS", "RP64_256_ARK1",
                                  "RP64_256_ARK2"])
def test_rescue_constants_equal(name):
    assert getattr(port_rc, name) == getattr(jax_rc, name)
    kind = name.rsplit("_", 1)[1]
    # RpJive64_256's and Rp62_248's tables of the kind
    for table in ("JIVE_" + kind, "RP62_" + kind):
        assert getattr(port_jive, table) == getattr(jax_jive, table)


def test_tensor_roundtrip_keeps_bits():
    rng = np.random.default_rng(11)
    a = rng.integers(0, F64.p, size=(33, 3), dtype=np.uint64)
    a[0, 0], a[0, 1] = F64.p - 1, 1 << 63
    t = interop.tensor_from_u64(a)
    assert t.dtype == torch.int64 and t.shape == (33, 3)
    assert np.array_equal(interop.u64_from_tensor(t), a)
    words = rng.integers(0, 2**32, size=(5, 8), dtype=np.uint32)
    words[0] = 2**32 - 1
    w = interop.tensor_from_u32(words)
    assert w.dtype == torch.int32 and w.shape == (5, 8)
    assert np.array_equal(interop.u32_from_tensor(w), words)


def test_trace_and_options_cross_over():
    jax_trace = build_fib_trace(F64, 64)
    rows = np.array(jax_trace.main_segment(), dtype=np.uint64)
    trace = interop.trace_from_numpy(rows, device="cpu")
    assert trace.length == 32 and trace.width == 2
    assert np.array_equal(trace.main_segment().astype(np.uint64), rows)
    cached = trace.device_cache()[("torch", "cpu")]
    assert np.array_equal(interop.u64_from_tensor(cached), rows)

    opts = ProofOptions(32, 8, 0, FieldExtension.CUBIC, 8, 31)
    w = ByteWriter()
    opts.write_into(w)
    port_opts = interop.options_from_bytes(w.to_bytes())
    assert (port_opts.num_queries, port_opts.blowup_factor,
            int(port_opts.field_extension), port_opts.fri_folding_factor,
            port_opts.fri_remainder_max_degree) == (32, 8, 3, 8, 31)
