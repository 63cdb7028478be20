"""Test harness config.

Tests run on CPU with a virtual 8-device mesh so multi-device sharding
paths (shard_map/psum over a Mesh) are exercised without a card. Tests
that need the GPU carry the `gpu` marker and take the `gpu` fixture:
they skip here and run on the card with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# no persistent compile cache in test runs (nor in the CLI subprocesses
# they start): tests write nothing into the checkout
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import pytest

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def ref():
    """The reference's own fixture tree. Only tests anchored on vg
    giraffe's output (its GAM and the goldens derived from it) still
    need it; they skip where it is absent."""
    if not REFERENCE.exists():
        pytest.skip("reference tree not available")
    return REFERENCE


@pytest.fixture
def gpu():
    """The GPU a `gpu`-marked test runs on; skips when JAX's default
    backend is not a GPU (decided here, at run time, so every pytest
    worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"
        )
    return jax.devices()[0]


@pytest.fixture(scope="session")
def toy_world(tmp_path_factory):
    """Seeded stand-in for the reference's test/reconstructInputSeq:
    a 5-path GFA (paths seq_1..seq_5) and 40 reads sampled from it.
    Returns (gfa_path, fastq_path, reads)."""
    from vgan_tpu.graph.synth import toy_gfa_world
    from vgan_tpu.io.fastx import write_fastq

    d = tmp_path_factory.mktemp("toy_world")
    gfa_text, reads = toy_gfa_world(seed=0)
    gfa = d / "target_graph.gfa"
    gfa.write_text(gfa_text)
    fq = d / "test_reads.fq"
    write_fastq(str(fq), reads)
    return gfa, fq, reads


@pytest.fixture(scope="session")
def toy_graph(ref):
    from vgan_tpu.graph.packed import PackedGraph

    return PackedGraph.from_gfa(str(ref / "test/reconstructInputSeq/target_graph.gfa"))


@pytest.fixture(scope="session")
def toy_reads(ref):
    from vgan_tpu.io.gam import read_gam

    return read_gam(str(ref / "test/reconstructInputSeq/test_reads.gam"))
