"""Process-wide rules decided once: the device float dtype, the compile
cache directory, and which cards a multi-process run gives each
process."""
import os

import jax.numpy as jnp
import pytest

import vgan_tpu
from vgan_tpu.parallel import multihost
from vgan_tpu.utils import precision


@pytest.mark.parametrize(
    "backend, use, want",
    [
        ("cpu", "scorer", jnp.float64),
        ("gpu", "scorer", jnp.float64),
        ("cpu", "sampler", jnp.float64),
        ("gpu", "sampler", jnp.float32),
    ],
)
def test_compute_dtype_by_backend(backend, use, want):
    assert precision.compute_dtype(use, backend) == want


def test_compute_dtype_defaults_to_backend_in_use_and_rejects_unknown():
    # tests run on CPU: both kinds of device math take f64
    assert precision.compute_dtype("scorer") == jnp.float64
    assert precision.compute_dtype("sampler") == jnp.float64
    with pytest.raises(RuntimeError, match="no compute dtype"):
        precision.compute_dtype("scorer", "rocm")
    with pytest.raises(RuntimeError, match="no compute dtype"):
        precision.compute_dtype("kernel", "cpu")


def test_compile_cache_dir_rule():
    # set: JAX reads the variable itself; this package configures nothing
    assert vgan_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere"}
    ) is None
    # unset (or empty): a fixed directory inside the checkout
    root = os.path.dirname(os.path.dirname(os.path.abspath(vgan_tpu.__file__)))
    for env in ({}, {"JAX_COMPILATION_CACHE_DIR": ""}):
        assert vgan_tpu.compile_cache_dir(env) == os.path.join(root, ".jax_cache")


@pytest.mark.parametrize(
    "coordinator, pid, want",
    [
        ("127.0.0.1:29000", 0, [0]),
        ("localhost:29000", 3, [3]),
        ("[::1]:29000", 1, [1]),
        ("node7.cluster:29000", 2, None),
    ],
)
def test_local_device_ids_one_card_per_process_on_one_host(coordinator, pid, want):
    assert multihost.local_device_ids(coordinator, pid) == want
