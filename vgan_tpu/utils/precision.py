"""Float dtype of the device scorers and samplers.

One rule, decided from the backend in use when a run starts (never at
import, which would pin the backend before the caller chose it), for
the two kinds of device math:

* "scorer": HaploCart's device scorer. f64 on every backend: its
  argmax over thousands of near-identical haplotypes must match the
  f64 host oracle (the reference accumulates in `long double`,
  `src/HaploCart.cpp:297`), and on the H100 f64 costs nothing
  measurable end to end (PERF.md).
* "sampler": the euka abundance and soibean tree MH chains. f64 on the
  CPU, for bit-parity with the oracles in the tests; f32 on the GPU,
  where the f64 chain ran 1.5x slower per iteration while the f32
  posterior summaries agree to <1e-3 (PERF.md; the f32-vs-f64 estimate
  tests in tests/test_soibean.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_DTYPE = {
    ("cpu", "scorer"): jnp.float64,
    ("gpu", "scorer"): jnp.float64,
    ("cpu", "sampler"): jnp.float64,
    ("gpu", "sampler"): jnp.float32,
}


def compute_dtype(use: str, backend: str | None = None):
    """Float dtype for `use` ("scorer" or "sampler") on `backend`
    (default: JAX's default backend). A pair without an entry is an
    error, not a silent default."""
    backend = backend or jax.default_backend()
    try:
        return _DTYPE[backend, use]
    except KeyError:
        raise RuntimeError(
            f"no compute dtype chosen for {use!r} on backend {backend!r}"
        ) from None
