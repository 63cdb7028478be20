"""vgan_tpu — a pangenome analysis engine in JAX.

A from-scratch reimplementation of the capabilities of grenaud/vgan
(HaploCart, euka, soibean, keelime, gam2prof, duprm) on JAX/XLA, run
on an NVIDIA GPU:

* graph + read data live as packed device arrays,
* per-read x per-path likelihoods are dense contractions against a
  node-to-path support bitmatrix,
* per-base probability models (ancient-DNA damage, sequencing error,
  HKY85) are vectorized element-wise passes,
* MCMC samplers are `lax.scan` loops with chains vmapped and sharded
  across devices,
* read batches shard data-parallel over a `jax.sharding.Mesh`
  with `psum`/`allgather` reductions.

Reference behavior is documented per-module with `file:line` citations
into the vgan source tree.
"""

__version__ = "0.1.0"

# The reference accumulates likelihoods in `long double`
# (`src/HaploCart.cpp:297`); we keep float64 available on every backend
# for the precision-critical reductions (the dtype each device path
# uses is chosen in utils/precision.py).
import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)


def compile_cache_dir(environ=_os.environ):
    """Directory this package configures for JAX's persistent compile
    cache, or None when JAX_COMPILATION_CACHE_DIR is set (JAX reads that
    variable itself and nothing is configured here). Otherwise the
    cache sits at a fixed, git-ignored path inside the checkout: the
    path is part of the cache's key, so only a fixed one is hit again
    by a later process."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".jax_cache")


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
