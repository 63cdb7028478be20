"""Multi-chip sharding of the pipeline steps.

The reference's only parallel structure is OpenMP threads + fork/FIFO
pipelines on one host (`src/HaploCart.cpp:313-383`, SURVEY.md §2.9).
The device layout:

* **dp** (data parallel): read/mapping batches shard across cards;
  per-node accumulators and per-path log-likelihood vectors merge with
  `psum`.
* **tp** (tensor parallel): the node->path support matrix shards along
  the path axis; each card computes its slice of final_vec and the
  argmax is taken over the gathered vector.
* MCMC chains map across cards (chain parallelism) — see
  infer/tree_mcmc.py; chain statistics merge host-side.

Everything compiles against an abstract `jax.sharding.Mesh`, so the
same code runs on one card, the cards of one host (joined all to all,
so no mesh shape is tied to a topology), or a CPU mesh in tests.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.lax import Precision
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..pipelines.haplocart_device import (
    HcBatch,
    HcTables,
    mapping_scores,
    segment_sum_fixed_order,
)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: int = 1) -> Mesh:
    # local devices only: cross-process parallelism is rank-sharded
    # reads + host-side merges (parallel/multihost.py); a mesh spanning
    # other processes' devices would make outputs non-addressable here
    devs = jax.local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if dp is None:
        dp = len(devs) // tp
    arr = np.array(devs[: dp * tp]).reshape(dp, tp)
    return Mesh(arr, ("dp", "tp"))


# ----------------------------------------------------------- auto selection
_DEVICE_LIMIT: Optional[int] = None
_AUTO_CACHE: dict = {}
# engage tp once the support matrix that dp replicates on every card
# would exceed 1/128 of an 80 GB card (640 MiB), leaving the rest of
# the card to the mapper's batches and XLA's workspace. The real HC DB
# (11,825 x 5,179 in f64 = ~490 MB, `src/load.cpp:284-292`) stays
# replicated: dp alone then moves no support bytes between cards.
TP_BYTES_THRESHOLD = 80 * 2**30 // 128


def set_device_limit(n: Optional[int]) -> None:
    """CLI `--devices N`: cap the auto mesh (0/1 disables sharding)."""
    global _DEVICE_LIMIT
    _DEVICE_LIMIT = n
    _AUTO_CACHE.clear()


def auto_mesh(support_bytes: int = 0) -> Optional[Mesh]:
    """Mesh over all local devices — the production default for the
    CLI runners; None when a single device is visible (or the limit
    disables sharding). The successor of the reference's
    OpenMP thread pool (`src/HaploCart.cpp:408-421`).

    dp takes the whole mesh unless `support_bytes` (the caller's
    node x path support matrix size) exceeds TP_BYTES_THRESHOLD, in
    which case the path axis is sharded with just enough tp (powers of
    two) to bring the per-chip slice under the threshold — reads keep
    the remaining dp ways. Callers that pass nothing (euka's scorer
    flattens (dp, tp) into one data axis) always get the dp-major
    mesh."""
    n = len(jax.local_devices())
    if _DEVICE_LIMIT is not None:
        n = min(n, _DEVICE_LIMIT)
    if n <= 1:
        return None
    tp = 1
    while tp < n and n % (tp * 2) == 0 and (
        support_bytes // tp > TP_BYTES_THRESHOLD
    ):
        tp *= 2
    key = ("mesh", n, tp)
    if key not in _AUTO_CACHE:
        _AUTO_CACHE[key] = make_mesh(n_devices=n, dp=n // tp, tp=tp)
    return _AUTO_CACHE[key]


def sharded_score_fn(mesh: Mesh, bep: float = 1e-4,
                     consensus: bool = False):
    """Build the pjit-ed haplocart scoring step over (dp, tp):
    mappings shard over dp, the support matrix (and final_vec) over tp;
    the per-node accumulator merges with psum over dp."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            HcBatch(
                g=P("dp", None), r=P("dp", None), q=P("dp", None),
                pang=P("dp"), mq=P("dp"), b=P("dp"), node=P("dp"),
                valid=P("dp", None), use_bep=P("dp"),
            ),
            HcTables(
                match_tab=P(), mapp_tab=P(), qtab=P(), imtab=P(), bg=P(),
                support=P(None, "tp"),
            ),
        ),
        out_specs=P("tp"),
        check_vma=False,
    )
    def step(batch: HcBatch, t: HcTables):
        A = mapping_scores(batch, t, bep, consensus)
        d = A - batch.b
        n_nodes = t.support.shape[0]
        c = segment_sum_fixed_order(d, batch.node, n_nodes)
        c = jax.lax.psum(c, "dp")
        total_b = jax.lax.psum(batch.b.sum(), "dp")
        return total_b + jnp.dot(c, t.support, precision=Precision.HIGHEST)

    return jax.jit(step)


def shard_batch(batch: HcBatch, mesh: Mesh) -> HcBatch:
    """Pad the mapping axis to the dp size and device_put with dp
    sharding."""
    dp = mesh.shape["dp"]
    M = batch.g.shape[0]
    pad = (-M) % dp

    def prep(x, spec):
        if pad:
            width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            x = jnp.pad(x, width)
        return jax.device_put(x, NamedSharding(mesh, spec))

    return HcBatch(
        g=prep(batch.g, P("dp", None)),
        r=prep(batch.r, P("dp", None)),
        q=prep(batch.q, P("dp", None)),
        pang=prep(batch.pang, P("dp")),
        mq=prep(batch.mq, P("dp")),
        b=prep(batch.b, P("dp")),
        # padded mappings scatter into node 0 with zero weight (b=0,A=0)
        node=prep(batch.node, P("dp")),
        valid=prep(batch.valid, P("dp", None)),
        use_bep=prep(batch.use_bep, P("dp")),
    )


def shard_tables(t: HcTables, mesh: Mesh) -> HcTables:
    tp = mesh.shape["tp"]
    n_paths = t.support.shape[1]
    pad = (-n_paths) % tp
    support = t.support
    if pad:
        support = jnp.pad(support, ((0, 0), (0, pad)))
    rep = NamedSharding(mesh, P())
    return HcTables(
        match_tab=jax.device_put(t.match_tab, rep),
        mapp_tab=jax.device_put(t.mapp_tab, rep),
        qtab=jax.device_put(t.qtab, rep),
        imtab=jax.device_put(t.imtab, rep),
        bg=jax.device_put(t.bg, rep),
        support=jax.device_put(support, NamedSharding(mesh, P(None, "tp"))),
    )


def sharded_euka_score_fn(mesh: Mesh):
    """Data-parallel euka two-model scorer over the dp axis
    (the device equivalent of euka's OpenMP read loop,
    `src/readGAM_Euka.h:41-649` / SURVEY §2.9): the [B, L] aligned
    batch shards over dp, damage/quality tables replicate, and the
    per-read (in_clade, not_in_clade) outputs stay dp-sharded — no
    collective needed until the host-side detection filter."""
    from ..pipelines.euka import _score_batch_impl

    dp_b = NamedSharding(mesh, P(("dp", "tp")))
    dp_bl = NamedSharding(mesh, P(("dp", "tp"), None))
    rep = NamedSharding(mesh, P())
    in_sh = (dp_bl,) * 4 + (dp_b, dp_b, dp_bl) + (rep,) * 5
    out_sh = (dp_b, dp_b)
    return jax.jit(_score_batch_impl, in_shardings=in_sh,
                   out_shardings=out_sh)


def shard_euka_batch(mesh: Mesh, *arrays):
    """Pad the read axis to the mesh size and place with dp sharding.
    arrays: (g, r, q, n_pos [B,L]...), (L_read, pair_dist [B]),
    (valid [B,L]). Returns the padded arrays + original B."""
    n = mesh.size
    B = arrays[0].shape[0]
    pad = (-B) % n
    out = []
    for x in arrays:
        if pad:
            # edge-pad: padded rows duplicate a real read (safe for
            # the damage-length gather) and are sliced off by B
            width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            x = jnp.pad(x, width, mode="edge")
        spec = P(("dp", "tp")) if x.ndim == 1 else P(("dp", "tp"), None)
        out.append(jax.device_put(x, NamedSharding(mesh, spec)))
    return out, B
