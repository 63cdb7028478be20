"""Device-resident HaploCart scoring step.

The full per-batch compute of `src/HaploCart.cpp:408-421` as one jitted
function: per-base probability math on [M, S] mapping tiles,
per-node accumulation (a segment sum in a fixed order), and the path reduction as
a single [n_nodes] x [n_nodes, n_paths] matvec. M = total
mappings in the batch, S = max node length (8 for the HC graph,
`src/test.cpp:627`).

This function is the framework's flagship jittable step: it is what
`__graft_entry__.entry()` exposes and what bench.py measures.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.lax import Precision
import numpy as np

from ..models import mutation, phred
from ..utils import precision


class HcBatch(NamedTuple):
    """Columnar mapping batch (padded)."""

    g: jnp.ndarray  # [M, S] graph codes (0..3 ACGT, >=4 skip)
    r: jnp.ndarray  # [M, S] read codes (from read start — reference quirk)
    q: jnp.ndarray  # [M, S] int quality of the mapping slice
    pang: jnp.ndarray  # [M] pangenome coordinate of the mapping's node
    mq: jnp.ndarray  # [M] read mapping quality
    b: jnp.ndarray  # [M] unsupported-path penalty (precomputed log-sum)
    node: jnp.ndarray  # [M] node index
    valid: jnp.ndarray  # [M, S] in-bounds mask
    use_bep: jnp.ndarray  # [M] read's sticky qual>=90 flag
    #   (`src/update_likelihood.cpp:42`: eps from the background error
    #   prob instead of the quality string; always set in consensus
    #   mode, `src/HaploCart.cpp:394-399`)


class HcTables(NamedTuple):
    match_tab: jnp.ndarray  # [PAN] (1-mu)^gens
    mapp_tab: jnp.ndarray  # [PAN] mappability
    qtab: jnp.ndarray  # [100] p_seq_error
    imtab: jnp.ndarray  # [100] p_incorrectly_mapped
    bg: jnp.ndarray  # [8] background freqs by code
    support: jnp.ndarray  # [n_nodes, n_paths]


def make_tables(support: np.ndarray, dtype=jnp.float32) -> HcTables:
    bg = np.concatenate([mutation.BACKGROUND_FREQ, [0.25, 0.25, 0.25]])
    return HcTables(
        match_tab=jnp.asarray(mutation.match_prob_table(), dtype),
        mapp_tab=jnp.asarray(np.ones(mutation.PANGENOME_LEN), dtype),
        qtab=jnp.asarray(phred.qscore_vec(), dtype),
        imtab=jnp.asarray(phred.incorrect_mapping_vec(), dtype),
        bg=jnp.asarray(bg, dtype),
        support=jnp.asarray(support, dtype),
    )


def mapping_scores(batch: HcBatch, t: HcTables, bep, consensus: bool):
    """Per-mapping supported-increment A[M] (`src/process_mapping.cpp:54-81`)."""
    qv = t.qtab[jnp.clip(batch.q, 0, 99)]
    valid = batch.valid & (batch.g < 4) & (batch.r < 4)
    match = batch.g == batch.r
    eps_q = jnp.where(match, qv, 1.0 - qv)
    # qual>=90 / consensus reads: eps from the background error prob
    # (`src/get_p_obs_base.cpp:14-17`)
    eps_b = jnp.where(match, bep, 1.0 - bep)
    eps = jnp.where(batch.use_bep[:, None], eps_b, eps_q)
    p_obs = t.match_tab[batch.pang][:, None] * (1.0 - eps)
    if consensus:
        term = jnp.log((1.0 - bep) * p_obs)
    else:
        p_correct = (
            1.0 - t.imtab[jnp.clip(batch.mq, 0, 99)]
        ) * t.mapp_tab[batch.pang]
        bg = t.bg[batch.r]
        term = jnp.log(
            (1.0 - p_correct)[:, None] * bg + p_correct[:, None] * p_obs
        )
    return jnp.where(valid, term, 0.0).sum(axis=1)


def segment_sum_fixed_order(d, node, num_segments: int):
    """Per-node sums of d, summed in an order fixed by the data.

    `jax.ops.segment_sum` lowers to a scatter-add, which XLA runs with
    atomic adds on the GPU: the order of the additions, and so the last
    bits of every sum, change from run to run. Here the mappings are
    stably sorted by node, each node's run is summed by a segmented
    associative scan, and each run's total is written once to its node
    (unique indices), so the result is the same on every run."""
    order = jnp.argsort(node, stable=True)
    ns, ds = node[order], d[order]
    boundary = ns[1:] != ns[:-1]
    first = jnp.concatenate([jnp.ones((1,), bool), boundary])
    last = jnp.concatenate([boundary, jnp.ones((1,), bool)])

    def add_within_runs(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va + vb)

    _, run_sums = jax.lax.associative_scan(add_within_runs, (first, ds))
    # rows that do not end a run go to an out-of-range index and drop
    dest = jnp.where(last, ns, num_segments)
    return jnp.zeros(num_segments, d.dtype).at[dest].set(run_sums, mode="drop")


@partial(jax.jit, static_argnames=("consensus",))
def score_batch(batch: HcBatch, t: HcTables, bep=1e-4, consensus: bool = False):
    """final_vec over paths for one sharded batch of mappings."""
    A = mapping_scores(batch, t, bep, consensus)
    d = A - batch.b
    n_nodes = t.support.shape[0]
    c = segment_sum_fixed_order(d, batch.node, n_nodes)
    total_b = batch.b.sum()
    # HIGHEST: an f32 contraction may otherwise run in TF32 on the GPU,
    # whose rounding of the per-node sums can flip the argmax over
    # thousands of near-identical haplotypes
    return total_b + jnp.dot(c, t.support, precision=Precision.HIGHEST)


@partial(jax.jit, static_argnames=("M", "S", "consensus"))
def score_packed(buf, t: HcTables, bep, M: int, S: int,
                 consensus: bool = False):
    """Unpack hc_columnar.pack_batch's single uint8 buffer on device
    and score it — ONE transfer + ONE dispatch for the whole batch
    (the single-device production path; the math is score_batch's,
    byte for byte)."""
    o = 0
    grq = buf[: 3 * M * S].reshape(3, M, S).astype(jnp.int32)
    o = 3 * M * S
    mq = buf[o : o + M].astype(jnp.int32)
    use_bep = buf[o + M : o + 2 * M] > 0
    o += 2 * M
    o += (-o) % 8
    i32 = jax.lax.bitcast_convert_type(
        buf[o : o + 12 * M].reshape(3 * M, 4), jnp.int32
    )
    o += 12 * M
    dt = t.support.dtype
    isz = jnp.dtype(dt).itemsize
    b = jax.lax.bitcast_convert_type(
        buf[o : o + isz * M].reshape(M, isz), dt
    )
    take = i32[2 * M :]
    valid = jnp.arange(S, dtype=jnp.int32)[None, :] < take[:, None]
    if consensus:
        use_bep = jnp.ones_like(use_bep)
    batch = HcBatch(
        g=grq[0], r=grq[1], q=grq[2], pang=i32[:M], mq=mq, b=b,
        node=i32[M : 2 * M], valid=valid, use_bep=use_bep,
    )
    A = mapping_scores(batch, t, bep, consensus)
    d = A - batch.b
    c = segment_sum_fixed_order(d, batch.node, t.support.shape[0])
    return batch.b.sum() + jnp.dot(
        c, t.support, precision=Precision.HIGHEST
    )


def synth_batch(
    n_reads: int,
    read_len: int = 100,
    node_len: int = 8,
    n_nodes: int = 11825,
    seed: int = 0,
    dtype=jnp.float32,
) -> HcBatch:
    """Synthesize a HaploCart-scale workload (for bench/compile-check)."""
    rng = np.random.default_rng(seed)
    m_per_read = read_len // node_len
    M = n_reads * m_per_read
    S = node_len
    g = rng.integers(0, 4, size=(M, S), dtype=np.int32)
    r = g.copy()
    mut = rng.random((M, S)) < 0.02
    r[mut] = rng.integers(0, 4, size=int(mut.sum()))
    q = rng.integers(20, 40, size=(M, S)).astype(np.int32)
    pang = rng.integers(1, 16569, size=M).astype(np.int32)
    mq = np.repeat(rng.integers(30, 61, size=n_reads), m_per_read).astype(np.int32)
    b = (read_len * np.log(1e-3)) * np.ones(M)
    node = rng.integers(0, n_nodes, size=M).astype(np.int32)
    valid = np.ones((M, S), dtype=bool)
    return HcBatch(
        g=jnp.asarray(g),
        r=jnp.asarray(r),
        q=jnp.asarray(q),
        pang=jnp.asarray(pang),
        mq=jnp.asarray(mq),
        b=jnp.asarray(b, dtype),
        node=jnp.asarray(node),
        valid=jnp.asarray(valid),
        use_bep=jnp.zeros(M, dtype=bool),
    )


def score_batch_reference(batch: HcBatch, support: np.ndarray,
                          bep: float = 1e-4) -> np.ndarray:
    """Plain numpy f64 twin of `score_batch` with `make_tables`' tables
    (unit mappability, non-consensus): the oracle the device scorer is
    checked against at the real DB's shape."""
    g, r, q, pang, mq, b, node, valid, use_bep = (np.asarray(x) for x in batch)
    b = b.astype(np.float64)
    ok = valid & (g < 4) & (r < 4)
    match = g == r
    qv = phred.qscore_vec()[np.clip(q, 0, 99)]
    eps = np.where(use_bep[:, None], np.where(match, bep, 1.0 - bep),
                   np.where(match, qv, 1.0 - qv))
    p_obs = mutation.match_prob_table()[pang][:, None] * (1.0 - eps)
    p_correct = 1.0 - phred.incorrect_mapping_vec()[np.clip(mq, 0, 99)]
    bg = np.concatenate([mutation.BACKGROUND_FREQ, [0.25, 0.25, 0.25]])
    term = np.log((1.0 - p_correct)[:, None] * bg[np.minimum(r, 7)]
                  + p_correct[:, None] * p_obs)
    A = np.where(ok, term, 0.0).sum(axis=1)
    c = np.bincount(node, weights=A - b, minlength=support.shape[0])
    return b.sum() + c @ support.astype(np.float64)


def synth_support(n_nodes: int = 11825, n_paths: int = 5179, seed: int = 1):
    rng = np.random.default_rng(seed)
    # realistic density: most nodes are on most paths (backbone), some
    # variant nodes are sparse
    support = rng.random((n_nodes, n_paths)) < 0.85
    return support.astype(np.float32)


def batch_from_alignments(db, alignments, max_node_len: int = 0,
                          bucket_m: bool = True):
    """Build an HcBatch from real GAM alignments (device-scorer input).

    Host prep mirrors pipelines/haplocart.mapping_scalars (same quirks:
    read bases from the read start, per-mapping quality slices, whole-
    read unsupported penalty); the per-base math then runs on device.

    max_node_len=0 (default) sizes the S axis to the batch's longest
    mapping, rounded up to a multiple of 8 (the real HC graph has
    <=8bp nodes, `src/test.cpp:627`, so S=8 there); a positive value
    truncates mappings to it. The M axis is bucketed to the next
    power-of-two-ish size with inert padding rows so ragged batches
    reuse one compiled executable."""
    from ..graph.reconstruct import reconstruct_graph_sequence
    from ..models import phred
    from ..utils import dna

    qscore = phred.qscore_vec()
    log_q0 = float(np.log(qscore[0]))

    # phase 1: host reconstruction + per-read scalars
    recs = []  # (gcodes, rcodes, qual, size_m, starts, nidx, mq, b_read, bep_flag)
    s_needed = 1
    for a in alignments:
        if a.identity < 1e-10 or not a.path.mappings:
            continue
        graph_seq, read_seq, sizes = reconstruct_graph_sequence(
            db.graph, a.path, a.sequence
        )
        gcodes = dna.encode(graph_seq).astype(np.int32)
        rcodes = dna.encode(read_seq).astype(np.int32)
        L = len(read_seq)
        qual = np.zeros(2 * L + 8, dtype=np.int64)
        q_raw = np.frombuffer(a.quality, dtype=np.uint8)
        qual[: len(q_raw)] = q_raw
        n_map = len(a.path.mappings)
        # per-mapping sizes: sizes is per-edit (reference quirk) but
        # indexed per mapping (`src/update_likelihood.cpp:36`)
        size_m = np.array(
            [sizes[i] if i < len(sizes) else 0 for i in range(n_map)],
            dtype=np.int64,
        )
        starts = np.concatenate([[0], np.cumsum(size_m)[:-1]])
        # unsupported-path penalty over [pos, pos+L) of the padded
        # quality array, via one cumulative sum per read
        logq = np.log(qscore[np.clip(qual, 0, 99)])
        cum = np.concatenate([[0.0], np.cumsum(logq)])
        ends = starts + L
        in_range = np.minimum(ends, len(qual))
        b_read = (
            cum[in_range] - cum[np.minimum(starts, len(qual))]
            + (ends - in_range) * log_q0
        )
        nidx = np.array(
            [m.position.node_id - db.graph.min_id for m in a.path.mappings],
            dtype=np.int32,
        )
        bep_flag = bool((q_raw >= 90).any())
        s_needed = max(s_needed, int(size_m.max(initial=0)))
        recs.append((gcodes, rcodes, qual, size_m, starts, nidx,
                     min(a.mapping_quality, 99), b_read, bep_flag))
    if not recs:
        return None

    S = max_node_len if max_node_len > 0 else -(-s_needed // 8) * 8
    col = np.arange(S)
    rows_g, rows_r, rows_q, rows_v = [], [], [], []
    pang, mq, bvec, node, use_bep = [], [], [], [], []
    # phase 2: padded row assembly at the chosen S
    for gcodes, rcodes, qual, size_m, starts, nidx, mqv, b_read, bf in recs:
        take = np.minimum(size_m, S)
        # all rows of this read in one gather
        idx = starts[:, None] + col[None, :]  # [n_map, S]
        v = col[None, :] < take[:, None]
        gpad = np.full(len(gcodes) + S, 255, dtype=np.int32)
        gpad[: len(gcodes)] = gcodes
        g_rows = np.where(v, gpad[np.minimum(idx, len(gpad) - 1)], 255)
        # read row content is shared: the first `take` chars of the
        # read from its start (reference quirk), masked per mapping
        r_base = np.full(S, 255, dtype=np.int32)
        r_base[: min(S, len(rcodes))] = rcodes[:S]
        r_rows = np.where(v, r_base[None, :], 255)
        qpad = np.zeros(len(qual) + S, dtype=np.int32)
        qpad[: len(qual)] = qual
        q_rows = np.where(v, qpad[np.minimum(idx, len(qpad) - 1)], 0)
        n_map = len(size_m)
        rows_g.append(g_rows)
        rows_r.append(r_rows)
        rows_q.append(q_rows)
        rows_v.append(v)
        node.append(nidx)
        pang.append(db.pangenome_base[nidx].astype(np.int32))
        mq.append(np.full(n_map, mqv, dtype=np.int32))
        bvec.append(b_read)
        use_bep.append(np.full(n_map, bf, dtype=bool))

    g = np.concatenate(rows_g)
    M = len(g)
    pad = 0
    if bucket_m:
        # next power of two (>= 256) keeps the compile count ~log(M)
        target = 256
        while target < M:
            target *= 2
        pad = target - M

    def _pad(x, fill=0):
        if not pad:
            return x
        shape = (pad,) + x.shape[1:]
        return np.concatenate([x, np.full(shape, fill, x.dtype)])

    return HcBatch(
        g=jnp.asarray(_pad(g, 255)),
        r=jnp.asarray(_pad(np.concatenate(rows_r), 255)),
        q=jnp.asarray(_pad(np.concatenate(rows_q))),
        pang=jnp.asarray(_pad(np.concatenate(pang))),
        mq=jnp.asarray(_pad(np.concatenate(mq))),
        b=jnp.asarray(_pad(np.concatenate(bvec))),
        node=jnp.asarray(_pad(np.concatenate(node))),
        valid=jnp.asarray(_pad(np.concatenate(rows_v), False)),
        use_bep=jnp.asarray(_pad(np.concatenate(use_bep), False)),
    )


def score_alignments_device(
    db,
    alignments,
    background_error_prob: float = 1e-4,
    is_consensus_fasta: bool = False,
    mesh="auto",
) -> np.ndarray:
    """Production device scorer: the full `src/HaploCart.cpp:408-421`
    batch on device (batch_from_alignments -> score_batch), replacing
    the host per-alignment loop (pipelines/haplocart.score_alignments,
    kept as the --precise f64 oracle). Tables are cached on the DB.

    mesh: "auto" (default) shards the mapping axis over all local
    devices with a psum merge (parallel/mesh.sharded_score_fn — the
    SURVEY §2.9 data-parallel path); None / single device runs the
    plain jitted step."""
    from ..utils import guards

    if mesh == "auto":
        from ..parallel.mesh import auto_mesh

        mesh = auto_mesh(support_bytes=support_bytes(db))
    tables = device_tables(db)
    batch = batch_from_alignments(db, alignments)
    if batch is None:
        raise RuntimeError("[HaploCart] Error, no reads mapped")
    dt = tables.support.dtype
    batch = batch._replace(b=batch.b.astype(dt))
    if is_consensus_fasta:
        # consensus mode: eps comes from bep for every base
        # (`src/HaploCart.cpp:394-399` sets the flag up front)
        batch = batch._replace(use_bep=jnp.ones_like(batch.use_bep))
    if mesh is not None:
        from ..parallel.mesh import (
            shard_batch,
            shard_tables,
            sharded_score_fn,
        )

        cache = getattr(db, "_sharded_cache", None)
        if cache is None:
            cache = db._sharded_cache = {}
        key = (id(mesh), float(background_error_prob), is_consensus_fasta)
        entry = cache.get(key)
        if entry is None:
            entry = (
                sharded_score_fn(
                    mesh, bep=background_error_prob,
                    consensus=is_consensus_fasta,
                ),
                shard_tables(tables, mesh),
            )
            cache[key] = entry
        fn, sh_tables = entry
        out = fn(shard_batch(batch, mesh), sh_tables)
        out = np.asarray(out, dtype=np.float64)[: len(db.path_names)]
    else:
        out = score_batch(
            batch,
            tables,
            bep=jnp.asarray(background_error_prob, dt),
            consensus=is_consensus_fasta,
        )
        out = np.asarray(out, dtype=np.float64)
    guards.check_finite(out, "haplocart final_vec (device)")
    return out


def support_bytes(db) -> int:
    """Device bytes of the DB's node x path support matrix."""
    n_nodes, n_paths = db.graph.path_support.shape
    return n_nodes * n_paths * np.dtype(precision.compute_dtype("scorer")).itemsize


def device_tables(db) -> HcTables:
    """The DB's scoring tables on device, built once and cached on it."""
    tables = getattr(db, "_device_tables", None)
    if tables is None:
        tables = make_tables_from_db(db, precision.compute_dtype("scorer"))
        db._device_tables = tables
    return tables


def make_tables_from_db(db, dtype=jnp.float32) -> HcTables:
    from ..models import mutation, phred

    mapp = db.mappabilities
    need = int(db.pangenome_base.max()) + 1
    if len(mapp) < need:
        mapp = np.concatenate([mapp, np.ones(need - len(mapp))])
    bg = np.concatenate([mutation.BACKGROUND_FREQ, [0.25, 0.25, 0.25]])
    return HcTables(
        match_tab=jnp.asarray(db.match_prob, dtype),
        mapp_tab=jnp.asarray(mapp, dtype),
        qtab=jnp.asarray(phred.qscore_vec(), dtype),
        imtab=jnp.asarray(phred.incorrect_mapping_vec(), dtype),
        bg=jnp.asarray(bg, dtype),
        support=jnp.asarray(db.graph.path_support, dtype),
    )
