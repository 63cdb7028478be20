"""Columnar HaploCart pipeline: mapper table -> device scorer with no
per-read Python objects.

The production FASTQ path (`src/HaploCart.cpp:313-421` stage chain) as
array passes over mapper/batch_map.AlignmentTable:

  filter   identity != 0 mask            (vg filter -r 1)
  gamsort  lexsort by (first node, off)  (`src/haplocart_functions.cpp:46-78`)
  duprm    unique start coordinate       (`src/rmdup.cpp:20-124`)
  recon    C++ batch reconstruction      (cpp/reconstruct.cpp, the
           `src/vgan_utils.h:6-79` expansion incl. quirks)
  batch    vectorized HcBatch assembly   (same quirks as
           haplocart_device.batch_from_alignments: read row from the
           read start, per-EDIT sizes indexed per mapping, quality at
           aligned coordinates, cumulative-logq unsupported penalty)
  score    haplocart_device.score_batch / the sharded mesh step

Parity: tests/test_pipelines_e2e.py (columnar-vs-object cases)
asserts the final_vec equals the object path bit-for-bit on mapper
output.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..mapper.batch_map import AlignmentTable, _p, load_native
from ..models import phred
from ..utils import dna


# ------------------------------------------------------------ stage chain
def filter_sort_dedup(t: AlignmentTable) -> AlignmentTable:
    """vg filter -r 1 -> gamsort -> Dup_Remover, as array ops."""
    mapped = t.identity != 0
    t = t.select(mapped)
    fn, fo, ln, lo = t.first_positions()
    order = np.lexsort((fo, fn))
    t = t.select(order)
    fn, fo, ln, lo = t.first_positions()
    paired = t.read_paired
    # duplicate keys: single-end (node, off); paired adds the last
    # mapping's coordinate (`src/rmdup.cpp:43-67`)
    keys = np.stack(
        [paired.astype(np.int64), fn, fo,
         np.where(paired, ln, 0), np.where(paired, lo, 0)], axis=1
    )
    # keep FIRST occurrence in current (sorted) order
    _uniq, first_idx = np.unique(keys, axis=0, return_index=True)
    keep = np.zeros(t.n, dtype=bool)
    keep[first_idx] = True
    return t.select(keep)


# ------------------------------------------------------------ reconstruction
def _setup_reconstruct(lib):
    if getattr(lib, "_recon_ready", False):
        return
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.reconstruct_batch.restype = ctypes.c_int64
    lib.reconstruct_batch.argtypes = [
        ctypes.c_int64,
        i64p, i64p, i32p, u8p,            # map_off, m_node, m_off, m_rev
        i64p, i32p, i32p, i64p,           # e_off, e_from, e_to, e_soff
        ctypes.c_char_p,                  # eseq
        u8p, i64p, ctypes.c_int64,        # node pool, node_off, min_id
        i64p, u8p, i64p,                  # g_off, out_g, out_g_len
        i64p, u8p, i64p,                  # r_off, out_r, out_r_len
        i64p, i32p, i64p,                 # s_off, out_sizes, out_s_len
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib._recon_ready = True


def reconstruct_table(graph, t: AlignmentTable):
    """C++ batch reconstruction. Returns (g_cat, g_off, g_len, r_cat,
    r_off, r_len, sizes_cat, s_off, s_len) — code arrays, one row range
    per alignment."""
    lib = load_native()
    _setup_reconstruct(lib)
    n = t.n
    i32, i64, u8 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint8
    # per-alignment caps: graph side <= sum(from)+sum(to); read side
    # <= sum(to)+sum(from); sizes = n_edits
    ef = t.e_from.astype(np.int64)
    et = t.e_to.astype(np.int64)
    e_per_map = np.diff(t.e_off)
    # per-aln edit ranges
    aln_e0 = t.e_off[t.map_off[:-1]]
    aln_e1 = t.e_off[t.map_off[1:]]
    ecum = np.zeros(len(ef) + 1, dtype=np.int64)
    np.cumsum(ef + et, out=ecum[1:])
    cap_per = ecum[aln_e1] - ecum[aln_e0] + 8
    g_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cap_per, out=g_off[1:])
    r_off = g_off.copy()
    s_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(aln_e1 - aln_e0, out=s_off[1:])
    g_cat = np.zeros(int(g_off[-1]), dtype=np.uint8)
    r_cat = np.zeros(int(r_off[-1]), dtype=np.uint8)
    sizes = np.zeros(max(int(s_off[-1]), 1), dtype=np.int32)
    g_len = np.zeros(n, dtype=np.int64)
    r_len = np.zeros(n, dtype=np.int64)
    s_len = np.zeros(n, dtype=np.int64)
    node_pool = np.ascontiguousarray(graph.node_seq_pool, dtype=np.uint8)
    node_off = np.ascontiguousarray(graph.node_off, dtype=np.int64)
    rc = lib.reconstruct_batch(
        n,
        _p(np.ascontiguousarray(t.map_off), i64),
        _p(np.ascontiguousarray(t.m_node), i64),
        _p(np.ascontiguousarray(t.m_off), i32),
        _p(np.ascontiguousarray(t.m_rev), u8),
        _p(np.ascontiguousarray(t.e_off), i64),
        _p(np.ascontiguousarray(t.e_from), i32),
        _p(np.ascontiguousarray(t.e_to), i32),
        _p(np.ascontiguousarray(t.e_soff), i64),
        t.eseq,
        _p(node_pool, u8), _p(node_off, i64), graph.min_id,
        _p(g_off, i64), _p(g_cat, u8), _p(g_len, i64),
        _p(r_off, i64), _p(r_cat, u8), _p(r_len, i64),
        _p(s_off, i64), _p(sizes, i32), _p(s_len, i64),
        len(g_cat), len(r_cat), len(sizes),
    )
    if rc != 0:
        raise RuntimeError(f"reconstruct_batch overflow at aln {-rc - 1}")
    return g_cat, g_off, g_len, r_cat, r_off, r_len, sizes, s_off, s_len


# ------------------------------------------------------------ batch build
def _batch_arrays(db, t: AlignmentTable, max_node_len: int = 0):
    """AlignmentTable -> compact numpy batch arrays, fully vectorized
    across reads (the columnar twin of
    haplocart_device.batch_from_alignments — same quirks, one pass).
    Returns None when nothing is mapped, else a dict with
    g/r/q uint8 [M0, S] (255 = invalid for g/r), mq/use_bep uint8
    [M0], pang/node/take int32 [M0], b float64 [M0], and S."""
    graph = db.graph
    has = (t.identity > 1e-10) & (t.nmap > 0)
    if not has.all():
        t = t.select(has)
    if t.n == 0:
        return None
    n = t.n
    g_cat, g_off, g_len, r_cat, r_off, r_len, sizes, s_off, s_len = (
        reconstruct_table(graph, t)
    )
    qscore = phred.qscore_vec()
    log_q0 = float(np.log(qscore[0]))

    nmap = t.nmap.astype(np.int64)
    M = int(nmap.sum())
    aln_of_m = np.repeat(np.arange(n), nmap)
    # size_m: per-EDIT sizes indexed per MAPPING (reference quirk,
    # `src/update_likelihood.cpp:36`): mapping k of read a uses
    # sizes[s_off[a] + k] when k < s_len[a], else 0
    k_in_aln = np.arange(M) - t.map_off[:-1][aln_of_m]
    sidx = s_off[:-1][aln_of_m] + k_in_aln
    valid_size = k_in_aln < s_len[aln_of_m]
    size_m = np.where(
        valid_size, sizes[np.minimum(sidx, len(sizes) - 1)], 0
    ).astype(np.int64)
    # per-read mapping starts = exclusive cumsum of size_m within read
    cs = np.concatenate([[0], np.cumsum(size_m)[:-1]])
    first_m = t.map_off[:-1]
    starts = cs - np.repeat(cs[first_m], nmap)

    S = max_node_len if max_node_len > 0 else max(
        8, -(-int(size_m.max(initial=1)) // 8) * 8
    )
    col = np.arange(S, dtype=np.int64)
    take = np.minimum(size_m, S)
    v = col[None, :] < take[:, None]

    # graph rows: gather from g_cat at g_off[aln] + starts + col
    gpos = g_off[:-1][aln_of_m][:, None] + starts[:, None] + col[None, :]
    in_g = (starts[:, None] + col[None, :]) < g_len[aln_of_m][:, None]
    np.clip(gpos, 0, max(len(g_cat) - 1, 0), out=gpos)
    g_rows = np.where(v & in_g, g_cat[gpos], np.uint8(255))

    # read rows: first `take` codes of the reconstructed read from its
    # START (reference quirk), shared across the read's mappings
    rpos = r_off[:-1][aln_of_m][:, None] + col[None, :]
    in_r = col[None, :] < r_len[aln_of_m][:, None]
    np.clip(rpos, 0, max(len(r_cat) - 1, 0), out=rpos)
    r_rows = np.where(v & in_r, r_cat[rpos], np.uint8(255))

    # qualities at aligned coordinates over the zero-padded quality
    # array of conceptual length 2L+8, where L is the RECONSTRUCTED
    # read length (incl. '-' splices at deletions — the object path's
    # len(read_seq), see batch_from_alignments)
    L_read = r_len.astype(np.int64)
    qlen_pad = 2 * L_read + 8
    q_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(qlen_pad, out=q_off[1:])
    # scatter the concatenated quality bytes into the padded layout
    # (vectorized; a per-read python loop here costs ~10ms/4k reads)
    qb_cat = np.frombuffer(b"".join(t.quals), dtype=np.uint8)
    qb_len = np.fromiter(
        (len(qb) for qb in t.quals), dtype=np.int64, count=n
    )
    q_cat = np.zeros(int(q_off[-1]), dtype=np.int64)
    q_cat[AlignmentTable._ranges(q_off[:-1], qb_len)] = qb_cat
    qpos = q_off[:-1][aln_of_m][:, None] + starts[:, None] + col[None, :]
    in_q = (starts[:, None] + col[None, :]) < qlen_pad[aln_of_m][:, None]
    np.clip(qpos, 0, max(len(q_cat) - 1, 0), out=qpos)
    q_rows = np.where(v & in_q, q_cat[qpos], 0).astype(np.uint8)

    # unsupported-path penalty per mapping: cumulative log q over
    # [start, start+L) of the padded quality array
    logq_cat = np.log(qscore)[np.clip(q_cat, 0, 99)]  # log the 100-LUT
    cum = np.zeros(len(logq_cat) + 1, dtype=np.float64)
    np.cumsum(logq_cat, out=cum[1:])
    Lm = L_read[aln_of_m]
    ends = starts + Lm
    lim = qlen_pad[aln_of_m]
    in_range = np.minimum(ends, lim)
    s_clip = np.minimum(starts, lim)
    qbase = q_off[:-1][aln_of_m]
    bvec = (
        cum[qbase + in_range] - cum[qbase + s_clip]
        + (ends - in_range) * log_q0
    )

    nidx = (t.m_node - graph.min_id).astype(np.int32)
    pang = db.pangenome_base[nidx].astype(np.int32)
    mq = np.minimum(t.mq, 99).astype(np.uint8)[aln_of_m]
    # sticky qual>=90 flag per read (`src/update_likelihood.cpp:42`),
    # as a segment-any over the concatenated quality bytes
    read_of_q = np.repeat(np.arange(n, dtype=np.int64), qb_len)
    has_q90 = (
        np.bincount(read_of_q[qb_cat >= 90], minlength=n) > 0
    )
    use_bep = has_q90[aln_of_m].astype(np.uint8)

    return dict(
        g=g_rows, r=r_rows, q=q_rows, mq=mq, use_bep=use_bep,
        pang=pang, node=nidx, take=take.astype(np.int32),
        b=bvec, S=S,
    )


def _bucket_M(m: int) -> int:
    target = 256
    while target < m:
        target *= 2
    return target


def hc_batch_from_table(db, t: AlignmentTable,
                        max_node_len: int = 0, bucket_m: bool = True):
    """AlignmentTable -> HcBatch (the per-array device placement used
    by the sharded mesh path and the parity tests; the single-device
    production path packs the same arrays into one upload instead —
    score_table_packed)."""
    import jax.numpy as jnp

    from .haplocart_device import HcBatch

    a = _batch_arrays(db, t, max_node_len)
    if a is None:
        return None
    M = len(a["b"])
    pad = (_bucket_M(M) - M) if bucket_m else 0

    def _pad(x, fill=0):
        if not pad:
            return x
        shape = (pad,) + x.shape[1:]
        return np.concatenate([x, np.full(shape, fill, x.dtype)])

    S = a["S"]
    col = np.arange(S, dtype=np.int64)
    valid = col[None, :] < a["take"][:, None]
    return HcBatch(
        g=jnp.asarray(_pad(a["g"], 255).astype(np.int32)),
        r=jnp.asarray(_pad(a["r"], 255).astype(np.int32)),
        q=jnp.asarray(_pad(a["q"]).astype(np.int32)),
        pang=jnp.asarray(_pad(a["pang"])),
        mq=jnp.asarray(_pad(a["mq"]).astype(np.int32)),
        b=jnp.asarray(_pad(a["b"])),
        node=jnp.asarray(_pad(a["node"])),
        valid=jnp.asarray(_pad(valid, False)),
        use_bep=jnp.asarray(_pad(a["use_bep"]).astype(bool)),
    )


def pack_batch(a: dict, dtype) -> np.ndarray:
    """Compact batch arrays -> ONE uint8 buffer (single host->device
    transfer instead of one per array, and uint8 g/r/q quarters the
    payload vs int32 rows). Layout
    (M = bucketed mapping count, S = a["S"], itemsize = dtype's):
      [3*M*S] g|r|q uint8, [2*M] mq|use_bep uint8, pad to 8,
      [12*M] pang|node|take int32 LE, [itemsize*M] b as dtype.
    Unpacked on device by haplocart_device.score_packed."""
    M0 = len(a["b"])
    M = _bucket_M(M0)
    S = a["S"]

    def padded(x, fill=0):
        out = np.full((M,) + x.shape[1:], fill, x.dtype)
        out[:M0] = x
        return out

    u8 = [
        padded(a["g"], 255).reshape(-1),
        padded(a["r"], 255).reshape(-1),
        padded(a["q"]).reshape(-1),
        padded(a["mq"]),
        padded(a["use_bep"]),
    ]
    head = np.concatenate(u8)
    align = (-len(head)) % 8
    i32 = np.concatenate(
        [padded(a["pang"]), padded(a["node"]), padded(a["take"])]
    ).view(np.uint8)
    b = np.ascontiguousarray(padded(a["b"]).astype(dtype)).view(np.uint8)
    return np.concatenate(
        [head, np.zeros(align, np.uint8), i32, b]
    )


def _dedup_keys(t: AlignmentTable) -> np.ndarray:
    """Duplicate keys of a mapped-only table as a 1D void array
    (bytewise-comparable rows): single-end (paired, first node, first
    off); paired adds the last mapping's coordinate
    (`src/rmdup.cpp:43-67`) — same fields as filter_sort_dedup."""
    fn, fo, ln, lo = t.first_positions()
    paired = t.read_paired.astype(np.int64)
    keys = np.ascontiguousarray(
        np.stack(
            [paired, fn, fo,
             np.where(t.read_paired, ln, 0),
             np.where(t.read_paired, lo, 0)], axis=1
        )
    )
    return keys.view(f"V{keys.shape[1] * keys.itemsize}").reshape(-1)


def score_table_stream(
    db,
    chunks,
    background_error_prob: float = 1e-4,
    is_consensus_fasta: bool = False,
):
    """Streaming production scorer: consume per-chunk AlignmentTables
    (mapper.map_table_chunks), filter + dedup + build + dispatch each
    chunk while the mapper seeds the next and the device scores the
    previous — the whole map->filter->duprm->score pipeline overlaps
    (single-device path; final_vec contributions are additive per
    mapping, accumulated on device, downloaded once).

    Dedup is streamable because filter_sort_dedup's kept set is exactly
    "first occurrence of each duplicate key in read order": the
    position sort is stable and reads sharing a key share its sort
    coordinates, so the sorted-first representative IS the lowest read
    index (parity-tested against the one-shot path). Returns
    (final_vec, n_kept_reads)."""
    import jax.numpy as jnp

    from ..utils import guards
    from .haplocart_device import device_tables, score_packed

    from concurrent.futures import ThreadPoolExecutor

    tables = device_tables(db)
    dt = tables.support.dtype
    bep = jnp.asarray(background_error_prob, dt)
    seen = np.zeros(0, dtype="V40")
    acc = None
    n_kept = 0

    # 1-ahead prefetch: the mapper generator advances on a worker
    # thread (its hot work is GIL-releasing ctypes/numpy), so chunk
    # i+1's mapping overlaps chunk i's dedup/build/pack on this thread
    _END = object()

    def _pull(it):
        return next(it, _END)

    ex = ThreadPoolExecutor(max_workers=1)
    it = iter(chunks)
    fut = ex.submit(_pull, it)

    def _iter_prefetched():
        nonlocal fut
        while True:
            table = fut.result()
            if table is _END:
                return
            fut = ex.submit(_pull, it)
            yield table

    # scoring dispatches are deferred and batched: per-chunk batch
    # arrays accumulate on host and score in one device dispatch per
    # FLUSH_MAPPINGS rows. Padding a chunk's [M0, S] rows to the
    # flush's max S reproduces exactly the rows _batch_arrays would
    # build at that S (255/255/0 fill beyond `take`), so this is
    # bit-identical to per-chunk dispatch (parity-tested against
    # score_table_device).
    # flush is capped by padded CELLS (mappings x flush-wide max S),
    # not mapping count alone: every pending row pads to the flush max
    # S at concat, so long-read chunks would otherwise multiply the
    # host-copy and device working set. 2^27 cells equals a
    # 2^20-mapping flush at the typical S=128 bucket.
    # The mapping-row threshold is small (8192 rows, ~600 hc reads, a
    # fraction of a 4096-read chunk): dispatches are ASYNC, so flushing
    # early overlaps the scorer's host build + device work with the
    # next chunks' mapping instead of serializing one big flush after
    # the last chunk.
    FLUSH_MAPPINGS = 8192
    FLUSH_CELLS = 1 << 27
    pending: list = []
    pending_m = 0
    pending_smax = 0

    def _flush():
        nonlocal acc, pending, pending_m, pending_smax
        if not pending:
            return
        a = _concat_batches(pending)
        pending = []
        pending_m = 0
        pending_smax = 0
        buf = pack_batch(a, np.dtype(dt))
        vec = score_packed(
            buf, tables, bep, M=_bucket_M(len(a["b"])), S=a["S"],
            consensus=is_consensus_fasta,
        )
        acc = vec if acc is None else acc + vec

    for table in _iter_prefetched():
        t = table.select(table.identity != 0)
        if t.n == 0:
            continue
        keys = _dedup_keys(t)
        # within-chunk first occurrence, then drop keys already seen
        _u, first_idx = np.unique(keys, return_index=True)
        keep = np.zeros(t.n, dtype=bool)
        keep[first_idx] = True
        if len(seen):
            pos = np.searchsorted(seen, keys)
            pos = np.minimum(pos, len(seen) - 1)
            keep &= seen[pos] != keys
        seen = np.union1d(seen, keys[keep])
        t = t.select(keep)
        if t.n == 0:
            continue
        n_kept += t.n
        a = _batch_arrays(db, t)
        if a is None:
            continue
        pending.append(a)
        pending_m += len(a["b"])
        pending_smax = max(pending_smax, int(a["S"]))
        if (pending_m >= FLUSH_MAPPINGS
                or pending_m * pending_smax >= FLUSH_CELLS):
            _flush()
    _flush()
    ex.shutdown(wait=False)
    if acc is None or n_kept == 0:
        raise RuntimeError("[HaploCart] Error, no reads mapped")
    out = np.asarray(acc, dtype=np.float64)
    guards.check_finite(out, "haplocart final_vec (stream)")
    return out, n_kept


def _concat_batches(parts: list) -> dict:
    """Concatenate _batch_arrays dicts; rows pad to the max S with the
    same fill pack_batch uses beyond `take` (g/r 255, q 0), so the
    result equals one _batch_arrays call at that S."""
    if len(parts) == 1:
        return parts[0]
    S = max(p["S"] for p in parts)

    def pad_rows(p, key, fill):
        x = p[key]
        if x.shape[1] == S:
            return x
        out = np.full((x.shape[0], S), fill, x.dtype)
        out[:, : x.shape[1]] = x
        return out

    a = {
        "g": np.concatenate([pad_rows(p, "g", 255) for p in parts]),
        "r": np.concatenate([pad_rows(p, "r", 255) for p in parts]),
        "q": np.concatenate([pad_rows(p, "q", 0) for p in parts]),
        "S": S,
    }
    for k in ("mq", "use_bep", "pang", "node", "take", "b"):
        a[k] = np.concatenate([p[k] for p in parts])
    return a


def score_table_device(
    db,
    t: AlignmentTable,
    background_error_prob: float = 1e-4,
    is_consensus_fasta: bool = False,
    mesh="auto",
) -> np.ndarray:
    """Columnar twin of haplocart_device.score_alignments_device."""
    import jax.numpy as jnp

    from ..utils import guards
    from .haplocart_device import device_tables, score_batch, support_bytes

    if mesh == "auto":
        from ..parallel.mesh import auto_mesh

        mesh = auto_mesh(support_bytes=support_bytes(db))
    tables = device_tables(db)
    dt = tables.support.dtype
    if mesh is None:
        # single-device production path: pack the whole batch into one
        # uint8 upload, unpack + score in one jitted dispatch
        from .haplocart_device import score_packed

        a = _batch_arrays(db, t)
        if a is None:
            raise RuntimeError("[HaploCart] Error, no reads mapped")
        buf = pack_batch(a, np.dtype(dt))
        out = score_packed(
            buf, tables, jnp.asarray(background_error_prob, dt),
            M=_bucket_M(len(a["b"])), S=a["S"],
            consensus=is_consensus_fasta,
        )
        out = np.asarray(out, dtype=np.float64)
        guards.check_finite(out, "haplocart final_vec (columnar)")
        return out
    batch = hc_batch_from_table(db, t)
    if batch is None:
        raise RuntimeError("[HaploCart] Error, no reads mapped")
    batch = batch._replace(b=batch.b.astype(dt))
    if is_consensus_fasta:
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
            batch, tables,
            bep=jnp.asarray(background_error_prob, dt),
            consensus=is_consensus_fasta,
        )
        out = np.asarray(out, dtype=np.float64)
    guards.check_finite(out, "haplocart final_vec (columnar)")
    return out
