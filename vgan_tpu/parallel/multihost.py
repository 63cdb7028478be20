"""Multi-host (multi-process) execution.

The reference's only cross-process structure is the fork+FIFO chain on
one machine (`src/HaploCart.cpp:313-383`). The replacement here
(SURVEY §2.9 communication-backend row): each host runs one process,
`jax.distributed.initialize` joins them into one JAX runtime, reads
shard across processes by rank, per-host batches land on the local
chips of a GLOBAL device mesh, and the per-path log-likelihood
accumulator merges with a cross-host psum (NVLink within a host, the
network across hosts). Host 0 performs all file output.

Activation: `vgan <cmd> ... --coordinator host:port --nproc N
--procid I` or the VGAN_COORDINATOR / VGAN_NPROC / VGAN_PROCID
environment variables (set by the launcher on every host).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np


_initialized = False


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the global runtime. Returns True if distributed mode is
    active. Arguments default to the VGAN_* environment variables; a
    missing coordinator means single-process mode."""
    global _initialized
    import jax

    coordinator = coordinator or os.environ.get("VGAN_COORDINATOR")
    if not coordinator:
        return False
    if _initialized:
        return True
    num_processes = num_processes or int(os.environ.get("VGAN_NPROC", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("VGAN_PROCID", "0"))
    )
    jax.distributed.initialize(
        coordinator, num_processes=num_processes, process_id=process_id,
        local_device_ids=local_device_ids(coordinator, process_id),
    )
    _initialized = True
    return True


def local_device_ids(coordinator: str, process_id: int) -> Optional[List[int]]:
    """Cards this process drives. When every process runs on this host
    (the coordinator is a loopback address), process i takes card i
    alone: a JAX process reserves most of each card it opens, so N
    processes that each opened every card would fail for want of
    memory. Processes on separate hosts keep all of their host's
    cards (None)."""
    host = coordinator.rsplit(":", 1)[0].strip("[]")
    if host in ("localhost", "127.0.0.1", "::1"):
        return [process_id]
    return None


def active() -> bool:
    """True when running as part of a multi-process job."""
    return _initialized


def process_id() -> int:
    import jax

    return jax.process_index()


def process_count() -> int:
    import jax

    return jax.process_count()


def is_host0() -> bool:
    return process_id() == 0


def shard_reads(reads: Sequence) -> List:
    """This process's contiguous slice of the read list (by rank)."""
    n = process_count()
    if n == 1:
        return list(reads)
    pid = process_id()
    per = -(-len(reads) // n)
    return list(reads[pid * per : (pid + 1) * per])


def global_mesh():
    """(dp,) mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("dp",))


def allgather_objects(obj):
    """Gather one picklable object per process; every process receives
    the rank-ordered list. Two-phase allgather (sizes, then padded
    bytes) over the global runtime — the comm-backend primitive the
    per-pipeline merges build on (SURVEY §2.9)."""
    import pickle

    from jax.experimental import multihost_utils as mhu

    if not active() or process_count() == 1:
        return [obj]
    data = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
    sizes = mhu.process_allgather(
        np.array([len(data)], dtype=np.int64)
    ).reshape(-1)
    mx = int(sizes.max())
    pad = np.zeros(mx, dtype=np.uint8)
    pad[: len(data)] = data
    gathered = np.asarray(mhu.process_allgather(pad)).reshape(-1, mx)
    return [
        pickle.loads(gathered[i, : sizes[i]].tobytes())
        for i in range(len(sizes))
    ]


def merge_euka_results(res, min_frag: int, min_bins: int, max_bins: int,
                       entropy_threshold: float):
    """Merge per-process EukaResults into the global one: counters,
    bin coverage and baseshift profiles SUM across ranks; the per-read
    lists (clade likelihoods, insert sizes, fragment names) concatenate
    in rank order (= global read order, shard_reads slices
    contiguously); detection re-runs on the merged accumulators
    (euka.detect_clades — the `src/Euka.cpp:625-633` filter must see
    global coverage). Every process returns the same merged result;
    host 0 does the writing."""
    from ..pipelines.euka import EukaResult, detect_clades

    parts = allgather_objects(
        dict(
            counts=res.counts, n_mapped=res.n_mapped,
            baseshift=res.baseshift, coverage=res.coverage,
            clade_like=res.clade_like, insert_sizes=res.insert_sizes,
            frag_names=res.frag_names,
        )
    )
    if len(parts) == 1:
        return res
    nC = len(res.clades)
    counts = np.sum([p["counts"] for p in parts], axis=0)
    n_mapped = np.sum([p["n_mapped"] for p in parts], axis=0)
    baseshift = np.sum([p["baseshift"] for p in parts], axis=0)
    coverage = [
        [
            float(sum(p["coverage"][i][j] for p in parts))
            for j in range(len(res.chunks[i]))
        ]
        for i in range(nC)
    ]
    clade_like = [
        [x for p in parts for x in p["clade_like"][i]] for i in range(nC)
    ]
    insert_sizes = [
        [x for p in parts for x in p["insert_sizes"][i]] for i in range(nC)
    ]
    frag_names = [
        [x for p in parts for x in p["frag_names"][i]] for i in range(nC)
    ]
    detected = detect_clades(
        res.chunks, coverage, counts, min_frag, min_bins, max_bins,
        entropy_threshold,
    )
    return EukaResult(
        clades=res.clades, chunks=res.chunks, coverage=coverage,
        counts=counts, n_mapped=n_mapped, clade_like=clade_like,
        insert_sizes=insert_sizes, frag_names=frag_names,
        baseshift=baseshift, detected=detected,
    )


def score_alignments_multihost(db, local_alignments, bep: float = 1e-4,
                               is_consensus_fasta: bool = False):
    """HaploCart scorer with the mapping axis sharded across ALL hosts:
    each process contributes its local alignments; the per-node
    accumulator and the total unsupported penalty merge with psum over
    the global mesh. Replicated final_vec returned on every host
    (`src/HaploCart.cpp:408-421` over the cluster)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.lax import Precision
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map
    from functools import partial

    from ..pipelines.haplocart_device import (
        HcBatch,
        batch_from_alignments,
        make_tables_from_db,
        mapping_scores,
        segment_sum_fixed_order,
    )
    from ..utils import precision

    mesh = global_mesh()
    tables = make_tables_from_db(db, precision.compute_dtype("scorer"))
    batch = batch_from_alignments(db, local_alignments, bucket_m=False)
    if batch is None:
        # this host may legitimately hold zero mapped reads
        S = 8
        z = jnp.zeros((0, S), jnp.int32)
        batch = HcBatch(
            g=z, r=z, q=z,
            pang=jnp.zeros(0, jnp.int32), mq=jnp.zeros(0, jnp.int32),
            b=jnp.zeros(0, tables.support.dtype),
            node=jnp.zeros(0, jnp.int32),
            valid=jnp.zeros((0, S), bool),
            use_bep=jnp.zeros(0, bool),
        )
    batch = batch._replace(b=batch.b.astype(tables.support.dtype))
    if is_consensus_fasta:
        batch = batch._replace(use_bep=jnp.ones_like(batch.use_bep))

    # agree on a common padded mapping count (and S axis) per host
    M_local = int(batch.g.shape[0])
    S_local = int(batch.g.shape[1]) if batch.g.ndim == 2 else 8
    sizes = multihost_utils.process_allgather(
        np.array([M_local, S_local], dtype=np.int64)
    ).reshape(-1, 2)
    n_dev = mesh.size
    per_proc_dev = n_dev // process_count()
    M = int(sizes[:, 0].max())
    M = -(-max(M, 1) // per_proc_dev) * per_proc_dev
    S = int(sizes[:, 1].max())

    def pad2(x, fill):
        out = np.full((M, S), fill, dtype=np.asarray(x).dtype)
        a = np.asarray(x)
        if a.size:
            out[: a.shape[0], : a.shape[1]] = a
        return out

    def pad1(x, fill=0):
        a = np.asarray(x)
        out = np.full(M, fill, dtype=a.dtype)
        out[: len(a)] = a
        return out

    f_dtype = np.dtype(tables.support.dtype)
    b_pad = np.zeros(M, dtype=f_dtype)
    b_pad[: M_local] = np.asarray(batch.b, dtype=f_dtype)
    local = HcBatch(
        g=pad2(batch.g, 255), r=pad2(batch.r, 255), q=pad2(batch.q, 0),
        pang=pad1(batch.pang), mq=pad1(batch.mq),
        b=b_pad,
        node=pad1(batch.node),
        valid=pad2(batch.valid, False),
        use_bep=pad1(batch.use_bep, False),
    )

    sh_rows = NamedSharding(mesh, P("dp"))
    sh_rows2 = NamedSharding(mesh, P("dp", None))
    rep = NamedSharding(mesh, P())
    gshape1 = (M * process_count(),)
    gshape2 = (M * process_count(), S)

    def mk(x, spec, gshape):
        return jax.make_array_from_process_local_data(spec, x, gshape)

    gbatch = HcBatch(
        g=mk(local.g, sh_rows2, gshape2),
        r=mk(local.r, sh_rows2, gshape2),
        q=mk(local.q, sh_rows2, gshape2),
        pang=mk(local.pang, sh_rows, gshape1),
        mq=mk(local.mq, sh_rows, gshape1),
        b=mk(np.asarray(local.b), sh_rows, gshape1),
        node=mk(local.node, sh_rows, gshape1),
        valid=mk(local.valid, sh_rows2, gshape2),
        use_bep=mk(local.use_bep, sh_rows, gshape1),
    )
    gtables = jax.device_put(tables, rep)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            HcBatch(
                g=P("dp", None), r=P("dp", None), q=P("dp", None),
                pang=P("dp"), mq=P("dp"), b=P("dp"), node=P("dp"),
                valid=P("dp", None), use_bep=P("dp"),
            ),
            jax.tree.map(lambda _: P(), tables),
        ),
        out_specs=P(),
        check_vma=False,
    )
    def step(bt, t):
        A = mapping_scores(bt, t, bep, is_consensus_fasta)
        d = A - bt.b
        n_nodes = t.support.shape[0]
        c = segment_sum_fixed_order(d, bt.node, n_nodes)
        c = jax.lax.psum(c, "dp")
        total_b = jax.lax.psum(bt.b.sum(), "dp")
        return total_b + jnp.dot(c, t.support, precision=Precision.HIGHEST)

    out = jax.jit(step)(gbatch, gtables)
    return np.asarray(jax.device_get(out), dtype=np.float64)
