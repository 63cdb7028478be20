"""Benchmark: production-path throughput on the GPU.

Headline metric = the code `vgan haplocart` actually executes
(`pipelines/haplocart_runner.run_sample`): FASTQ parse -> batched
mapping (device SW scoring + native batch finalize) -> filter ->
gamsort -> duplicate removal -> batched device likelihood
(`src/HaploCart.cpp:408-421` as one jitted step) -> argmax, on an
mtDNA-scale synthetic world (seeded 16,569-bp backbone, 32 haplotypes,
120 variants — the real hcfiles DB is distributed out-of-band and not
in the repo snapshot, `src/Makefile:89-91`).

vs_baseline = the same end-to-end pipeline with the --precise host
scorer (pipelines/haplocart.score_alignments — the literal f64
transcription of the reference's per-read C++ loop, same accumulator
order). The reference binary itself cannot be built here (vendored vg
absent), so this oracle transcription is the measured CPU stand-in
(BASELINE.md).

Also reported:
  haplocart_device_reads_per_s  device scorer at REAL DB scale
                                (11,825 nodes x 5,179 paths,
                                `src/load.cpp:284-292`) vs an optimized
                                single-core numpy f64 twin
  mapping_reads_per_s           mapper alone on the same world
  euka_mcmc_iters_per_s         abundance MCMC, reference default
                                10k iters (`src/Euka.cpp:172-173`)
  soibean_mcmc_iters_per_s      tree MCMC, reference defaults 500k
                                iters x 4 chains
                                (`src/soibean.cpp:224-226`) on the
                                seeded 8-leaf Ursidae tree
  sw_kernel_gcups               batched SW scoring kernel

Every phase runs in its own subprocess, one at a time, so exactly one
process holds the card; the parent never imports jax and merges one
JSON at the end. Each phase records the device it ran on (platform,
device_kind, count, and the card's name and power limit) and fails
when JAX finds no GPU.

Prints ONE JSON line.
"""
import hashlib
import json
import math
import os
import sys
import subprocess
import tempfile
import time

import numpy as np

# BENCH_SMOKE=1: tiny workloads for functional validation on CPU (the
# recorded numbers always come from the full run on the GPU)
_SMOKE = bool(int(os.environ.get("BENCH_SMOKE", "0") or 0))
N_READS_DEV = 2048 if _SMOKE else 16384
N_READS_E2E = 400 if _SMOKE else 16000
N_READS_REAL = 200 if _SMOKE else 8000
EUKA_ITERS = 2000 if _SMOKE else 10000
SOIBEAN_ITERS, SOIBEAN_BURN = (4000, 1000) if _SMOKE else (500_000, 75_000)

# the pinned e2e/oracle workload (VERDICT r2 #7): BOTH the production
# pipeline and the --precise host oracle run exactly this; the hash is
# recorded in the JSON so BASELINE.md numbers are comparable run to run
WORKLOAD = dict(
    world="mt_backbone(seed 0) x 32 haplotypes x 120 variants, seed 3",
    reads=N_READS_E2E, read_seed=0, read_hap=5, mapper_k=31, mapper_w=11,
)
WORKLOAD_HASH = hashlib.sha1(
    json.dumps(WORKLOAD, sort_keys=True).encode()
).hexdigest()[:12]


# ------------------------------------------------------------------ kernels
def bench_sw_kernel():
    from vgan_tpu.mapper.sw_pallas import sw_scores_xla

    rng = np.random.default_rng(0)
    B, R, W = (256, 64, 64) if _SMOKE else (4096, 128, 256)
    reps = 2 if _SMOKE else 20
    read = rng.integers(0, 4, size=(B, R)).astype(np.int32)
    win = rng.integers(0, 4, size=(B, W)).astype(np.int32)
    rlen = np.full(B, R, np.int32)
    wlen = np.full(B, W, np.int32)
    out = sw_scores_xla(read, win, rlen, wlen)
    out.block_until_ready()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = sw_scores_xla(read, win, rlen, wlen)
        out.block_until_ready()
        best = min(best, (time.perf_counter() - t0) / reps)
    return B * R * W / best / 1e9


def bench_device_step():
    """Device scorer at real HC DB scale vs single-core numpy f64."""
    from vgan_tpu.pipelines.haplocart_device import (
        make_tables,
        score_batch,
        score_batch_reference,
        synth_batch,
        synth_support,
    )

    support = synth_support()
    tables = make_tables(support)
    batch = synth_batch(n_reads=N_READS_DEV)
    out = score_batch(batch, tables)
    out.block_until_ready()
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(20):
            out = score_batch(batch, tables)
        out.block_until_ready()
        best = min(best, (time.perf_counter() - t0) / 20)
    dev_rps = N_READS_DEV / best
    dev_out = np.asarray(out)

    t0 = time.perf_counter()
    for _ in range(2):
        final = score_batch_reference(batch, support)
    cpu_rps = N_READS_DEV / ((time.perf_counter() - t0) / 2)
    agree = int(np.argmax(dev_out)) == int(np.argmax(final))
    return dev_rps, cpu_rps, agree


# ------------------------------------------------------------------ e2e
def _bench_world():
    from vgan_tpu.graph.synth import build_haplotype_graph, mt_backbone

    graph, _ = build_haplotype_graph(
        mt_backbone(0), n_haplotypes=32, n_variants=120, seed=3
    )
    return graph


def _db_from_graph(graph):
    from vgan_tpu.pipelines import haplocart as hc

    pang = np.ones(graph.n_nodes, dtype=np.int64)
    pos = 1
    for nidx in graph.path_steps_node[0]:
        pang[nidx] = pos
        pos += int(graph.node_off[nidx + 1] - graph.node_off[nidx])
    return hc.HaplocartDB(
        graph=graph,
        path_names=list(graph.path_names),
        pangenome_base=pang,
        mappabilities=np.ones(int(pang.max()) + 2, dtype=np.float64),
    )


def bench_haplocart_e2e(graph):
    """Full production pipeline (run_sample) vs the --precise host
    oracle pipeline on the same input."""
    from vgan_tpu.graph.synth import sample_reads
    from vgan_tpu.mapper.giraffe import BatchedMapper
    from vgan_tpu.pipelines.haplocart_runner import (
        HaplocartConfig,
        run_sample,
    )

    from vgan_tpu.io import fastx

    db = _db_from_graph(graph)
    mapper = BatchedMapper(graph, k=31, w=11)
    reads = sample_reads(graph, 5, n_reads=N_READS_E2E, seed=0)
    fd, fq = tempfile.mkstemp(suffix=".fq")
    os.close(fd)
    fastx.write_fastq(fq, reads)
    try:
        cfg = HaplocartConfig(db_dir="", fq1=fq, quiet=True)
        run_sample(cfg, db, mapper, "warm")  # compile + warm caches
        dt = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            pred_d, n_d, vec_d = run_sample(cfg, db, mapper, "bench")
            dt = min(dt, time.perf_counter() - t0)
        e2e_rps = len(reads) / dt

        cfg_p = HaplocartConfig(db_dir="", fq1=fq, quiet=True, precise=True)
        run_sample(cfg_p, db, mapper, "warm")
        host_dt = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            pred_p, n_p, vec_p = run_sample(cfg_p, db, mapper, "precise")
            host_dt = min(host_dt, time.perf_counter() - t0)
        host_rps = len(reads) / host_dt
    finally:
        os.unlink(fq)
    agree = (pred_d == pred_p) and (
        int(np.argmax(vec_d)) == int(np.argmax(vec_p))
    )
    return e2e_rps, host_rps, agree, mapper, reads


def bench_euka_e2e(graph, mapper, reads):
    """euka production path: map (columnar) -> two-model device scorer
    -> detection, on the same world treated as a 2-taxon DB
    (21 bins/taxon like the real DB, `src/Euka.cpp:602-608`)."""
    import numpy as np

    from vgan_tpu.pipelines import euka as ek

    mid = graph.min_id + graph.n_nodes // 2

    def bins(lo, hi):
        bounds = np.linspace(lo, hi, 22).astype(int)
        return [
            (int(bounds[j]), int(bounds[j + 1]), 1.5) for j in range(21)
        ] + [(lo, hi, 0.5)]

    clades = [
        ek.CladeInfo(id=0, name="taxA", dist=0.05, n_paths=16,
                     start_node=graph.min_id, end_node=mid),
        ek.CladeInfo(id=1, name="taxB", dist=0.05, n_paths=16,
                     start_node=mid + 1, end_node=graph.max_id),
    ]
    chunks = [bins(graph.min_id, mid), bins(mid + 1, graph.max_id)]
    scorer = ek.EukaScorer(graph, clades, chunks)

    def run():
        table = mapper.map_reads_table(reads)
        return scorer.score_table(table, min_mq=0, min_frag=1, min_bins=1,
                                  max_bins=21)

    run()  # warm
    dt = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        res = run()
        dt = min(dt, time.perf_counter() - t0)
    assert int(res.counts.sum()) > 0
    return len(reads) / dt


def bench_mapping(mapper, reads):
    """Mapper alone (seed + device SW + native batch finalize), in the
    columnar form the production pipeline consumes."""
    mapper.map_reads_table(reads[:128])  # warm
    dt = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        out = mapper.map_reads_table(reads)
        dt = min(dt, time.perf_counter() - t0)
    mapped = int((out.identity != 0).sum())
    return len(reads) / dt, mapped / len(reads)


# ------------------------------------------------------------ real DB scale
def build_realdb_world():
    """The REAL DB's shape — 5,179 paths (`src/load.cpp:284-292`) over
    the full rCRS, 600 variant sites — mapping cost grows with path
    count (seeding hits every near-identical haplotype), so toy-world
    numbers don't transfer (VERDICT r2 #2)."""
    from vgan_tpu.graph.synth import (
        build_haplotype_graph,
        mt_backbone,
        sample_reads,
    )
    from vgan_tpu.mapper.giraffe import BatchedMapper

    n_haps = 64 if _SMOKE else 5179
    graph, _ = build_haplotype_graph(
        mt_backbone(0), n_haplotypes=n_haps, n_variants=600, seed=3
    )
    db = _db_from_graph(graph)
    mapper = BatchedMapper(graph, k=31, w=11)
    # mapping measures on 2x the e2e read count so the streaming
    # pipeline (4 chunks) reaches steady state instead of paying the
    # fill/drain on a 2-chunk run
    all_reads = sample_reads(graph, 5, n_reads=2 * N_READS_REAL, seed=0)
    return db, mapper, all_reads, n_haps


def bench_realdb_mapping(mapper, all_reads):
    """Best-of-3 steady-state mapping at 5,179-path scale. Also records
    the per-stage host budget of the best run: submit = seed+pack+
    dispatch, collect = device wait+download+winner-select, finalize =
    native table build — the artifact form of BASELINE.md's host-work
    ceiling analysis."""
    from vgan_tpu.mapper import batch_map

    mapper.map_reads_table(all_reads[:4096])  # warm/compile
    dt = math.inf
    stages = {}
    for _ in range(3):
        batch_map.reset_stage_times()
        t0 = time.perf_counter()
        out = mapper.map_reads_table(all_reads)
        run_dt = time.perf_counter() - t0
        if run_dt < dt:
            dt = run_dt
            stages = dict(batch_map.STAGE_TIMES)
    map_rps = len(all_reads) / dt
    assert int((out.identity != 0).sum()) == len(all_reads)
    nchunk = max(stages.get("chunks", 0), 1)
    stage_fields = {
        "hc_realdb_map_chunks": int(stages.get("chunks", 0)),
        "hc_realdb_map_submit_s_per_chunk": round(
            stages.get("submit_s", 0.0) / nchunk, 4),
        "hc_realdb_map_collect_s_per_chunk": round(
            stages.get("collect_s", 0.0) / nchunk, 4),
        "hc_realdb_map_finalize_s_per_chunk": round(
            stages.get("finalize_s", 0.0) / nchunk, 4),
        "hc_realdb_map_wall_s": round(dt, 3),
    }
    return map_rps, stage_fields


def bench_haplocart_realdb(db, mapper, all_reads):
    """HaploCart e2e + host-oracle ratio at the real 5,179-path scale
    (VERDICT r3 #1). r5: e2e runs the SAME 16k-read workload as the
    mapping metric (it was 8k), so the two are directly comparable —
    the streaming pipeline's fixed scoring-flush tail (~0.15s) is a
    per-run cost, not per-read, and the oracle runs on its 250-read
    subset either way."""
    from vgan_tpu.pipelines.haplocart_runner import (
        HaplocartConfig,
        run_sample,
    )

    from vgan_tpu.io import fastx

    reads = all_reads
    fd, fq = tempfile.mkstemp(suffix=".fq")
    os.close(fd)
    fastx.write_fastq(fq, reads)
    # host oracle at REAL path-axis scale on a read subset (the
    # per-read x 5,179-path f64 loop is O(paths): 8k reads would take
    # ~10 min; the subset keeps the protocol identical on both sides)
    n_oracle = 50 if _SMOKE else 250
    fd2, fq_small = tempfile.mkstemp(suffix=".fq")
    os.close(fd2)
    fastx.write_fastq(fq_small, reads[:n_oracle])
    try:
        cfg = HaplocartConfig(db_dir="", fq1=fq, quiet=True)
        run_sample(cfg, db, mapper, "warm")
        dt = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            pred_d, _n, vec_d = run_sample(cfg, db, mapper, "bench")
            dt = min(dt, time.perf_counter() - t0)
        e2e_rps = len(reads) / dt

        cfg_p = HaplocartConfig(db_dir="", fq1=fq_small, quiet=True,
                                precise=True)
        host_dt = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            pred_p, _n, vec_p = run_sample(cfg_p, db, mapper, "precise")
            host_dt = min(host_dt, time.perf_counter() - t0)
        host_rps = n_oracle / host_dt
        # same argmax on the oracle's own subset
        cfg_ds = HaplocartConfig(db_dir="", fq1=fq_small, quiet=True)
        pred_ds, _n, vec_ds = run_sample(cfg_ds, db, mapper, "sub")
        agree = (pred_ds == pred_p) and (
            int(np.argmax(vec_ds)) == int(np.argmax(vec_p))
        )
    finally:
        os.unlink(fq)
        os.unlink(fq_small)
    return e2e_rps, host_rps, agree


def bench_euka_realdb():
    """euka e2e at the real clade-table width: 334 taxa
    (`src/MCMC.cpp:1193`'s 1/334), 21 bins/taxon
    (`src/Euka.cpp:602-608`), one ~5kb path per taxon."""
    from vgan_tpu.graph.synth import sample_reads, taxa_world
    from vgan_tpu.mapper.giraffe import BatchedMapper
    from vgan_tpu.pipelines import euka as ek

    n_taxa = 8 if _SMOKE else 334
    graph, clades, chunks = taxa_world(
        n_taxa=n_taxa, bp_per=1024 if _SMOKE else 5120
    )
    mapper = BatchedMapper(graph, k=20, w=10)
    scorer = ek.EukaScorer(graph, clades, chunks)
    reads = []
    n_src = min(n_taxa, 24)
    per_src = max(N_READS_REAL // n_src, 4)
    for i in range(n_src):
        reads.extend(sample_reads(graph, i * (n_taxa // n_src),
                                  n_reads=per_src, seed=i))

    def run_stream():
        t0 = time.perf_counter()
        res = scorer.score_table_stream(
            mapper.map_table_chunks(reads),
            min_mq=0, min_frag=1, min_bins=1, max_bins=21,
        )
        return res, time.perf_counter() - t0

    def run_stages():
        t0 = time.perf_counter()
        table = mapper.map_reads_table(reads)
        t1 = time.perf_counter()
        scorer.score_table(table, min_mq=0, min_frag=1,
                           min_bins=1, max_bins=21)
        return t1 - t0, time.perf_counter() - t1

    run_stream()  # warm
    # production e2e = the streamed path (scoring overlaps mapping, as
    # the CLI runs it), plus separate per-stage measurements
    dt = map_s = score_s = math.inf
    for _ in range(3):
        res, d = run_stream()
        dt = min(dt, d)
    for _ in range(3):
        m_s, s_s = run_stages()
        map_s = min(map_s, m_s)
        score_s = min(score_s, s_s)
    assert int(res.counts.sum()) > 0
    stage_fields = {
        "euka_realdb_map_reads_per_s": round(len(reads) / map_s, 1),
        "euka_realdb_score_reads_per_s": round(len(reads) / score_s, 1),
    }
    return len(reads) / dt, n_taxa, stage_fields


def bench_soibean_e2e():
    """soibean e2e: map -> columnar precompute (analyse_table) ->
    4-chain tree MCMC at reference defaults (500k iters,
    `src/soibean.cpp:224-226`) on a 4-species world."""
    from vgan_tpu.graph.synth import (
        build_haplotype_graph,
        mt_backbone,
        sample_reads,
    )
    from vgan_tpu.mapper.giraffe import BatchedMapper
    from vgan_tpu.pipelines import soibean as sb
    from vgan_tpu.pipelines.soibean_runner import run_soibean_inference
    from vgan_tpu.utils.newick import parse_newick

    names = ["speciesA", "speciesB", "speciesC", "speciesD"]
    graph, _ = build_haplotype_graph(
        mt_backbone(0, 4000), n_haplotypes=4, n_variants=40, seed=11,
        hap_names=names,
    )
    for proxy in ["speciesA", "speciesC", "speciesA"]:
        j = graph.path_names.index(proxy)
        graph.path_steps_node.append(graph.path_steps_node[j])
        graph.path_steps_rev.append(graph.path_steps_rev[j])
    graph.path_names.extend(["N1", "N2", "N3"])
    support = np.zeros((graph.n_nodes, len(graph.path_names)), dtype=bool)
    for j, sn in enumerate(graph.path_steps_node):
        support[sn, j] = True
    graph.path_support = support
    tree = parse_newick(
        "((speciesA:0.2,speciesB:0.25)N1:0.3,"
        "(speciesC:0.22,speciesD:0.18)N2:0.28)N3;"
    )
    mapper = BatchedMapper(graph, k=20, w=10)
    n_reads = 200 if _SMOKE else 2000
    reads = sample_reads(graph, 1, n_reads=n_reads, seed=1)
    freqs = sb.make_freqs(0.25, 0.25, 0.25, 0.25)

    stages = {}

    def run(tag):
        t0 = time.perf_counter()
        table = mapper.map_reads_table(reads)
        t1 = time.perf_counter()
        stats = sb.analyse_table(graph, table)
        t2 = time.perf_counter()
        run_soibean_inference(
            tree, stats, graph.path_names, freqs, tag,
            n_iter=SOIBEAN_ITERS, burnin=SOIBEAN_BURN, chains=4,
            specified_k=1, write_files=False,
        )
        t3 = time.perf_counter()
        stages.update(map_s=t1 - t0, precompute_s=t2 - t1,
                      mcmc_s=t3 - t2)
        return stats

    run("warm")
    t0 = time.perf_counter()
    stats = run("bench")
    dt = time.perf_counter() - t0
    # host anchor for the MCMC: one numpy likelihood recompute per
    # iteration over the same [R, P, 25] tensors — the per-iteration
    # reads x bases scan the reference re-runs 500k times
    # (`src/MCMC.cpp:739-740`); chains sequential like the reference
    pm = stats.path_map
    c25 = stats.counts25
    rng = np.random.default_rng(0)
    hv = rng.standard_normal(25)
    n_host_iter = 50 if _SMOKE else 500
    th0 = time.perf_counter()
    for it in range(n_host_iter):
        c = it % pm.shape[1]
        p = (it + 1) % pm.shape[1]
        llc = pm[:, c] + c25[:, c, :] @ hv
        llp = pm[:, p] + c25[:, p, :] @ hv
        np.logaddexp(np.log(0.5) + llc, np.log(0.5) + llp).sum()
    # chain-iterations/s: the host runs chains sequentially (as the
    # reference does, `src/soibean.cpp:805-840`), so one measured
    # iteration = one chain-iteration
    host_iters_per_s = n_host_iter / (time.perf_counter() - th0)
    stages["mcmc_host_iters_per_s"] = host_iters_per_s
    stages["mcmc_iters_per_s"] = (
        (SOIBEAN_ITERS + 1) * 4 / stages["mcmc_s"]
    )
    return len(reads) / dt, stages


def bench_keelime_e2e(graph, mapper, reads):
    """keelime e2e on the bench world, PRODUCTION path (the CLI's
    map_reads_table -> analyse_gam_table -> assemble -> consensus,
    `pipelines/keelime.py::main_keelime`; `src/assembly.cpp:3837-4550`
    semantics)."""
    from vgan_tpu.pipelines import keelime

    sub = reads[: (100 if _SMOKE else 1500)]

    def run():
        table = mapper.map_reads_table(sub)
        frags = keelime.analyse_gam_table(graph, table)
        contigs = keelime.assemble(graph, frags)
        cons, scoring, counts, empty = keelime.consensus(graph, contigs)
        return cons

    run()  # warm
    dt = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        cons = run()
        dt = min(dt, time.perf_counter() - t0)
    assert len(cons) > 0
    return len(sub) / dt


# ------------------------------------------------------------------ MCMC
def bench_euka_mcmc():
    """Abundance MCMC at reference defaults: 10k iters
    (`src/Euka.cpp:172-173`), 6 detected taxa."""
    from vgan_tpu.infer.abundance_mcmc import run_mcmc

    rng = np.random.default_rng(0)
    T = 6
    n_reads = rng.integers(100, 5000, size=T).astype(np.float64)
    sum_ll = -rng.uniform(1.0, 3.0, size=T) * n_reads
    init = n_reads / n_reads.sum()
    n_iter = EUKA_ITERS
    run_mcmc(n_reads, sum_ll, init, n_iter=n_iter, burnin=100, seed=1)
    t0 = time.perf_counter()
    run_mcmc(n_reads, sum_ll, init, n_iter=n_iter, burnin=100, seed=2)
    dt = time.perf_counter() - t0
    return n_iter / dt


def bench_soibean_mcmc():
    """Tree MCMC at reference defaults: 500k iters x 4 chains
    (`src/soibean.cpp:224-226`) on the seeded 8-leaf Ursidae tree
    (graph/synth.ursidae_tree, in place of the bundled
    share/vgan/soibean_dir/tree_dir/trees.zip), chains vmapped in one
    device program."""
    from vgan_tpu.graph.synth import ursidae_tree
    from vgan_tpu.infer import tree_mcmc
    from vgan_tpu.pipelines import soibean
    from vgan_tpu.utils.newick import parse_newick

    tree = parse_newick(ursidae_tree(0))
    N = tree.n_nodes
    rng = np.random.default_rng(0)
    R = 200  # reads
    path_map = -rng.uniform(20.0, 60.0, size=(R, N))
    counts25 = rng.integers(0, 3, size=(R, N, 25)).astype(np.float32)
    freqs = soibean.make_freqs(0.25, 0.25, 0.25, 0.25)
    C, k = 4, 2
    leaves = np.nonzero(tree.n_children == 0)[0]
    srcs = np.tile(leaves[:k], (C, 1)).astype(np.int32)
    n_iter, burn = SOIBEAN_ITERS, SOIBEAN_BURN

    def run(seed0):
        return tree_mcmc.run_tree_mcmc_chains(
            tree, path_map, counts25, srcs, freqs, con=0.01,
            max_iter=n_iter, burn=burn, num_paths=N,
            init_loglike=float(path_map[:, srcs[0, 0]].sum()),
            seeds=np.arange(C) + seed0,
        )

    run(0)  # compile
    t0 = time.perf_counter()
    trace = run(100)
    dt = time.perf_counter() - t0
    assert np.isfinite(trace.loglike).all()
    standalone_ips = C * n_iter / dt

    # the vmapped k-sweep: k = 1..3 x C chains as ONE masked
    # batch — the reference runs each k sequentially
    # (`src/soibean.cpp:745-840`), so its wall-clock for the sweep is
    # K x one k's; here the whole sweep costs ~one k's wall-clock
    K = 3
    sweep_iter = n_iter // 5 if not _SMOKE else n_iter
    sweep_burn = max(sweep_iter // 7, 1)
    srcs_k = [np.tile(leaves[:kk], (C, 1)).astype(np.int32)
              for kk in range(1, K + 1)]
    lls = [float(path_map[:, s[0, 0]].sum()) for s in srcs_k]
    seeds_k = [np.arange(C) + 10 * kk for kk in range(1, K + 1)]

    def run_sweep():
        return tree_mcmc.run_tree_mcmc_ksweep(
            tree, path_map, counts25, srcs_k, freqs, con=0.01,
            max_iter=sweep_iter, burn=sweep_burn, num_paths=N,
            init_logls=lls, seeds_per_k=seeds_k,
        )

    run_sweep()  # compile
    t0 = time.perf_counter()
    traces = run_sweep()
    dt_sweep = time.perf_counter() - t0
    assert all(np.isfinite(t.loglike).all() for t in traces)
    sweep_ips = K * C * sweep_iter / dt_sweep
    return standalone_ips, sweep_ips


def _note(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def device_fields() -> dict:
    """The device a phase ran on, as JAX reports it, plus the card's
    name and power limit (a card set below its maximum runs slower
    under load). Fails when JAX finds no GPU, unless BENCH_SMOKE."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not _SMOKE:
        raise SystemExit(f"no GPU: JAX's default device is {dev}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    ) if dev.platform == "gpu" else None
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": smi.stdout.strip().splitlines()[0] if smi else None,
    }


# ------------------------------------------------------------------ phases
# Each phase is a self-contained function returning a dict of JSON
# fields; main() runs each in its own subprocess.
def phase_sw():
    return {"sw_kernel_gcups": round(bench_sw_kernel(), 2)}


def phase_device_step():
    dev_rps, dev_cpu_rps, dev_agree = bench_device_step()
    return {
        "haplocart_device_reads_per_s": round(dev_rps, 1),
        "device_vs_numpy": round(dev_rps / dev_cpu_rps, 2),
        "device_argmax_agrees": bool(dev_agree),
    }


def phase_hc_toy_e2e():
    graph = _bench_world()
    e2e_rps, host_rps, agree, _m, _r = bench_haplocart_e2e(graph)
    return {
        "metric": "haplocart_e2e_reads_per_s",
        "value": round(e2e_rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(e2e_rps / host_rps, 2),
        "host_oracle_e2e_reads_per_s": round(host_rps, 1),
        "workload": WORKLOAD_HASH,
        "argmax_agrees": bool(agree),
    }


def _toy_ctx():
    from vgan_tpu.graph.synth import sample_reads
    from vgan_tpu.mapper.giraffe import BatchedMapper

    graph = _bench_world()
    mapper = BatchedMapper(graph, k=31, w=11)
    reads = sample_reads(graph, 5, n_reads=N_READS_E2E, seed=0)
    return graph, mapper, reads


def phase_toy_mapping():
    _g, mapper, reads = _toy_ctx()
    map_rps, map_rate = bench_mapping(mapper, reads)
    return {
        "mapping_reads_per_s": round(map_rps, 1),
        "mapping_rate": round(map_rate, 4),
    }


def phase_euka_toy():
    graph, mapper, reads = _toy_ctx()
    euka_rps = bench_euka_e2e(graph, mapper, reads)
    return {"euka_e2e_reads_per_s": round(euka_rps, 1)}


def phase_keelime():
    graph, mapper, reads = _toy_ctx()
    keelime_rps = bench_keelime_e2e(graph, mapper, reads)
    return {"keelime_e2e_reads_per_s": round(keelime_rps, 1)}


def phase_realdb_mapping():
    _db, mapper, all_reads, n_haps = build_realdb_world()
    map_real_rps, stage_fields = bench_realdb_mapping(mapper, all_reads)
    out = {
        "hc_realdb_mapping_reads_per_s": round(map_real_rps, 1),
        "hc_realdb_paths": n_haps,
    }
    out.update(stage_fields)
    return out


def phase_hc_realdb():
    db, mapper, all_reads, _n = build_realdb_world()
    rps, host_rps, agree = bench_haplocart_realdb(db, mapper, all_reads)
    return {
        "hc_realdb_e2e_reads_per_s": round(rps, 1),
        "hc_realdb_host_oracle_reads_per_s": round(host_rps, 1),
        "hc_realdb_vs_baseline": round(rps / host_rps, 2),
        "hc_realdb_argmax_agrees": bool(agree),
    }


def phase_euka_realdb():
    rps, n_taxa, stage_fields = bench_euka_realdb()
    out = {
        "euka_realdb_e2e_reads_per_s": round(rps, 1),
        "euka_realdb_taxa": n_taxa,
    }
    out.update(stage_fields)
    return out


def phase_euka_mcmc():
    return {"euka_mcmc_iters_per_s": round(bench_euka_mcmc(), 1)}


def phase_soibean_mcmc():
    standalone, sweep = bench_soibean_mcmc()
    return {
        "soibean_mcmc_iters_per_s": round(standalone, 1),
        "soibean_ksweep_iters_per_s": round(sweep, 1),
    }


def phase_soibean_e2e():
    soibean_rps, sb_stages = bench_soibean_e2e()
    return {
        # soibean e2e + its per-stage split (VERDICT r3 #3): the MCMC
        # is a fixed ~500k x 4-chain cost at reference defaults, so
        # reads/s mostly measures iteration count; the split lets each
        # stage be judged on its own
        "soibean_e2e_reads_per_s": round(soibean_rps, 1),
        "soibean_map_s": round(sb_stages["map_s"], 2),
        "soibean_precompute_s": round(sb_stages["precompute_s"], 2),
        "soibean_precompute_reads_per_s": round(
            (200 if _SMOKE else 2000) / sb_stages["precompute_s"], 1
        ),
        "soibean_mcmc_s": round(sb_stages["mcmc_s"], 2),
        "soibean_mcmc_e2e_iters_per_s": round(
            sb_stages["mcmc_iters_per_s"], 1
        ),
        "soibean_mcmc_host_iters_per_s": round(
            sb_stages["mcmc_host_iters_per_s"], 1
        ),
    }


PHASES = [
    ("hc_toy_e2e", phase_hc_toy_e2e),
    ("sw", phase_sw),
    ("device_step", phase_device_step),
    ("toy_mapping", phase_toy_mapping),
    ("euka_toy", phase_euka_toy),
    ("realdb_mapping", phase_realdb_mapping),
    ("hc_realdb", phase_hc_realdb),
    ("euka_realdb", phase_euka_realdb),
    ("euka_mcmc", phase_euka_mcmc),
    ("soibean_mcmc", phase_soibean_mcmc),
    ("soibean_e2e", phase_soibean_e2e),
    ("keelime", phase_keelime),
]
_PHASE_BY_NAME = {name: fn for name, fn in PHASES}

# the merged JSON keeps a stable field order regardless of phase order
FIELD_ORDER = [
    "metric", "value", "unit", "vs_baseline",
    "host_oracle_e2e_reads_per_s", "workload", "argmax_agrees",
    "mapping_reads_per_s", "mapping_rate",
    "hc_realdb_e2e_reads_per_s", "hc_realdb_mapping_reads_per_s",
    "hc_realdb_paths", "hc_realdb_host_oracle_reads_per_s",
    "hc_realdb_vs_baseline", "hc_realdb_argmax_agrees",
    "hc_realdb_map_chunks", "hc_realdb_map_submit_s_per_chunk",
    "hc_realdb_map_collect_s_per_chunk",
    "hc_realdb_map_finalize_s_per_chunk", "hc_realdb_map_wall_s",
    "euka_realdb_e2e_reads_per_s", "euka_realdb_taxa",
    "euka_realdb_map_reads_per_s", "euka_realdb_score_reads_per_s",
    "haplocart_device_reads_per_s", "device_vs_numpy",
    "device_argmax_agrees",
    "euka_e2e_reads_per_s",
    "soibean_e2e_reads_per_s", "soibean_map_s", "soibean_precompute_s",
    "soibean_precompute_reads_per_s", "soibean_mcmc_s",
    "soibean_mcmc_e2e_iters_per_s", "soibean_mcmc_host_iters_per_s",
    "keelime_e2e_reads_per_s",
    "euka_mcmc_iters_per_s", "soibean_mcmc_iters_per_s",
    "soibean_ksweep_iters_per_s",
    "sw_kernel_gcups", "devices",
]


def run_phase(name: str) -> None:
    """Child entry: run one phase, print its JSON fields (and the
    device it ran on) as the last stdout line."""
    dev = device_fields()
    fields = _PHASE_BY_NAME[name]()
    fields["devices"] = {name: dev}
    print(json.dumps(fields), flush=True)


def main():
    merged: dict = {"devices": {}}
    errors: dict = {}
    for name, _fn in PHASES:
        _note(name)
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--phase", name],
                capture_output=True, text=True, timeout=3600,
            )
        except subprocess.TimeoutExpired:
            # a hung phase must not discard every completed phase —
            # record it like a nonzero exit
            errors[name] = "phase timed out after 3600s"
            _note(f"{name} TIMED OUT")
            continue
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        if proc.returncode != 0 or not lines:
            errors[name] = (proc.stderr or "no output").strip()[-800:]
            _note(f"{name} FAILED: {errors[name][-200:]}")
            continue
        fields = json.loads(lines[-1])
        merged["devices"].update(fields.pop("devices"))
        merged.update(fields)
    if "value" not in merged:
        raise SystemExit(
            f"headline phase failed: {errors.get('hc_toy_e2e', '?')}"
        )
    if errors:
        merged["phase_errors"] = sorted(errors)
    result = {k: merged[k] for k in FIELD_ORDER if k in merged}
    for k in merged:
        if k not in result:
            result[k] = merged[k]
    print(json.dumps(result))
    if errors:
        raise SystemExit(f"phases failed: {sorted(errors)}")


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--phase":
        run_phase(sys.argv[2])
    else:
        main()
