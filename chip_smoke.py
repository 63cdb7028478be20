#!/usr/bin/env python3
"""Smoke run of vgan_tpu's main path on the GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # the multi-device path only, each
                                       # part against --devices 1 (4 cards)

One-card phases, each a plain function; any failure exits non-zero and
prints no result:

  device          JAX's default device is a GPU (there is no CPU fallback)
  native          vgan_tpu/cpp compiled from its sources
  hc_main         `vgan haplocart` at the real DB shape (5,179 haplotypes
                  over a 16,569-bp backbone, 600 variant sites; 16,000
                  100-bp reads of one haplotype) twice through the CLI:
                  byte-equal outputs predicting the sampled haplotype;
                  then the --precise f64 host oracle vs the device path
                  on a 250-read subset
  hc_scorer_real  score_batch at 11,825 nodes x 5,179 paths vs numpy f64
  sw              sw_scores_xla / gather_score_hash at 4,096 x 128 x 256
                  vs the host oracle on 256 rows, and GCUPS
  dtypes          the HC scorer and soibean tree MCMC timed in f32 / f64
  pipelines       euka two-model scorer vs its per-read oracle (334
                  taxa), euka abundance MCMC, soibean tree MCMC on the
                  seeded Ursidae tree, keelime consensus
  gpu_tests       `pytest -m gpu` in a child process

The phases run in one child process (they share compilations), the
gpu tests in a second one started after the first has exited, and this
parent never imports JAX: one process holds the card at a time. The
last stdout line is the JSON result; every other line comes before it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the HaploCart world of the real DB's shape (`src/load.cpp:284-292`)
HC_HAPS, HC_VARIANTS, HC_READS, HC_READ_HAP, HC_ORACLE_READS = 5179, 600, 16000, 5, 250


def say(msg: str) -> None:
    print(msg, flush=True)


def _peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}  # None on the CPU
    return int(stats.get("peak_bytes_in_use", 0))


def _timed(fn, reps: int = 1):
    """(first-call seconds, steady seconds per call, result): the first
    call includes compilation, the steady calls end in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn())
    return first, (time.perf_counter() - t0) / reps, out


# ------------------------------------------------------------------ phases
def phase_device(n_cards: int = 1) -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"JAX's default device is {devs[0]}, not a GPU")
    if len(devs) < n_cards:
        raise RuntimeError(f"{n_cards} cards needed, JAX sees {len(devs)}")
    say(f"jax {jax.__version__}; device {devs[0].device_kind} x {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": n_cards}


def phase_native() -> None:
    from vgan_tpu.io import gam_native
    from vgan_tpu.mapper import batch_map, graph_align

    cxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    say(f"native: compiler {cxx.stdout.splitlines()[0]}")
    fresh = not os.path.exists(gam_native._LIB_PATH)
    t0 = time.perf_counter()
    if not gam_native.build():
        raise RuntimeError("make -C vgan_tpu/cpp failed")
    say(f"native: {'built from sources' if fresh else 'already built'} in "
        f"{time.perf_counter() - t0:.1f} s")
    if batch_map.load_native() is None or graph_align._load_native() is None:
        raise RuntimeError("native library built but does not load")


def hc_world(d: str, n_haps: int = HC_HAPS, n_variants: int = HC_VARIANTS,
             n_reads: int = HC_READS, seed: int = 0):
    """HC DB directory (graph.npz) + FASTQ of reads from one haplotype."""
    from vgan_tpu.graph.synth import build_haplotype_graph, mt_backbone, sample_reads
    from vgan_tpu.io import fastx

    graph, _ = build_haplotype_graph(
        mt_backbone(seed), n_haplotypes=n_haps, n_variants=n_variants, seed=3
    )
    os.makedirs(d, exist_ok=True)
    graph.save(os.path.join(d, "graph.npz"))
    reads = sample_reads(graph, HC_READ_HAP, n_reads=n_reads, seed=seed)
    fq = os.path.join(d, "reads.fq")
    fastx.write_fastq(fq, reads)
    return graph, reads, fq


def _cli_haplocart(db: str, fq: str, out: str, extra=()) -> str:
    from vgan_tpu import cli

    if cli.main(["haplocart", "--db", db, "-fq1", fq, "-o", out, *extra]) != 0:
        raise RuntimeError("vgan haplocart exited non-zero")
    with open(out, "rb") as f:
        return f.read().decode()


def phase_hc_main(d: str, n_haps: int = HC_HAPS, n_variants: int = HC_VARIANTS,
                  n_reads: int = HC_READS, n_oracle: int = HC_ORACLE_READS):
    from vgan_tpu.io import fastx
    from vgan_tpu.mapper import batch_map
    from vgan_tpu.mapper.giraffe import BatchedMapper
    from vgan_tpu.pipelines.haplocart_runner import HaplocartConfig, load_db, run_sample

    t0 = time.perf_counter()
    graph, reads, fq = hc_world(d, n_haps, n_variants, n_reads)
    want = graph.path_names[HC_READ_HAP]
    say(f"hc_main: world {n_haps} haplotypes x {graph.n_nodes} nodes, "
        f"{len(reads)} reads, built in {time.perf_counter() - t0:.1f} s")
    outs, secs = [], []
    for i in (1, 2):
        t0 = time.perf_counter()
        outs.append(_cli_haplocart(d, fq, os.path.join(d, f"hc{i}.tsv")))
        secs.append(time.perf_counter() - t0)
    pred = outs[0].splitlines()[1].split("\t")[1]
    say(f"hc_main: CLI run 1 (compile + run) {secs[0]:.2f} s, run 2 "
        f"{secs[1]:.2f} s = {len(reads) / secs[1]:.1f} reads/s incl. DB load "
        f"and index build; predicted {pred}, sampled {want}")
    if outs[0] != outs[1]:
        raise RuntimeError("two CLI runs wrote different outputs")
    say("hc_main: the two CLI outputs are byte-equal")
    if pred != want:
        raise RuntimeError(f"predicted {pred}, reads came from {want}")

    # the runner alone (DB loaded, index built): map + dedup + score
    db = load_db(d)
    mapper = BatchedMapper(db.graph, k=31, w=11)
    cfg = HaplocartConfig(db_dir=d, fq1=fq, quiet=True)
    run_sample(cfg, db, mapper, "warm")
    vecs = []
    for _ in range(2):
        batch_map.reset_stage_times()
        t0 = time.perf_counter()
        p, _n, vec = run_sample(cfg, db, mapper, "s")
        dt = time.perf_counter() - t0
        vecs.append(vec)
    st = dict(batch_map.STAGE_TIMES)
    say(f"hc_main: run_sample {dt:.3f} s = {len(reads) / dt:.1f} reads/s; "
        f"mapper submit {st['submit_s']:.3f} s, collect {st['collect_s']:.3f}"
        f" s, finalize {st['finalize_s']:.3f} s over {st['chunks']} chunks, "
        f"{st['sw_cells']:.4g} SW cells")
    same = vecs[0].tobytes() == vecs[1].tobytes()
    say(f"hc_main: final_vec bit-identical across runs: {same}; "
        f"max |diff| {np.max(np.abs(vecs[0] - vecs[1])):.3g}")
    if not same:
        raise RuntimeError("final_vec differs between two identical runs")

    # --precise f64 host oracle vs the device path on a read subset.
    # Both sum the same per-mapping f64 terms in a different order
    # (host loop vs device segment-sum + contraction), so their vectors
    # agree to ~1e-13 relative; rtol 1e-9 leaves room for the device's
    # reduction order while catching any f32 or TF32 step (~1e-7 / 1e-3).
    sub = os.path.join(d, "sub.fq")
    fastx.write_fastq(sub, reads[:n_oracle])
    t0 = time.perf_counter()
    p_o, _n, v_o = run_sample(
        HaplocartConfig(db_dir=d, fq1=sub, quiet=True, precise=True), db, mapper, "o")
    t_o = time.perf_counter() - t0
    p_d, _n, v_d = run_sample(HaplocartConfig(db_dir=d, fq1=sub, quiet=True), db, mapper, "d")
    rel = np.max(np.abs(v_d - v_o) / np.abs(v_o))
    say(f"hc_main: {n_oracle}-read oracle {t_o:.1f} s; argmax oracle {p_o} "
        f"device {p_d}; max rel diff {rel:.3g} (tolerance 1e-9)")
    if p_o != p_d or int(np.argmax(v_o)) != int(np.argmax(v_d)) or rel > 1e-9:
        raise RuntimeError("device path disagrees with the f64 host oracle")

    # the same run with f32 scoring tables (dtype rule: f64 unless f32
    # is measurably faster end to end)
    import jax.numpy as jnp

    def f32_run():
        db.__dict__.pop("_device_tables", None)
        run_sample(cfg, db, mapper, "warm")
        t0 = time.perf_counter()
        p32, _n, _v = run_sample(cfg, db, mapper, "s")
        return p32, time.perf_counter() - t0

    p32, dt32 = _with_dtype(jnp.float32, f32_run)
    db.__dict__.pop("_device_tables", None)
    say(f"dtypes: hc run_sample f64 {dt:.3f} s vs f32 {dt32:.3f} s "
        f"(f32 predicted {p32})")
    return {"reads_per_s": len(reads) / dt, "sw_cells": st["sw_cells"],
            "run_s": dt}


def phase_hc_scorer_real(n_nodes: int = 11825, n_paths: int = 5179,
                         n_reads: int = 16384) -> dict:
    """Real-DB support shape. The error is taken relative to the largest
    |final_vec| entry (entries are differences of large sums, so a
    per-entry relative error would measure the cancellation, not the
    scorer): f64 must agree to 1e-12, f32 to 1e-5 (f32 resolves ~6e-8
    per operation; sums over ~2e5 mappings lose up to two digits)."""
    import jax.numpy as jnp

    from vgan_tpu.pipelines import haplocart_device as hcd

    support = hcd.synth_support(n_nodes=n_nodes, n_paths=n_paths)
    times = {}
    for name, dt, rtol in (("f64", jnp.float64, 1e-12), ("f32", jnp.float32, 1e-5)):
        batch = hcd.synth_batch(n_reads=n_reads, n_nodes=n_nodes, dtype=dt)
        tables = hcd.make_tables(support, dt)
        first, steady, out = _timed(lambda: hcd.score_batch(batch, tables), reps=20)
        want = hcd.score_batch_reference(batch, support)
        got = np.asarray(out, dtype=np.float64)
        rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
        say(f"hc_scorer_real {name}: {n_nodes} x {n_paths}, {n_reads} reads; "
            f"compile+run {first:.2f} s, run {steady * 1e3:.3f} ms = "
            f"{n_reads / steady:.4g} reads/s; max rel diff {rel:.3g} "
            f"(tolerance {rtol:g}); peak_bytes_in_use {_peak_bytes()}")
        if int(np.argmax(got)) != int(np.argmax(want)) or rel > rtol:
            raise RuntimeError(f"score_batch ({name}) disagrees with numpy f64")
        times[name] = steady
    return times


def _sw_batch(rng, B, R, W):
    """Reads planted in their windows with 5% substitutions."""
    win = rng.integers(0, 4, size=(B, W)).astype(np.int32)
    start = rng.integers(0, W - R, size=B)
    read = win[np.arange(B)[:, None], start[:, None] + np.arange(R)].copy()
    mut = rng.random((B, R)) < 0.05
    read[mut] = rng.integers(0, 4, size=int(mut.sum()))
    return read, win, np.full(B, R, np.int32), np.full(B, W, np.int32)


def phase_sw(card: str, B: int = 4096, R: int = 128, W: int = 256,
             n_check: int = 256) -> float:
    """Scores are small integers in f32: the device must match exactly."""
    from vgan_tpu.mapper.sw_pallas import gather_score_hash, sw_scores_reference, sw_scores_xla
    from vgan_tpu.utils import dna

    read, win, rlen, wlen = _sw_batch(np.random.default_rng(0), B, R, W)
    first, steady, out = _timed(lambda: sw_scores_xla(read, win, rlen, wlen), reps=10)
    want = sw_scores_reference(read[:n_check], win[:n_check], rlen[:n_check], wlen[:n_check])
    if not np.array_equal(np.asarray(out)[:n_check], want):
        raise RuntimeError("sw_scores_xla disagrees with the host oracle")
    gcups = B * R * W / steady / 1e9
    say(f"sw: sw_scores_xla {B} x {R} x {W}: compile+run {first:.2f} s, run "
        f"{steady * 1e3:.3f} ms = {gcups:.2f} GCUPS on {card}; exact on "
        f"{n_check} rows")

    # fused path: windows gathered from a path-code pool, odd rows on
    # the reverse strand, the last 8 rows padding (window length 0)
    strand = np.arange(B) % 2
    wl = wlen.copy()
    wl[-8:] = 0
    pc_buf = np.concatenate([win.reshape(-1).astype(np.uint8), np.zeros(8, np.uint8)])
    aux = np.stack([np.arange(B), np.arange(B) * W, wl, strand]).astype(np.int32)
    q = read.copy()
    for b in np.nonzero(strand[:n_check])[0]:
        q[b] = dna.revcomp_codes(read[b].astype(np.uint8))
    reads_mat = read.astype(np.uint8)
    first, steady, out = _timed(
        lambda: gather_score_hash(pc_buf, reads_mat, rlen, aux, Wmax=W), reps=10)
    got = np.asarray(out)[0].view(np.float32)
    want = sw_scores_reference(q[:n_check], win[:n_check], rlen[:n_check], wl[:n_check])
    pad = sw_scores_reference(q[-8:], win[-8:], rlen[-8:], wl[-8:])
    if not (np.array_equal(got[:n_check], want) and np.array_equal(got[-8:], pad)):
        raise RuntimeError("gather_score_hash disagrees with the host oracle")
    gcups_g = B * R * W / steady / 1e9
    say(f"sw: gather_score_hash {B} x {R} x {W}: compile+run {first:.2f} s, "
        f"run {steady * 1e3:.3f} ms = {gcups_g:.2f} GCUPS on {card}; exact on "
        f"{n_check} rows + 8 padding rows; peak_bytes_in_use {_peak_bytes()}")
    return gcups_g


def _tree_world(R: int = 120, seed: int = 5):
    """Two-source reads over the seeded Ursidae tree (as
    tests/test_soibean.py::test_tree_mcmc_f32_matches_f64_estimates)."""
    from vgan_tpu.graph.synth import ursidae_tree
    from vgan_tpu.utils.newick import parse_newick

    tree = parse_newick(ursidae_tree(0))
    rng = np.random.default_rng(seed)
    leaves = np.nonzero(tree.n_children == 0)[0]
    path_map = np.full((R, tree.n_nodes), -60.0)
    path_map[: R // 2, leaves[0]] = -20.0
    path_map[R // 2:, leaves[1]] = -20.0
    path_map += rng.uniform(-0.5, 0.5, size=path_map.shape)
    counts25 = rng.integers(0, 3, size=(R, tree.n_nodes, 25)).astype(np.float32)
    return tree, leaves, path_map, counts25


def _with_dtype(dtype, fn):
    """Run fn with the device float dtype forced (utils/precision.py)."""
    import jax

    from vgan_tpu.utils import precision

    orig = precision.compute_dtype
    precision.compute_dtype = lambda use, backend=None: dtype
    jax.clear_caches()
    try:
        return fn()
    finally:
        precision.compute_dtype = orig
        jax.clear_caches()


def phase_dtypes(card: str, n_iter: int = 20000, burn: int = 4000,
                 C: int = 4) -> dict:
    """soibean tree MCMC in f32 and f64 on the seeded tree (k=2, two
    equal sources): chain-iterations/s, and posterior means that must
    agree within 0.05 (accept/reject is chaotic; the summaries are not)."""
    import jax.numpy as jnp

    from vgan_tpu.infer import tree_mcmc
    from vgan_tpu.pipelines import soibean

    tree, leaves, path_map, counts25 = _tree_world()
    srcs = np.tile(leaves[:2], (C, 1)).astype(np.int32)
    freqs = soibean.make_freqs(0.25, 0.25, 0.25, 0.25)

    def run(seed0):
        return tree_mcmc.run_tree_mcmc_chains(
            tree, path_map, counts25, srcs, freqs, con=0.01, max_iter=n_iter,
            burn=burn, num_paths=tree.n_nodes,
            init_loglike=float(path_map[:, srcs[0, 0]].sum()),
            seeds=np.arange(C) + seed0)

    res = {}
    for name, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
        def timed():
            t0 = time.perf_counter()
            run(7)
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            tr = run(7)
            return first, time.perf_counter() - t0, tr
        first, steady, tr = _with_dtype(dt, timed)
        if not np.isfinite(tr.loglike).all():
            raise RuntimeError(f"soibean MCMC ({name}) trace not finite")
        res[name] = (np.asarray(tr.theta, np.float64).mean(axis=(0, 1)),
                     np.asarray(tr.pos, np.float64).mean(axis=(0, 1)))
        say(f"dtypes: soibean MCMC {name} {C} chains x {n_iter} iters: "
            f"compile+run {first:.2f} s, run {steady:.3f} s = "
            f"{C * (n_iter + 1) / steady:.1f} chain-iters/s on {card}")
    dth = np.max(np.abs(res["f32"][0] - res["f64"][0]))
    dpos = np.max(np.abs(res["f32"][1] - res["f64"][1]))
    say(f"dtypes: soibean f32 vs f64 posterior means: |theta| {dth:.3g}, "
        f"|pos| {dpos:.3g} (tolerance 0.05)")
    if dth > 0.05 or dpos > 0.05:
        raise RuntimeError("soibean f32 and f64 estimates disagree")
    return res


def _deamination(rate: float = 0.3, decay: float = 0.6):
    """Ancient-DNA damage: C->T at the 5' end and G->A at the 3' end,
    `rate` at the terminal base and decaying by `decay` per position."""
    from vgan_tpu.models.damage import DamageModel

    dm = DamageModel.none()
    p = rate * decay ** np.arange(len(dm.sub5p))
    dm.sub5p[:, 1, 3], dm.sub5p[:, 1, 1] = p, 1.0 - p  # C -> T
    dm.sub3p[:, 2, 0], dm.sub3p[:, 2, 2] = p, 1.0 - p  # G -> A
    return dm


def phase_pipelines(card: str, n_taxa: int = 334, bp_per: int = 5120,
                    n_euka_reads: int = 200, n_keelime: int = 1500) -> None:
    import jax.numpy as jnp

    from vgan_tpu.graph.reconstruct import reconstruct_graph_sequence
    from vgan_tpu.graph.synth import build_haplotype_graph, mt_backbone, sample_reads, taxa_world
    from vgan_tpu.infer import abundance_mcmc, tree_mcmc
    from vgan_tpu.mapper.giraffe import BatchedMapper
    from vgan_tpu.models.damage import DamageModel
    from vgan_tpu.pipelines import euka, keelime, soibean

    # euka: device two-model scorer vs the per-read readGAM3 oracle,
    # f64 on both sides -> rel 1e-9 (as tests/test_euka.py)
    t0 = time.perf_counter()
    graph, clades, chunks = taxa_world(n_taxa=n_taxa, bp_per=bp_per)
    mapper = BatchedMapper(graph, k=20, w=10)
    reads = []
    for i in range(min(n_taxa, 20)):
        reads += sample_reads(graph, i * (n_taxa // min(n_taxa, 20)),
                              n_reads=max(n_euka_reads // 20, 1), seed=i)
    alns = [a for a in mapper.map_reads(reads) if a.identity != 0]
    recon = [reconstruct_graph_sequence(graph, a.path, a.sequence) for a in alns]
    for dname, dm in (("no damage", DamageModel.none()),
                      ("terminal deamination", _deamination())):
        scorer = euka.EukaScorer(graph, clades, chunks, damage=dm)
        il, nl = scorer._score_device(alns, recon)
        want = np.array([euka.score_read_reference(graph, clades, chunks, a, dm)
                         for a in alns])
        rel = max(np.max(np.abs(il - want[:, 0]) / np.abs(want[:, 0])),
                  np.max(np.abs(nl - want[:, 1]) / np.abs(want[:, 1])))
        say(f"pipelines: euka scorer ({dname}) {len(alns)} reads over "
            f"{n_taxa} taxa vs per-read oracle: max rel diff {rel:.3g} "
            f"(tolerance 1e-9)")
        if rel > 1e-9:
            raise RuntimeError("euka device scorer disagrees with its oracle")

    # euka abundance MCMC: finite, f32 and f64 estimates within 0.02
    rng = np.random.default_rng(3)
    n_r = np.array([4000.0, 2000.0, 1000.0, 500.0])
    sum_ll = -rng.uniform(1.0, 2.0, size=4) * n_r
    est = {}

    def abundance():
        run = lambda: abundance_mcmc.run_mcmc(  # noqa: E731
            n_r, sum_ll, n_r / n_r.sum(), n_iter=20000, burnin=200, seed=11)
        run()
        t0 = time.perf_counter()
        return run(), time.perf_counter() - t0

    for name, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
        r, secs = _with_dtype(dt, abundance)
        if not np.isfinite(r.samples).all():
            raise RuntimeError("euka abundance MCMC not finite")
        est[name] = np.asarray(r.estimate, np.float64)
        say(f"dtypes: euka abundance MCMC {name} 20000 iters: run {secs:.3f} s "
            f"= {20000 / secs:.1f} iters/s on {card}")
    d = np.max(np.abs(est["f32"] - est["f64"]))
    say(f"pipelines: euka abundance MCMC f32 vs f64 estimates |diff| {d:.3g} "
        f"(tolerance 0.02)")
    if d > 0.02:
        raise RuntimeError("euka abundance f32 and f64 estimates disagree")

    # soibean: one source -> the chain recovers that leaf, theta == 1
    tree, leaves, path_map, counts25 = _tree_world()
    pm = path_map.copy()
    pm[:, leaves[1]] = -60.0  # every read now prefers leaves[0]
    src = np.array([leaves[3]], dtype=np.int32)  # start elsewhere
    tr = tree_mcmc.run_tree_mcmc(
        tree, pm, counts25, src, soibean.make_freqs(0.25, 0.25, 0.25, 0.25),
        con=0.01, max_iter=4000, burn=1000, num_paths=tree.n_nodes,
        init_loglike=float(pm[:, src[0]].sum()), seed=2)
    on_true = float((np.asarray(tr.node)[:, 0] == leaves[0]).mean())
    say(f"pipelines: soibean k=1 chain on the true leaf {on_true:.3f} of the "
        f"recorded iterations (needs > 0.5)")
    if not (np.isfinite(tr.loglike).all() and np.allclose(tr.theta, 1.0)
            and on_true > 0.5):
        raise RuntimeError("soibean did not recover the single source")

    # keelime on the bench world: non-empty consensus
    kg, _ = build_haplotype_graph(mt_backbone(0), n_haplotypes=32,
                                  n_variants=120, seed=3)
    kmap = BatchedMapper(kg, k=31, w=11)
    kreads = sample_reads(kg, 5, n_reads=n_keelime, seed=0)
    t0 = time.perf_counter()
    frags = keelime.analyse_gam_table(kg, kmap.map_reads_table(kreads))
    cons, _s, _c, _e = keelime.consensus(kg, keelime.assemble(kg, frags))
    say(f"pipelines: keelime {n_keelime} reads -> consensus of {len(cons)} bp "
        f"in {time.perf_counter() - t0:.2f} s")
    if not cons:
        raise RuntimeError("keelime produced an empty consensus")


def phase_four_cards(d: str, n_haps: int = HC_HAPS, n_variants: int = HC_VARIANTS,
                     n_reads: int = HC_READS, n_taxa: int = 334) -> None:
    """The multi-device path a four-card host gets by default, each part
    against the same work on one device, in this process."""
    import jax
    from jax.sharding import Mesh

    from vgan_tpu.graph.reconstruct import reconstruct_graph_sequence
    from vgan_tpu.graph.synth import sample_reads, taxa_world
    from vgan_tpu.infer import tree_mcmc
    from vgan_tpu.mapper.giraffe import BatchedMapper
    from vgan_tpu.parallel import mesh as pmesh
    from vgan_tpu.pipelines import euka, hc_columnar, soibean
    from vgan_tpu.pipelines.haplocart_runner import HaplocartConfig, load_db, run_sample

    n_dev = len(jax.devices())
    graph, reads, fq = hc_world(d, n_haps, n_variants, n_reads)
    db = load_db(d)
    mapper = BatchedMapper(db.graph, k=31, w=11)
    cfg = HaplocartConfig(db_dir=d, fq1=fq, quiet=True)

    def hc_run(limit):
        pmesh.set_device_limit(limit)
        db.__dict__.pop("_sharded_cache", None)
        run_sample(cfg, db, mapper, "warm")
        t0 = time.perf_counter()
        out = run_sample(cfg, db, mapper, "s")
        return out, time.perf_counter() - t0

    (p1, n1, v1), t1 = hc_run(1)
    (pN, nN, vN), tN = hc_run(None)
    mesh = pmesh.auto_mesh(support_bytes=0)
    rel = np.max(np.abs(vN - v1) / np.abs(v1))
    say(f"four_cards: haplocart auto mesh {dict(mesh.shape)} over {n_dev} "
        f"cards {tN:.3f} s vs --devices 1 {t1:.3f} s; predictions {pN} / "
        f"{p1}; max rel diff {rel:.3g} (tolerance 1e-9)")
    if pN != p1 or n1 != nN or rel > 1e-9 or pN != graph.path_names[HC_READ_HAP]:
        raise RuntimeError("haplocart on the auto mesh disagrees with one device")

    table = hc_columnar.filter_sort_dedup(mapper.map_reads_table(reads))
    m22 = pmesh.make_mesh(dp=2, tp=2)
    v22 = hc_columnar.score_table_device(db, table, mesh=m22)
    v11 = hc_columnar.score_table_device(db, table, mesh=None)
    rel = np.max(np.abs(v22 - v11) / np.abs(v11))
    say(f"four_cards: haplocart scorer on mesh dp=2 x tp=2 vs one device: "
        f"argmax {int(np.argmax(v22))} / {int(np.argmax(v11))}, max rel diff "
        f"{rel:.3g} (tolerance 1e-9)")
    if int(np.argmax(v22)) != int(np.argmax(v11)) or rel > 1e-9:
        raise RuntimeError("dp=2 x tp=2 scorer disagrees with one device")

    # soibean: chains sharded over the cards vs the same chains on one
    tree, leaves, path_map, counts25 = _tree_world()
    C = 4 * n_dev
    srcs = np.tile(leaves[:2], (C, 1)).astype(np.int32)

    def chains(mesh_):
        return tree_mcmc.run_tree_mcmc_chains(
            tree, path_map, counts25, srcs, soibean.make_freqs(0.25, 0.25, 0.25, 0.25),
            con=0.01, max_iter=20000, burn=4000, num_paths=tree.n_nodes,
            init_loglike=float(path_map[:, srcs[0, 0]].sum()),
            seeds=np.arange(C), mesh=mesh_)

    tr_n = chains(Mesh(np.array(jax.devices()), ("dp",)))
    tr_1 = chains(None)
    same = np.array_equal(np.asarray(tr_n.theta), np.asarray(tr_1.theta))
    dth = np.max(np.abs(np.asarray(tr_n.theta).mean(axis=(0, 1))
                        - np.asarray(tr_1.theta).mean(axis=(0, 1))))
    say(f"four_cards: soibean {C} chains sharded over {n_dev} cards vs one "
        f"device: traces identical {same}; |mean theta diff| {dth:.3g} "
        f"(tolerance 0.05)")
    if not np.isfinite(np.asarray(tr_n.loglike)).all() or dth > 0.05:
        raise RuntimeError("chain-parallel soibean disagrees with one device")

    # euka: reads dp-sharded over the cards vs one device
    egraph, clades, chunks = taxa_world(n_taxa=n_taxa)
    emap = BatchedMapper(egraph, k=20, w=10)
    ereads = []
    for i in range(20):
        ereads += sample_reads(egraph, i * (n_taxa // 20), n_reads=20, seed=i)
    alns = [a for a in emap.map_reads(ereads) if a.identity != 0]
    recon = [reconstruct_graph_sequence(egraph, a.path, a.sequence) for a in alns]
    scorer = euka.EukaScorer(egraph, clades, chunks)
    pmesh.set_device_limit(1)
    il1, nl1 = scorer._score_device(alns, recon)
    pmesh.set_device_limit(None)
    ilN, nlN = scorer._score_device(alns, recon)
    rel = max(np.max(np.abs(ilN - il1) / np.abs(il1)),
              np.max(np.abs(nlN - nl1) / np.abs(nl1)))
    say(f"four_cards: euka scorer dp-sharded over {n_dev} cards vs one "
        f"device on {len(alns)} reads: max rel diff {rel:.3g} (tolerance 1e-12)")
    if rel > 1e-12:
        raise RuntimeError("dp-sharded euka scorer disagrees with one device")


# ------------------------------------------------------------------ drivers
def child(four_cards: bool) -> None:
    """All phases in one process; the last line is the device JSON."""
    card = os.environ.get("CHIP_SMOKE_CARD", "the card")
    dev = phase_device(4 if four_cards else 1)
    phase_native()
    with tempfile.TemporaryDirectory() as d:
        if four_cards:
            phase_four_cards(os.path.join(d, "hc"))
        else:
            hc = phase_hc_main(os.path.join(d, "hc"))
            phase_hc_scorer_real()
            gcups = phase_sw(card)
            say(f"sw: estimated share of the hc_main run: {hc['sw_cells']:.4g} "
                f"cells / {gcups:.2f} GCUPS = {hc['sw_cells'] / gcups / 1e9:.3f}"
                f" s of {hc['run_s']:.3f} s")
            phase_dtypes(card)
            phase_pipelines(card)
    say(f"peak_bytes_in_use {_peak_bytes()}")
    print(json.dumps({"device": dev}), flush=True)


def _run_streamed(cmd, env, timeout):
    """Run cmd, echo its stdout line by line; return (rc, last line)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env, cwd=HERE)
    last = ""
    deadline = time.monotonic() + timeout
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            if line:
                if last:
                    say(last)
                last = line
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(cmd, timeout)
        rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        say(f"timed out after {timeout} s: {' '.join(cmd)}")
        return 124, ""
    return rc, last


def card_name() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError("nvidia-smi not found: no NVIDIA driver here") from None
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return lines[0]


def main() -> int:
    four = "--four-cards" in sys.argv[1:]
    t_start = time.perf_counter()
    try:
        card = card_name()
    except RuntimeError as e:
        say(f"chip_smoke: {e}")
        return 1
    env = dict(os.environ, PYTHONPATH=HERE, CHIP_SMOKE_CARD=card)
    rc, last = _run_streamed(
        [sys.executable, os.path.abspath(__file__), "--child"] + (["--four-cards"] if four else []),
        env, timeout=1000)
    if rc != 0:
        say(last)
        say(f"chip_smoke: phases failed (exit {rc})")
        return 1
    result = json.loads(last)
    if not four:
        t0 = time.perf_counter()
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
             "-p", "no:cacheprovider"],
            env=dict(env, JAX_PLATFORMS="cuda"), cwd=HERE, capture_output=True,
            text=True, timeout=300)
        tail = tests.stdout.strip().splitlines()[-1:] or ["no output"]
        say(f"gpu_tests: {tail[0]} ({time.perf_counter() - t0:.1f} s)")
        if tests.returncode != 0 or "passed" not in tail[0] or "skipped" in tail[0]:
            say(tests.stdout[-3000:] + tests.stderr[-3000:])
            say("chip_smoke: gpu tests failed")
            return 1
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(card)
    print(json.dumps({"ok": True, "device": result["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv[1:]:
        child("--four-cards" in sys.argv[1:])
    else:
        sys.exit(main())
