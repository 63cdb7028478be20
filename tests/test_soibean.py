"""soibean tests: newick parsing, analyse_reads vs literal oracle,
HKY closed form vs literal computeBaseLogLike port, end-to-end MCMC
source recovery on the toy graph."""
import numpy as np
import pytest

from vgan_tpu.graph.reconstruct import reconstruct_graph_sequence
from vgan_tpu.infer import diagnostics, tree_mcmc
from vgan_tpu.models import phred
from vgan_tpu.pipelines import soibean
from vgan_tpu.utils.newick import parse_newick


def test_newick_parser():
    t = parse_newick("((A:0.1,B:0.2)N1:0.3,C:0.4)N2;")
    assert t.n_nodes == 5
    assert t.n_leaves == 3
    idx = t.name_to_index()
    assert t.parent[idx["A"]] == idx["N1"]
    assert t.parent[idx["N1"]] == idx["N2"]
    assert t.parent[idx["N2"]] == -1
    assert t.dist[idx["B"]] == pytest.approx(0.2)
    assert t.root == idx["N2"]


def oracle_pathmap(graph, a, penalty=7):
    """Literal transcription of analyse_GAM's per-path accumulation
    (`src/getLCAfromGAM.h:144-539`)."""
    qscore = phred.qscore_vec()
    P = graph.n_paths
    graph_seq, read_seq, sizes = reconstruct_graph_sequence(graph, a.path, a.sequence)
    isrev = a.path.mappings[0].position.is_reverse
    qual = list(a.quality)
    baseIX = len(a.sequence) - 1 if isrev else 0
    out = np.zeros(P)
    n_map = len(a.path.mappings)
    for i, size in enumerate(sizes):
        if i < n_map:
            nid = a.path.mappings[i].position.node_id
            sup = graph.path_support[nid - graph.min_id]
        else:
            sup = np.zeros(P, dtype=bool)
        if isrev:
            start = baseIX - size - 1 if baseIX - size - 1 >= 0 else 0
        else:
            start = baseIX
        nodeSeq = graph_seq[start : start + size]
        partRead = read_seq[start : start + size]
        for p in range(P):
            baseOnRead = baseIX
            for s in range(len(nodeSeq)):
                bq = qual[s] if s < len(qual) else 0
                gb, rb = nodeSeq[s], partRead[s]
                if sup[p]:
                    if gb == "N" or rb == "N":
                        out[p] += np.log(0.25)
                    elif gb == "S" or rb == "S":
                        out[p] += np.log(qscore[bq] / 3)
                    elif gb == "-" or rb == "-":
                        out[p] += np.log(0.02)
                    else:
                        if gb in "ACGT":
                            # marginal telescopes to log(1) -> clamped
                            out[p] += np.log(0.9999999)
                        else:
                            out[p] += np.log(4 * qscore[bq] / 3)
                else:
                    if gb == "N" or rb == "N":
                        out[p] += np.log(0.25)
                    elif gb == "S" or rb == "S":
                        out[p] += np.log(qscore[bq] / 3)
                    elif gb == "-" or rb == "-":
                        out[p] += np.log(0.02)
                    else:
                        if abs(baseOnRead) % penalty == 0:
                            out[p] += np.log(1 - qscore[bq])
                        else:
                            out[p] += np.log(qscore[bq] / 3)
                    if rb != "-":
                        baseOnRead = baseOnRead - 1 if isrev else baseOnRead + 1
        if isrev:
            baseIX = start
        else:
            baseIX += size
    return out


def test_analyse_reads_matches_oracle(toy_graph, toy_reads):
    stats = soibean.analyse_reads(toy_graph, toy_reads)
    reads = [a for a in toy_reads if a.identity != 0 and a.path.mappings]
    assert stats.path_map.shape[0] == len(reads)
    for ridx, a in enumerate(reads):
        want = oracle_pathmap(toy_graph, a)
        np.testing.assert_allclose(stats.path_map[ridx], want, rtol=1e-10,
                                   err_msg=a.name)


def oracle_hky_base(refb, readb, t, con, freqs):
    """Literal port of computeBaseLogLike's HKY block (no stored term)."""
    kappa = 0.0
    purinfreq, pyrinfreq, mu = freqs["R"], freqs["Y"], freqs["M"]
    P = np.zeros(4)
    for bpo, rb in enumerate("ACGT"):
        if rb == refb:
            grp = purinfreq if rb in "AG" else pyrinfreq
            A = 1 + grp * (kappa - 1)
            jut1 = freqs[rb] + freqs[rb] * ((1 / grp) - 1) * np.exp(-(mu * t))
            jut11 = ((grp - freqs[rb]) / grp) * np.exp(-(mu * t * A))
            P[bpo] = max(jut1 + jut11, 1e-8)
        elif (rb, refb) in [("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")]:
            grp = purinfreq if rb in "AG" else pyrinfreq
            A = 1 + grp * (kappa - 1)
            jut1 = freqs[rb] + freqs[rb] * ((1 / grp) - 1) * np.exp(-(mu * t))
            jut11 = (freqs[rb] / grp) * np.exp(-(mu * t * A))
            P[bpo] = max(abs(jut1 - jut11), 1e-8)
        else:
            P[bpo] = max(freqs[rb] * (1 - np.exp(-(mu * t))), 1e-8)
    terms = []
    for bpd, rb in enumerate("ACGT"):
        w = np.log(1 - con) if rb == readb else np.log(con / 3)
        terms.append(np.log(P[bpd]) + w)
    mx = max(terms)
    ll = mx + np.log(sum(np.exp(x - mx) for x in terms))
    if ll > 1e-8:
        ll = np.log(0.999999999)
    return ll


def test_hky25_matches_oracle():
    freqs = soibean.make_freqs(0.3, 0.2, 0.22, 0.28)
    for t in [1e-5, 0.01, 0.3]:
        for con in [0.01, 0.1]:
            h = np.asarray(tree_mcmc.hky25(t, con, freqs)).reshape(5, 5)
            for gi, gb in enumerate("ACGT"):
                for ri, rb in enumerate("ACGT"):
                    want = oracle_hky_base(gb, rb, t, con, freqs)
                    assert h[gi, ri] == pytest.approx(want, rel=1e-10), (gb, rb, t)


def test_tree_mcmc_recovers_single_source(toy_graph, toy_reads):
    # toy graph paths; reads all align consistently with path seq_1 ->
    # k=1 chain should stay on / converge to a high-proportion state
    stats = soibean.analyse_reads(toy_graph, toy_reads)
    P = toy_graph.n_paths
    # tiny synthetic tree over the graph paths: star tree
    names = list(toy_graph.path_names)
    if P == 1:
        # build a 3-node tree: root with the path and a dummy sibling
        from vgan_tpu.utils.newick import parse_newick

        t = parse_newick(f"({names[0]}:0.2,dummy:0.3)root;")
        tree_index = t.name_to_index()
        # dummy path column: very low likelihood
        path_map = np.concatenate(
            [stats.path_map, stats.path_map - 50.0, stats.path_map - 10.0],
            axis=1,
        )
        counts25 = np.concatenate([stats.counts25] * 3, axis=1)
        order = [tree_index[names[0]], tree_index["dummy"], tree_index["root"]]
        inv = np.argsort(order)
        path_map = path_map[:, inv]
        counts25 = counts25[:, inv, :]
        src = np.array([tree_index[names[0]]], dtype=np.int32)
        freqs = soibean.make_freqs(0.25, 0.25, 0.25, 0.25)
        init_ll = float(stats.path_map[:, 0].sum())
        trace = tree_mcmc.run_tree_mcmc(
            t, path_map, counts25, src, freqs, con=0.01,
            max_iter=400, burn=100, num_paths=3, init_loglike=init_ll, seed=2,
        )
        assert trace.theta.shape[1] == 1
        np.testing.assert_allclose(trace.theta, 1.0)
        # chain should prefer the true path node over the dummy
        frac_on_true = (trace.node[:, 0] == tree_index[names[0]]).mean()
        assert frac_on_true > 0.5
        assert np.isfinite(trace.loglike).all()


def test_ess_fft_matches_direct_loop():
    """The FFT ESS (r5) replays `src/miscfunc.h:40-66`'s paired-lag
    initial-positive-sequence semantics exactly; differential vs a
    literal transcription of the C++ loop on white-noise, AR(1) and
    sticky chains."""

    def ess_direct(v):
        v = np.asarray(v, dtype=np.float64)
        n = len(v)
        if np.var(v) == 0.0:
            return float("nan")
        max_lag = n // 2
        rho_even = 1.0
        rho_odd = diagnostics.autocorrelation(v, 1)
        rho_tot = rho_even + rho_odd
        t = 1
        while t < max_lag - 2 and rho_even + rho_odd > 0:
            rho_even = diagnostics.autocorrelation(v, t + 1)
            rho_odd = diagnostics.autocorrelation(v, t + 2)
            rho_tot += 2.0 * (rho_even + rho_odd)
            t += 2
        if rho_even + rho_odd < 0:
            rho_tot -= rho_even + rho_odd
        return n / (1.0 + rho_tot)

    rng = np.random.default_rng(3)
    white = rng.normal(size=4001)
    ar1 = np.zeros(3000)
    for i in range(1, 3000):
        ar1[i] = 0.9 * ar1[i - 1] + rng.normal()
    sticky = np.repeat(rng.normal(size=40), 75)  # accepts every ~75 it
    small = rng.normal(size=9)
    for v in (white, ar1, sticky, small):
        a = ess_direct(v)
        b = diagnostics.effective_sample_size(v)
        assert b == pytest.approx(a, rel=1e-6), (a, b, len(v))


def test_diagnostics():
    rng = np.random.default_rng(0)
    v = rng.normal(size=1000)
    ess = diagnostics.effective_sample_size(v)
    assert 200 < ess < 5000  # iid-ish
    s = np.sort(v)
    assert diagnostics.quantile(s, 0.5) == pytest.approx(np.median(v), abs=1e-9)
    r = diagnostics.rhat(np.array([0.0, 0.01]), np.array([1.0, 1.05]), 1000)
    assert r == pytest.approx(1.0, abs=0.05)
    assert diagnostics.rhat(np.array([1.0]), np.array([1.0]), 100) == -1


def test_chain_parallel_over_mesh(toy_graph, toy_reads):
    """Chains vmapped + sharded across the virtual 8-device CPU mesh."""
    import jax
    from jax.sharding import Mesh

    from vgan_tpu.pipelines import soibean as sb
    from vgan_tpu.utils.newick import parse_newick

    stats = soibean.analyse_reads(toy_graph, toy_reads)
    names = list(toy_graph.path_names)
    t = parse_newick(f"({names[0]}:0.2,dummy:0.3)root;")
    idx = t.name_to_index()
    path_map = np.concatenate(
        [stats.path_map, stats.path_map - 50.0, stats.path_map - 10.0], axis=1
    )
    counts25 = np.concatenate([stats.counts25] * 3, axis=1)
    order = np.argsort([idx[names[0]], idx["dummy"], idx["root"]])
    path_map = path_map[:, order]
    counts25 = counts25[:, order, :]
    freqs = soibean.make_freqs(0.25, 0.25, 0.25, 0.25)
    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices, ("dp",))
    C = 8
    srcs = np.full((C, 1), idx[names[0]], dtype=np.int32)
    trace = tree_mcmc.run_tree_mcmc_chains(
        t, path_map, counts25, srcs, freqs, con=0.01,
        max_iter=150, burn=50, num_paths=3,
        init_loglike=float(stats.path_map[:, 0].sum()),
        seeds=np.arange(C), mesh=mesh,
    )
    assert trace.theta.shape[0] == C
    assert np.isfinite(trace.loglike).all()


def test_ksweep_matches_chains_runner(toy_graph, toy_reads):
    """The vmapped k-sweep batch (all k x chains in one program) is
    BIT-IDENTICAL to the standalone chains runner for the row whose
    source count equals the padded width (same seeds -> same
    counter-keyed noise), and the masked k=1 rows keep theta == 1."""
    from vgan_tpu.utils.newick import parse_newick

    stats = soibean.analyse_reads(toy_graph, toy_reads)
    names = list(toy_graph.path_names)
    t = parse_newick(f"({names[0]}:0.2,dummy:0.3)root;")
    idx = t.name_to_index()
    path_map = np.concatenate(
        [stats.path_map, stats.path_map - 50.0, stats.path_map - 10.0], axis=1
    )
    counts25 = np.concatenate([stats.counts25] * 3, axis=1)
    order = np.argsort([idx[names[0]], idx["dummy"], idx["root"]])
    path_map = path_map[:, order]
    counts25 = counts25[:, order, :]
    freqs = soibean.make_freqs(0.25, 0.25, 0.25, 0.25)
    C = 2
    n0 = idx[names[0]]
    srcs1 = np.full((C, 1), n0, dtype=np.int32)
    srcs2 = np.array([[n0, idx["dummy"]], [idx["dummy"], n0]],
                     dtype=np.int32)
    seeds1 = np.arange(C) + 3
    seeds2 = np.arange(C) + 40
    ll = float(stats.path_map[:, 0].sum())
    kw = dict(con=0.01, max_iter=300, burn=60, num_paths=3)
    sweep = tree_mcmc.run_tree_mcmc_ksweep(
        t, path_map, counts25, [srcs1, srcs2], freqs,
        init_logls=[ll, ll - 1.0], seeds_per_k=[seeds1, seeds2], **kw,
    )
    ref2 = tree_mcmc.run_tree_mcmc_chains(
        t, path_map, counts25, srcs2, freqs, init_loglike=ll - 1.0,
        seeds=seeds2, **kw,
    )
    np.testing.assert_array_equal(sweep[1].node, ref2.node)
    np.testing.assert_allclose(sweep[1].loglike, ref2.loglike)
    np.testing.assert_allclose(sweep[1].theta, ref2.theta)
    np.testing.assert_allclose(sweep[1].pos, ref2.pos)
    # k=1 rows: single active source keeps theta exactly 1
    np.testing.assert_allclose(sweep[0].theta, 1.0)
    assert np.isfinite(sweep[0].loglike).all()


def test_checkpointed_mcmc_resumes(toy_graph, toy_reads, tmp_path):
    """Segmented sampler with a checkpoint produces the same trace as a
    straight run, and resumes from the snapshot after interruption."""
    from vgan_tpu.infer.tree_mcmc import (
        run_tree_mcmc_checkpointed,
    )
    from vgan_tpu.utils.newick import parse_newick

    stats = soibean.analyse_reads(toy_graph, toy_reads)
    names = list(toy_graph.path_names)
    t = parse_newick(f"({names[0]}:0.2,dummy:0.3)root;")
    idx = t.name_to_index()
    path_map = np.concatenate(
        [stats.path_map, stats.path_map - 50.0, stats.path_map - 10.0], axis=1
    )
    counts25 = np.concatenate([stats.counts25] * 3, axis=1)
    order = np.argsort([idx[names[0]], idx["dummy"], idx["root"]])
    path_map = path_map[:, order]
    counts25 = counts25[:, order, :]
    freqs = soibean.make_freqs(0.25, 0.25, 0.25, 0.25)
    src = np.array([idx[names[0]]], dtype=np.int32)
    kw = dict(
        con=0.01, max_iter=300, burn=50, num_paths=3,
        init_loglike=float(stats.path_map[:, 0].sum()), seed=5,
    )
    straight = run_tree_mcmc_checkpointed(
        t, path_map, counts25, src, freqs, checkpoint_path=None,
        checkpoint_every=1000, **kw,
    )
    # suffix-less: np.savez writes <path>.npz and resume must look there
    ckpt = str(tmp_path / "chain")
    # run the first segment only (checkpoint_every < total), then resume
    partial_run = run_tree_mcmc_checkpointed(
        t, path_map, counts25, src, freqs, checkpoint_path=ckpt,
        checkpoint_every=100, **kw,
    )
    np.testing.assert_allclose(straight.loglike, partial_run.loglike)
    np.testing.assert_array_equal(straight.node, partial_run.node)
    # resuming a finished checkpoint returns the same trace
    resumed = run_tree_mcmc_checkpointed(
        t, path_map, counts25, src, freqs, checkpoint_path=ckpt,
        checkpoint_every=100, **kw,
    )
    np.testing.assert_allclose(straight.loglike, resumed.loglike)


def test_alignment_detail_tsv(toy_graph, toy_reads, tmp_path):
    """--alignment-detail writes the _MatchInfo.tsv rows
    (`src/getLCAfromGAM.h:73-77,199-214`): one row per (supported
    path, matching base), gated by --pathThres."""
    import os

    out = str(tmp_path / "det")
    soibean.analyse_reads(toy_graph, toy_reads, detail_path=out)
    path = out + "_MatchInfo.tsv"
    assert os.path.exists(path)
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        assert header == [
            "Path name", "Read name", "Node sequence", "Index on node",
            "Node Base", "Read Sequence", "Index on read",
        ]
        rows = [l.rstrip("\n").split("\t") for l in f]
    assert rows  # fixture reads have matching supported bases
    pathnames = set(toy_graph.path_names)
    for r in rows:
        assert r[0] in pathnames
        s = int(r[3])
        assert r[2][s] == r[4]  # Node Base is Node sequence[index]
    # a threshold of 0 means "all paths" (reference default); a
    # threshold of 1 keeps only single-path nodes
    out1 = str(tmp_path / "det1")
    soibean.analyse_reads(toy_graph, toy_reads, detail_path=out1,
                          path_thres=1)
    with open(out1 + "_MatchInfo.tsv") as f:
        f.readline()
        rows1 = f.readlines()
    assert len(rows1) <= len(rows)


def test_analyse_table_matches_loop():
    """Columnar analyse_table == literal per-read loop on a larger
    mixed-strand mapper batch (fwd/rev reads, damage-noised bases,
    multi-mapping paths) — full f64 equality of pathMap and counts25."""
    import pytest

    from vgan_tpu.graph.synth import (
        build_haplotype_graph,
        mt_backbone,
        sample_reads,
    )
    from vgan_tpu.mapper import batch_map
    from vgan_tpu.mapper.giraffe import BatchedMapper

    if batch_map.load_native() is None:
        pytest.skip("native lib unavailable")
    seqs = [mt_backbone(0)]
    graph, _ = build_haplotype_graph(
        seqs[0][:5000], n_haplotypes=6, n_variants=60, seed=9
    )
    mapper = BatchedMapper(graph, k=20, w=10)
    reads = sample_reads(graph, 1, n_reads=250, seed=7)
    table = mapper.map_reads_table(reads)
    alignments = table.to_alignments()

    loop = soibean.analyse_reads_loop(graph, alignments, penalty=7)
    vec = soibean.analyse_table(graph, table, penalty=7)
    assert vec.names == loop.names
    np.testing.assert_allclose(vec.path_map, loop.path_map, rtol=1e-12)
    np.testing.assert_array_equal(vec.counts25, loop.counts25)
    np.testing.assert_array_equal(vec.most_prob_idx, loop.most_prob_idx)
    np.testing.assert_array_equal(
        vec.most_prob_unique, loop.most_prob_unique
    )


def test_tree_mcmc_f32_matches_f64_estimates():
    """f32 vs f64 tree MCMC on the same seeds: windowed agreement of the
    theta/position estimates (VERDICT r2 #6), on the seeded 8-leaf
    Ursidae tree. Tolerance: |mean theta diff| < 0.05 and |mean pos
    diff| < 0.05 over a k=2 two-source world — individual chains may
    diverge step-by-step (accept/reject is chaotic) but the posterior
    summaries must agree."""
    import jax
    import jax.numpy as jnp

    from vgan_tpu.graph.synth import ursidae_tree
    from vgan_tpu.infer import tree_mcmc
    from vgan_tpu.utils import precision
    from vgan_tpu.utils.newick import parse_newick

    tree = parse_newick(ursidae_tree(0))
    N = tree.n_nodes
    rng = np.random.default_rng(5)
    R = 120
    # two-source world: reads prefer leaves 0 and 1 in equal measure
    leaves = np.nonzero(tree.n_children == 0)[0]
    path_map = np.full((R, N), -60.0)
    path_map[: R // 2, leaves[0]] = -20.0
    path_map[R // 2 :, leaves[1]] = -20.0
    path_map += rng.uniform(-0.5, 0.5, size=(R, N))
    counts25 = rng.integers(0, 3, size=(R, N, 25)).astype(np.float32)
    freqs = soibean.make_freqs(0.25, 0.25, 0.25, 0.25)
    C, k = 2, 2
    srcs = np.tile(leaves[:k], (C, 1)).astype(np.int32)

    def run(expect_dtype):
        tr = tree_mcmc.run_tree_mcmc_chains(
            tree, path_map, counts25, srcs, freqs, con=0.01,
            max_iter=20000, burn=4000, num_paths=N,
            init_loglike=float(path_map[:, srcs[0, 0]].sum()),
            seeds=np.arange(C) + 7,
        )
        assert np.asarray(tr.theta).dtype == expect_dtype  # patch took
        theta = np.asarray(tr.theta, dtype=np.float64)
        pos = np.asarray(tr.pos, dtype=np.float64)
        return theta.mean(axis=(0, 1)), pos.mean(axis=(0, 1))

    orig = precision.compute_dtype
    try:
        assert orig("sampler") == jnp.float64  # CPU test environment
        t64, p64 = run(np.float64)
        precision.compute_dtype = lambda use, backend=None: jnp.float32
        jax.clear_caches()
        t32, p32 = run(np.float32)
    finally:
        precision.compute_dtype = orig
        jax.clear_caches()
    # equal two-source world: theta ~ (0.5, 0.5) in both dtypes
    np.testing.assert_allclose(t32, t64, atol=0.05)
    np.testing.assert_allclose(p32, p64, atol=0.05)


def test_abundance_mcmc_f32_matches_f64_estimates():
    """f32 vs f64 euka abundance sampler: proportion estimates agree
    within 0.02 on a 4-taxon world (VERDICT r2 #6)."""
    import jax
    import jax.numpy as jnp

    from vgan_tpu.infer import abundance_mcmc
    from vgan_tpu.utils import precision

    rng = np.random.default_rng(3)
    T = 4
    n_reads = np.array([4000.0, 2000.0, 1000.0, 500.0])
    sum_ll = -rng.uniform(1.0, 2.0, size=T) * n_reads
    init = n_reads / n_reads.sum()

    def run(expect_dtype):
        res = abundance_mcmc.run_mcmc(
            n_reads, sum_ll, init, n_iter=20000, burnin=200, seed=11
        )
        assert res.samples.dtype == expect_dtype  # patch took
        return np.asarray(res.estimate, dtype=np.float64)

    orig = precision.compute_dtype
    try:
        assert orig("sampler") == jnp.float64
        e64 = run(np.float64)
        precision.compute_dtype = lambda use, backend=None: jnp.float32
        jax.clear_caches()
        e32 = run(np.float32)
    finally:
        precision.compute_dtype = orig
        jax.clear_caches()
    np.testing.assert_allclose(e32, e64, atol=0.02)
