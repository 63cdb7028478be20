"""euka pipeline tests: loaders on the real DB metadata, device scorer
vs a literal oracle of readGAM3's per-base loop, abundance MCMC."""
import os

import numpy as np
import pytest

from vgan_tpu.graph.reconstruct import reconstruct_graph_sequence
from vgan_tpu.infer.abundance_mcmc import run_mcmc
from vgan_tpu.models.damage import DamageModel
from vgan_tpu.pipelines import euka


def test_load_real_clade_and_bins(ref):
    clades = euka.load_clade_info(str(ref / "share/vgan/euka_dir/euka_db.clade"))
    assert len(clades) > 100
    assert clades[0].id == 0
    names = {c.name for c in clades}
    assert "Bovidae" in names or any("ovidae" in n for n in names)
    chunks = euka.load_clade_chunks(str(ref / "share/vgan/euka_dir/euka_db.bins"))
    assert len(chunks) == len(clades)
    assert all(len(row) >= 5 for row in chunks)
    # bins are (start <= end, entropy) triplets
    for row in chunks[:10]:
        for lo, hi, ent in row:
            assert lo <= hi
            assert 0 <= ent <= 2.1


def test_damage_model(ref):
    dm = DamageModel.from_profiles(
        str(ref / "share/vgan/damageProfiles/dhigh5p.prof"),
        str(ref / "share/vgan/damageProfiles/dhigh3p.prof"),
    )
    m = dm.dinuc(100, 0)  # 5' end of a 100bp fragment
    assert m[1, 3] == pytest.approx(0.329405)  # C>T from dhigh5p row 0
    np.testing.assert_allclose(m.sum(axis=1), 1.0, atol=1e-12)
    m3 = dm.dinuc(100, 99)  # 3' end
    assert m3[2, 0] == pytest.approx(0.32891)  # G>A from dhigh3p row 0
    # none -> identity
    none = DamageModel.none().dinuc(50, 10)
    np.testing.assert_allclose(none, np.eye(4))


@pytest.fixture(scope="module")
def toy_clades(toy_graph):
    clades = [
        euka.CladeInfo(0, "cladeA", 0.05, 1, toy_graph.min_id, 15),
        euka.CladeInfo(1, "cladeB", 0.10, 1, 16, toy_graph.max_id),
    ]
    chunks = [
        [(toy_graph.min_id, 10, 1.5), (11, 15, 1.3)],
        [(16, 22, 1.4), (23, toy_graph.max_id, 1.2)],
    ]
    return clades, chunks


@pytest.mark.parametrize("dmg", ["none", "high"])
def test_scorer_matches_oracle(ref, toy_graph, toy_reads, toy_clades, dmg):
    clades, chunks = toy_clades
    if dmg == "high":
        dm = DamageModel.from_profiles(
            str(ref / "share/vgan/damageProfiles/dhigh5p.prof"),
            str(ref / "share/vgan/damageProfiles/dhigh3p.prof"),
        )
    else:
        dm = DamageModel.none()
    scorer = euka.EukaScorer(toy_graph, clades, chunks, damage=dm)
    batch = [a for a in toy_reads if a.identity != 0]
    recon = [
        reconstruct_graph_sequence(toy_graph, a.path, a.sequence) for a in batch
    ]
    il, nl = scorer._score_device(batch, recon)
    for i, a in enumerate(batch):
        want_in, want_not = euka.score_read_reference(
            toy_graph, clades, chunks, a, dm
        )
        assert il[i] == pytest.approx(want_in, rel=1e-9), a.name
        assert nl[i] == pytest.approx(want_not, rel=1e-9), a.name


def test_full_scoring_and_detection(toy_graph, toy_reads, toy_clades):
    clades, chunks = toy_clades
    scorer = euka.EukaScorer(toy_graph, clades, chunks)
    res = scorer.score(toy_reads, min_mq=1, min_frag=1, min_bins=1, max_bins=2,
                       entropy_threshold=1.0)
    assert res.n_mapped.sum() == len([a for a in toy_reads if a.identity != 0])
    assert res.counts.sum() >= 1
    assert res.baseshift.sum() > 0


def test_abundance_mcmc_recovers_proportions():
    # two taxa with 300 and 100 high-confidence reads
    n = np.array([300, 100])
    slog = np.array([300 * np.log(0.95), 100 * np.log(0.95)])
    init = np.array([0.5, 0.5])
    res = run_mcmc(n, slog, init, n_iter=8000, burnin=100, seed=1)
    # posterior should concentrate near (0.75, 0.25)
    assert res.estimate[0] == pytest.approx(0.75, abs=0.06)
    assert res.estimate[1] == pytest.approx(0.25, abs=0.06)
    assert res.ci95[0, 0] < res.estimate[0] < res.ci95[0, 1]


def test_mcmc_handles_zero_likes():
    # a taxon containing an MQ-0 read has clade_like 0 -> sum log = -inf;
    # the reference then never accepts but still records proposals
    n = np.array([10, 10])
    slog = np.array([-np.inf, 10 * np.log(0.9)])
    init = np.array([0.6, 0.4])
    res = run_mcmc(n, slog, init, n_iter=500, burnin=50, seed=0)
    assert np.isfinite(res.estimate).all()


def test_score_table_stream_matches_one_shot(toy_graph, toy_reads, toy_clades):
    """The streaming scorer (r5: per-chunk accumulate over the mapper's
    chunk generator) merges to the one-shot score_table result: ints
    and per-read lists exactly, coverage to fp-summation tolerance."""
    from vgan_tpu.mapper.batch_map import table_from_alignments

    scorer = euka.EukaScorer(toy_graph, *toy_clades)
    full = table_from_alignments(toy_reads)
    one = scorer.score_table(full, min_mq=0, min_frag=1, min_bins=1,
                             max_bins=3, entropy_threshold=0.5)
    # chunked: split the table into 3 pieces like the chunk generator
    n = full.n
    cuts = [0, n // 3, 2 * n // 3, n]
    parts = [
        table_from_alignments(toy_reads[cuts[i]:cuts[i + 1]])
        for i in range(3)
    ]
    streamed = scorer.score_table_stream(
        iter(parts), min_mq=0, min_frag=1, min_bins=1, max_bins=3,
        entropy_threshold=0.5,
    )
    np.testing.assert_array_equal(one.counts, streamed.counts)
    np.testing.assert_array_equal(one.n_mapped, streamed.n_mapped)
    np.testing.assert_array_equal(one.baseshift, streamed.baseshift)
    assert one.detected == streamed.detected
    for c in range(len(one.clades)):
        np.testing.assert_allclose(one.clade_like[c],
                                   streamed.clade_like[c], rtol=1e-12)
        assert one.insert_sizes[c] == streamed.insert_sizes[c]
        assert one.frag_names[c] == streamed.frag_names[c]
        np.testing.assert_allclose(one.coverage[c], streamed.coverage[c],
                                   rtol=1e-12)


def test_abundance_checkpointed_resumes(tmp_path, monkeypatch):
    """Segmented abundance sampler: identical trace to the straight
    run, and a killed run resumes from its snapshot to the same
    result (VERDICT r4 #7 — euka's MCMC now has the resume path
    soibean gained in r4)."""
    from vgan_tpu.infer import abundance_mcmc as am

    n = np.array([300, 100, 50])
    slog = np.array([300 * np.log(0.95), 100 * np.log(0.9),
                     50 * np.log(0.85)])
    init = np.array([0.4, 0.35, 0.25])
    kw = dict(n_iter=3000, burnin=100, seed=7)
    straight = am.run_mcmc(n, slog, init, **kw)
    # suffix-less path: np.savez writes <path>.npz, and resume must
    # look there (a bare-path exists() check made resume a silent no-op)
    ckpt = str(tmp_path / "ab")
    segmented = am.run_mcmc_checkpointed(
        n, slog, init, checkpoint_path=ckpt, checkpoint_every=700, **kw
    )
    assert os.path.exists(ckpt + ".npz")
    np.testing.assert_allclose(straight.samples, segmented.samples)
    np.testing.assert_allclose(straight.estimate, segmented.estimate)
    # genuine kill-and-resume: a fresh run dies after 2 segments...
    ckpt2 = str(tmp_path / "ab2.npz")
    real_seg = am._run_seg
    calls = {"n": 0}

    def dying_seg(*a, **k):
        if calls["n"] >= 2:
            raise KeyboardInterrupt
        calls["n"] += 1
        return real_seg(*a, **k)

    monkeypatch.setattr(am, "_run_seg", dying_seg)
    with pytest.raises(KeyboardInterrupt):
        am.run_mcmc_checkpointed(
            n, slog, init, checkpoint_path=ckpt2, checkpoint_every=700,
            **kw,
        )
    monkeypatch.setattr(am, "_run_seg", real_seg)
    # ...and the rerun continues from the snapshot to the same trace
    resumed = am.run_mcmc_checkpointed(
        n, slog, init, checkpoint_path=ckpt2, checkpoint_every=700, **kw
    )
    np.testing.assert_allclose(straight.samples, resumed.samples)


def test_score_table_matches_score(toy_graph, toy_reads):
    """Columnar euka scorer (score_table) reproduces the object scorer
    on real fixture alignments: every EukaResult field."""
    import numpy as np

    from vgan_tpu.mapper.batch_map import load_native, table_from_alignments
    from vgan_tpu.pipelines import euka as ek

    if load_native() is None:
        pytest.skip("native lib unavailable")
    # synthesize a 2-clade world over the toy graph's node range
    clades = [
        ek.CladeInfo(id=0, name="cladeA", dist=0.05, n_paths=3,
                     start_node=2, end_node=15),
        ek.CladeInfo(id=1, name="cladeB", dist=0.08, n_paths=2,
                     start_node=16, end_node=29),
    ]
    chunks = [
        [(2, 8, 1.5), (9, 15, 1.2), (2, 15, 0.5)],
        [(16, 22, 1.4), (23, 29, 1.3), (16, 29, 0.4)],
    ]
    scorer = ek.EukaScorer(toy_graph, clades, chunks)
    alns = [a for a in toy_reads if a.identity != 0]
    want = scorer.score(alns, min_mq=0, min_frag=1, min_bins=1)
    got = scorer.score_table(
        table_from_alignments(alns), min_mq=0, min_frag=1, min_bins=1
    )
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.n_mapped, want.n_mapped)
    np.testing.assert_array_equal(got.baseshift, want.baseshift)
    assert got.detected == want.detected
    for a, b in zip(got.coverage, want.coverage):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    for a, b in zip(got.clade_like, want.clade_like):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    assert got.insert_sizes == want.insert_sizes
    assert got.frag_names == want.frag_names
