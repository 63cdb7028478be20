"""HaploCart likelihood core tests.

The matmul reformulation (final_vec = sum B + c^T S) is validated
against a literal Python oracle that mirrors the reference's per-path
loop (`src/process_mapping.cpp:54-88`) term by term.
"""
import numpy as np
import pytest

from vgan_tpu.graph.reconstruct import reconstruct_graph_sequence
from vgan_tpu.io.gam import Alignment
from vgan_tpu.models import mutation, phred
from vgan_tpu.pipelines import haplocart as hc
from vgan_tpu.utils import dna


@pytest.fixture(scope="module")
def toy_db(toy_graph):
    g = toy_graph
    # pangenome coordinate: position of each node along the first path
    pangenome_base = np.ones(g.n_nodes, dtype=np.int64)
    pos = 1
    for nidx in g.path_steps_node[0]:
        pangenome_base[nidx] = pos
        pos += int(g.node_off[nidx + 1] - g.node_off[nidx])
    mapp = np.ones(mutation.PANGENOME_LEN, dtype=np.float64)
    return hc.HaplocartDB(
        graph=g,
        path_names=[f"P{i}" for i in range(g.n_paths)],
        pangenome_base=pangenome_base,
        mappabilities=mapp,
    )


def oracle_final_vec(db, alignments):
    """Literal reimplementation of the reference inner loop."""
    qscore = phred.qscore_vec()
    incorrect = phred.incorrect_mapping_vec()
    nbpaths = db.n_paths
    final = np.zeros(nbpaths, dtype=np.float64)
    for a in alignments:
        if a.identity < 1e-10:
            continue
        graph_seq, read_seq, sizes = reconstruct_graph_sequence(
            db.graph, a.path, a.sequence
        )
        L = len(read_seq)
        qual = list(a.quality) + [0] * (2 * L)
        pos = 0
        use_bep = any(q >= 90 for q in a.quality)
        for i, mppg in enumerate(a.path.mappings):
            size = sizes[i] if i < len(sizes) else 0
            g = graph_seq[pos : pos + size]
            r = read_seq[:size]  # quirk: from read start
            node_idx = mppg.position.node_id - db.graph.min_id
            pangenome_base = int(db.pangenome_base[node_idx])
            mappability = db.mappabilities[pangenome_base]
            p_correct = (1 - incorrect[min(a.mapping_quality, 99)]) * mappability
            quality_scores = qual[pos : pos + L]
            for p in range(nbpaths):
                if db.graph.path_support[node_idx, p]:
                    ll = 0.0
                    for j in range(len(g)):
                        if g[j] in "N-S" or r[j] in "N-S" or g[j] not in "ACGT" or r[j] not in "ACGT":
                            continue
                        q = qscore[quality_scores[j]]
                        eps = q if g[j] == r[j] else 1 - q
                        p_obs = db.match_prob[pangenome_base] * (1 - eps)
                        bg = mutation.background_freq(int(dna.encode(r[j])[0]))
                        ll += np.log((1 - p_correct) * bg + p_correct * p_obs)
                    final[p] += ll
                else:
                    ll = 0.0
                    for Q in quality_scores:
                        ll += np.log(phred.p_seq_error(Q))
                    final[p] += ll
            pos += size
    return final


def test_matmul_matches_oracle(toy_db, toy_reads):
    got = hc.score_alignments(toy_db, toy_reads, precise=True)
    want = oracle_final_vec(toy_db, toy_reads)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-8)


def test_f32_path_close(toy_db, toy_reads):
    got32 = hc.score_alignments(toy_db, toy_reads, precise=False)
    want = oracle_final_vec(toy_db, toy_reads)
    np.testing.assert_allclose(got32, want, rtol=1e-5)


def test_duplicate_removal(toy_reads):
    # duplicating the list marks every second copy a duplicate
    out = hc.remove_duplicates(list(toy_reads) + list(toy_reads))
    # reads in the fixture have distinct start coords except any natural dups
    base = hc.remove_duplicates(list(toy_reads))
    assert len(out) == len(base)


def test_posterior_rollup(toy_db, toy_reads):
    # synthesize a parent/child tree over the toy paths
    toy_db.parents = {"P0": ["root"]}
    toy_db.children = {"root": ["P0"] + [f"P{i}" for i in range(1, toy_db.n_paths)]}
    final = hc.score_alignments(toy_db, toy_reads)
    pred = hc.predict(toy_db, final)
    post = hc.get_posterior(toy_db, final, pred)
    assert post[0][0] == pred
    assert 0.0 <= post[0][1] <= 1.0 + 1e-12
    if len(post) > 1:
        # ancestor confidence is at least the leaf confidence
        assert post[1][1] >= post[0][1] - 1e-12


def test_fa2fq_windows():
    from vgan_tpu.io import fastx

    seq = "ACGT" * 5000  # 20000 bp
    reads = fastx.fa2fq_reads(seq, dummy_qual=30)
    assert len(reads) == 201
    w = -(-len(seq) // 100)
    assert all(len(r.seq) <= w for r in reads)
    # N handling: N -> A with phred 0
    reads2 = fastx.fa2fq_reads("N" * 300, dummy_qual=30)
    assert set(reads2[0].seq) == {"A"}
    assert set(reads2[0].qual) == {0}


def test_device_scorer_matches_host(toy_db, toy_reads):
    """The fully on-device scorer (haplocart_device) agrees with the
    exact host path on real alignments."""
    import jax.numpy as jnp

    from vgan_tpu.pipelines import haplocart_device as hcd

    # toy graph nodes up to 32bp -> pass a bigger tile
    batch = hcd.batch_from_alignments(toy_db, toy_reads, max_node_len=64)
    tables = hcd.make_tables_from_db(toy_db, dtype=jnp.float64)
    got = np.asarray(hcd.score_batch(batch, tables))
    want = hc.score_alignments(toy_db, toy_reads, precise=True)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert int(np.argmax(got)) == int(np.argmax(want))


def test_production_device_scorer_matches_host(toy_db, toy_reads):
    """score_alignments_device — the scorer `vgan haplocart` runs by
    default (haplocart_runner.run_sample) — agrees with the --precise
    host oracle on real alignments, with auto node-length sizing and
    M-axis bucketing in play."""
    from vgan_tpu.pipelines import haplocart_device as hcd

    got = hcd.score_alignments_device(toy_db, toy_reads)
    want = hc.score_alignments(toy_db, toy_reads, precise=True)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert int(np.argmax(got)) == int(np.argmax(want))


def test_device_scorer_consensus_mode(toy_db, toy_reads):
    """Consensus-FASTA mode: device scorer applies the eps=bep
    substitution (`src/get_p_obs_base.cpp:14-17`) and the
    log((1-bep)*p_obs) term, matching the host oracle."""
    from vgan_tpu.pipelines import haplocart_device as hcd

    bep = 1e-4
    got = hcd.score_alignments_device(
        toy_db, toy_reads, background_error_prob=bep,
        is_consensus_fasta=True,
    )
    want = hc.score_alignments(
        toy_db, toy_reads, use_background_error_prob=True,
        background_error_prob=bep, is_consensus_fasta=True, precise=True,
    )
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert int(np.argmax(got)) == int(np.argmax(want))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_score_batch_matches_numpy_reference(dtype):
    """The jitted scorer vs its plain numpy f64 twin on a synthetic
    batch (valid-mask, qual>=90 and unsupported-path terms in play)."""
    import jax.numpy as jnp

    from vgan_tpu.pipelines import haplocart_device as hcd

    support = hcd.synth_support(n_nodes=300, n_paths=96)
    batch = hcd.synth_batch(n_reads=64, n_nodes=300, dtype=jnp.dtype(dtype))
    rng = np.random.default_rng(4)
    batch = batch._replace(
        valid=jnp.asarray(rng.random(batch.valid.shape) < 0.9),
        use_bep=jnp.asarray(rng.random(batch.use_bep.shape) < 0.2),
    )
    got = np.asarray(hcd.score_batch(batch, hcd.make_tables(support, jnp.dtype(dtype))))
    want = hcd.score_batch_reference(batch, support)
    np.testing.assert_allclose(got, want, rtol=1e-12 if dtype == "float64" else 1e-5)
    assert int(np.argmax(got)) == int(np.argmax(want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_score_batch_on_gpu_matches_numpy_reference(gpu, dtype):
    """The scorer compiled for the card at the real DB's path count
    (f32 relies on the contraction's HIGHEST precision: TF32 would move
    the per-path sums by ~1e-3 relative)."""
    import jax.numpy as jnp

    from vgan_tpu.pipelines import haplocart_device as hcd

    support = hcd.synth_support(n_nodes=2048, n_paths=5179)
    batch = hcd.synth_batch(n_reads=512, n_nodes=2048, dtype=jnp.dtype(dtype))
    got = np.asarray(hcd.score_batch(batch, hcd.make_tables(support, jnp.dtype(dtype))))
    want = hcd.score_batch_reference(batch, support)
    np.testing.assert_allclose(got, want, rtol=1e-12 if dtype == "float64" else 1e-5)
    assert int(np.argmax(got)) == int(np.argmax(want))


@pytest.mark.parametrize("M, n_nodes", [(1, 4), (257, 16), (4096, 3000)])
def test_segment_sum_fixed_order_matches_segment_sum(M, n_nodes):
    """The fixed-order per-node sum equals jax.ops.segment_sum (empty
    nodes stay 0) and is bit-identical across repeated calls."""
    import jax
    import jax.numpy as jnp

    from vgan_tpu.pipelines.haplocart_device import segment_sum_fixed_order

    rng = np.random.default_rng(M)
    d = jnp.asarray(rng.normal(size=M) * 100)
    node = jnp.asarray(rng.integers(0, n_nodes, size=M).astype(np.int32))
    f = jax.jit(segment_sum_fixed_order, static_argnums=2)
    got = np.asarray(f(d, node, n_nodes))
    want = np.asarray(jax.ops.segment_sum(d, node, num_segments=n_nodes))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    assert np.asarray(f(d, node, n_nodes)).tobytes() == got.tobytes()
