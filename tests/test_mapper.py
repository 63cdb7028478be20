"""Mapper tests: oracle = vg giraffe's own output on the bundled toy
fixture (test_reads.gam was produced by `vg giraffe` with -k 20 -w 10,
`test/reconstructInputSeq/cmds:17-21`). Our mapper must reproduce the
same alignments (validated through the reconstruction goldens)."""
import numpy as np
import pytest

from vgan_tpu.graph.reconstruct import reconstruct_graph_sequence
from vgan_tpu.io import fastx
from vgan_tpu.mapper import minimizer as mz
from vgan_tpu.mapper.align import smith_waterman
from vgan_tpu.mapper.giraffe import Mapper
from vgan_tpu.utils import dna


def test_minimizer_basics():
    codes = dna.encode("ACGTACGTACGTACGTACGTAAACCCGGGTTT")
    pos, hashes, rc = mz.minimizers(codes, k=5, w=3)
    assert len(pos) > 0
    assert (np.diff(pos) > 0).all()
    # canonical: sequence and its revcomp sample the same hash set
    pos2, hashes2, rc2 = mz.minimizers(dna.revcomp_codes(codes), k=5, w=3)
    assert set(hashes) == set(hashes2)


def test_sw_perfect_and_mismatch():
    ref = dna.encode("ACGTACGTAAACCCGGGTTTACGT")
    aln = smith_waterman(ref[4:20], ref)
    assert aln.read_start == 0 and aln.read_end == 16
    assert aln.ref_start == 4 and aln.ref_end == 20
    assert aln.cigar == [("M", 16)]
    # single mismatch
    q = ref[4:20].copy()
    q[8] = (q[8] + 1) % 4
    aln2 = smith_waterman(q, ref)
    assert aln2.ref_start == 4 and aln2.ref_end == 20
    ops = [op for op, _ in aln2.cigar]
    assert "X" in ops


def test_sw_indel():
    ref = dna.encode("ACGTACGTAAACCCGGGTTTACGTACGTGGCCA")
    # deletion of 3 bases from the read
    q = np.concatenate([ref[2:12], ref[15:30]])
    aln = smith_waterman(q, ref)
    assert ("D", 3) in aln.cigar
    # insertion of 4 bases into the read
    ins = dna.encode("TTTT")
    q2 = np.concatenate([ref[2:12], ins, ref[12:30]])
    aln2 = smith_waterman(q2, ref)
    assert ("I", 4) in aln2.cigar


@pytest.fixture(scope="module")
def toy_mapper(toy_graph):
    return Mapper(toy_graph, k=20, w=10)


def test_map_toy_reads_match_giraffe(toy_mapper, toy_graph, ref, toy_reads):
    """Map the fixture reads and compare alignments against giraffe's
    GAM via the reconstructed aligned strings."""
    reads = fastx.read_fastq(str(ref / "test/reconstructInputSeq/test_reads.fq"))
    by_name = {a.name: a for a in toy_reads}
    n_checked = 0
    for r in reads:
        ours = toy_mapper.map_read(r)
        theirs = by_name.get(r.name)
        if theirs is None or theirs.identity == 0:
            continue
        assert ours.identity != 0, f"{r.name} unmapped by our mapper"
        g_ours, r_ours, _ = reconstruct_graph_sequence(
            toy_graph, ours.path, ours.sequence
        )
        g_ref, r_ref, _ = reconstruct_graph_sequence(
            toy_graph, theirs.path, theirs.sequence
        )
        # aligned core must agree; softclip annotation may differ in
        # S-vs-'-' markers only at the very start (reference quirk)
        assert r_ours == r_ref, r.name
        assert g_ours.replace("S", "-") == g_ref.replace("S", "-"), r.name
        # strand agreement
        assert (
            ours.path.mappings[0].position.is_reverse
            == theirs.path.mappings[0].position.is_reverse
        ), r.name
        n_checked += 1
    assert n_checked == 10


def test_mq_and_scores(toy_mapper, ref):
    reads = fastx.read_fastq(str(ref / "test/reconstructInputSeq/test_reads.fq"))
    for r in reads:
        a = toy_mapper.map_read(r)
        assert 0 <= a.mapping_quality <= 60
        assert a.score > 0


def test_score_and_mq_calibration_vs_giraffe(toy_mapper, ref, toy_reads):
    """Per-read calibration against giraffe's own values in the fixture
    GAM (VERDICT r1 #6).

    * alignment scores must agree EXACTLY (same scoring model:
      match 1 / mismatch 4 / gap 6+1 / full-length bonus 5);
    * MQ semantics: our MQ is a score-gap approximation of giraffe's
      cap chain, not the same algorithm — giraffe applies
      exploration-based caps that yield 52-55 for unique-but-imperfect
      reads where the gap rule yields 60. The downstream contracts are
      the MQ>29 hard filter (`src/Euka.cpp:184`) and the 10^(-MQ/10)
      weight (`src/process_mapping.cpp:41`), so we assert per-read
      >29-filter concordance and that both sides give confident
      (>=50) values for every uniquely-placed fixture read."""
    reads = fastx.read_fastq(str(ref / "test/reconstructInputSeq/test_reads.fq"))
    by_name = {a.name: a for a in toy_reads}
    n = 0
    for r in reads:
        theirs = by_name.get(r.name)
        if theirs is None or theirs.identity == 0:
            continue
        ours = toy_mapper.map_read(r)
        assert ours.score == theirs.score, r.name
        assert (ours.mapping_quality > 29) == (
            theirs.mapping_quality > 29
        ), (r.name, ours.mapping_quality, theirs.mapping_quality)
        assert ours.mapping_quality >= 50, r.name
        assert theirs.mapping_quality >= 50, r.name
        n += 1
    assert n == 10


def test_batched_mapper_agrees(toy_graph, ref, toy_reads):
    from vgan_tpu.mapper.giraffe import BatchedMapper, Mapper

    reads = fastx.read_fastq(str(ref / "test/reconstructInputSeq/test_reads.fq"))
    m1 = Mapper(toy_graph, k=20, w=10)
    m2 = BatchedMapper(toy_graph, k=20, w=10, index=m1.index)
    out1 = [m1.map_read(r) for r in reads]
    out2 = m2.map_reads(reads)
    for a, b in zip(out1, out2):
        assert (a.identity != 0) == (b.identity != 0), a.name
        if a.identity != 0:
            ga, ra, _ = reconstruct_graph_sequence(toy_graph, a.path, a.sequence)
            gb, rb, _ = reconstruct_graph_sequence(toy_graph, b.path, b.sequence)
            assert ra == rb, a.name
            assert ga == gb, a.name


def test_fast_batch_parity():
    """The vectorized native batch path (mapper/batch_map.py) produces
    bit-identical alignments — scores, MQ, identity, full mapping/edit
    structure — to the object-based path it replaces, on an
    mtDNA-scale world with errors/indels."""
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
        seqs[0][:6000], n_haplotypes=8, n_variants=40, seed=3
    )
    mapper = BatchedMapper(graph, k=20, w=10)
    reads = sample_reads(graph, 2, n_reads=300, seed=0)
    old = mapper._map_reads_obj(reads)
    new = mapper.map_reads(reads)

    def key(a):
        return (
            a.score, a.mapping_quality, round(a.identity, 12),
            [
                (m.position.node_id, m.position.offset,
                 m.position.is_reverse,
                 [(e.from_length, e.to_length, e.sequence)
                  for e in m.edits])
                for m in a.path.mappings
            ],
        )

    for a, b in zip(old, new):
        assert (a.identity != 0) == (b.identity != 0), a.name
        assert key(a) == key(b), a.name


def test_chunked_table_parity():
    """Double-buffered chunked map_reads_table == one-shot (per-read
    results are independent; chunking must not change anything)."""
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
        seqs[0][:6000], n_haplotypes=8, n_variants=40, seed=3
    )
    mapper = BatchedMapper(graph, k=20, w=10)
    reads = sample_reads(graph, 2, n_reads=300, seed=4)
    one = mapper.map_reads_table(reads, chunk=10**9)
    chunked = mapper.map_reads_table(reads, chunk=64)
    assert one.names == chunked.names
    np.testing.assert_array_equal(one.score, chunked.score)
    np.testing.assert_array_equal(one.mq, chunked.mq)
    np.testing.assert_array_equal(one.identity, chunked.identity)
    np.testing.assert_array_equal(one.nmap, chunked.nmap)
    np.testing.assert_array_equal(one.map_off, chunked.map_off)
    np.testing.assert_array_equal(one.m_node, chunked.m_node)
    np.testing.assert_array_equal(one.m_off, chunked.m_off)
    np.testing.assert_array_equal(one.m_rev, chunked.m_rev)
    np.testing.assert_array_equal(one.e_off, chunked.e_off)
    np.testing.assert_array_equal(one.e_from, chunked.e_from)
    np.testing.assert_array_equal(one.e_to, chunked.e_to)
    np.testing.assert_array_equal(one.e_soff, chunked.e_soff)
    assert one.eseq == chunked.eseq


def test_native_seed_hits_parity():
    """The C++ batch seeding (cpp/seedhits.cpp) reproduces the numpy
    join (_batch_hits) hit-for-hit — same (read, path, strand, diag)
    multisets — on an mtDNA-scale world incl. N bases and an RYmer
    index."""
    from vgan_tpu.graph.synth import (
        build_haplotype_graph,
        mt_backbone,
        sample_reads,
    )
    from vgan_tpu.mapper import batch_map
    from vgan_tpu.mapper.giraffe import (
        BatchedMapper, _batch_hits, _batch_hits_native,
    )
    from vgan_tpu.mapper.index import MinimizerIndex

    if batch_map.load_native() is None:
        pytest.skip("native lib unavailable")
    seqs = [mt_backbone(0)]
    graph, _ = build_haplotype_graph(
        seqs[0][:6000], n_haplotypes=8, n_variants=40, seed=3
    )
    mapper = BatchedMapper(graph, k=20, w=10)
    reads = sample_reads(graph, 2, n_reads=200, seed=1)
    codes = [dna.encode(r.seq) for r in reads]
    codes[3] = codes[3].copy()
    codes[3][10:14] = 4  # N run: windows spanning it must drop
    codes[7] = codes[7][:15]  # shorter than k: no k-mers
    lens = np.array([len(c) for c in codes], dtype=np.int64)
    off = np.zeros(len(codes) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    buf = np.ascontiguousarray(np.concatenate(codes))

    for index in (mapper.index,
                  MinimizerIndex.build(graph, k=20, w=10, ry=True,
                                       max_occ=64)):
        want = _batch_hits(index, codes, lens)
        got = _batch_hits_native(index, buf, off)
        assert got is not None
        w = np.lexsort(want[::-1])
        g = np.lexsort(got[::-1])
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a[w], b[g])


def test_native_graph_aligner_parity(toy_graph, ref):
    """Native C++ graph aligner produces identical walks to the python
    reference on the fixture reads."""
    from vgan_tpu.mapper import graph_align as ga
    from vgan_tpu.mapper.giraffe import seed_and_cluster
    from vgan_tpu.mapper.index import MinimizerIndex

    if ga._load_native() is None:
        pytest.skip("native lib unavailable")
    index = MinimizerIndex.build(toy_graph, k=20, w=10)
    reads = fastx.read_fastq(str(ref / "test/reconstructInputSeq/test_reads.fq"))
    checked = 0
    for r in reads:
        codes = dna.encode(r.seq)
        for cand in seed_and_cluster(index, codes)[:2]:
            lo = max(0, cand.diag_lo - 24)
            hi = cand.diag_hi + len(codes) + 24
            win = ga.build_window(toy_graph, cand.path, lo, hi)
            q = dna.revcomp_codes(codes) if cand.strand else codes
            py = ga.align_to_window(q, win)
            nat = ga.align_to_window_native(q, win)
            assert (py is None) == (nat is None)
            if py is not None:
                assert py.score == nat.score
                assert py.read_start == nat.read_start
                assert py.read_end == nat.read_end
                assert py.walk == nat.walk, r.name
                checked += 1
    assert checked >= 10


# ------------------------------------------------------ paired mapping
@pytest.fixture(scope="module")
def mt_world():
    from vgan_tpu.graph.synth import build_haplotype_graph, mt_backbone
    from vgan_tpu.mapper.giraffe import BatchedMapper

    seqs = [mt_backbone(0)]
    graph, _ = build_haplotype_graph(
        seqs[0][:4000], n_haplotypes=4, n_variants=20, seed=5
    )
    return graph, BatchedMapper(graph, k=20, w=10)


def _make_pairs(graph, n_pairs, frag_len=300, read_len=60, seed=0):
    from vgan_tpu.io.fastx import Read
    from vgan_tpu.utils import dna as d

    rng = np.random.default_rng(seed)
    seq = graph.path_seq(0)
    pairs1, pairs2, starts = [], [], []
    for i in range(n_pairs):
        start = int(rng.integers(0, len(seq) - frag_len))
        frag = seq[start : start + frag_len]
        r1 = frag[:read_len]
        r2 = d.decode(d.revcomp_codes(d.encode(frag[-read_len:])))
        q = bytes([35] * read_len)
        pairs1.append(Read(name=f"p{i}/1", seq=r1, qual=q))
        pairs2.append(Read(name=f"p{i}/2", seq=r2, qual=q))
        starts.append(start)
    return pairs1, pairs2, starts


def test_map_read_pairs_consistent(mt_world):
    graph, mapper = mt_world
    p1, p2, starts = _make_pairs(graph, 8)
    out = mapper.map_read_pairs(p1, p2)
    assert len(out) == 16
    for k in range(8):
        a1, a2 = out[2 * k], out[2 * k + 1]
        assert a1.read_paired and a2.read_paired
        assert a1.identity > 0 and a2.identity > 0
        # proper orientation: mates on opposite strands
        s1 = a1.path.mappings[0].position.is_reverse
        s2 = a2.path.mappings[0].position.is_reverse
        assert s1 != s2
        assert a1.mapping_quality > 0


def test_map_read_pairs_agrees_with_single(mt_world):
    """On unambiguous input, joint selection picks the same placements
    as independent mapping."""
    graph, mapper = mt_world
    p1, p2, _ = _make_pairs(graph, 6, seed=3)
    paired = mapper.map_read_pairs(p1, p2)
    single = mapper.map_reads(p1 + p2)
    for k in range(6):
        for a_p, a_s in ((paired[2 * k], single[k]),
                         (paired[2 * k + 1], single[6 + k])):
            if a_s.identity == 0:
                continue
            assert (
                a_p.path.mappings[0].position.node_id
                == a_s.path.mappings[0].position.node_id
            )


def test_mate_rescue(mt_world):
    """A mate whose every k-mer is broken by mismatches (no seeds) is
    rescued by alignment next to its mapped partner."""
    graph, mapper = mt_world
    p1, p2, _ = _make_pairs(graph, 3, read_len=60, seed=7)
    # corrupt mate 2: a mismatch every 15bp kills all 20-mers
    from vgan_tpu.io.fastx import Read

    def corrupt(r):
        s = list(r.seq)
        for pos in range(7, len(s), 15):
            s[pos] = {"A": "C", "C": "A", "G": "T", "T": "G"}[s[pos]]
        return Read(name=r.name, seq="".join(s), qual=r.qual)

    p2c = [corrupt(r) for r in p2]
    # sanity: corrupted mates find no candidates on their own
    solo = mapper.map_reads(p2c)
    assert all(a.identity == 0 for a in solo)
    out = mapper.map_read_pairs(p1, p2c)
    rescued = [out[2 * k + 1] for k in range(3)]
    assert all(a.identity > 0.8 for a in rescued)
    assert all(a.mapping_quality == 30 for a in rescued)
    # rescued placement is near the partner (same path / fragment span)
    for k in range(3):
        n1 = out[2 * k].path.mappings[0].position.node_id
        n2 = rescued[k].path.mappings[0].position.node_id
        assert abs(n1 - n2) < 80  # nodes are 8bp; 300bp fragment ~ 40


def test_fallback_minimizer_trigger():
    """Consensus inputs with >7999 ambiguous bases switch to the
    k17/w18 index (`src/map_giraffe.cpp:44-55`)."""
    from vgan_tpu.pipelines.haplocart_runner import needs_fallback_index

    assert not needs_fallback_index("ACGT" * 4000)
    assert not needs_fallback_index("N" * 7999)
    assert needs_fallback_index("N" * 8000)
    assert needs_fallback_index(("ACGT" * 2000) + ("-" * 8000))


def test_safari_rescues_deaminated_reads():
    """SAFARI mode (-S): RYmer-space seeding recovers reads whose
    exact k-mer seeds were destroyed by C->T / G->A deamination
    (functional here; the reference parses the flag but never shipped
    the mapper, `src/Euka.cpp:300-303`)."""
    from vgan_tpu.graph.synth import (
        build_haplotype_graph,
        mt_backbone,
        sample_reads,
    )
    from vgan_tpu.io.fastx import Read
    from vgan_tpu.mapper.giraffe import BatchedMapper

    seqs = [mt_backbone(0)]
    graph, _ = build_haplotype_graph(
        seqs[0][:4000], n_haplotypes=4, n_variants=20, seed=5
    )
    rng = np.random.default_rng(7)
    reads = sample_reads(graph, 0, n_reads=40, read_len=60,
                         error_rate=0.0, seed=7)

    # saturating terminal deamination: every C->T / G->A transition
    # fires with p=0.9 across the read (ancient-DNA worst case)
    def deaminate(r):
        s = list(r.seq)
        for i, ch in enumerate(s):
            if ch == "C" and rng.random() < 0.9:
                s[i] = "T"
            elif ch == "G" and rng.random() < 0.9:
                s[i] = "A"
        return Read(name=r.name, seq="".join(s), qual=r.qual)

    damaged = [deaminate(r) for r in reads]

    plain = BatchedMapper(graph, k=20, w=10)
    saf = BatchedMapper(graph, k=20, w=10, safari=True)

    mapped_plain = sum(a.identity != 0 for a in plain.map_reads(damaged))
    mapped_saf = sum(a.identity != 0 for a in saf.map_reads(damaged))
    # exact seeding collapses under saturating damage; RYmer seeding
    # is invariant to it
    assert mapped_saf >= 0.9 * len(damaged), mapped_saf
    assert mapped_saf > mapped_plain

    # and on undamaged reads SAFARI must not lose anything
    clean_plain = sum(a.identity != 0 for a in plain.map_reads(reads))
    clean_saf = sum(a.identity != 0 for a in saf.map_reads(reads))
    assert clean_saf >= clean_plain


def test_paired_fast_path_parity(mt_world):
    """Vectorized paired mapping == the object implementation: same
    placements, scores, MQ, flags — including rescued mates."""
    from vgan_tpu.mapper import batch_map

    if batch_map.load_native() is None:
        pytest.skip("native lib unavailable")
    graph, mapper = mt_world
    p1, p2, _ = _make_pairs(graph, 10, seed=21)
    # corrupt a couple of mates to exercise rescue
    from vgan_tpu.io.fastx import Read

    def corrupt(r):
        s = list(r.seq)
        for pos in range(7, len(s), 15):
            s[pos] = {"A": "C", "C": "A", "G": "T", "T": "G"}[s[pos]]
        return Read(name=r.name, seq="".join(s), qual=r.qual)

    p2 = [corrupt(r) if i % 4 == 0 else r for i, r in enumerate(p2)]
    new = mapper.map_read_pairs(p1, p2)
    old = mapper._map_read_pairs_obj(p1, p2)

    def key(a):
        return (
            a.score, a.mapping_quality, round(a.identity, 12),
            a.read_paired,
            [
                (m.position.node_id, m.position.offset,
                 m.position.is_reverse,
                 [(e.from_length, e.to_length, e.sequence)
                  for e in m.edits])
                for m in a.path.mappings
            ],
        )

    assert len(new) == len(old)
    for a, b in zip(old, new):
        assert (a.identity != 0) == (b.identity != 0), a.name
        assert key(a) == key(b), a.name


def test_index_build_vectorized_matches_loop():
    """Vectorized MinimizerIndex.build == the per-minimizer dict-loop
    oracle field-for-field (incl. first-seen posting order and max_occ
    filtering) on a multi-haplotype world with reverse steps and an
    RYmer index."""
    from vgan_tpu.graph.synth import build_haplotype_graph, mt_backbone
    from vgan_tpu.mapper.index import MinimizerIndex

    seqs = [mt_backbone(0)]
    graph, _ = build_haplotype_graph(
        seqs[0][:4000], n_haplotypes=6, n_variants=50, seed=13
    )
    for ry, mo in ((False, None), (True, 64), (False, 3)):
        a = MinimizerIndex.build(graph, k=20, w=10, ry=ry, max_occ=mo)
        b = MinimizerIndex._build_loop(graph, k=20, w=10, ry=ry,
                                       max_occ=mo)
        np.testing.assert_array_equal(a.hashes, b.hashes)
        np.testing.assert_array_equal(a.post_off, b.post_off)
        np.testing.assert_array_equal(a.post_path, b.post_path)
        np.testing.assert_array_equal(a.post_ppos, b.post_ppos)
        np.testing.assert_array_equal(a.post_rc, b.post_rc)
        np.testing.assert_array_equal(a.path_len, b.path_len)


# ---------------------------------------------------------------------------
# adversarial MQ calibration (VERDICT r3 #4): synthetic ambiguous-
# placement worlds where giraffe's MQ behavior is derivable — unique
# placement -> 60, exactly tied distinct placements -> ~0 (fails the
# MQ>29 filter, `src/Euka.cpp:184`), and MQ monotone in the score gap
# (`src/process_mapping.cpp:41` consumes MQ as a 10^(-MQ/10) weight).
# ---------------------------------------------------------------------------
def _rand_seq(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _linear_graph(named_seqs, node_len=8):
    """One linear node chain per named sequence (disjoint node ranges,
    like taxa in a euka/soibean DB)."""
    from vgan_tpu.graph.synth import _graph_from_parts

    segments, paths, links = {}, [], []
    nid = 1
    for name, seq in named_seqs:
        steps, prev = [], None
        for i in range(0, len(seq), node_len):
            segments[nid] = seq[i : i + node_len]
            steps.append((nid, False))
            if prev is not None:
                links.append((prev, False, nid, False))
            prev = nid
            nid += 1
        paths.append((name, steps))
    return _graph_from_parts(segments, paths, links)


def _read_from(seq, start, L=100, name="r"):
    return fastx.Read(name=name, seq=seq[start : start + L],
                      qual=bytes([40] * L))


def _mq_both(graph, read):
    """MQ from the per-read mapper and the batched production mapper
    (they must agree on the filter decision)."""
    from vgan_tpu.mapper.giraffe import BatchedMapper

    m1 = Mapper(graph, k=20, w=10).map_read(read).mapping_quality
    m2 = BatchedMapper(graph, k=20, w=10).map_reads([read])[0].mapping_quality
    return m1, m2


def test_mq_adversarial_unique_placement():
    seq = _rand_seq(2000, 1)
    g = _linear_graph([("only", seq)])
    m1, m2 = _mq_both(g, _read_from(seq, 900))
    assert m1 == 60 and m2 == 60


def test_mq_adversarial_cross_path_tie():
    """A read tied between two paths with DISJOINT node ranges but the
    same path-local offsets (two taxa sharing a conserved cassette)
    must be ambiguous: MQ ~0, failing the >29 filter — not a
    haplotype-duplicate of one region."""
    u = _rand_seq(300, 2)
    a = _rand_seq(1000, 3) + u
    b = _rand_seq(1000, 4) + u
    g = _linear_graph([("taxonA", a), ("taxonB", b)])
    m1, m2 = _mq_both(g, _read_from(a, 1100))
    assert m1 <= 3 and m2 <= 3  # tied -> fails MQ>29
    # control: a read unique to taxonA keeps MQ 60
    u1, u2 = _mq_both(g, _read_from(a, 400))
    assert u1 == 60 and u2 == 60


def test_mq_adversarial_tandem_repeat_same_path():
    """A repeated cassette within ONE path gives two genuinely distinct
    placements -> tie -> MQ ~0."""
    u = _rand_seq(200, 5)
    seq = _rand_seq(500, 6) + u + _rand_seq(600, 7) + u + _rand_seq(500, 8)
    g = _linear_graph([("tandem", seq)])
    m1, m2 = _mq_both(g, _read_from(seq, 550))
    assert m1 <= 3 and m2 <= 3


def test_mq_adversarial_haplotype_duplicate_region():
    """Two haplotype paths that WALK THE SAME NODES are one placement
    (giraffe's haplotype dedup): a read there stays MQ 60."""
    from vgan_tpu.graph.synth import _graph_from_parts

    seq = _rand_seq(1200, 9)
    segments, links = {}, []
    steps = []
    nid = 1
    for i in range(0, len(seq), 8):
        segments[nid] = seq[i : i + 8]
        steps.append((nid, False))
        if nid > 1:
            links.append((nid - 1, False, nid, False))
        nid += 1
    g = _graph_from_parts(segments, [("hapA", steps), ("hapB", steps)], links)
    m1, m2 = _mq_both(g, _read_from(seq, 500))
    assert m1 == 60 and m2 == 60


def test_mq_adversarial_monotone_in_gap():
    """Decoy regions at increasing Hamming distance from the true
    placement: MQ is monotone nondecreasing in the score gap, ties land
    below the >29 filter, and far decoys land above it."""
    true = _rand_seq(1200, 10)
    start, L = 600, 100
    mqs = []
    for d in (0, 1, 2, 4, 8):
        decoy = list(true)
        rng = np.random.default_rng(100 + d)
        # mutate d positions inside the read window
        for pos in rng.choice(np.arange(start, start + L), size=d,
                              replace=False):
            decoy[pos] = "ACGT"[("ACGT".find(decoy[pos]) + 2) % 4]
        g = _linear_graph([("true", true), ("decoy", "".join(decoy))])
        m1, m2 = _mq_both(g, _read_from(true, start))
        assert m1 == m2, f"d={d}: per-read {m1} != batched {m2}"
        mqs.append(m1)
    assert mqs[0] <= 3  # exact tie
    assert all(b >= a for a, b in zip(mqs, mqs[1:])), mqs
    assert mqs[-1] >= 30  # far decoy passes the euka filter side


def test_mq_distributional_calibration_and_sensitivity():
    """VERDICT r4 #5 — graded-ambiguity MQ distribution, not just the
    poles: a 400bp cassette duplicated on a decoy path at Hamming
    distance d in {0,1,2,4,8}, with reads tiling the cassette so each
    read sees a varying share of the d mutations (score gaps sweep
    0..max). Checks (a) the per-read oracle and the batched production
    mapper agree on EVERY read's MQ (the two paths' distributions are
    identical, so downstream `src/process_mapping.cpp:41` weights and
    the `src/Euka.cpp:184` MQ>29 filter cannot diverge between them);
    (b) the MQ>29 pass rate is monotone in d with the derivable poles
    (d=0 all-fail, d=8 all-pass); (c) downstream bound: the haplocart
    argmax is stable under a +-5 (one filter class) MQ perturbation of
    every read in the borderline d=2 world."""
    from vgan_tpu.mapper.giraffe import BatchedMapper

    L, cas_lo, cas_hi = 100, 1000, 1400
    base = _rand_seq(2400, 31)
    starts = list(range(cas_lo, cas_hi - L + 1, 25))
    pass_rates = []
    tables = {}
    for d in (0, 1, 2, 4, 8):
        decoy = list(base)
        rng = np.random.default_rng(200 + d)
        for pos in rng.choice(np.arange(cas_lo, cas_hi), size=d,
                              replace=False):
            decoy[pos] = "ACGT"[("ACGT".find(decoy[pos]) + 2) % 4]
        g = _linear_graph([("true", base), ("decoy", "".join(decoy))])
        m_per = Mapper(g, k=20, w=10)
        m_bat = BatchedMapper(g, k=20, w=10)
        reads = [_read_from(base, s, name=f"d{d}s{s}") for s in starts]
        out1 = [m_per.map_read(r) for r in reads]
        out2 = m_bat.map_reads(reads)
        mqs = []
        for a, b in zip(out1, out2):
            assert a.mapping_quality == b.mapping_quality, (
                d, a.name, a.mapping_quality, b.mapping_quality
            )
            mqs.append(b.mapping_quality)
        pass_rates.append(np.mean([m > 29 for m in mqs]))
        tables[d] = (g, m_bat, reads)
    assert pass_rates[0] == 0.0, pass_rates  # exact duplicate: all fail
    # far decoy: nearly all pass (a window can miss all 8 mutations
    # with p ~ (300/400)^8 ~= 0.1 — that read is genuinely ambiguous)
    assert pass_rates[-1] >= 0.9, pass_rates
    assert all(b >= a for a, b in zip(pass_rates, pass_rates[1:])), (
        pass_rates
    )

    # (c) haplocart sensitivity to one MQ filter class (+-5)
    from vgan_tpu.pipelines import haplocart as hc
    from vgan_tpu.pipelines.hc_columnar import (
        filter_sort_dedup,
        score_table_device,
    )

    g, m_bat, reads = tables[2]
    pang = np.ones(g.n_nodes, dtype=np.int64)
    pos = 1
    for nidx in g.path_steps_node[0]:
        pang[nidx] = pos
        pos += int(g.node_off[nidx + 1] - g.node_off[nidx])
    db = hc.HaplocartDB(
        graph=g, path_names=list(g.path_names), pangenome_base=pang,
        mappabilities=np.ones(int(pang.max()) + 2, dtype=np.float64),
    )
    t = filter_sort_dedup(m_bat.map_reads_table(reads))
    base_vec = score_table_device(db, t, mesh=None)
    base_arg = int(np.argmax(base_vec))
    for delta in (-5, 5):
        t.mq = np.clip(t.mq + delta, 0, 60)
        vec = score_table_device(db, t, mesh=None)
        assert int(np.argmax(vec)) == base_arg, (delta, vec, base_vec)
        t.mq = np.clip(t.mq - delta, 0, 60)


def test_mq_adversarial_chained_repeat_three_copies():
    """ADVICE r4: >=3 equal-content windows whose intervals chain (B
    overlaps A, C overlaps B but NOT A). Kept-only dedup — the host
    semantics in giraffe._gather_candidates — keeps A and C: two
    genuinely distinct placements, so the read is ambiguous (MQ ~0,
    fails the euka MQ>29 filter). An adjacent-row-only device dedup
    would let the dropped B suppress C and wrongly report a unique
    placement (MQ 60)."""
    u = _rand_seq(100, 21)
    # 5 tandem copies + a 24bp periodic tail so every interior window
    # (width L + 2*pad = 148) has identical content: kept-only keeps
    # los {76, 276}; adjacent-only would chain-drop everything past 76
    seq = u * 5 + u[:24] + _rand_seq(200, 22)
    g = _linear_graph([("rep", seq)])
    m1, m2 = _mq_both(g, _read_from(seq, 100))
    assert m1 == m2, (m1, m2)
    assert m1 <= 3


def test_streaming_threaded_finalize_parity():
    """map_table_chunks with the worker-thread collect+finalize
    produces byte-identical tables to the serial path (pool snapshots
    keep concurrent readers consistent)."""
    from vgan_tpu.graph.synth import build_haplotype_graph, sample_reads
    from vgan_tpu.mapper import giraffe as gi
    from vgan_tpu.mapper.giraffe import BatchedMapper

    base = _rand_seq(4000, 42)
    graph, _ = build_haplotype_graph(base, n_haplotypes=8, n_variants=40,
                                     seed=3)
    mapper = BatchedMapper(graph, k=20, w=10)
    reads = sample_reads(graph, 2, n_reads=7000, seed=0)
    old = gi.OVERLAP_FINALIZE
    try:
        gi.OVERLAP_FINALIZE = True
        t1 = mapper.map_reads_table(reads, chunk=2048)
        gi.OVERLAP_FINALIZE = False
        t2 = mapper.map_reads_table(reads, chunk=2048)
    finally:
        gi.OVERLAP_FINALIZE = old
    np.testing.assert_array_equal(t1.score, t2.score)
    np.testing.assert_array_equal(t1.mq, t2.mq)
    np.testing.assert_array_equal(t1.nmap, t2.nmap)
    np.testing.assert_array_equal(t1.m_node, t2.m_node)
    np.testing.assert_array_equal(t1.e_from, t2.e_from)
