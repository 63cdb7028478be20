"""mtDNA-scale end-to-end: synthetic multi-haplotype graph built over
the seeded 16,569-bp backbone, mapped + classified like HaploCart does.

The real hcfiles DB (5,179 haplotypes) is distributed out-of-band and
absent from the reference snapshot, so the graph is synthesized at the
same shape (<=8bp nodes, variant bubbles, one path per haplotype) and
ground truth is known by construction."""
import numpy as np
import pytest

from vgan_tpu.graph.synth import (
    build_haplotype_graph,
    mt_backbone,
    sample_reads,
)
from vgan_tpu.io import fastx
from vgan_tpu.mapper.giraffe import BatchedMapper
from vgan_tpu.models import mutation
from vgan_tpu.pipelines import haplocart as hc


@pytest.fixture(scope="module")
def rcrs():
    return mt_backbone(0)


@pytest.fixture(scope="module")
def mito_world(rcrs):
    graph, truth = build_haplotype_graph(
        rcrs, n_haplotypes=12, n_variants=48, seed=3
    )
    pang = np.ones(graph.n_nodes, dtype=np.int64)
    pos = 1
    for nidx in graph.path_steps_node[0]:
        pang[nidx] = pos
        pos += int(graph.node_off[nidx + 1] - graph.node_off[nidx])
    # alt nodes inherit their backbone coordinate
    for j in range(1, graph.n_paths):
        pos = 1
        for nidx in graph.path_steps_node[j]:
            if pang[nidx] == 1:
                pang[nidx] = pos
            pos += int(graph.node_off[nidx + 1] - graph.node_off[nidx])
    db = hc.HaplocartDB(
        graph=graph,
        path_names=list(graph.path_names),
        pangenome_base=pang,
        mappabilities=np.ones(mutation.PANGENOME_LEN + 8),
    )
    mapper = BatchedMapper(graph, k=31, w=11)
    return graph, truth, db, mapper


def test_mapper_maps_rcrs_fixture_reads(ref, mito_world):
    graph, truth, db, mapper = mito_world
    reads = fastx.read_fastq(str(ref / "test/input_files/rCRS.fq"))[:60]
    alignments = mapper.map_reads(reads)
    mapped = [a for a in alignments if a.identity != 0]
    assert len(mapped) >= 0.9 * len(reads)
    # most reads should map with high identity
    idents = [a.identity for a in mapped]
    assert np.median(idents) > 0.95


def test_haplocart_classifies_reference_haplotype(ref, mito_world):
    graph, truth, db, mapper = mito_world
    reads = fastx.read_fastq(str(ref / "test/input_files/rCRS.fq"))[:80]
    alignments = [a for a in mapper.map_reads(reads) if a.identity != 0]
    final = hc.score_alignments(db, alignments)
    pred = hc.predict(db, final)
    # hap0 carries no variants == rCRS
    assert pred == "hap0", sorted(
        zip(db.path_names, final), key=lambda t: -t[1]
    )[:3]


@pytest.mark.parametrize("hap_idx", [3, 7])
def test_haplocart_classifies_variant_haplotype(mito_world, hap_idx):
    graph, truth, db, mapper = mito_world
    reads = sample_reads(graph, hap_idx, n_reads=120, seed=hap_idx)
    alignments = [a for a in mapper.map_reads(reads) if a.identity != 0]
    assert len(alignments) > 100
    final = hc.score_alignments(db, alignments)
    pred = hc.predict(db, final)
    want = graph.path_names[hap_idx]
    # the predicted haplotype must carry exactly the true variant set
    # (haplotypes with identical variant subsets are equivalent)
    assert truth[pred] == truth[want], (pred, want)
