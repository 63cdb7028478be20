"""DB self-hosting tests (VERDICT r1 #8): build a mini hcfiles-layout
DB from raw consensus FASTAs and run haplocart on it end-to-end with
posterior output; subset a per-taxon soibean DB from a super-graph."""
import os

import numpy as np
import pytest

from vgan_tpu import cli
from vgan_tpu.graph.synth import mt_backbone


@pytest.fixture(scope="module")
def hap_world(tmp_path_factory):
    """Reference slice + 4 haplotypes with known SNPs and a phylotree:

            ROOT
           /    \\
          A      B
         / \\
       A1   A2
    """
    d = tmp_path_factory.mktemp("hcworld")
    seqs = [mt_backbone(0)]
    base = seqs[0][:2400].upper().replace("N", "A")
    rng = np.random.default_rng(11)

    def mutate(s, sites):
        s = list(s)
        for pos in sites:
            s[pos] = {"A": "C", "C": "G", "G": "T", "T": "A"}[s[pos]]
        return "".join(s)

    sites_a = list(rng.choice(2200, size=8, replace=False) + 100)
    sites_b = list(rng.choice(2200, size=8, replace=False) + 100)
    hapA = mutate(base, sites_a)
    hapB = mutate(base, sites_b)
    hapA1 = mutate(hapA, [50])
    hapA2 = mutate(hapA, [60])
    with open(d / "ref.fa", "w") as f:
        f.write(f">refseq\n{base}\n")
    with open(d / "haps.fa", "w") as f:
        for name, s in [("A", hapA), ("A1", hapA1), ("A2", hapA2),
                        ("B", hapB)]:
            f.write(f">{name}\n{s}\n")
    with open(d / "phylo.tsv", "w") as f:
        f.write("A\tROOT\nB\tROOT\nA1\tA\nA2\tA\n")
    return d, {"A": hapA, "A1": hapA1, "A2": hapA2, "B": hapB}


def test_build_hc_db_and_run_haplocart(hap_world, tmp_path):
    d, haps = hap_world
    out_db = tmp_path / "db"
    rc = cli.main([
        "build-hc-db", str(d / "ref.fa"), str(d / "haps.fa"),
        str(out_db), "--phylo", str(d / "phylo.tsv"),
    ])
    assert rc == 0
    # reference-format sidecars all present
    for name in ("graph.npz", "graph_paths", "path_supports",
                 "parsed_pangenome_mapping", "mappability.tsv",
                 "parents.txt", "children.txt"):
        assert (out_db / name).exists(), name
    # path_supports: reference format = one '0'/'1' line per node
    lines = (out_db / "path_supports").read_text().splitlines()
    from vgan_tpu.graph.packed import PackedGraph

    g = PackedGraph.load(str(out_db / "graph.npz"))
    assert len(lines) == g.n_nodes
    assert set("".join(lines)) <= {"0", "1"}
    assert all(len(ln) == 4 for ln in lines)

    # reads from haplotype A1 -> haplocart must call A1, with a clade
    # posterior that includes ancestors A and ROOT
    rng = np.random.default_rng(5)
    fq = tmp_path / "reads.fq"
    seq = haps["A1"]
    with open(fq, "w") as f:
        for i in range(60):
            start = int(rng.integers(0, len(seq) - 90))
            r = seq[start : start + 90]
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    out = tmp_path / "hc.tsv"
    post = tmp_path / "post.txt"
    rc = cli.main([
        "haplocart", "--db", str(out_db), "-fq1", str(fq),
        "-o", str(out), "-pf", str(post), "-k", "20", "--minw", "10",
    ])
    assert rc == 0
    text = out.read_text()
    assert "\tA1\t" in text, text
    ptxt = post.read_text()
    assert "A1" in ptxt and "ROOT" in ptxt


def test_build_taxon_db_subsets(tmp_path):
    """make_graph_files.sh-equivalent: per-taxon npz from a super-graph
    + clade node ranges, loadable and locally complete."""
    from vgan_tpu.db.taxa import build_taxon_db, subset_graph
    from vgan_tpu.graph.packed import PackedGraph
    from vgan_tpu.graph.synth import build_haplotype_graph, mt_backbone

    seqs = [mt_backbone(0)]
    g = build_haplotype_graph(
        seqs[0][:4000], n_haplotypes=3, n_variants=10, seed=1
    )[0]
    d = tmp_path / "super"
    os.makedirs(d)
    g.save(str(d / "graph.npz"))
    mid = g.min_id + g.n_nodes // 2
    with open(d / "soibean_db.clade", "w") as f:
        f.write(f"0 TaxLow 0.05 3 {g.min_id} {mid}\n")
        f.write(f"1 TaxHigh 0.05 3 {mid + 1} {g.max_id}\n")
    out = build_taxon_db(str(d), "TaxLow")
    sub = PackedGraph.load(out)
    assert sub.min_id == g.min_id
    assert sub.max_id <= mid
    assert sub.n_paths >= 1
    # node sequences preserved
    for nid in range(sub.min_id, sub.min_id + min(5, sub.n_nodes)):
        assert sub.node_seq(nid) == g.node_seq(nid)
    # subset path steps are a contiguous run of the original
    orig = {n: (sn, sr) for n, sn, sr in zip(
        g.path_names, g.path_steps_node, g.path_steps_rev)}
    for name, sn in zip(sub.path_names, sub.path_steps_node):
        osn = orig[name][0]
        shifted = sn + (sub.min_id - g.min_id)
        s = "".join(f",{x}" for x in osn)
        assert "".join(f",{x}" for x in shifted) in s
