"""Seeded synthetic worlds.

Generates HaploCart-shaped pangenome graphs (segmented backbone nodes
of <=8bp like the real mtDNA graph, `src/test.cpp:627`, with single-node
variant bubbles and one path per haplotype) from any reference
sequence, plus the seeded inputs that stand in for the reference's own
fixtures: an mtDNA-length backbone in place of `rCRS.fa`, an 8-leaf
Newick tree in place of soibean's `Ursidae.new.dnd`, and a small GFA
world with reads in place of `test/reconstructInputSeq`. The real
hcfiles/euka/soibean databases are distributed out-of-band (FTP,
`src/Makefile:89-91`), so every test, benchmark and smoke run builds
its inputs here from a seed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import dna
from .packed import PackedGraph

# rCRS (NC_012920.1): 16,569 bp; base composition A 5,124 / C 5,181 /
# G 2,169 / T 4,094 (one N, counted as A here)
MT_LENGTH = 16569
MT_BASE_FREQ = np.array([5125, 5181, 2169, 4094], dtype=np.float64) / MT_LENGTH

# the eight extant Ursidae species, in the accepted topology (giant
# panda, then spectacled bear, then the Ursinae)
URSIDAE = (
    "Ailuropoda_melanoleuca",
    ("Tremarctos_ornatus",
     ("Melursus_ursinus",
      ("Ursus_thibetanus",
       ("Helarctos_malayanus",
        ("Ursus_americanus", ("Ursus_arctos", "Ursus_maritimus")))))),
)


def mt_backbone(seed: int = 0, length: int = MT_LENGTH) -> str:
    """Seeded mtDNA-like backbone: i.i.d. bases at rCRS's composition."""
    rng = np.random.default_rng(seed)
    codes = rng.choice(4, size=length, p=MT_BASE_FREQ)
    return "".join(np.array(list("ACGT"))[codes])


def ursidae_tree(seed: int = 0) -> str:
    """Seeded Newick tree with the eight extant Ursidae species as
    leaves, internal nodes named N1..N7 in post-order (root last) and
    branch lengths drawn uniformly from [0.005, 0.1]."""
    rng = np.random.default_rng(seed)
    labels = iter(f"N{i}" for i in range(1, 8))

    def clade(c):
        if isinstance(c, str):
            return c
        kids = ",".join(
            f"{clade(x)}:{rng.uniform(0.005, 0.1):.5f}" for x in c
        )
        return f"({kids}){next(labels)}"

    return clade(URSIDAE) + ";"


def toy_gfa_world(seed: int = 0, length: int = 600, n_paths: int = 5,
                  n_variants: int = 12, n_reads: int = 40):
    """Small seeded GFA world: `n_paths` haplotype paths seq_1..seq_N
    over a `length`-bp backbone and `n_reads` 100-bp reads sampled
    round-robin from every path. Returns (gfa_text, reads)."""
    from ..io.gfa import format_gfa

    graph, _ = build_haplotype_graph(
        mt_backbone(seed, length), n_haplotypes=n_paths,
        n_variants=n_variants, seed=seed,
        hap_names=[f"seq_{i + 1}" for i in range(n_paths)],
    )
    reads = []
    per = -(-n_reads // n_paths)
    for p in range(n_paths):
        for r in sample_reads(graph, p, n_reads=per, seed=seed + p):
            r.name = f"read{len(reads)}"
            reads.append(r)
    return format_gfa(graph), reads[:n_reads]


def build_haplotype_graph(
    ref_seq: str,
    n_haplotypes: int = 16,
    n_variants: int = 60,
    node_len: int = 8,
    seed: int = 0,
    hap_names: Optional[List[str]] = None,
):
    """Returns (PackedGraph, truth) where truth maps haplotype name ->
    set of variant ids it carries. Haplotype 0 carries no variants
    (the reference haplotype)."""
    rng = np.random.default_rng(seed)
    ref = ref_seq.upper().replace("N", "A")
    L = len(ref)
    n_backbone = (L + node_len - 1) // node_len

    # segments: backbone nodes 1..n_backbone
    segments: Dict[int, str] = {}
    for i in range(n_backbone):
        segments[i + 1] = ref[i * node_len : (i + 1) * node_len]

    # variant sites: distinct backbone nodes (not first/last)
    sites = rng.choice(
        np.arange(1, n_backbone - 1), size=min(n_variants, n_backbone - 2),
        replace=False,
    )
    sites.sort()
    alt_of: Dict[int, int] = {}  # backbone node id -> alt node id
    next_id = n_backbone + 1
    links: List[Tuple[int, bool, int, bool]] = []
    for s in sites:
        nid = int(s) + 1
        seq = segments[nid]
        off = int(rng.integers(0, len(seq)))
        base = seq[off]
        alt_base = "ACGT"[(("ACGT".find(base)) + 1 + int(rng.integers(0, 3))) % 4]
        alt_seq = seq[:off] + alt_base + seq[off + 1 :]
        segments[next_id] = alt_seq
        alt_of[nid] = next_id
        next_id += 1

    # edges: backbone chain + bubbles
    for i in range(1, n_backbone):
        links.append((i, False, i + 1, False))
    for nid, alt in alt_of.items():
        links.append((nid - 1, False, alt, False))
        links.append((alt, False, nid + 1, False))

    # haplotypes: hap 0 = reference; others carry nested variant subsets
    names = hap_names or [f"hap{h}" for h in range(n_haplotypes)]
    paths = []
    truth: Dict[str, set] = {}
    site_ids = list(alt_of.keys())
    for h in range(n_haplotypes):
        if h == 0:
            carried = set()
        else:
            k = int(rng.integers(1, max(2, len(site_ids) // 2)))
            carried = set(
                rng.choice(site_ids, size=min(k, len(site_ids)), replace=False)
                .tolist()
            )
        steps = []
        for i in range(1, n_backbone + 1):
            steps.append((alt_of[i] if i in carried else i, False))
        paths.append((names[h], steps))
        truth[names[h]] = carried

    graph = _graph_from_parts(segments, paths, links)
    return graph, truth


def _graph_from_parts(segments, paths, links) -> PackedGraph:
    ids = sorted(segments)
    min_id = ids[0]
    max_id = ids[-1]
    n_nodes = max_id - min_id + 1
    lens = np.zeros(n_nodes, dtype=np.int64)
    for nid in ids:
        lens[nid - min_id] = len(segments[nid])
    node_off = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(lens, out=node_off[1:])
    pool = np.zeros(int(node_off[-1]), dtype=np.uint8)
    for nid in ids:
        i = nid - min_id
        pool[node_off[i] : node_off[i + 1]] = dna.encode(segments[nid])
    path_names = [p[0] for p in paths]
    steps_node = [
        np.array([nid - min_id for nid, _ in p[1]], dtype=np.int32) for p in paths
    ]
    steps_rev = [np.array([rev for _, rev in p[1]], dtype=bool) for p in paths]
    support = np.zeros((n_nodes, len(paths)), dtype=bool)
    for j, sn in enumerate(steps_node):
        support[sn, j] = True
    return PackedGraph(
        min_id=min_id,
        node_seq_pool=pool,
        node_off=node_off,
        edge_from=np.array([l[0] - min_id for l in links], dtype=np.int32),
        edge_from_rev=np.array([l[1] for l in links], dtype=bool),
        edge_to=np.array([l[2] - min_id for l in links], dtype=np.int32),
        edge_to_rev=np.array([l[3] for l in links], dtype=bool),
        path_names=path_names,
        path_steps_node=steps_node,
        path_steps_rev=steps_rev,
        path_support=support,
    )


def sample_reads(
    graph: PackedGraph,
    path_idx: int,
    n_reads: int,
    read_len: int = 100,
    error_rate: float = 0.002,
    seed: int = 0,
):
    """Sample error-bearing reads (both strands) from a haplotype."""
    from ..io.fastx import Read

    rng = np.random.default_rng(seed)
    seq = graph.path_seq(path_idx)
    L = len(seq)
    out = []
    for i in range(n_reads):
        start = int(rng.integers(0, L - read_len))
        codes = dna.encode(seq[start : start + read_len])
        errs = rng.random(read_len) < error_rate
        codes = codes.copy()
        codes[errs] = rng.integers(0, 4, size=int(errs.sum()))
        if rng.random() < 0.5:
            codes = dna.revcomp_codes(codes)
        out.append(
            Read(
                name=f"r{i}",
                seq=dna.decode(codes),
                qual=bytes([30 + int(rng.integers(0, 10)) for _ in range(read_len)]),
            )
        )
    return out


def taxa_world(n_taxa: int = 334, bp_per: int = 5120, node_len: int = 16,
               seed: int = 0):
    """euka-shaped world at the real clade-table width: `n_taxa` taxa
    (`src/MCMC.cpp:1193`'s 1/334), one ~5 kb stored path per taxon over
    its own node range, 21 entropy bins per taxon plus the whole-range
    row (`src/Euka.cpp:602-608`). Returns (graph, clades, chunks)."""
    from ..pipelines import euka as ek

    rng = np.random.default_rng(seed)
    per = bp_per // node_len
    n_nodes = per * n_taxa
    pool = rng.integers(0, 4, size=n_nodes * node_len,
                        dtype=np.int64).astype(np.uint8)
    steps = [np.arange(i * per, (i + 1) * per, dtype=np.int32)
             for i in range(n_taxa)]
    support = np.zeros((n_nodes, n_taxa), dtype=bool)
    for j, st in enumerate(steps):
        support[st, j] = True
    graph = PackedGraph(
        min_id=1,
        node_seq_pool=pool,
        node_off=np.arange(n_nodes + 1, dtype=np.int64) * node_len,
        edge_from=np.arange(n_nodes - 1, dtype=np.int32),
        edge_from_rev=np.zeros(n_nodes - 1, dtype=bool),
        edge_to=np.arange(1, n_nodes, dtype=np.int32),
        edge_to_rev=np.zeros(n_nodes - 1, dtype=bool),
        path_names=[f"taxon{i}" for i in range(n_taxa)],
        path_steps_node=steps,
        path_steps_rev=[np.zeros(len(st), dtype=bool) for st in steps],
        path_support=support,
    )
    clades, chunks = [], []
    for i in range(n_taxa):
        lo, hi = 1 + i * per, (i + 1) * per
        clades.append(ek.CladeInfo(id=i, name=f"taxon{i}", dist=0.05,
                                   n_paths=1, start_node=lo, end_node=hi))
        bounds = np.linspace(lo, hi, 22).astype(int)
        chunks.append([(int(bounds[j]), int(bounds[j + 1]), 1.5)
                       for j in range(21)] + [(lo, hi, 0.5)])
    return graph, clades, chunks
