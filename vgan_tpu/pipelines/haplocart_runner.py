"""HaploCart end-to-end driver: input -> map -> dedup -> score -> report.

Mirrors the stage chain of `Haplocart::run` (`src/HaploCart.cpp:58-488`):
giraffe -> filter mapped -> gamsort -> duplicate removal -> likelihood ->
argmax -> TSV/posterior output — with the fork/FIFO process pipeline
replaced by in-process stages feeding the device scorer.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..graph.packed import PackedGraph
from ..io import fastx, gam
from ..mapper.giraffe import BatchedMapper as Mapper
from ..utils.profiling import PROFILER
from . import haplocart as hc
from . import haplocart_device as hc_device


@dataclass
class HaplocartConfig:
    db_dir: str
    fasta: str = ""
    fq1: str = ""
    fq2: str = ""
    gamfile: str = ""
    interleaved: bool = False
    output: str = "/dev/stdout"
    posterior_file: str = ""
    background_error_prob: float = 0.0001
    samplename: str = ""
    quiet: bool = False
    webapp: bool = False
    k: int = 31
    w: int = 11
    # True: host f64 oracle loop (pipelines/haplocart.score_alignments);
    # False (default): batched device scorer (haplocart_device.score_batch)
    precise: bool = False
    # streaming map->score chunk size (dispatches scale inversely)
    chunk: int = 4096


def load_db(db_dir: str) -> hc.HaplocartDB:
    """Load a HaploCart DB directory. Accepts our packed graph
    (graph.npz / graph.gfa) plus the reference's sidecar file formats
    (`src/load.cpp`)."""
    gnpz = os.path.join(db_dir, "graph.npz")
    ggfa = os.path.join(db_dir, "graph.gfa")
    ggbz = os.path.join(db_dir, "graph.giraffe.gbz")
    if os.path.exists(gnpz):
        graph = PackedGraph.load(gnpz)
    elif os.path.exists(ggfa):
        graph = PackedGraph.from_gfa(ggfa)
    elif os.path.exists(ggbz):
        # the reference hcfiles layout ships graph.giraffe.gbz
        # (`src/map_giraffe.cpp:41-55`)
        from ..io.gbz import load_packed_graph

        graph = load_packed_graph(ggbz)
    else:
        raise FileNotFoundError(f"no graph.npz/graph.gfa/.gbz in {db_dir}")

    paths_file = os.path.join(db_dir, "graph_paths")
    if os.path.exists(paths_file):
        path_names = []
        with open(paths_file) as f:
            for line in f:
                t = line.split()
                if t:
                    path_names.append(t[0].split(".")[0])
    else:
        path_names = list(graph.path_names)

    pang = np.ones(graph.n_nodes, dtype=np.int64)
    pmap_file = os.path.join(db_dir, "parsed_pangenome_mapping")
    if os.path.exists(pmap_file):
        pmap = hc.load_pangenome_map(pmap_file)
        for key, val in pmap.items():
            idx = int(key) - graph.min_id
            if 0 <= idx < graph.n_nodes:
                pang[idx] = val
    else:
        # derive from the first path's coordinates
        pos = 1
        if graph.n_paths:
            for nidx in graph.path_steps_node[0]:
                pang[nidx] = pos
                pos += int(graph.node_off[nidx + 1] - graph.node_off[nidx])

    mapp_file = os.path.join(db_dir, "mappability.tsv")
    if os.path.exists(mapp_file):
        mapp = hc.load_mappabilities(mapp_file)
    else:
        mapp = np.ones(int(pang.max()) + 2, dtype=np.float64)

    parents = {}
    children = {}
    pf = os.path.join(db_dir, "parents.txt")
    cf = os.path.join(db_dir, "children.txt")
    if os.path.exists(pf):
        parents = hc.load_parents_children(pf)
    if os.path.exists(cf):
        children = hc.load_parents_children(cf)

    return hc.HaplocartDB(
        graph=graph,
        path_names=path_names,
        pangenome_base=pang,
        mappabilities=mapp,
        parents=parents,
        children=children,
    )


def gamsort(alignments: List[gam.Alignment]) -> List[gam.Alignment]:
    """Coordinate sort by (first node id, offset) — the vg gamsort
    stage (`src/haplocart_functions.cpp:46-78`)."""
    def key(a):
        if not a.path.mappings:
            return (1 << 62, 0)
        p = a.path.mappings[0].position
        return (p.node_id, p.offset)

    return sorted(alignments, key=key)


def get_reads(cfg: HaplocartConfig, fasta_seq: str = "") -> List[fastx.Read]:
    from ..parallel import multihost

    if fasta_seq:
        dq = fastx.dummy_qual_score(cfg.background_error_prob)
        reads = [r for r in fastx.fa2fq_reads(fasta_seq, dq) if r.seq]
    elif cfg.fq1 and cfg.fq2:
        reads = fastx.read_fastq(cfg.fq1) + fastx.read_fastq(cfg.fq2)
    elif cfg.fq1:
        reads = fastx.read_fastq(cfg.fq1)
    else:
        raise ValueError("no input")
    if multihost.active():
        # reads shard across processes by rank (SURVEY §2.9 DP row)
        reads = multihost.shard_reads(reads)
    return reads


def needs_fallback_index(fasta_seq: str) -> bool:
    """>7999 non-ACGT bases in a consensus input trigger the
    alternative minimizer parameters (k17/w18), mirroring
    `src/map_giraffe.cpp:44-55`."""
    nonbase = sum(1 for c in fasta_seq if c not in "ACGTacgt")
    return nonbase > 7999


def get_read_pairs(cfg: HaplocartConfig):
    """Mate pairs for fragment-aware mapping: two files pair by rank
    (giraffe `-f a -f b`), interleaved pairs consecutive records
    (giraffe `-i`, `src/map_giraffe.cpp:58-109`). Returns None if the
    input is not paired or the mate counts disagree."""
    if cfg.fq1 and cfg.fq2:
        r1 = fastx.read_fastq(cfg.fq1)
        r2 = fastx.read_fastq(cfg.fq2)
        if len(r1) == len(r2):
            return r1, r2
        return None
    if cfg.fq1 and cfg.interleaved:
        reads = fastx.read_fastq(cfg.fq1)
        if len(reads) % 2 == 0:
            return reads[0::2], reads[1::2]
    return None


def run_sample(
    cfg: HaplocartConfig,
    db: hc.HaplocartDB,
    mapper: Optional[Mapper],
    samplename: str,
    fasta_seq: str = "",
    sample_idx: int = 0,
) -> Tuple[str, int, np.ndarray]:
    is_consensus = bool(fasta_seq) or bool(cfg.fasta)
    if cfg.gamfile:
        from ..parallel import multihost as _mh

        if not cfg.precise and not _mh.active():
            from ..mapper.batch_map import table_from_gam

            with PROFILER.stage("read_gam"):
                table = table_from_gam(cfg.gamfile)
            if table is not None:
                # columnar GAM-input path (native codec -> table ->
                # array stage chain -> device scorer)
                from . import hc_columnar

                table = hc_columnar.filter_sort_dedup(table)
                if table.n == 0:
                    raise RuntimeError(
                        "[HaploCart] Error, no reads mapped"
                    )
                n_reads = table.n
                with PROFILER.stage("score", items=n_reads):
                    final_vec = hc_columnar.score_table_device(
                        db, table,
                        background_error_prob=cfg.background_error_prob,
                        is_consensus_fasta=is_consensus,
                    )
                pred = hc.predict(db, final_vec)
                return pred, n_reads, final_vec
        with PROFILER.stage("read_gam"):
            alignments = gam.read_gam(cfg.gamfile)
        if _mh.active():
            alignments = _mh.shard_reads(alignments)
    else:
        pairs = None
        if (cfg.fq2 or cfg.interleaved) and not fasta_seq:
            pairs = get_read_pairs(cfg)
        if pairs is not None:
            # fragment-aware joint mapping: mates select candidate
            # pairs together, with rescue (mapper.map_read_pairs);
            # read_paired is set so duplicate removal uses the paired
            # start+end coordinate rule (`src/rmdup.cpp:43-67`)
            with PROFILER.stage("map", items=2 * len(pairs[0])):
                alignments = mapper.map_read_pairs(pairs[0], pairs[1])
        else:
            reads = get_reads(cfg, fasta_seq)
            from ..mapper.batch_map import load_native
            from ..parallel import multihost

            if (
                not cfg.precise
                and not multihost.active()
                and load_native() is not None
            ):
                # COLUMNAR production path: the whole
                # filter->sort->dedup->reconstruct->score chain runs as
                # array passes with no per-read Python objects
                # (pipelines/hc_columnar.py); parity with the object
                # path is test-asserted
                from . import hc_columnar
                from ..parallel.mesh import auto_mesh

                mesh = auto_mesh(
                    support_bytes=hc_device.support_bytes(db)
                )
                if mesh is None and not (cfg.fq2 or cfg.interleaved):
                    # single-device: stream chunks straight from the
                    # mapper into the packed scorer — map host work,
                    # device SW, dedup, batch build, transfer, and
                    # scoring all overlap (hc_columnar.score_table_stream)
                    with PROFILER.stage("map+score", items=len(reads)):
                        final_vec, n_reads = (
                            hc_columnar.score_table_stream(
                                db,
                                mapper.map_table_chunks(
                                    reads, chunk=cfg.chunk
                                ),
                                background_error_prob=(
                                    cfg.background_error_prob
                                ),
                                is_consensus_fasta=is_consensus,
                            )
                        )
                    pred = hc.predict(db, final_vec)
                    return pred, n_reads, final_vec
                with PROFILER.stage("map", items=len(reads)):
                    table = mapper.map_reads_table(reads)
                if cfg.fq2 or cfg.interleaved:
                    table.read_paired[:] = True
                table = hc_columnar.filter_sort_dedup(table)
                if table.n == 0:
                    raise RuntimeError("[HaploCart] Error, no reads mapped")
                n_reads = table.n
                with PROFILER.stage("score", items=n_reads):
                    final_vec = hc_columnar.score_table_device(
                        db, table, mesh=mesh,
                        background_error_prob=cfg.background_error_prob,
                        is_consensus_fasta=is_consensus,
                    )
                pred = hc.predict(db, final_vec)
                return pred, n_reads, final_vec
            with PROFILER.stage("map", items=len(reads)):
                alignments = mapper.map_reads(reads)
            if cfg.fq2 or cfg.interleaved:
                for a in alignments:
                    a.read_paired = True
    alignments = [a for a in alignments if a.identity != 0]  # vg filter -r 1
    alignments = gamsort(alignments)
    from ..parallel import multihost

    if not alignments and not multihost.active():
        raise RuntimeError("[HaploCart] Error, no reads mapped")
    alignments = hc.remove_duplicates(alignments)
    n_reads = len(alignments)
    if multihost.active():
        # cross-host path: this process scored its own read shard (see
        # run()); accumulators merge with a global psum
        with PROFILER.stage("score", items=n_reads):
            final_vec = multihost.score_alignments_multihost(
                db, alignments,
                bep=cfg.background_error_prob,
                is_consensus_fasta=is_consensus,
            )
        pred = hc.predict(db, final_vec)
        return pred, n_reads, final_vec
    with PROFILER.stage("score", items=n_reads):
        if cfg.precise:
            # host f64 oracle (the reference's exact accumulator order)
            final_vec = hc.score_alignments(
                db,
                alignments,
                use_background_error_prob=is_consensus,
                background_error_prob=cfg.background_error_prob,
                is_consensus_fasta=is_consensus,
            )
        else:
            # production path: one batched device pass
            # (`src/HaploCart.cpp:408-421` as a single jitted step)
            final_vec = hc_device.score_alignments_device(
                db,
                alignments,
                background_error_prob=cfg.background_error_prob,
                is_consensus_fasta=is_consensus,
            )
    pred = hc.predict(db, final_vec)
    return pred, n_reads, final_vec


def validate(cfg: HaplocartConfig) -> None:
    """Input validation mirroring `src/HaploCart.cpp:107-110,255-261`
    and the error cases asserted by the reference test suite
    (`src/test.cpp:655-825`)."""
    if not 0.0 <= cfg.background_error_prob <= 1.0:
        raise RuntimeError(
            "[HaploCart] Error, option -e is not a valid probability."
        )
    n_inputs = sum(
        1 for x in (cfg.gamfile, cfg.fasta, cfg.fq1, cfg.fq2) if x
    )
    if n_inputs == 0:
        raise RuntimeError("[HaploCart] Error, no input file given")
    if n_inputs > 1 and not (
        cfg.fq1 and cfg.fq2 and not cfg.gamfile and not cfg.fasta
    ):
        raise RuntimeError("[HaploCart] Error, cannot accept multiple input files.")
    for f in (cfg.gamfile, cfg.fasta, cfg.fq1, cfg.fq2):
        if f and not os.path.exists(f):
            raise RuntimeError(f"[HaploCart] Error, input file {f} does not exist")
    # FASTA handed to -fq1 (`src/test.cpp:736-742` wrong-format case)
    if cfg.fq1.endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz")):
        raise RuntimeError("[HaploCart] Error, input file must be FASTQ")


def run(cfg: HaplocartConfig) -> List[Tuple[str, str, int]]:
    validate(cfg)
    db = load_db(cfg.db_dir)
    mapper = None
    if not cfg.gamfile:
        mapper = Mapper(db.graph, k=cfg.k, w=cfg.w)

    samples: List[Tuple[str, str]] = []  # (name, fasta_seq or "")
    if cfg.fasta:
        seqs, ids = fastx.read_fasta(cfg.fasta)
        for s, i in zip(seqs, ids):
            samples.append((cfg.samplename or i, s))
    else:
        name = cfg.samplename or (cfg.fq1 or cfg.gamfile)
        samples.append((name, ""))

    results = []
    fallback_mapper: List[Optional[Mapper]] = [None]

    def mapper_for(fseq: str) -> Optional[Mapper]:
        """Noisy consensus inputs switch to the alternative minimizer
        parameters, mirroring the reference's k17_w18.min fallback when
        the input has >7999 ambiguous bases
        (`src/map_giraffe.cpp:44-55`)."""
        if mapper is None or not fseq:
            return mapper
        if not needs_fallback_index(fseq):
            return mapper
        if not cfg.quiet:
            print(
                "Detecting many ambiguous bases, using alternative"
                " minimizer index...",
                file=sys.stderr,
            )
        if fallback_mapper[0] is None:
            fallback_mapper[0] = Mapper(db.graph, k=17, w=18)
        return fallback_mapper[0]

    from ..parallel import multihost

    if multihost.active() and not multihost.is_host0():
        out = open(os.devnull, "w")  # host 0 performs all file output
    elif cfg.output == "/dev/stdout":
        out = sys.stdout
    else:
        out = open(cfg.output, "a")
    try:
        for idx, (name, fseq) in enumerate(samples):
            pred, n_reads, final_vec = run_sample(
                cfg, db, mapper_for(fseq), name, fseq, idx
            )
            if cfg.fasta:
                n_reads = 1  # `src/HaploCart.cpp:427`
            if cfg.webapp:
                # HTML tables (`src/HaploCart.cpp:441-457`)
                out.write("\n\n\n<table>\n")
                label = "#sample" if cfg.fasta else "Sample Number"
                shown = name.replace(" ", "_") if cfg.fasta else str(idx + 1)
                out.write(f"<tr><td>{label}</td><td>&emsp;Haplogroup\n")
                out.write(
                    f"<tr><td>{shown}</td><td>&emsp;<strong>{pred}</strong>\n"
                )
                out.write("</table><br><br>\n")
            else:
                if idx == 0:
                    out.write("#sample\tpredicted haplogroup\treads\n")
                out.write(f"{name.replace(' ', '_')}\t{pred}\t{n_reads}\n")
            results.append((name, pred, n_reads))
            if cfg.posterior_file and (
                not multihost.active() or multihost.is_host0()
            ):
                post = hc.get_posterior(db, final_vec, pred)
                with open(cfg.posterior_file, "a") as pfh:
                    pfh.write(
                        f"\nClade-level posterior confidence values\n{name}\t"
                    )
                    for i, (clade, conf) in enumerate(post):
                        pfh.write(f"{clade}\t{conf}\t{i}\t")
                    pfh.write("\n\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return results
