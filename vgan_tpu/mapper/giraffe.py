"""Haplotype-constrained read mapper (giraffe-equivalent pipeline).

Stages (SURVEY.md §2.2):
  1. sketch: (w,k)-minimizers of the read (mapper/minimizer.py)
  2. seed:   index lookup -> (path, strand, diagonal) hits
  3. cluster: group seeds per (path, strand) within a diagonal band
  4. extend: banded affine SW of the (oriented) read against the
     candidate path window (mapper/align.py; batched device scorer in
     mapper/sw_pallas.py for the heavy phase)
  5. select: best alignment after node-projection dedup; mapping
     quality from the best-vs-second score gap
  6. project: path interval -> per-node GAM mappings with edits
     (softclips as boundary insertions, exactly the structures
     `reconstruct_graph_sequence` consumes)

Like vg giraffe, alignment is haplotype-constrained: candidates are
windows of the stored haplotype paths, which is giraffe's GBWT
restriction in explicit form (`src/map_giraffe.cpp:24-164` invokes
giraffe with -H/-Z haplotype indexes).

Mapping quality is a score-gap approximation of giraffe's cap
(mq = min(60, 6.23 * (best - second)); 60 when unique) — the reference
pipelines only consume MQ through 10^(-MQ/10) weights and >29/30
filters (`src/process_mapping.cpp:41`, `src/Euka.cpp:184`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..graph.packed import PackedGraph
from ..io import gam
from ..io.fastx import Read
from ..utils import dna
from . import minimizer as mz
from .align import FULL_LENGTH_BONUS
from .index import MinimizerIndex, _path_codes, _step_offsets


# stream collect+finalize on a worker thread in map_table_chunks
# (module flag so benchmarks can A/B within one process)
OVERLAP_FINALIZE = True


@dataclass
class Candidate:
    path: int
    strand: bool  # True: read maps to path reverse strand
    diag_lo: int
    diag_hi: int
    n_seeds: int


def seed_and_cluster(
    index: MinimizerIndex,
    read_codes: np.ndarray,
    max_diag_gap: int = 48,
) -> List[Candidate]:
    if index.ry:
        read_codes = mz.to_ry(read_codes)
    pos, hashes, read_rc = mz.all_kmers(read_codes, index.k)
    L = len(read_codes)
    hits: List[Tuple[int, bool, int]] = []  # (path, strand, diag)
    for (p0, p1), rpos, rrc in zip(index.lookup(hashes), pos, read_rc):
        for i in range(p0, p1):
            path = int(index.post_path[i])
            ppos = int(index.post_ppos[i])
            strand = bool(index.post_rc[i]) ^ bool(rrc)
            if not strand:
                diag = ppos - int(rpos)
            else:
                # read rc coordinate of this k-mer start
                rc_pos = L - index.k - int(rpos)
                diag = ppos - rc_pos
            hits.append((path, strand, diag))
    if not hits:
        return []
    hits.sort()
    clusters: List[Candidate] = []
    cur: Optional[Candidate] = None
    for path, strand, diag in hits:
        if (
            cur is not None
            and cur.path == path
            and cur.strand == strand
            and diag - cur.diag_hi <= max_diag_gap
        ):
            cur.diag_hi = diag
            cur.n_seeds += 1
        else:
            cur = Candidate(path, strand, diag, diag, 1)
            clusters.append(cur)
    clusters.sort(key=lambda c: -c.n_seeds)
    return clusters


@dataclass
class PathAlignment:
    path: int
    strand: bool
    aln: "GraphAlignment"
    window: "Window"
    eff_score: int
    lo: int = 0  # window start on the haplotype linearization
    hi: int = 0


def same_placement(strand_a, lo_a, hi_a, strand_b, lo_b, hi_b,
                   span_a=None, span_b=None) -> bool:
    """Two candidates describe the same read placement when they share
    the strand and their haplotype-window intervals overlap — the same
    graph region reached via different (near-identical) haplotypes.
    Such pairs do not compete for mapping quality (giraffe likewise
    rates a placement against genuinely distinct placements only; the
    fixture GAM gives softclipped unique reads MQ 52-55, not a
    near-zero gap score).

    spans are the candidates' path (min,max) node-index ranges
    (PackedGraph.path_node_spans): paths over disjoint node ranges
    (different taxa in a multi-clade DB) share path-local offsets but
    never the graph region, so they always count as distinct — a read
    tied between two taxa must score MQ ~0 and fail the MQ>29 filter
    (`src/Euka.cpp:184`), as giraffe's multiplicity model would."""
    if strand_a != strand_b or lo_a >= hi_b or lo_b >= hi_a:
        return False
    if span_a is not None and span_b is not None:
        if span_a[1] < span_b[0] or span_b[1] < span_a[0]:
            return False
    return True


def extend_candidates(
    graph: PackedGraph,
    index: MinimizerIndex,
    read_codes: np.ndarray,
    clusters: List[Candidate],
    max_candidates: int = 8,
    pad: int = 24,
) -> List[PathAlignment]:
    from .graph_align import align_to_window, build_window

    out: List[PathAlignment] = []
    L = len(read_codes)
    rc_codes = dna.revcomp_codes(read_codes)
    for cand in clusters[:max_candidates]:
        plen = int(index.path_len[cand.path])
        lo = max(0, cand.diag_lo - pad)
        hi = min(plen, cand.diag_hi + L + pad)
        if hi <= lo:
            continue
        win = build_window(graph, cand.path, lo, hi)
        if win is None:
            continue
        q = rc_codes if cand.strand else read_codes
        aln = align_to_window(q, win)
        if aln is None:
            continue
        # start bonus is baked into the DP; add the end bonus here
        eff = aln.score + (FULL_LENGTH_BONUS if aln.read_end == L else 0)
        out.append(
            PathAlignment(cand.path, cand.strand, aln, win, eff, lo, hi)
        )
    out.sort(key=lambda a: -a.eff_score)
    return out


def _project_walk(
    graph: PackedGraph,
    win,
    read: str,
    aln,
) -> gam.Path:
    """Build per-node GAM mappings from a graph-alignment walk."""
    mappings: List[gam.Mapping] = []
    cur: Optional[gam.Mapping] = None
    cur_handle = None
    pending: List[gam.Edit] = []
    read_pos = aln.read_start
    if aln.read_start > 0:
        pending.append(gam.Edit(0, aln.read_start, read[: aln.read_start]))

    def new_mapping(handle_idx, offset):
        nonlocal cur, cur_handle
        nidx, rev = win.handles[handle_idx]
        cur = gam.Mapping(
            position=gam.Position(
                node_id=int(nidx) + graph.min_id,
                offset=int(offset),
                is_reverse=bool(rev),
            ),
            edits=[],
            rank=len(mappings) + 1,
        )
        cur_handle = handle_idx
        mappings.append(cur)
        if pending:
            cur.edits.extend(pending)
            pending.clear()

    for handle_idx, offset, op in aln.walk:
        if op == "I":
            e = gam.Edit(0, 1, read[read_pos : read_pos + 1])
            read_pos += 1
            if cur is None:
                pending.append(e)
            else:
                cur.edits.append(e)
            continue
        if cur is None or handle_idx != cur_handle:
            new_mapping(handle_idx, offset)
        if op == "M":
            cur.edits.append(gam.Edit(1, 1, ""))
            read_pos += 1
        elif op == "X":
            cur.edits.append(gam.Edit(1, 1, read[read_pos : read_pos + 1]))
            read_pos += 1
        else:  # D
            cur.edits.append(gam.Edit(1, 0, ""))
    # trailing softclip
    if read_pos < len(read):
        e = gam.Edit(0, len(read) - read_pos, read[read_pos:])
        if cur is None:
            pending.append(e)
        else:
            cur.edits.append(e)

    # merge adjacent same-type edits
    for m in mappings:
        merged: List[gam.Edit] = []
        for e in m.edits:
            if merged:
                last = merged[-1]
                if last.is_match and e.is_match:
                    merged[-1] = gam.Edit(
                        last.from_length + e.from_length,
                        last.to_length + e.to_length, "",
                    )
                    continue
                if last.is_sub and e.is_sub:
                    merged[-1] = gam.Edit(
                        last.from_length + e.from_length,
                        last.to_length + e.to_length,
                        last.sequence + e.sequence,
                    )
                    continue
                if last.is_deletion and e.is_deletion:
                    merged[-1] = gam.Edit(
                        last.from_length + e.from_length, 0, ""
                    )
                    continue
                if last.is_insertion and e.is_insertion:
                    merged[-1] = gam.Edit(
                        0, last.to_length + e.to_length,
                        last.sequence + e.sequence,
                    )
                    continue
            merged.append(e)
        m.edits = merged
    return gam.Path(mappings=mappings)


def _flip_path(graph: PackedGraph, p: gam.Path, rc_read: str, read: str) -> gam.Path:
    """Convert an alignment of rc(read) on the path's forward strand
    into the GAM convention for a minus-strand read: mappings in read
    order (reversed), orientations flipped, offsets re-anchored, edit
    sequences reverse-complemented."""
    out = gam.Path()
    for m in reversed(p.mappings):
        nid = m.position.node_id
        nlen = graph.node_len(nid)
        consumed = sum(e.from_length for e in m.edits)
        new_off = nlen - m.position.offset - consumed
        edits = []
        for e in reversed(m.edits):
            edits.append(
                gam.Edit(
                    e.from_length,
                    e.to_length,
                    dna.revcomp(e.sequence) if e.sequence else "",
                )
            )
        out.mappings.append(
            gam.Mapping(
                position=gam.Position(
                    node_id=nid,
                    offset=int(new_off),
                    is_reverse=not m.position.is_reverse,
                ),
                edits=edits,
                rank=len(out.mappings) + 1,
            )
        )
    return out


class Mapper:
    """End-to-end read mapper producing GAM alignments."""

    def __init__(self, graph: PackedGraph, k: int = 20, w: int = 10,
                 index: Optional[MinimizerIndex] = None,
                 safari: bool = False):
        self.graph = graph
        self.index = index or MinimizerIndex.build(graph, k=k, w=w)
        # SAFARI damage-aware mode: a second, RYmer-space index whose
        # seeds survive C->T/G->A deamination (the reference's
        # -S/--SAFARI flags are parsed but inert, src/Euka.cpp:300-303)
        self.ry_index = (
            MinimizerIndex.build(graph, k=k, w=w, ry=True, max_occ=64)
            if safari
            else None
        )
        self._step_offs = [
            _step_offsets(graph, p) for p in range(graph.n_paths)
        ]

    def map_read(self, read: Read) -> gam.Alignment:
        codes = dna.encode(read.seq)
        clusters = seed_and_cluster(self.index, codes)
        if self.ry_index is not None:
            clusters = sorted(
                clusters + seed_and_cluster(self.ry_index, codes),
                key=lambda c: -c.n_seeds,
            )
        a = gam.Alignment(sequence=read.seq, name=read.name,
                          quality=bytes(read.qual or b""))
        if not clusters:
            return a  # unmapped (identity 0)
        alns = extend_candidates(self.graph, self.index, codes, clusters)
        if not alns:
            return a
        best = alns[0]
        # runner-up = best genuinely DISTINCT placement (same-placement
        # candidates via different haplotypes don't compete for MQ)
        sp_lo, sp_hi = self.graph.path_node_spans()
        second = None
        for pa in alns[1:]:
            if not same_placement(
                pa.strand, pa.lo, pa.hi, best.strand, best.lo, best.hi,
                (sp_lo[pa.path], sp_hi[pa.path]),
                (sp_lo[best.path], sp_hi[best.path]),
            ):
                second = pa.eff_score
                break

        path = _project_walk(
            self.graph,
            best.window,
            dna.decode(dna.revcomp_codes(codes)) if best.strand else read.seq,
            best.aln,
        )
        if best.strand:
            path = _flip_path(self.graph, path, None, read.seq)

        a.path = path
        a.score = int(best.eff_score)
        aln_len = len(best.aln.walk)
        a.identity = best.aln.n_matches / aln_len if aln_len else 0.0
        if second is None:
            a.mapping_quality = 60
        else:
            a.mapping_quality = int(
                max(0, min(60, round(6.23 * (best.eff_score - second))))
            )
        return a

    def map_reads(self, reads) -> List[gam.Alignment]:
        return [self.map_read(r) for r in reads]


class BatchedMapper(Mapper):
    """Mapper with device-batched candidate scoring.

    Per read, seeding/clustering stays on host; ALL candidate windows
    across the read batch are scored in one device call
    (mapper/sw_pallas.sw_scores_xla), then only each read's winner goes through the exact
    host-side graph alignment + projection. Winner selection uses the
    haplotype-linear score; the final alignment may still improve
    through off-path alleles in the graph window (same behavior as the
    per-read path).
    """

    def _gather_candidates(self, reads, max_candidates: int = 8,
                           pad: int = 24):
        """Seed + cluster the whole batch, score every candidate
        window in one device call. Returns (read_codes, all_cands,
        scores, best_of) where best_of[ri] maps a window-content key
        to (score, candidate index)."""
        import hashlib

        from .sw_pallas import sw_scores_xla
        from .index import _path_codes

        graph = self.graph
        index = self.index
        all_cands = []  # (read_idx, cand, window_codes, window_lo)
        path_cache = self._path_cache
        read_codes = [dna.encode(r.seq) for r in reads]
        clusters_per_read = seed_and_cluster_batch(
            index, read_codes, ry_index=self.ry_index
        )
        # haplotype paths share most sequence, so a read's candidates
        # are usually byte-identical windows: dedup by content BEFORE
        # scoring so the device scores each distinct window once
        dedup_keys = []
        for ri, r in enumerate(reads):
            codes = read_codes[ri]
            clusters = clusters_per_read[ri]
            L = len(codes)
            seen_windows: dict = {}
            for cand in clusters[:max_candidates]:
                pc = path_cache.get(cand.path)
                if pc is None:
                    pc = _path_codes(graph, cand.path)
                    path_cache[cand.path] = pc
                lo = max(0, cand.diag_lo - pad)
                hi = min(len(pc), cand.diag_hi + L + pad)
                if hi <= lo:
                    continue
                wcodes = pc[lo:hi]
                # span group in the key: identical windows from paths
                # over disjoint node ranges are distinct placements;
                # equal content is one placement only when the
                # intervals also overlap (else: tandem repeat)
                key = (
                    cand.strand,
                    int(graph.path_span_groups()[cand.path]),
                    hashlib.md5(wcodes.tobytes()).hexdigest(),
                )
                spans = seen_windows.setdefault(key, [])
                if any(lo < h and l < hi for l, h in spans):
                    continue
                spans.append((lo, hi))
                all_cands.append((ri, cand, wcodes, lo))
                dedup_keys.append(key + (lo,))

        if not all_cands:
            return read_codes, [], np.zeros(0), {}

        def _round_up(x, m):
            return ((x + m - 1) // m) * m

        # bucket shapes so the device scorer compiles once per bucket
        Rmax = _round_up(max(len(read_codes[ri]) for ri, *_ in all_cands), 32)
        Wmax = _round_up(max(len(w) for _ri, _c, w, _lo in all_cands), 64)
        N = len(all_cands)
        qarr = np.full((N, Rmax), 255, dtype=np.int32)
        warr = np.full((N, Wmax), 255, dtype=np.int32)
        rlen = np.zeros(N, dtype=np.int32)
        wlen = np.zeros(N, dtype=np.int32)
        for i, (ri, cand, wcodes, _lo) in enumerate(all_cands):
            q = read_codes[ri]
            if cand.strand:
                q = dna.revcomp_codes(q)
            qarr[i, : len(q)] = q
            rlen[i] = len(q)
            warr[i, : len(wcodes)] = wcodes
            wlen[i] = len(wcodes)
        scores = np.asarray(sw_scores_xla(qarr, warr, rlen, wlen))

        # per read: candidates are already content-unique (dedup above)
        best_of = {}
        for i, (ri, cand, wcodes, lo) in enumerate(all_cands):
            best_of.setdefault(ri, {})[dedup_keys[i]] = (scores[i], i)
        return read_codes, all_cands, scores, best_of

    @property
    def _path_cache(self):
        if not hasattr(self, "_path_cache_d"):
            self._path_cache_d = {}
        return self._path_cache_d

    @property
    def _pools(self):
        if not hasattr(self, "_pools_o"):
            from .batch_map import NativePools

            self._pools_o = NativePools(self.graph, self._path_cache)
        return self._pools_o

    def map_reads(self, reads, max_candidates: int = 8, pad: int = 24):
        """Batch mapping. Fast path: vectorized gather + one native C++
        finalize (mapper/batch_map.py); object path kept as the oracle
        (tests assert parity) and the fallback when the native lib is
        unavailable."""
        from . import batch_map

        if not reads:
            return []
        if batch_map.load_native() is None:
            return self._map_reads_obj(reads, max_candidates, pad)
        return self.map_reads_table(
            reads, max_candidates, pad
        ).to_alignments()

    def map_reads_table(self, reads, max_candidates: int = 8,
                        pad: int = 24, chunk: int = 4096,
                        depth: int = 3):
        """Batch mapping with columnar output (batch_map.AlignmentTable)
        — the production form consumed by the haplocart columnar
        pipeline (pipelines/hc_columnar.py); no per-read Python objects
        are built. Requires the native lib.

        Batches larger than ~1.5*chunk are double-buffered: while the
        device scores chunk i, the host runs chunk i+1's seeding and
        chunk i-1's finalize (per-read results are independent, so the
        chunked output is identical to the one-shot path)."""
        from . import batch_map

        if batch_map.load_native() is None:
            return batch_map.table_from_alignments(
                self._map_reads_obj(reads, max_candidates, pad)
            )
        return batch_map.AlignmentTable.concat(
            list(self.map_table_chunks(reads, max_candidates, pad, chunk,
                                       depth))
        )

    def map_table_chunks(self, reads, max_candidates: int = 8,
                         pad: int = 24, chunk: int = 4096,
                         depth: int = 3):
        """Generator form of map_reads_table: yields per-chunk
        AlignmentTables in read order as they finalize, so a consumer
        (hc_columnar.score_table_stream) can overlap its own host/
        device work with the next chunk's mapping. Requires the native
        lib (map_reads_table handles the fallback).

        Up to `depth` chunks stay in flight on the device: the deeper
        queue keeps the device busy while the host seeds the next
        chunk and finalizes the oldest (the submit is async; collect
        blocks only on the oldest chunk's download)."""
        from collections import deque

        from . import batch_map

        if len(reads) <= (chunk * 3) // 2:
            br = batch_map.gather_and_score(self, reads, max_candidates,
                                            pad)
            yield batch_map.finalize_table(self, reads, br)
            return
        # collect+finalize can run on a worker thread (the native
        # finalize releases the GIL), so chunk i's host finalize
        # overlaps chunk i+1's host seeding on the 2-core host in
        # addition to the device overlap; FIFO futures keep read order
        from concurrent.futures import ThreadPoolExecutor

        if not hasattr(self, "_fin_pool"):
            import weakref

            self._fin_pool = ThreadPoolExecutor(1)
            # the worker thread is non-daemon: tie its lifetime to the
            # mapper so an abandoned mapper doesn't pin the interpreter
            weakref.finalize(self, self._fin_pool.shutdown, wait=False)

        def _cf(pend, rr):
            return batch_map.finalize_table(
                self, rr, batch_map.gather_collect(pend)
            )

        if not OVERLAP_FINALIZE:
            q0 = deque()
            for i in range(0, len(reads), chunk):
                ch = reads[i : i + chunk]
                q0.append((batch_map.gather_submit(self, ch,
                                                   max_candidates, pad),
                           ch))
                if len(q0) > depth:
                    pend, rr = q0.popleft()
                    yield _cf(pend, rr)
            while q0:
                pend, rr = q0.popleft()
                yield _cf(pend, rr)
            return

        q = deque()  # (pending, chunk_reads), oldest first
        fq = deque()  # finalize futures, oldest first
        try:
            for i in range(0, len(reads), chunk):
                ch = reads[i : i + chunk]
                q.append((batch_map.gather_submit(self, ch,
                                                  max_candidates, pad),
                          ch))
                if len(q) > depth:
                    pend, rr = q.popleft()
                    fq.append(self._fin_pool.submit(_cf, pend, rr))
                while len(fq) > 1:
                    yield fq.popleft().result()
            while q:
                pend, rr = q.popleft()
                fq.append(self._fin_pool.submit(_cf, pend, rr))
            while fq:
                yield fq.popleft().result()
        finally:
            # consumer abandoned the generator (early break/exception):
            # cancel queued finalizes and drain the running one so no
            # future keeps touching pending device buffers afterwards
            for f in fq:
                f.cancel()
            for f in fq:
                if not f.cancelled():
                    try:
                        f.result()
                    except Exception:
                        pass
            q.clear()

    def _map_reads_obj(self, reads, max_candidates: int = 8, pad: int = 24):
        read_codes, all_cands, scores, best_of = self._gather_candidates(
            reads, max_candidates, pad
        )
        out = []
        for ri, r in enumerate(reads):
            d = best_of.get(ri)
            if not d:
                out.append(
                    gam.Alignment(sequence=r.seq, name=r.name,
                                  quality=bytes(r.qual or b""))
                )
                continue
            ranked = sorted(d.values(), key=lambda t: -t[0])
            _score, i = ranked[0]
            _ri, cand_w, w_w, lo_w = all_cands[i]
            hi_w = lo_w + len(w_w)
            sp_lo, sp_hi = self.graph.path_node_spans()
            # runner-up = best genuinely distinct placement
            second = None
            for s, j in ranked[1:]:
                _rj, cj, wj, lj = all_cands[j]
                if not same_placement(
                    cj.strand, lj, lj + len(wj),
                    cand_w.strand, lo_w, hi_w,
                    (sp_lo[cj.path], sp_hi[cj.path]),
                    (sp_lo[cand_w.path], sp_hi[cand_w.path]),
                ):
                    second = s
                    break
            out.append(
                self._finalize(r, read_codes[ri], all_cands[i], _score,
                               second)
            )
        return out

    def _finalize(self, r, codes, cand_rec, _score, second,
                  mq_override: Optional[int] = None):
        """Exact host alignment + GAM projection of one read's winning
        candidate."""
        from .graph_align import align_to_window_native, build_window

        graph = self.graph
        a = gam.Alignment(sequence=r.seq, name=r.name,
                          quality=bytes(r.qual or b""))
        _ri, cand, wcodes, lo = cand_rec
        L = len(codes)

        def mq(eff_score: float) -> int:
            if mq_override is not None:
                return mq_override
            if second is None:
                return 60
            return int(
                max(0, min(60, round(6.23 * (eff_score - float(second)))))
            )

        # perfect full-length alignments (score == L + both bonuses)
        # skip the graph DP: locate by exact search and project the
        # path interval directly
        if _score == L + 2 * FULL_LENGTH_BONUS:
            q = dna.revcomp_codes(codes) if cand.strand else codes
            off = wcodes.tobytes().find(q.tobytes())
            if off >= 0:
                a.path = _project_path_interval(
                    graph, cand.path, lo + off, L, flip=cand.strand
                )
                a.score = int(_score)
                a.identity = 1.0
                a.mapping_quality = mq(float(_score))
                return a
        # windows bucket-cached: nearby reads share one window
        lo_b = (lo // 128) * 128
        hi_b = -(-(lo + len(wcodes)) // 128) * 128
        wkey = (cand.path, lo_b, hi_b)
        win = self._win_cache.get(wkey) if hasattr(self, "_win_cache") else None
        if win is None:
            if not hasattr(self, "_win_cache"):
                self._win_cache = {}
            win = build_window(graph, cand.path, lo_b, hi_b)
            self._win_cache[wkey] = win
        if win is None:
            return a
        q = dna.revcomp_codes(codes) if cand.strand else codes
        aln = align_to_window_native(q, win)
        if aln is None:
            return a
        eff = aln.score + (
            FULL_LENGTH_BONUS if aln.read_end == len(codes) else 0
        )
        path = _project_walk(
            graph, win,
            dna.decode(q),
            aln,
        )
        if cand.strand:
            path = _flip_path(graph, path, None, r.seq)
        a.path = path
        a.score = int(eff)
        aln_len = len(aln.walk)
        a.identity = aln.n_matches / aln_len if aln_len else 0.0
        a.mapping_quality = mq(float(eff))
        return a

    # ------------------------------------------------------ paired-end
    def map_read_pairs(
        self,
        reads1,
        reads2,
        max_candidates: int = 8,
        pad: int = 24,
        max_fragment: int = 1000,
        pair_bonus: float = 6.0,
        rescue_min_score: Optional[float] = None,
    ) -> List[gam.Alignment]:
        """Fragment-aware paired mapping (see _map_read_pairs_obj for
        the semantics). Production path: vectorized joint selection
        over the top-4 candidates of each mate + one native batch
        finalize; the object path is kept as the oracle (parity
        test-asserted) and the no-native fallback."""
        from . import batch_map

        if batch_map.load_native() is None:
            return self._map_read_pairs_obj(
                reads1, reads2, max_candidates, pad, max_fragment,
                pair_bonus, rescue_min_score,
            )
        assert len(reads1) == len(reads2)
        n = len(reads1)
        reads = list(reads1) + list(reads2)
        br = batch_map.gather_and_score(self, reads, max_candidates, pad)
        if br is None:
            out = [
                gam.Alignment(sequence=r.seq, name=r.name,
                              quality=bytes(r.qual or b""),
                              read_paired=True)
                for r in reads
            ]
            return [out[i // 2 + (i % 2) * n] for i in range(2 * n)]

        K = br.topk_rows.shape[1]
        r1 = np.arange(n)
        t1, t2 = br.topk_rows[r1], br.topk_rows[r1 + n]  # [n, K]
        s1 = br.topk_scores[r1].astype(np.float64)
        s2 = br.topk_scores[r1 + n].astype(np.float64)
        v1, v2 = t1 >= 0, t2 >= 0
        c1s = np.clip(t1, 0, None)
        c2s = np.clip(t2, 0, None)
        p1 = np.where(v1, br.cand_path[c1s], -1)
        p2 = np.where(v2, br.cand_path[c2s], -2)
        st1 = np.where(v1, br.cand_strand[c1s], 0)
        st2 = np.where(v2, br.cand_strand[c2s], 0)
        lo1 = np.where(v1, br.cand_lo[c1s], 0)
        lo2 = np.where(v2, br.cand_lo[c2s], 0)
        consistent = (
            (p1[:, :, None] == p2[:, None, :])
            & (st1[:, :, None] != st2[:, None, :])
            & (np.abs(lo1[:, :, None] - lo2[:, None, :]) <= max_fragment)
        )
        joint = (
            s1[:, :, None] + s2[:, None, :]
            + np.where(consistent, pair_bonus, 0.0)
        )
        joint = np.where(
            v1[:, :, None] & v2[:, None, :], joint, -np.inf
        )
        flat = joint.reshape(n, K * K)
        best = np.argmax(flat, axis=1)  # first max = old loop order
        i1, i2 = best // K, best % K
        cons = consistent[np.arange(n), i1, i2]
        c1 = t1[np.arange(n), i1]
        c2 = t2[np.arange(n), i2]
        cs1 = s1[np.arange(n), i1]
        cs2 = s2[np.arange(n), i2]

        # pair-level MQ: gap vs the mate's best OTHER candidate
        def pair_mq(reads_idx, chosen, s_this):
            top_row = br.topk_rows[reads_idx, 0]
            top_s = br.topk_scores[reads_idx, 0].astype(np.float64)
            alt = np.where(
                chosen == top_row, br.top2_score[reads_idx], top_s
            ).astype(np.float64)
            has_alt = np.where(
                chosen == top_row, br.top2_has[reads_idx], True
            )
            gap = s_this - alt + np.where(cons, 6.0, 0.0)
            mq = np.clip(np.round(6.23 * gap), 0, 60).astype(np.int32)
            return np.where(has_alt, mq, 60).astype(np.int32)

        both = v1[:, 0] & v2[:, 0]
        only1 = v1[:, 0] & ~v2[:, 0]
        only2 = v2[:, 0] & ~v1[:, 0]

        sel = np.full(2 * n, -1, dtype=np.int64)
        mq_ovr = np.full(2 * n, -1, dtype=np.int32)
        second_ovr = np.full(2 * n, np.nan, dtype=np.float64)
        mq1 = pair_mq(r1, c1, cs1)
        mq2 = pair_mq(r1 + n, c2, cs2)
        sel[:n][both] = c1[both]
        sel[n:][both] = c2[both]
        mq_ovr[:n][both] = mq1[both]
        mq_ovr[n:][both] = mq2[both]
        # single-sided: the mapped mate finalizes alone (content-level
        # runner-up for MQ); the other is rescued below
        for side, mask in ((0, only1), (1, only2)):
            idx = np.nonzero(mask)[0] + side * n
            sel[idx] = br.topk_rows[idx, 0]
            second_ovr[idx] = np.where(
                br.top2_has[idx], br.top2_score[idx], np.nan
            )

        table = batch_map.finalize_table(
            self, reads, br, sel_override=sel, mq_override=mq_ovr,
            second_override=second_ovr,
        )
        out = table.to_alignments()

        # mate rescue for single-sided pairs (host, rare)
        pools = self._pools.arrays()
        for pi in np.nonzero(only1 | only2)[0]:
            have = pi if only1[pi] else pi + n
            miss = pi + n if only1[pi] else pi
            row = int(sel[have])
            cand = Candidate(
                path=int(br.cand_path[row]),
                strand=bool(br.cand_strand[row]),
                diag_lo=0, diag_hi=0, n_seeds=0,
            )
            wc = pools.pc_buf[
                pools.pc_beg[cand.path] + br.cand_lo[row] :
                pools.pc_beg[cand.path] + br.cand_lo[row]
                + br.cand_wlen[row]
            ]
            out[miss] = self._rescue_mate(
                reads[miss], br.read_codes[miss],
                (have, cand, wc, int(br.cand_lo[row])),
                max_fragment, rescue_min_score,
            )
        result: List[gam.Alignment] = []
        for k in range(n):
            a1, a2 = out[k], out[k + n]
            a1.read_paired = True
            a2.read_paired = True
            result.append(a1)
            result.append(a2)
        return result

    def _map_read_pairs_obj(
        self,
        reads1,
        reads2,
        max_candidates: int = 8,
        pad: int = 24,
        max_fragment: int = 1000,
        pair_bonus: float = 6.0,
        rescue_min_score: Optional[float] = None,
    ) -> List[gam.Alignment]:
        """Fragment-aware paired mapping (the giraffe behavior vgan
        relies on when invoked with two -f files,
        `src/map_giraffe.cpp:58-88`): mates are scored jointly — the
        winning candidate *pair* maximizes score1 + score2 + a
        consistency bonus for (same path, opposite strands, fragment
        span <= max_fragment; the reference's fragment model bound is
        MAXLENGTHFRAGMENT=1000, `src/damage.h:43`). A mate with no
        candidates of its own is rescued by direct alignment against
        the fragment-sized window next to its partner. Consistent
        pairs keep MQ from the pair-level score gap, so a read that is
        ambiguous alone but anchored by its mate maps confidently —
        the property HaploCart's paired tests depend on. Both mates
        are flagged read_paired.

        Returns alignments interleaved [r1[0], r2[0], r1[1], ...]."""
        assert len(reads1) == len(reads2)
        n = len(reads1)
        reads = list(reads1) + list(reads2)
        read_codes, all_cands, scores, best_of = self._gather_candidates(
            reads, max_candidates, pad
        )

        def ranked(ri):
            d = best_of.get(ri)
            if not d:
                return []
            return sorted(d.values(), key=lambda t: -t[0])

        out: List[gam.Alignment] = []
        for pi in range(n):
            r1, r2 = reads[pi], reads[pi + n]
            rank1, rank2 = ranked(pi), ranked(pi + n)
            a1 = a2 = None
            if rank1 and rank2:
                a1, a2 = self._select_pair(
                    r1, r2, read_codes[pi], read_codes[pi + n],
                    rank1, rank2, all_cands, max_fragment, pair_bonus,
                )
            elif rank1 or rank2:
                # mate rescue: align the missing mate next to the
                # mapped one (giraffe's rescue-by-alignment)
                have, miss = (pi, pi + n) if rank1 else (pi + n, pi)
                rk = rank1 or rank2
                sc, i = rk[0]
                second = rk[1][0] if len(rk) > 1 else None
                a_have = self._finalize(
                    reads[have], read_codes[have], all_cands[i], sc, second
                )
                a_miss = self._rescue_mate(
                    reads[miss], read_codes[miss], all_cands[i],
                    max_fragment, rescue_min_score,
                )
                a1, a2 = (a_have, a_miss) if rank1 else (a_miss, a_have)
            if a1 is None:
                a1 = gam.Alignment(sequence=r1.seq, name=r1.name,
                                   quality=bytes(r1.qual or b""))
            if a2 is None:
                a2 = gam.Alignment(sequence=r2.seq, name=r2.name,
                                   quality=bytes(r2.qual or b""))
            a1.read_paired = True
            a2.read_paired = True
            out.append(a1)
            out.append(a2)
        return out

    def _select_pair(self, r1, r2, codes1, codes2, rank1, rank2,
                     all_cands, max_fragment, pair_bonus):
        """Joint candidate-pair selection over the top candidates of
        each mate."""
        TOP = 4
        best = None  # (joint, consistent, i1, i2, s1, s2)
        for s1, i1 in rank1[:TOP]:
            _r1, c1, w1, lo1 = all_cands[i1]
            for s2, i2 in rank2[:TOP]:
                _r2, c2, w2, lo2 = all_cands[i2]
                consistent = (
                    c1.path == c2.path
                    and c1.strand != c2.strand
                    and abs(lo1 - lo2) <= max_fragment
                )
                joint = float(s1) + float(s2) + (
                    pair_bonus if consistent else 0.0
                )
                if best is None or joint > best[0]:
                    best = (joint, consistent, i1, i2, float(s1), float(s2))
        _joint, consistent, i1, i2, s1, s2 = best
        # pair-level MQ: gap between the best joint score and the best
        # joint score using a different candidate for that mate
        def pair_mq(this_i, rank, s_this, s_other):
            alt = [s for s, i in rank if i != this_i]
            if not alt:
                return 60
            gap = s_this - alt[0]
            if consistent:
                gap += 6.0  # the mate anchors this placement
            return int(max(0, min(60, round(6.23 * gap))))

        a1 = self._finalize(r1, codes1, all_cands[i1], s1, None,
                            mq_override=pair_mq(i1, rank1, s1, s2))
        a2 = self._finalize(r2, codes2, all_cands[i2], s2, None,
                            mq_override=pair_mq(i2, rank2, s2, s1))
        return a1, a2

    def _rescue_mate(self, r, codes, mate_cand_rec, max_fragment,
                     rescue_min_score):
        """Align an unseeded mate against the fragment window flanking
        its mapped partner, on the opposite strand first."""
        from .graph_align import align_to_window_native, build_window
        from .index import _path_codes

        _ri, mc, mw, mlo = mate_cand_rec
        graph = self.graph
        pc = self._path_cache.get(mc.path)
        if pc is None:
            pc = _path_codes(graph, mc.path)
            self._path_cache[mc.path] = pc
        lo = max(0, mlo - max_fragment)
        hi = min(len(pc), mlo + len(mw) + max_fragment)
        a = gam.Alignment(sequence=r.seq, name=r.name,
                          quality=bytes(r.qual or b""))
        if hi <= lo:
            return a
        win = build_window(graph, mc.path, lo, hi)
        if win is None:
            return a
        L = len(codes)
        if rescue_min_score is None:
            rescue_min_score = 0.8 * L  # >= ~90% identity
        best = None
        for strand in (not mc.strand, mc.strand):
            q = dna.revcomp_codes(codes) if strand else codes
            aln = align_to_window_native(q, win)
            if aln is None:
                continue
            eff = aln.score + (
                FULL_LENGTH_BONUS if aln.read_end == L else 0
            )
            if best is None or eff > best[0]:
                best = (eff, strand, aln)
        if best is None or best[0] < rescue_min_score:
            return a
        eff, strand, aln = best
        q = dna.revcomp_codes(codes) if strand else codes
        path = _project_walk(graph, win, dna.decode(q), aln)
        if strand:
            path = _flip_path(graph, path, None, r.seq)
        a.path = path
        a.score = int(eff)
        aln_len = len(aln.walk)
        a.identity = aln.n_matches / aln_len if aln_len else 0.0
        a.mapping_quality = 30  # rescued placement: anchored, not unique
        return a


def _batch_hits_native(index: MinimizerIndex, read_buf, read_off):
    """C++ twin of _batch_hits (cpp/seedhits.cpp): rolling k-mer hash +
    binary-search join + postings expansion over a packed read buffer,
    threaded over reads. Returns None when the native lib is absent."""
    import ctypes

    from . import batch_map

    lib = batch_map.load_native()
    if lib is None:
        return None
    arrs = getattr(index, "_native_arrs", None)
    if arrs is None:
        arrs = (
            np.ascontiguousarray(index.hashes, dtype=np.uint64),
            np.ascontiguousarray(index.post_off, dtype=np.int64),
            np.ascontiguousarray(index.post_path, dtype=np.int32),
            np.ascontiguousarray(index.post_ppos, dtype=np.int64),
            np.ascontiguousarray(
                index.post_rc.astype(np.uint8), dtype=np.uint8
            ),
        )
        index._native_arrs = arrs
    hashes, post_off, post_path, post_ppos, post_rc = arrs
    n_reads = len(read_off) - 1
    total = int(read_off[-1])
    cap = max(1 << 16, 4 * max(total - (index.k - 1) * n_reads, 1))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    while True:
        hit_read = np.empty(cap, dtype=np.int32)
        hit_path = np.empty(cap, dtype=np.int32)
        hit_strand = np.empty(cap, dtype=np.uint8)
        hit_diag = np.empty(cap, dtype=np.int64)
        rc = lib.batch_seed_hits(
            p(read_buf, ctypes.c_uint8), p(read_off, ctypes.c_int64),
            n_reads, index.k, 1 if index.ry else 0,
            p(hashes, ctypes.c_uint64), len(hashes),
            p(post_off, ctypes.c_int64),
            p(post_path, ctypes.c_int32), p(post_ppos, ctypes.c_int64),
            p(post_rc, ctypes.c_uint8),
            p(hit_read, ctypes.c_int32), p(hit_path, ctypes.c_int32),
            p(hit_strand, ctypes.c_uint8), p(hit_diag, ctypes.c_int64),
            cap,
        )
        if rc >= 0:
            n = int(rc)
            return (
                hit_read[:n].astype(np.int64),
                hit_path[:n].astype(np.int64),
                hit_strand[:n].astype(np.int64),
                hit_diag[:n],
            )
        cap = int(-rc)


def _batch_hits(index: MinimizerIndex, read_codes_list, read_lens):
    """Hash every read k-mer (RY-projected when the index is an RYmer
    index), join against the index, and expand postings to flat hit
    arrays (read, path, strand, diag)."""
    codes_list = (
        [mz.to_ry(c) for c in read_codes_list] if index.ry else read_codes_list
    )
    rid, pos, hashes, rrc = mz.all_kmers_batch(codes_list, index.k)
    empty = (np.zeros(0, np.int64),) * 4
    if not len(pos) or not len(index.hashes):
        return empty
    rlen = read_lens[rid]

    idx = np.searchsorted(index.hashes, hashes)
    idx = np.minimum(idx, len(index.hashes) - 1)
    found = index.hashes[idx] == hashes
    p0 = np.where(found, index.post_off[idx], 0)
    p1 = np.where(found, index.post_off[idx + 1], 0)
    counts = (p1 - p0).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return empty
    # expand postings CSR-style
    qidx = np.repeat(np.arange(len(pos)), counts)  # query row per hit
    starts = np.repeat(p0, counts)
    within = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    pi = starts + within  # posting index per hit

    path = index.post_path[pi].astype(np.int64)
    ppos = index.post_ppos[pi]
    strand = index.post_rc[pi] ^ rrc[qidx]
    rc_pos = rlen[qidx] - index.k - pos[qidx]
    diag = np.where(strand, ppos - rc_pos, ppos - pos[qidx])
    return rid[qidx], path, strand.astype(np.int64), diag


def seed_and_cluster_arrays(
    index: MinimizerIndex,
    read_codes_list,
    max_diag_gap: int = 48,
    ry_index: Optional[MinimizerIndex] = None,
    read_buf: Optional[np.ndarray] = None,
    read_off: Optional[np.ndarray] = None,
):
    """Vectorized seeding for a whole read batch, flat-array output.

    Production path is the native C++ join (_batch_hits_native, 2
    threads); the numpy pass (_batch_hits: searchsorted join + CSR
    postings expansion) is the fallback and oracle. Clusters are cut
    with a single lexsort over (read, path, strand, diagonal) — no
    per-hit Python loops. With ry_index (SAFARI damage-aware mode)
    RYmer-space hits are merged in before clustering, so seeds broken
    by C->T/G->A deamination still anchor candidates.

    read_buf/read_off: optional packed view of read_codes_list
    (concatenated uint8 codes + [n+1] offsets) — passed by the batch
    mapper to avoid a re-concatenation.

    Returns (read, path, strand, diag_lo, diag_hi, n_seeds) arrays in
    (read, path, strand, diag) order, or None when there are no hits.
    """
    read_lens = np.array([len(c) for c in read_codes_list], dtype=np.int64)
    if read_buf is None:
        read_off = np.zeros(len(read_codes_list) + 1, dtype=np.int64)
        np.cumsum(read_lens, out=read_off[1:])
        read_buf = (
            np.ascontiguousarray(np.concatenate(read_codes_list))
            if read_codes_list
            else np.zeros(0, dtype=np.uint8)
        )
    hits = _batch_hits_native(index, read_buf, read_off)
    if hits is None:
        hits = _batch_hits(index, read_codes_list, read_lens)
    read_of, path, strand, diag = hits
    if ry_index is not None:
        hits2 = _batch_hits_native(ry_index, read_buf, read_off)
        if hits2 is None:
            hits2 = _batch_hits(ry_index, read_codes_list, read_lens)
        r2, p2, s2, d2 = hits2
        read_of = np.concatenate([read_of, r2])
        path = np.concatenate([path, p2])
        strand = np.concatenate([strand, s2])
        diag = np.concatenate([diag, d2])
    total = len(read_of)
    if total == 0:
        return None

    order = np.lexsort((diag, strand, path, read_of))
    read_s = read_of[order]
    path_s = path[order]
    strand_s = strand[order]
    diag_s = diag[order]

    new_cluster = np.ones(total, dtype=bool)
    new_cluster[1:] = (
        (read_s[1:] != read_s[:-1])
        | (path_s[1:] != path_s[:-1])
        | (strand_s[1:] != strand_s[:-1])
        | (diag_s[1:] - diag_s[:-1] > max_diag_gap)
    )
    first = np.nonzero(new_cluster)[0]
    sizes = np.diff(np.concatenate([first, [total]]))
    last = first + sizes - 1
    return (
        read_s[first],
        path_s[first],
        strand_s[first],
        diag_s[first],
        diag_s[last],
        sizes,
    )


def seed_and_cluster_batch(
    index: MinimizerIndex,
    read_codes_list,
    max_diag_gap: int = 48,
    ry_index: Optional[MinimizerIndex] = None,
):
    """Per-read Candidate lists (sorted by -n_seeds, stable) built from
    seed_and_cluster_arrays — the object API used by the paired-end
    path and the tests."""
    n_reads = len(read_codes_list)
    arrs = seed_and_cluster_arrays(
        index, read_codes_list, max_diag_gap, ry_index
    )
    out = [[] for _ in range(n_reads)]
    if arrs is None:
        return out
    read, path, strand, dlo, dhi, sizes = arrs
    for ci in range(len(read)):
        out[int(read[ci])].append(
            Candidate(
                path=int(path[ci]),
                strand=bool(strand[ci]),
                diag_lo=int(dlo[ci]),
                diag_hi=int(dhi[ci]),
                n_seeds=int(sizes[ci]),
            )
        )
    for ri in range(n_reads):
        out[ri].sort(key=lambda c: -c.n_seeds)
    return out


def _project_path_interval(graph, path: int, start: int, length: int,
                           flip: bool = False) -> gam.Path:
    """All-match projection of a path interval [start, start+length)
    onto per-node mappings (perfect-alignment fast path). With flip,
    emit the GAM minus-strand convention directly (mappings in read
    order = reversed, orientations flipped, offsets re-anchored from
    the node's other end) — one pass instead of project-then-flip."""
    offs = graph.step_offsets(path)
    steps_node = graph.path_steps_node[path]
    min_id = graph.min_id
    end = start + length
    s0 = int(np.searchsorted(offs, start, side="right") - 1)
    s1 = int(np.searchsorted(offs, end - 1, side="right"))
    nidx = steps_node[s0:s1]
    node_id = (nidx.astype(np.int64) + min_id).tolist()
    nst = offs[s0:s1].tolist()
    nlen = (graph.node_off[nidx + 1] - graph.node_off[nidx]).tolist()
    rev = graph.path_steps_rev[path][s0:s1].tolist()
    parts = []  # (node_id, offset, is_reverse, take)
    pos = start
    for i in range(len(node_id)):
        off_in_node = pos - nst[i]
        take = min(end - pos, nlen[i] - off_in_node)
        if flip:
            parts.append(
                (node_id[i], nlen[i] - off_in_node - take, not rev[i], take)
            )
        else:
            parts.append((node_id[i], off_in_node, rev[i], take))
        pos += take
    if flip:
        parts.reverse()
    out = gam.Path()
    for rank, (nid, off, rev, take) in enumerate(parts, 1):
        out.mappings.append(
            gam.Mapping(
                position=gam.Position(node_id=nid, offset=off, is_reverse=rev),
                edits=[gam.Edit(take, take, "")],
                rank=rank,
            )
        )
    return out
