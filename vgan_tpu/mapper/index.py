"""Minimizer index over the haplotype paths of a packed graph.

Replaces vg's GBWT-constrained minimizer index (`.min` + `.gbwt`,
`src/map_giraffe.cpp:41-55`): minimizers are extracted from every
haplotype path's linearized sequence and posted as *graph positions*
(node, oriented offset) so occurrences shared by many near-identical
haplotypes dedup to one posting, with a representative (path, offset)
retained for the banded-extension stage. Lookups are a binary search
into the sorted hash array (device-friendly: `searchsorted` instead of
pointer-chasing hash probes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..graph.packed import PackedGraph
from . import minimizer as mz


@dataclass
class MinimizerIndex:
    k: int
    w: int
    hashes: np.ndarray  # [U] sorted unique hashes
    post_off: np.ndarray  # [U+1] CSR offsets
    post_path: np.ndarray  # [Np] representative path idx
    post_ppos: np.ndarray  # [Np] offset of k-mer start on that path
    post_rc: np.ndarray  # [Np] canonical k-mer is reverse of path orientation
    # per-path linearization support
    path_len: np.ndarray  # [P]
    step_off: List[np.ndarray]  # per path: cumulative node start offsets
    ry: bool = False  # index is over RYmer-projected sequence

    @classmethod
    def build(
        cls,
        graph: PackedGraph,
        k: int = 20,
        w: int = 10,
        ry: bool = False,
        max_occ: int | None = None,
    ) -> "MinimizerIndex":
        """Build the index. ry=True hashes RYmer-projected sequence
        (damage-aware SAFARI seeding); max_occ drops hashes with more
        postings (frequent-kmer filter — RY space is 1 bit/base, so
        low-complexity stretches need it).

        Vectorized (r3): per-path minimizer extraction and graph-
        position resolution are array passes; the global (hash, graph
        position) dedup keeps the FIRST-SEEN representative and
        first-seen posting order within each hash — exactly the
        per-minimizer dict loop's semantics (kept as `_build_loop`,
        parity-tested) but ~100x faster at 5,179-path DB scale."""
        path_len = np.zeros(graph.n_paths, dtype=np.int64)
        step_off: List[np.ndarray] = []
        Hs, NIs, NOs, RVs, Ps, PPs, RCs = [], [], [], [], [], [], []
        for p in range(graph.n_paths):
            codes = _path_codes(graph, p)
            path_len[p] = len(codes)
            offs = _step_offsets(graph, p)
            step_off.append(offs)
            pos, hashes, is_rc = mz.minimizers(
                mz.to_ry(codes) if ry else codes, k, w
            )
            if len(pos) == 0:
                continue
            pos = np.asarray(pos, dtype=np.int64)
            step = np.searchsorted(offs, pos, side="right") - 1
            steps_node = np.asarray(graph.path_steps_node[p])
            steps_rev = np.asarray(graph.path_steps_rev[p])
            Hs.append(np.asarray(hashes, dtype=np.uint64))
            NIs.append(steps_node[step].astype(np.int64))
            NOs.append(pos - offs[step])
            RVs.append(steps_rev[step].astype(bool))
            Ps.append(np.full(len(pos), p, dtype=np.int32))
            PPs.append(pos)
            RCs.append(np.asarray(is_rc, dtype=bool))
        if not Hs:
            return cls(
                k=k, w=w, hashes=np.zeros(0, np.uint64),
                post_off=np.zeros(1, np.int64),
                post_path=np.zeros(0, np.int32),
                post_ppos=np.zeros(0, np.int64),
                post_rc=np.zeros(0, bool),
                path_len=path_len, step_off=step_off, ry=ry,
            )
        h = np.concatenate(Hs)
        nidx = np.concatenate(NIs)
        noff = np.concatenate(NOs)
        rev = np.concatenate(RVs)
        pth = np.concatenate(Ps)
        ppos = np.concatenate(PPs)
        rc = np.concatenate(RCs)
        g = np.arange(len(h), dtype=np.int64)  # global scan order
        # first occurrence per (h, nidx, noff, rev): lexsort is stable,
        # so within equal keys rows keep scan order and the run head is
        # the first-seen representative
        order = np.lexsort((g, rev, noff, nidx, h))
        hs = h[order]
        ks = np.stack(
            [nidx[order], noff[order], rev[order].astype(np.int64)],
            axis=1,
        )
        same = np.zeros(len(order), dtype=bool)
        if len(order) > 1:
            same[1:] = (hs[1:] == hs[:-1]) & (ks[1:] == ks[:-1]).all(
                axis=1
            )
        kept = order[~same]
        # postings within a hash in first-seen order (dict insertion
        # order of the loop)
        kept = kept[np.lexsort((kept, h[kept]))]
        hk = h[kept]
        uniq, counts = np.unique(hk, return_counts=True)
        if max_occ is not None:
            ok = counts <= max_occ
            keep_mask = np.repeat(ok, counts)
            kept = kept[keep_mask]
            uniq, counts = uniq[ok], counts[ok]
        post_off = np.zeros(len(uniq) + 1, dtype=np.int64)
        np.cumsum(counts, out=post_off[1:])
        return cls(
            k=k, w=w, hashes=uniq, post_off=post_off,
            post_path=pth[kept].astype(np.int32),
            post_ppos=ppos[kept],
            post_rc=rc[kept],
            path_len=path_len, step_off=step_off, ry=ry,
        )

    @classmethod
    def _build_loop(
        cls,
        graph: PackedGraph,
        k: int = 20,
        w: int = 10,
        ry: bool = False,
        max_occ: int | None = None,
    ) -> "MinimizerIndex":
        """Per-minimizer dict-loop oracle for build (parity test)."""
        postings: Dict[int, Dict[Tuple[int, int, bool], Tuple[int, int, bool]]] = {}
        path_len = np.zeros(graph.n_paths, dtype=np.int64)
        step_off: List[np.ndarray] = []
        for p in range(graph.n_paths):
            codes = _path_codes(graph, p)
            path_len[p] = len(codes)
            offs = _step_offsets(graph, p)
            step_off.append(offs)
            pos, hashes, is_rc = mz.minimizers(
                mz.to_ry(codes) if ry else codes, k, w
            )
            for ppos, h, rc in zip(pos, hashes, is_rc):
                # graph position of the k-mer start
                step = int(np.searchsorted(offs, ppos, side="right") - 1)
                nidx = int(graph.path_steps_node[p][step])
                noff = int(ppos - offs[step])
                key = (nidx, noff, bool(graph.path_steps_rev[p][step]))
                postings.setdefault(int(h), {}).setdefault(
                    key, (p, int(ppos), bool(rc))
                )
        if max_occ is not None:
            postings = {
                h: d for h, d in postings.items() if len(d) <= max_occ
            }
        uniq = np.array(sorted(postings), dtype=np.uint64)
        counts = np.array([len(postings[int(h)]) for h in uniq], dtype=np.int64)
        post_off = np.zeros(len(uniq) + 1, dtype=np.int64)
        np.cumsum(counts, out=post_off[1:])
        Np = int(post_off[-1])
        post_path = np.zeros(Np, dtype=np.int32)
        post_ppos = np.zeros(Np, dtype=np.int64)
        post_rc = np.zeros(Np, dtype=bool)
        i = 0
        for h in uniq:
            for p, ppos, rc in postings[int(h)].values():
                post_path[i] = p
                post_ppos[i] = ppos
                post_rc[i] = rc
                i += 1
        return cls(
            k=k, w=w, hashes=uniq, post_off=post_off, post_path=post_path,
            post_ppos=post_ppos, post_rc=post_rc, path_len=path_len,
            step_off=step_off, ry=ry,
        )

    def lookup(self, hashes: np.ndarray) -> List[Tuple[int, int]]:
        """For each query hash return the (start, end) posting range
        (empty if absent)."""
        idx = np.searchsorted(self.hashes, hashes)
        out = []
        for q, i in zip(hashes, idx):
            if i < len(self.hashes) and self.hashes[i] == q:
                out.append((int(self.post_off[i]), int(self.post_off[i + 1])))
            else:
                out.append((0, 0))
        return out


def _path_codes(graph: PackedGraph, p: int) -> np.ndarray:
    from ..utils import dna

    steps = np.asarray(graph.path_steps_node[p], dtype=np.int64)
    revs = np.asarray(graph.path_steps_rev[p], dtype=bool)
    if len(steps) == 0:
        return np.zeros(0, dtype=np.uint8)
    if not revs.any():
        # all-forward path (the common case): one flat gather
        starts = graph.node_off[steps]
        lens = graph.node_off[steps + 1] - starts
        total = int(lens.sum())
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
        )
        return graph.node_seq_pool[np.repeat(starts, lens) + within]
    parts = []
    for nidx, rev in zip(steps, revs):
        codes = graph.node_seq_pool[graph.node_off[nidx] : graph.node_off[nidx + 1]]
        parts.append(dna.revcomp_codes(codes) if rev else codes)
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)


def _step_offsets(graph: PackedGraph, p: int) -> np.ndarray:
    steps = np.asarray(graph.path_steps_node[p], dtype=np.int64)
    lens = graph.node_off[steps + 1] - graph.node_off[steps]
    offs = np.zeros(len(steps), dtype=np.int64)
    if len(steps) > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    return offs
