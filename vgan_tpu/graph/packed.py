"""PackedGraph: the device-friendly flat-array graph representation.

Replaces the reference's pointer-based `vector<NodeInfo*>` + ODGI handle
graph (`src/NodeInfo.h:28-42`, `src/readPathHandleGraph.cpp:14-37`,
`src/readOG_Euka.h:29-140`) with columnar numpy arrays that can be
shipped to device memory:

* node sequences as one uint8 code pool + CSR offsets,
* topology as CSR edge lists,
* path membership as a dense bool matrix [n_nodes, n_paths]
  (the `pathsgo` bits / GBWT extraction of the reference),
* per-path step lists for coordinate projection (linearization).

Build once offline (DB compiler), save/load as .npz.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..utils import dna


@dataclass
class PackedGraph:
    # node storage (index = node_id - min_id)
    min_id: int
    node_seq_pool: np.ndarray  # uint8 codes, concatenated
    node_off: np.ndarray  # int64 [n_nodes+1]
    # topology (forward adjacency on oriented handles is flattened to
    # undirected-successor CSR on node indices; orientations kept)
    edge_from: np.ndarray  # int32 node index
    edge_from_rev: np.ndarray  # bool
    edge_to: np.ndarray  # int32 node index
    edge_to_rev: np.ndarray  # bool
    # paths
    path_names: List[str]
    path_steps_node: List[np.ndarray]  # per path: int32 node indices
    path_steps_rev: List[np.ndarray]  # per path: bool orientation
    # support matrix [n_nodes, n_paths]
    path_support: np.ndarray
    # optional metadata
    meta: Dict = field(default_factory=dict)

    # ------------------------------------------------------------ properties
    @property
    def n_nodes(self) -> int:
        return len(self.node_off) - 1

    @property
    def max_id(self) -> int:
        return self.min_id + self.n_nodes - 1

    @property
    def n_paths(self) -> int:
        return len(self.path_names)

    # ------------------------------------------------------------ caches
    def oriented_adjacency(self):
        """(fwd_adj, rev_adj) dicts over oriented handles (node_idx,
        is_reverse), built once and cached (used by the mapper's window
        extraction)."""
        if getattr(self, "_adj_cache", None) is None:
            fwd, rev = {}, {}

            def add(a, b):
                fwd.setdefault(a, []).append(b)
                rev.setdefault(b, []).append(a)

            for f, fr, t, tr in zip(
                self.edge_from, self.edge_from_rev, self.edge_to, self.edge_to_rev
            ):
                add((int(f), bool(fr)), (int(t), bool(tr)))
                add((int(t), not bool(tr)), (int(f), not bool(fr)))
            self._adj_cache = (fwd, rev)
        return self._adj_cache

    def step_offsets(self, path_idx: int):
        """Cumulative node-start offsets along a path (cached)."""
        if getattr(self, "_stepoff_cache", None) is None:
            self._stepoff_cache = {}
        out = self._stepoff_cache.get(path_idx)
        if out is None:
            lens = self.node_off[self.path_steps_node[path_idx] + 1] -                 self.node_off[self.path_steps_node[path_idx]]
            out = np.zeros(len(lens), dtype=np.int64)
            np.cumsum(lens[:-1], out=out[1:])
            self._stepoff_cache[path_idx] = out
        return out

    def path_node_spans(self):
        """Per-path (min, max) node index over the path's steps, as two
        int64 arrays [P] (cached).  Paths over disjoint node ranges
        (e.g. different taxa in a euka/soibean DB) never describe the
        same graph placement, while haplotypes of one backbone all span
        the same range — used by the mapper's MQ runner-up test."""
        if getattr(self, "_span_cache", None) is None:
            P = self.n_paths
            lo = np.zeros(P, dtype=np.int64)
            hi = np.zeros(P, dtype=np.int64)
            for j, sn in enumerate(self.path_steps_node):
                if len(sn):
                    lo[j] = int(sn.min())
                    hi[j] = int(sn.max())
                else:
                    lo[j], hi[j] = -1, -2
            self._span_cache = (lo, hi)
        return self._span_cache

    def path_span_groups(self):
        """Group id per path from interval-union of the node spans
        (cached): paths in different groups occupy disjoint node ranges
        (different taxa) and may carry byte-identical windows that are
        nonetheless DISTINCT placements — the mapper's content dedup
        must not collapse them across groups."""
        if getattr(self, "_spangrp_cache", None) is None:
            lo, hi = self.path_node_spans()
            order = np.argsort(lo, kind="stable")
            grp = np.zeros(self.n_paths, dtype=np.int32)
            cur, cur_hi = -1, -2
            for j in order:
                if lo[j] > cur_hi:
                    cur += 1
                    cur_hi = hi[j]
                else:
                    cur_hi = max(cur_hi, hi[j])
                grp[j] = cur
            self._spangrp_cache = grp
        return self._spangrp_cache

    # ------------------------------------------------------------ accessors
    def node_index(self, node_id: int) -> int:
        return node_id - self.min_id

    def node_len(self, node_id: int) -> int:
        i = node_id - self.min_id
        return int(self.node_off[i + 1] - self.node_off[i])

    def node_codes(self, node_id: int, is_reverse: bool = False) -> np.ndarray:
        """Oriented node sequence codes (ODGI get_sequence(get_handle(id, rev)),
        `src/vgan_utils.h:24`)."""
        i = node_id - self.min_id
        codes = self.node_seq_pool[self.node_off[i] : self.node_off[i + 1]]
        if is_reverse:
            codes = dna.revcomp_codes(codes)
        return codes

    def node_seq(self, node_id: int, is_reverse: bool = False) -> str:
        return dna.decode(self.node_codes(node_id, is_reverse))

    def path_seq(self, path_idx: int) -> str:
        """Full sequence of a stored path (haplotype linearization)."""
        parts = []
        for nidx, rev in zip(self.path_steps_node[path_idx], self.path_steps_rev[path_idx]):
            codes = self.node_seq_pool[self.node_off[nidx] : self.node_off[nidx + 1]]
            parts.append(dna.revcomp_codes(codes) if rev else codes)
        return dna.decode(np.concatenate(parts)) if parts else ""

    def paths_through_node(self, node_id: int) -> List[str]:
        """Names of paths touching a node (`src/soibean_functions.cpp:8-17`)."""
        i = node_id - self.min_id
        return [self.path_names[j] for j in np.nonzero(self.path_support[i])[0]]

    # ------------------------------------------------------------ build
    @classmethod
    def from_gfa(cls, gfa_path: str, meta: Optional[Dict] = None) -> "PackedGraph":
        from ..io.gfa import parse_gfa

        segments, paths, links = parse_gfa(gfa_path)
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

        ef = np.array([l[0] - min_id for l in links], dtype=np.int32)
        efr = np.array([l[1] for l in links], dtype=bool)
        et = np.array([l[2] - min_id for l in links], dtype=np.int32)
        etr = np.array([l[3] for l in links], dtype=bool)

        return cls(
            min_id=min_id,
            node_seq_pool=pool,
            node_off=node_off,
            edge_from=ef,
            edge_from_rev=efr,
            edge_to=et,
            edge_to_rev=etr,
            path_names=path_names,
            path_steps_node=steps_node,
            path_steps_rev=steps_rev,
            path_support=support,
            meta=meta or {},
        )

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        steps_flat = (
            np.concatenate(self.path_steps_node)
            if self.path_steps_node
            else np.zeros(0, dtype=np.int32)
        )
        steps_rev_flat = (
            np.concatenate(self.path_steps_rev)
            if self.path_steps_rev
            else np.zeros(0, dtype=bool)
        )
        steps_len = np.array([len(s) for s in self.path_steps_node], dtype=np.int64)
        np.savez_compressed(
            path,
            min_id=np.int64(self.min_id),
            node_seq_pool=self.node_seq_pool,
            node_off=self.node_off,
            edge_from=self.edge_from,
            edge_from_rev=self.edge_from_rev,
            edge_to=self.edge_to,
            edge_to_rev=self.edge_to_rev,
            path_names=np.array(self.path_names, dtype=object),
            steps_flat=steps_flat,
            steps_rev_flat=steps_rev_flat,
            steps_len=steps_len,
            path_support=np.packbits(self.path_support, axis=1),
            n_paths=np.int64(self.n_paths),
            meta=json.dumps(self.meta),
        )

    @classmethod
    def load(cls, path: str) -> "PackedGraph":
        z = np.load(path, allow_pickle=True)
        steps_len = z["steps_len"]
        offs = np.zeros(len(steps_len) + 1, dtype=np.int64)
        np.cumsum(steps_len, out=offs[1:])
        sf, srf = z["steps_flat"], z["steps_rev_flat"]
        steps_node = [sf[offs[i] : offs[i + 1]] for i in range(len(steps_len))]
        steps_rev = [srf[offs[i] : offs[i + 1]] for i in range(len(steps_len))]
        n_paths = int(z["n_paths"])
        support = np.unpackbits(z["path_support"], axis=1)[:, :n_paths].astype(bool)
        return cls(
            min_id=int(z["min_id"]),
            node_seq_pool=z["node_seq_pool"],
            node_off=z["node_off"],
            edge_from=z["edge_from"],
            edge_from_rev=z["edge_from_rev"],
            edge_to=z["edge_to"],
            edge_to_rev=z["edge_to_rev"],
            path_names=list(z["path_names"]),
            path_steps_node=steps_node,
            path_steps_rev=steps_rev,
            path_support=support,
            meta=json.loads(str(z["meta"])),
        )
