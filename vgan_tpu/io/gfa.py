"""GFA 1.0 parser producing the packed graph arrays.

The reference loads graphs through bdsg::ODGI (`src/readPathHandleGraph.cpp`,
`src/readOG_Euka.h`); our DB compiler instead consumes the GFA text form
(as emitted by `vg view`, see `test/reconstructInputSeq/cmds:7`) and
packs it into flat numpy arrays (see vgan_tpu.graph.packed.PackedGraph).
"""
from __future__ import annotations

import gzip
from typing import Dict, List, Tuple


def parse_gfa(path: str):
    """Parse S/P/L lines. Returns (segments, paths, links).

    segments: dict node_id(int) -> sequence(str)
    paths: list of (name, [(node_id, is_reverse), ...])
    links: list of (from_id, from_rev, to_id, to_rev)
    """
    opener = gzip.open if path.endswith(".gz") else open
    segments: Dict[int, str] = {}
    paths: List[Tuple[str, List[Tuple[int, bool]]]] = []
    links: List[Tuple[int, bool, int, bool]] = []
    with opener(path, "rt") as f:
        for line in f:
            if not line or line[0] not in "SPLW":
                continue
            fields = line.rstrip("\n").split("\t")
            tag = fields[0]
            if tag == "S":
                segments[int(fields[1])] = fields[2].upper()
            elif tag == "P":
                name = fields[1]
                steps = []
                if fields[2] and fields[2] != "*":
                    for step in fields[2].split(","):
                        steps.append((int(step[:-1]), step[-1] == "-"))
                paths.append((name, steps))
            elif tag == "L":
                links.append(
                    (int(fields[1]), fields[2] == "-", int(fields[3]), fields[4] == "-")
                )
            elif tag == "W":  # walk lines (GFA 1.1) -> convert to path
                name = "#".join(fields[2:5])
                walk = fields[6]
                steps = []
                cur = ""
                rev = False
                for ch in walk:
                    if ch in "><":
                        if cur:
                            steps.append((int(cur), rev))
                        rev = ch == "<"
                        cur = ""
                    else:
                        cur += ch
                if cur:
                    steps.append((int(cur), rev))
                paths.append((name, steps))
    return segments, paths, links


def format_gfa(graph) -> str:
    """GFA 1.0 text (S/L/P lines) of a PackedGraph; `parse_gfa` and
    `PackedGraph.from_gfa` read it back to the same arrays."""
    from ..utils import dna

    lines = ["H\tVN:Z:1.0"]
    for i in range(graph.n_nodes):
        seq = dna.decode(graph.node_seq_pool[graph.node_off[i] : graph.node_off[i + 1]])
        lines.append(f"S\t{graph.min_id + i}\t{seq}")
    for f, fr, t, tr in zip(graph.edge_from, graph.edge_from_rev,
                            graph.edge_to, graph.edge_to_rev):
        lines.append(
            f"L\t{graph.min_id + int(f)}\t{'-' if fr else '+'}\t"
            f"{graph.min_id + int(t)}\t{'-' if tr else '+'}\t0M"
        )
    for name, steps, revs in zip(graph.path_names, graph.path_steps_node,
                                 graph.path_steps_rev):
        walk = ",".join(
            f"{graph.min_id + int(n)}{'-' if r else '+'}"
            for n, r in zip(steps, revs)
        )
        lines.append(f"P\t{name}\t{walk}\t*")
    return "\n".join(lines) + "\n"
