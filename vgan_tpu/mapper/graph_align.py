"""Sequence-to-graph banded alignment over a local window.

The extension stage proper: after seeding locates a candidate interval
on a haplotype path, the read is aligned against the *graph* around
that interval — the path backbone plus local alternative alleles
(bubbles) — with affine gaps, exactly like giraffe's extension explores
the graph rather than a single haplotype. This is the "graph-banded
Smith-Waterman over unrolled graph windows" of SURVEY.md §7.

DP layout: graph positions (topologically ordered oriented-handle
offsets) are columns, read positions are rows. The vertical (F) affine
recurrence is evaluated exactly with the prefix-max trick, the
horizontal (E) recurrence propagates across node boundaries through
each position's predecessor set. Full-length bonus semantics match
mapper/align.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..graph.packed import PackedGraph
from .align import FULL_LENGTH_BONUS, GAP_EXT, GAP_OPEN, MATCH, MISMATCH

NEG = -(10**9)


@dataclass
class Window:
    handles: List[Tuple[int, bool]]  # (node_idx, is_reverse) in topo order
    seqs: List[np.ndarray]  # oriented codes per handle
    preds: List[List[int]]  # handle-level predecessor indices
    # flattened positions
    pos_handle: np.ndarray  # [ncols] handle index per graph position
    pos_offset: np.ndarray  # [ncols] offset within handle
    ref: np.ndarray  # [ncols] uint8 position codes
    csr_off: np.ndarray  # [ncols+1] predecessor CSR offsets (int64)
    csr_idx: np.ndarray  # predecessor position ids (int32)

    @property
    def pos_pred(self) -> List[List[int]]:
        """Per-position predecessor lists (derived view of the CSR;
        used by the pure-python oracle aligner)."""
        cached = getattr(self, "_pos_pred", None)
        if cached is None:
            off, idx = self.csr_off, self.csr_idx
            cached = [
                idx[off[i] : off[i + 1]].tolist()
                for i in range(len(off) - 1)
            ]
            self._pos_pred = cached
        return cached


def build_window(
    graph: PackedGraph, path: int, lo: int, hi: int,
    max_handles: int = 512,
) -> Optional[Window]:
    """Backbone = path steps covering [lo, hi) in path coordinates,
    plus every local alternative: oriented handles reachable forward
    from the first backbone handle AND backward from the last one
    (depth-bounded BFS), topologically ordered (Kahn)."""
    offs = graph.step_offsets(path)
    steps_node = graph.path_steps_node[path]
    steps_rev = graph.path_steps_rev[path]
    if len(steps_node) == 0:
        return None
    s0 = max(0, int(np.searchsorted(offs, lo, side="right") - 1))
    s1 = min(len(steps_node) - 1, int(np.searchsorted(offs, max(hi - 1, 0), side="right") - 1))
    backbone = [
        (int(steps_node[s]), bool(steps_rev[s])) for s in range(s0, s1 + 1)
    ]

    # oriented adjacency (and reverse), cached on the graph
    fwd_adj, rev_adj = graph.oriented_adjacency()

    depth_cap = 2 * len(backbone) + 8

    def bfs(start_handles, adj):
        seen = set(start_handles)
        frontier = list(start_handles)
        for _ in range(depth_cap):
            nxt = []
            for h in frontier:
                for x in adj.get(h, []):
                    if x not in seen:
                        seen.add(x)
                        nxt.append(x)
                        if len(seen) >= max_handles:
                            return seen
            if not nxt:
                break
            frontier = nxt
        return seen

    F = bfs([backbone[0]], fwd_adj)
    Bk = bfs([backbone[-1]], rev_adj)
    S = (F & Bk) | set(backbone)

    # induced predecessor lists + Kahn topological order
    preds_of = {h: [p for p in rev_adj.get(h, []) if p in S] for h in S}
    indeg = {h: len(preds_of[h]) for h in S}
    from collections import deque

    queue = deque(sorted([h for h in S if indeg[h] == 0]))
    order: List[Tuple[int, bool]] = []
    while queue:
        h = queue.popleft()
        order.append(h)
        for x in fwd_adj.get(h, []):
            if x in S:
                indeg[x] -= 1
                if indeg[x] == 0:
                    queue.append(x)
    if len(order) != len(S):
        # local cycle: fall back to the backbone chain only
        order = backbone
        preds_of = {
            h: ([backbone[i - 1]] if i > 0 else [])
            for i, h in enumerate(backbone)
        }

    handles = order
    hidx = {h: i for i, h in enumerate(handles)}
    preds: List[List[int]] = [
        [hidx[p] for p in preds_of.get(h, []) if p in hidx] for h in handles
    ]

    seqs = [graph.node_codes(n + graph.min_id, rev) for n, rev in handles]
    # flattened positions + predecessor CSR, vectorized (per-base
    # Python loops here were the window-build hot spot)
    H = len(handles)
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int64)
    starts = np.zeros(H + 1, dtype=np.int64)
    np.cumsum(seq_lens, out=starts[1:])
    total = int(starts[-1])
    pos_handle = np.repeat(np.arange(H, dtype=np.int32), seq_lens)
    pos_offset = (
        np.arange(total, dtype=np.int64) - starts[pos_handle]
    ).astype(np.int32)
    ref = (
        np.concatenate(seqs) if total else np.zeros(0, dtype=np.uint8)
    ).astype(np.uint8, copy=False)
    # first position of each non-empty handle takes the handle's
    # predecessor list (last positions of non-empty preds); every
    # other position's sole predecessor is the previous position
    first_preds = [
        [int(starts[p] + seq_lens[p] - 1) for p in preds[i]
         if seq_lens[p] > 0]
        for i in range(H)
    ]
    counts = np.ones(total, dtype=np.int64)
    is_first = pos_offset == 0
    fp_rows = np.nonzero(is_first)[0]
    for r in fp_rows:
        counts[r] = len(first_preds[int(pos_handle[r])])
    csr_off = np.zeros(total + 1, dtype=np.int64)
    np.cumsum(counts, out=csr_off[1:])
    csr_idx = np.empty(int(csr_off[-1]), dtype=np.int32)
    nonfirst = np.nonzero(~is_first)[0]
    csr_idx[csr_off[nonfirst]] = (nonfirst - 1).astype(np.int32)
    for r in fp_rows:
        fp = first_preds[int(pos_handle[r])]
        csr_idx[csr_off[r] : csr_off[r] + len(fp)] = fp
    return Window(
        handles=handles,
        seqs=seqs,
        preds=preds,
        pos_handle=pos_handle,
        pos_offset=pos_offset,
        ref=ref,
        csr_off=csr_off,
        csr_idx=csr_idx,
    )


@dataclass
class GraphAlignment:
    score: int
    read_start: int
    read_end: int
    # aligned columns: list of (handle_idx, offset, op) where op in
    # M/X/D; I entries have handle_idx = -1 (consume read only)
    walk: List[Tuple[int, int, str]]
    n_matches: int
    aligned_cols: int


def align_to_window(q: np.ndarray, win: Window) -> Optional[GraphAlignment]:
    n = len(q)
    ncols = len(win.pos_handle)
    if n == 0 or ncols == 0:
        return None
    ref = win.ref
    H = np.zeros((ncols + 1, n + 1), dtype=np.int32)  # [col+1, row]
    E = np.full((ncols + 1, n + 1), NEG, dtype=np.int32)
    # column 0 is the virtual empty predecessor
    rows = np.arange(n + 1)
    ext_w = rows.astype(np.int64) * GAP_EXT

    sub_match = np.int32(MATCH)
    for c in range(ncols):
        preds = [p + 1 for p in win.pos_pred[c]]
        if not preds:
            preds = [0]
        Hp = np.max([H[p] for p in preds], axis=0)
        Ep = np.max([E[p] for p in preds], axis=0)
        s = np.where((q == ref[c]) & (q < 4), MATCH, MISMATCH).astype(np.int32)
        diag = Hp[:-1] + s
        diag[0] += FULL_LENGTH_BONUS  # read-start anchored bonus
        e = np.maximum(Hp - GAP_OPEN, Ep - GAP_EXT)
        h_no_f = np.zeros(n + 1, dtype=np.int32)
        h_no_f[1:] = diag
        h_no_f = np.maximum(h_no_f, e)
        h_no_f[0] = max(0, e[0])
        h_no_f = np.maximum(h_no_f, 0)
        # exact F via prefix max of (H + i*ext)
        a = np.maximum.accumulate(h_no_f + ext_w)
        f = np.full(n + 1, NEG, dtype=np.int64)
        f[1:] = a[:-1] - GAP_OPEN - ext_w[1:] + GAP_EXT
        Hc = np.maximum(h_no_f, f).astype(np.int32)
        H[c + 1] = Hc
        E[c + 1] = e
    # choose best cell with end bonus on the last row
    Hb = H[1:].astype(np.int64).copy()
    Hb[:, n] += FULL_LENGTH_BONUS
    c_best, i_best = np.unravel_index(np.argmax(Hb), Hb.shape)
    score = int(H[c_best + 1, i_best])
    if score <= 0:
        return None

    # traceback by local recomputation, tracking H/E state across columns
    walk: List[Tuple[int, int, str]] = []
    c, i = int(c_best), int(i_best)
    state = "H"
    n_matches = 0
    aligned = 0
    guard = 0
    done = False
    while not done and i >= 0 and guard < 10 * (n + ncols + 2):
        guard += 1
        preds = [p + 1 for p in win.pos_pred[c]] or [0]
        Hp = np.max([H[p] for p in preds], axis=0)
        Ep = np.max([E[p] for p in preds], axis=0)
        hloc = int(win.pos_handle[c])
        oloc = int(win.pos_offset[c])
        if state == "H":
            cur = H[c + 1, i]
            if cur <= 0 or i == 0:
                break
            s = MATCH if (q[i - 1] == ref[c] and q[i - 1] < 4) else MISMATCH
            diag_val = Hp[i - 1] + s + (FULL_LENGTH_BONUS if i == 1 else 0)
            if cur == diag_val:
                op = "M" if s == MATCH else "X"
                if op == "M":
                    n_matches += 1
                walk.append((hloc, oloc, op))
                aligned += 1
                best_p = max(preds, key=lambda p: H[p][i - 1])
                i -= 1
                if best_p == 0 or i == 0:
                    done = True
                else:
                    c = best_p - 1
            elif cur == E[c + 1, i]:
                state = "E"  # re-handle this column in E state
            else:
                # vertical gap: locate the opener row i' with
                # H[i'] - open - (gap-1)*ext == cur, emit the whole run
                opener = None
                for i2 in range(i - 1, 0, -1):
                    if (
                        H[c + 1, i2] - GAP_OPEN - (i - i2 - 1) * GAP_EXT
                        == cur
                    ):
                        opener = i2
                        break
                if opener is None:
                    break  # inconsistent cell; stop cleanly
                for _ in range(i - opener):
                    walk.append((-1, 0, "I"))
                i = opener
        else:  # E state: this column is consumed as a deletion
            walk.append((hloc, oloc, "D"))
            aligned += 1
            if Ep[i] - GAP_EXT == E[c + 1, i]:
                best_p = max(preds, key=lambda p: E[p][i])
                state = "E"
            else:
                best_p = max(preds, key=lambda p: H[p][i])
                state = "H"
            if best_p == 0:
                done = True
            else:
                c = best_p - 1
    walk.reverse()
    return GraphAlignment(
        score=score,
        read_start=i,
        read_end=int(i_best),
        walk=walk,
        n_matches=n_matches,
        aligned_cols=aligned,
    )


# ---------------------------------------------------------------------------
# native fast path (vgan_tpu/cpp/graphalign.cpp)
# ---------------------------------------------------------------------------
_native_lib = None
_native_checked = False


def _load_native():
    global _native_lib, _native_checked
    if _native_checked:
        return _native_lib
    _native_checked = True
    try:
        import ctypes

        from ..io.gam_native import _LIB_PATH, build

        build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.graph_align.restype = ctypes.c_int64
        lib.graph_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        _native_lib = lib
    except OSError:
        _native_lib = None
    return _native_lib


def _window_csr(win: Window):
    """(ref codes, CSR preds) — precomputed at build_window time."""
    return win.ref, win.csr_off, win.csr_idx


def align_to_window_native(q: np.ndarray, win: Window) -> Optional[GraphAlignment]:
    import ctypes

    lib = _load_native()
    if lib is None:
        return align_to_window(q, win)
    ref, off, idx = _window_csr(win)
    n = len(q)
    ncols = len(ref)
    if n == 0 or ncols == 0:
        return None
    cap = 4 * (n + ncols) + 8
    ops = np.zeros(cap, dtype=np.int32)
    cols = np.zeros(cap, dtype=np.int32)
    meta = np.zeros(5, dtype=np.int64)
    wl = lib.graph_align(
        np.ascontiguousarray(q, dtype=np.uint8).tobytes(), n,
        ref.tobytes(), ncols,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if wl < 0:
        return None
    opchar = "MXDI"
    walk = []
    for k in range(wl):
        c = int(cols[k])
        if c < 0:
            walk.append((-1, 0, "I"))
        else:
            walk.append(
                (int(win.pos_handle[c]), int(win.pos_offset[c]), opchar[ops[k]])
            )
    return GraphAlignment(
        score=int(meta[0]),
        read_start=int(meta[1]),
        read_end=int(meta[2]),
        walk=walk,
        n_matches=int(meta[3]),
        aligned_cols=int(meta[4]),
    )
