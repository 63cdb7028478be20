"""Affine-gap local alignment with traceback.

The extension/alignment stage of the giraffe-equivalent
mapper (SURVEY.md §2.2: minimizer seeding + gapless extension +
banded Smith-Waterman). Scoring follows vg's default aligner
(match 1, mismatch 4, gap open 6, gap extend 1, full-length bonus 5),
which is what `vg giraffe -b fast` uses in the reference invocation
(`src/map_giraffe.cpp:24-164`).

This module is the host reference implementation (vectorized numpy
rows); the batched device scorer (mapper/sw_pallas.py) reproduces
its scores on device for the heavy batch phase. Traceback runs on host
for selected winners only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

MATCH = 1
MISMATCH = -4
GAP_OPEN = 6  # cost of a 1-base gap
GAP_EXT = 1
FULL_LENGTH_BONUS = 5

NEG = -(10**9)


@dataclass
class LocalAlignment:
    score: int
    read_start: int
    read_end: int  # exclusive
    ref_start: int
    ref_end: int  # exclusive
    cigar: List[Tuple[str, int]]  # ops M/X/I/D over the aligned core
    n_matches: int

    @property
    def score_with_bonus(self) -> int:
        return self.score


def smith_waterman(
    read: np.ndarray,
    ref: np.ndarray,
    band: Optional[Tuple[int, int]] = None,
) -> Optional[LocalAlignment]:
    """Local affine alignment of read vs ref (uint8 code arrays).
    `band` restricts diagonals d = j - i to [band[0], band[1]].
    Full-length bonus is added for alignments reaching the read ends
    (applied inside the DP so end-anchored alignments win ties, as in
    vg's Aligner)."""
    n, m = len(read), len(ref)
    if n == 0 or m == 0:
        return None
    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int32)  # gap in read (consumes ref)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int32)  # gap in ref (consumes read)
    # traceback: 0 stop, 1 diag, 2 E(left), 3 F(up)
    TB = np.zeros((n + 1, m + 1), dtype=np.int8)
    TE = np.zeros((n + 1, m + 1), dtype=np.int8)  # 1 if E opened here
    TF = np.zeros((n + 1, m + 1), dtype=np.int8)

    sub = np.where(read[:, None] == ref[None, :], MATCH, MISMATCH).astype(np.int32)
    # N never matches positively
    nmask = (read[:, None] >= 4) | (ref[None, :] >= 4)
    sub[nmask] = MISMATCH

    lo, hi = (-(m + 1), m + 1) if band is None else band

    for i in range(1, n + 1):
        jmin = max(1, i + lo)
        jmax = min(m, i + hi)
        if jmin > jmax:
            continue
        js = np.arange(jmin, jmax + 1)
        # E: running max along the row (sequential) — vectorize via scan
        # iterate E sequentially (short rows; fine on host)
        e = NEG
        diag = H[i - 1, jmin - 1 : jmax] + sub[i - 1, jmin - 1 : jmax]
        if i == 1:
            # full-length bonus for alignments anchored at the read
            # start (vg Aligner's left bonus), baked into the DP so
            # end-to-end alignments can beat clipped ones
            diag = diag + FULL_LENGTH_BONUS
        f_open = H[i - 1, jmin : jmax + 1] - GAP_OPEN
        f_ext = F[i - 1, jmin : jmax + 1] - GAP_EXT
        Fi = np.maximum(f_open, f_ext)
        F[i, jmin : jmax + 1] = Fi
        TF[i, jmin : jmax + 1] = (f_ext > f_open).astype(np.int8)
        for idx, j in enumerate(js):
            e_o = H[i, j - 1] - GAP_OPEN
            e_x = e - GAP_EXT
            e = max(e_o, e_x)
            TE[i, j] = 1 if e_x > e_o else 0
            E[i, j] = e
            d = diag[idx]
            best = max(0, d, e, Fi[idx])
            H[i, j] = best
            if best == 0:
                TB[i, j] = 0
            elif best == d:
                TB[i, j] = 1
            elif best == e:
                TB[i, j] = 2
            else:
                TB[i, j] = 3

    # select best cell, preferring read-end-reaching alignments by bonus
    Hb = H.astype(np.int64).copy()
    Hb[n, :] += FULL_LENGTH_BONUS
    i, j = np.unravel_index(np.argmax(Hb), Hb.shape)
    if H[i, j] <= 0:
        return None
    # traceback
    cigar: List[Tuple[str, int]] = []
    n_matches = 0
    ie, je = int(i), int(j)
    while i > 0 and j > 0 and H[i, j] > 0:
        t = TB[i, j]
        if t == 0:
            break
        if t == 1:
            op = "M" if read[i - 1] == ref[j - 1] and read[i - 1] < 4 else "X"
            if op == "M":
                n_matches += 1
            cigar.append((op, 1))
            i -= 1
            j -= 1
        elif t == 2:  # gap in read: consumes ref (deletion from read)
            length = 0
            while True:
                ext = TE[i, j]
                j -= 1
                length += 1
                if not ext or j == 0:
                    break
            cigar.append(("D", length))
        else:  # gap in ref: consumes read (insertion in read)
            length = 0
            while True:
                ext = TF[i, j]
                i -= 1
                length += 1
                if not ext or i == 0:
                    break
            cigar.append(("I", length))
    cigar.reverse()
    # merge adjacent same-ops
    merged: List[Tuple[str, int]] = []
    for op, length in cigar:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + length)
        else:
            merged.append((op, length))
    return LocalAlignment(
        score=int(H[ie, je]),
        read_start=int(i),
        read_end=ie,
        ref_start=int(j),
        ref_end=je,
        cigar=merged,
        n_matches=n_matches,
    )
