"""Device-batched keelime overlap scoring (SURVEY.md §7.8: "overlap
scoring as a batched device kernel ... in RY+damage space, keep graph
assembly logic on host").

The reference scores candidate read pairs one at a time on the host
(`get_overlap_length_and_score`, `src/assembly.cpp:523-610`). Here all
candidate pairs from the density map score in ONE device pass:

  scores[n, s] = sum_j TABLE[a[n, s+j], b[n, j]]   for every start s,

where TABLE is the combined calculate_match_score − basesMatch-penalty
char-pair table (`src/assembly.cpp:323-486`) and the per-start overlap
length is min(len_b, len_a − s). The [N, S] score matrix comes back to
the host, where the reference's exact winner rule (longest qualifying
overlap, ties by score) picks the result — bit-identical to the
sequential scorer (tests/test_keelime.py).

Shapes fed to the jitted kernel are bucketed (N to the chunk size,
La/Lb up to multiples of 64) so repeated calls with ragged batches
reuse one compiled executable instead of recompiling per shape.

The inner loop is a diagonal-band contraction of the pair-score tensor
M[n, i, j] = TABLE[a[n, i], b[n, j]]: an elementwise gather plus a
scan of shifted row-sums — elementwise work with static shapes.
"""
from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .keelime import _COMBINED, _enc

PAD = 0  # padded char code; TABLE[0, x] = 0 contribution via masking


@partial(jax.jit, static_argnames=())
def _overlap_scores_device(a, b, len_a, len_b, table):
    """a: [N, La] uint8 char codes (latin-1 bytes), b: [N, Lb];
    len_a/len_b: [N]. Returns scores [N, La] where scores[n, s] is the
    overlap score of b[n] placed at start s in a[n] (positions past
    either length contribute 0)."""
    N, La = a.shape
    Lb = b.shape[1]
    j = jnp.arange(Lb)
    valid_b = j[None, :] < len_b[:, None]  # [N, Lb]

    def score_at(s):
        # a chars at positions s..s+Lb-1 (clamped; masked past len_a)
        ia = s + j  # [Lb]
        in_a = ia[None, :] < len_a[:, None]
        ag = a[:, jnp.minimum(ia, La - 1)]  # [N, Lb]
        pair = table[ag, b]  # [N, Lb]
        m = valid_b & in_a
        return jnp.where(m, pair, 0.0).sum(axis=1)

    starts = jnp.arange(La)
    scores = jax.vmap(score_at, out_axes=1)(starts)  # [N, La]
    return scores


def overlap_scores_batch(
    pairs: Sequence[Tuple[str, str]],
    min_olen: int,
    min_score: float,
    chunk: int = 4096,
) -> List[Tuple[int, float]]:
    """Reference-exact (length, score) for every (a, b) pair, scored on
    device in chunks. Winner selection per get_overlap_length_and_score
    (`src/assembly.cpp:585-597`): among starts with olen >= min_olen
    and score >= min_score, maximize olen, ties by score."""
    out: List[Tuple[int, float]] = []
    table = jnp.asarray(_COMBINED, dtype=jnp.float32)
    i = 0

    def _bucket(x: int, q: int = 64) -> int:
        return max(q, -(-x // q) * q)

    while i < len(pairs):
        batch = pairs[i : i + chunk]
        nb = len(batch)
        # bucket shapes: one compile per (chunk, La-bucket, Lb-bucket)
        La = _bucket(max(len(a) for a, _ in batch))
        Lb = _bucket(max(len(b) for _, b in batch))
        N = chunk if nb == chunk else _bucket(nb, 256)
        A = np.zeros((N, La), dtype=np.uint8)
        B = np.zeros((N, Lb), dtype=np.uint8)
        la = np.zeros(N, dtype=np.int32)
        lb = np.zeros(N, dtype=np.int32)
        for n, (a, b) in enumerate(batch):
            ea, eb = _enc(a), _enc(b)
            A[n, : len(ea)] = ea
            B[n, : len(eb)] = eb
            la[n] = len(ea)
            lb[n] = len(eb)
        # f32 download is exact: scores are multiples of 0.5 bounded by
        # 12*Lb, far under the 2^24 integer range
        S = np.asarray(
            _overlap_scores_device(
                jnp.asarray(A), jnp.asarray(B),
                jnp.asarray(la), jnp.asarray(lb), table,
            )
        )[:nb].astype(np.float64)  # [nb, La]
        starts = np.arange(La)
        olen = np.minimum(lb[:nb, None], la[:nb, None] - starts[None, :])
        ok = (
            (olen >= min_olen)
            & (S >= min_score)
            & (starts[None, :] <= (la[:nb, None] - min_olen))
        )
        # maximize olen then score, fully vectorized: first the longest
        # qualifying olen per row, then the best score at that olen
        ol_ok = np.where(ok, olen, -1)
        best_len = ol_ok.max(axis=1)  # -1 when no qualifier
        at_best = ok & (olen == best_len[:, None])
        sc = np.where(at_best, S, -np.inf).max(axis=1)
        has = best_len >= 0
        out.extend(
            (int(l), float(s)) if h else (0, 0.0)
            for h, l, s in zip(has, best_len, sc)
        )
        i += chunk
    return out
