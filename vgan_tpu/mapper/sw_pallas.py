"""Batched affine Smith-Waterman scoring on device.

The mapper's heavy phase: thousands of (read, candidate-window) pairs
are scored on device; only the per-read winners go through the exact
host-side graph alignment + traceback (mapper/graph_align.py). This is
the "graph-banded SW over unrolled windows" split of SURVEY.md §7.4:
candidate windows are haplotype-linearized, so the DP is a dense
rectangle with no data-dependent control flow.

`sw_scores_core` runs the window-column recurrence as a `lax.scan`
whose carry is the [R+1, B] column (batch pairs on the minor axis, read
positions on the major one); the vertical affine recurrence F is
evaluated exactly per column with a log-depth doubling cummax.
`gather_score_hash` fuses it with the device-side window gather and is
the production entry; `sw_scores_reference` is the host oracle.
Scoring matches mapper/align.py: match +1, mismatch -4, gap open 6,
gap extend 1, full-length bonus 5 at the read's first row (in-DP) and
last row (at the max reduction).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .align import FULL_LENGTH_BONUS, GAP_EXT, GAP_OPEN, MATCH, MISMATCH

NEG = -1e9  # python scalar: jnp constants would be captured as tracers


def sw_scores_reference(read_codes, win_codes, read_len, win_len):
    """Pure-numpy oracle with identical semantics (for testing)."""
    from .align import smith_waterman

    out = np.zeros(len(read_codes), dtype=np.float32)
    for b in range(len(read_codes)):
        q = np.asarray(read_codes[b][: read_len[b]], dtype=np.uint8)
        w = np.asarray(win_codes[b][: win_len[b]], dtype=np.uint8)
        aln = smith_waterman(q, w)
        if aln is None:
            out[b] = 0.0
        else:
            out[b] = aln.score + (
                FULL_LENGTH_BONUS if aln.read_end == len(q) else 0
            )
    return out


def sw_scores_core(read_codes, win_codes, read_len, win_len):
    """Score a batch of read/window pairs: the column recurrence as a
    `lax.scan` over window columns.

    read_codes: [B, R] int32 (255-padded), win_codes: [B, W] int32,
    read_len/win_len: [B] int32. Returns [B] float32 best scores
    (including full-length bonuses). Traceable core; `sw_scores_xla` is
    the jitted entry and `gather_score_hash` fuses it with the
    device-side window gather."""
    B, R = read_codes.shape
    W = win_codes.shape[1]
    rT = jnp.concatenate(
        [jnp.full((1, B), 255, jnp.int32), read_codes.T.astype(jnp.int32)],
        axis=0,
    )  # [R+1, B]
    wT = win_codes.T.astype(jnp.int32)  # [W, B]
    wvalid = jnp.arange(W, dtype=jnp.int32)[:, None] < win_len[None, :]
    rlen = read_len[None, :].astype(jnp.int32)  # [1, B]

    R1 = R + 1
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (R1, B), 0)
    valid_rows = row_ids <= rlen
    ext_w = row_ids.astype(jnp.float32) * GAP_EXT
    neg = jnp.float32(NEG)
    bonus_row1 = jnp.where(row_ids == 1, jnp.float32(FULL_LENGTH_BONUS), 0.0)
    bonus_end = jnp.where(row_ids == rlen, jnp.float32(FULL_LENGTH_BONUS), 0.0)

    def cummax(x):
        n = x.shape[0]
        shift = 1
        while shift < n:
            shifted = jnp.where(
                row_ids < shift, neg, jnp.roll(x, shift, axis=0)
            )
            x = jnp.maximum(x, shifted)
            shift *= 2
        return x

    def one_col(H, E, best, wcol, cvalid):
        s = jnp.where(
            (rT == wcol[None, :]) & (rT < 4),
            jnp.float32(MATCH),
            jnp.float32(MISMATCH),
        )
        h_shift = jnp.where(row_ids == 0, 0.0, jnp.roll(H, 1, axis=0))
        diag = jnp.where(row_ids == 0, neg, h_shift + s + bonus_row1)
        e_new = jnp.maximum(H - GAP_OPEN, E - GAP_EXT)
        h_no_f = jnp.maximum(jnp.maximum(diag, e_new), 0.0)
        a = cummax(h_no_f + ext_w)
        a_shift = jnp.where(row_ids == 0, neg, jnp.roll(a, 1, axis=0))
        f = a_shift - GAP_OPEN - ext_w + GAP_EXT
        h_new = jnp.maximum(h_no_f, f)
        h_new = jnp.where(valid_rows, h_new, 0.0)
        h_new = jnp.where(cvalid[None, :], h_new, H)
        e_new = jnp.where(cvalid[None, :], e_new, E)
        cell = jnp.where(cvalid[None, :], h_new + bonus_end, neg)
        best = jnp.maximum(best, jnp.max(cell, axis=0))
        return h_new, e_new, best

    # CB columns per scan step: the unrolled step body fuses CB column
    # recurrences between carry loads and stores, so the [R+1, B] carry
    # makes a quarter of the round trips through device memory. W is a
    # multiple of 64 by construction (batch_map rounds window widths),
    # so CB always divides it.
    CB = 4 if W % 4 == 0 else 1

    def step(carry, inp):
        H, E, best = carry
        wcols, cvalids = inp  # [CB, B]
        for kk in range(CB):
            H, E, best = one_col(H, E, best, wcols[kk], cvalids[kk])
        return (H, E, best), None

    H0 = jnp.zeros((R1, B), jnp.float32)
    E0 = jnp.full((R1, B), neg)
    best0 = jnp.zeros((B,), jnp.float32)
    (H, E, best), _ = jax.lax.scan(
        step,
        (H0, E0, best0),
        (wT.reshape(W // CB, CB, B), wvalid.reshape(W // CB, CB, B)),
    )
    return best


sw_scores_xla = jax.jit(sw_scores_core)

# complement LUT over the uint8 code alphabet (codes 0..7 complemented,
# everything else — incl. the 255 padding sentinel — identity)
_COMP256 = np.arange(256, dtype=np.uint8)


def _init_comp256():
    from ..utils import dna

    _COMP256[:8] = dna._COMP


_init_comp256()


@partial(jax.jit, static_argnames=("Wmax",))
def gather_score_hash(pc_buf, reads_mat, read_lens, aux, Wmax):
    """One-dispatch mapper device phase: window gather + oriented query
    build + content hash + batched SW scoring.

    Host traffic is tiny index arrays: the path-code pool (`pc_buf`,
    device-cached across batches) and the packed read matrix
    (`reads_mat`, uint8) stay resident while per-candidate traffic is
    one packed [4, Mb] aux array (one host-to-device copy per batch).
    The scoring math is byte-identical to `sw_scores_core`.

    Args (all device/committable):
      pc_buf    [P]        uint8  pooled per-path haplotype codes
      reads_mat [Nb, Rmax] uint8  row r = read r's codes, 255-padded
      read_lens [Nb]       int32
      aux       [4, Mb]    int32/int64: rows = candidate -> read row,
                           pc_buf offset of window start, window length
                           (0 = padding row), strand (1 = revcomp)
      Wmax      static     window width (hash ladders are compile-time
                           constants keyed by it)

    Returns [3, Mb] int32: row 0 = SW scores (f32 bitcast), rows 1-2 =
    window content hashes (the host dedups with these; two independent
    32-bit hashes + (read, strand, wlen) key the dedup groups).
    """
    c_read = aux[0].astype(jnp.int32)
    gbase = aux[1]
    wlen = aux[2].astype(jnp.int32)
    strand = aux[3].astype(jnp.int32)
    from .batch_map import _pows

    p1_np, p2_np = _pows(Wmax)
    p1 = jnp.asarray(np.ascontiguousarray(p1_np))
    p2 = jnp.asarray(np.ascontiguousarray(p2_np))
    Rmax = reads_mat.shape[1]
    jj = jnp.arange(Wmax, dtype=gbase.dtype)
    gpos = jnp.clip(gbase[:, None] + jj[None, :], 0,
                    max(pc_buf.shape[0] - 1, 0))
    wmask = jj[None, :].astype(jnp.int32) < wlen[:, None]
    w8 = jnp.where(wmask, pc_buf[gpos], jnp.uint8(255))
    wi = w8.astype(jnp.int32) + 1
    h1 = jnp.sum(wi * p1[None, :], axis=1, dtype=jnp.int32)
    h2 = jnp.sum(wi * p2[None, :], axis=1, dtype=jnp.int32)

    L = read_lens[c_read].astype(jnp.int32)
    jr = jnp.arange(Rmax, dtype=jnp.int32)
    flip = (strand > 0)[:, None]
    idx = jnp.where(flip, L[:, None] - 1 - jr[None, :], jr[None, :])
    idx = jnp.clip(idx, 0, Rmax - 1)
    rows = reads_mat[c_read]
    vals = jnp.take_along_axis(rows, idx, axis=1)
    vals = jnp.where(flip, jnp.asarray(_COMP256)[vals], vals)
    q8 = jnp.where(jr[None, :] < L[:, None], vals, jnp.uint8(255))

    scores = sw_scores_core(
        q8.astype(jnp.int32), w8.astype(jnp.int32), L, wlen
    )
    return jnp.stack(
        [jax.lax.bitcast_convert_type(scores, jnp.int32), h1, h2]
    )
