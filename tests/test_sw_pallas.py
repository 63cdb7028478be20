"""Batched device SW scorer (sw_scores_xla / gather_score_hash) vs the
host oracle."""
import numpy as np
import pytest

from vgan_tpu.mapper.sw_pallas import (
    gather_score_hash,
    sw_scores_reference,
    sw_scores_xla,
)
from vgan_tpu.utils import dna


def _make_batch(rng, B=16, R=64, W=128):
    read = np.full((B, R), 255, dtype=np.int32)
    win = np.full((B, W), 255, dtype=np.int32)
    rlen = rng.integers(20, R, size=B).astype(np.int32)
    wlen = rng.integers(60, W, size=B).astype(np.int32)
    for b in range(B):
        w = rng.integers(0, 4, size=wlen[b])
        win[b, : wlen[b]] = w
        # plant the read inside the window with mutations/indels
        start = rng.integers(0, max(1, wlen[b] - rlen[b])) if wlen[b] > rlen[b] else 0
        r = w[start : start + rlen[b]].copy()
        if len(r) < rlen[b]:
            r = np.concatenate([r, rng.integers(0, 4, size=rlen[b] - len(r))])
        mut = rng.random(rlen[b]) < 0.05
        r[mut] = rng.integers(0, 4, size=int(mut.sum()))
        read[b, : rlen[b]] = r
    return read, win, rlen, wlen


def _unrelated_batch(rng, B=8, R=48, W=96):
    read = rng.integers(0, 4, size=(B, R)).astype(np.int32)
    win = rng.integers(0, 4, size=(B, W)).astype(np.int32)
    return read, win, np.full(B, R, np.int32), np.full(B, W, np.int32)


def _check_gather_score_hash(rng):
    """The fused gather path: windows cut from a pooled path-code buffer,
    reverse-strand candidates scored on the read's reverse complement,
    and padding rows (window length 0) scoring like an empty window."""
    Wmax, Rmax = 128, 64
    read, win, rlen, wlen = _make_batch(rng, B=12, R=Rmax, W=Wmax)
    strand = (np.arange(12) % 3 == 1).astype(np.int64)
    wlen[-2:] = 0  # padding rows
    pool, gbase = [], []
    for b in range(12):
        gbase.append(sum(len(p) for p in pool))
        pool.append(win[b, : wlen[b]].astype(np.uint8))
    pc_buf = np.concatenate(pool + [np.zeros(8, np.uint8)])
    reads_mat = read.astype(np.uint8)  # row b is read b, 255-padded
    aux = np.stack([np.arange(12), np.asarray(gbase), wlen, strand]).astype(np.int64)
    out = np.asarray(gather_score_hash(pc_buf, reads_mat, rlen, aux, Wmax=Wmax))
    got = out[0].view(np.float32)
    q = read.copy()
    for b in np.nonzero(strand)[0]:
        q[b, : rlen[b]] = dna.revcomp_codes(read[b, : rlen[b]].astype(np.uint8))
    want = sw_scores_reference(q, win, rlen, wlen)
    np.testing.assert_array_equal(got, want)
    # equal window contents hash equal; the two padding rows are equal
    assert out[1, -1] == out[1, -2] and out[2, -1] == out[2, -2]


@pytest.mark.parametrize("case", [0, 1, 2, 3, "unrelated", "gather"])
def test_xla_twin_matches_oracle(case):
    """Scores are small integers in f32, so the device and the oracle
    agree exactly."""
    if case == "gather":
        _check_gather_score_hash(np.random.default_rng(11))
        return
    if case == "unrelated":
        read, win, rlen, wlen = _unrelated_batch(np.random.default_rng(7))
    else:
        read, win, rlen, wlen = _make_batch(np.random.default_rng(case))
    got = np.asarray(sw_scores_xla(read, win, rlen, wlen))
    want = sw_scores_reference(read, win, rlen, wlen)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_sw_on_gpu_matches_oracle(gpu):
    """The scan compiled for the card, at the benchmark's window shape
    (rows checked against the host oracle)."""
    rng = np.random.default_rng(0)
    read, win, rlen, wlen = _make_batch(rng, B=256, R=128, W=256)
    got = np.asarray(sw_scores_xla(read, win, rlen, wlen))
    np.testing.assert_array_equal(got, sw_scores_reference(read, win, rlen, wlen))
