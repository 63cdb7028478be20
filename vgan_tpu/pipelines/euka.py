"""euka: bilaterian taxon detection + abundance from ancient eDNA.

Device reformulation of `src/Euka.cpp` + `src/readGAM_Euka.h`.
The reference's fused GAM scorer (readGAM3, `src/readGAM_Euka.h:41-649`)
walks each read base-by-base; here the per-base two-model likelihood is
one vectorized [B, Lmax] element-wise pass on device, with the
damage matrices gathered on the fly from the 5'/3' tables
(models/damage.py) instead of a materialized subDeamDiNuc[L][l] tensor.

Reference quirks preserved (all load-bearing for the bundled tests):
* clade assignment scans every clade's bins and keeps the LAST match;
  no match leaves the read on clade 0 (`src/readGAM_Euka.h:115-140`).
* model-2 mismatch constant 0.25536 (`src/readGAM_Euka.h:423,441`).
* the per-base damage position n is the read coordinate (reverse reads
  count down from L-1) while the base-quality index is the *aligned*
  coordinate m (`src/readGAM_Euka.h:227,264,286`).
* clade_like gets an entry for EVERY mapped read of the clade
  (pre-filter, `src/readGAM_Euka.h:491-492`); the MCMC skips the dummy
  leading 0.0 element.
* detection counts a bin as "zero" when its fractional coverage
  truncates to int 0 (`vector<int> check_for_zero`,
  `src/readGAM_Euka.h:601-610`, `src/Euka.cpp:625-633`), ignores the
  last bin of each clade, and requires:
  #zero-bins <= maxBins, #entropy-qualified bins >= minBins,
  filtered read count >= minFrag.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.lax import Precision
import numpy as np

from ..graph.packed import PackedGraph
from ..graph.reconstruct import reconstruct_graph_sequence
from ..utils import guards
from ..io.gam import Alignment
from ..models import phred
from ..models.damage import DamageModel, dinuc_gather
from ..utils import dna

MODEL2_MISMATCH = 0.25536

# log base frequencies (`src/Euka.cpp:446-450`), indexed by dna code;
# codes without a table entry (gap/softclip/rare) use log 0.25 — the
# reference reads uninitialized memory there.
BASE_FREQ_LOG = np.log(
    np.array([0.362815, 0.207743, 0.116809, 0.312435, 0.25, 0.25, 0.25, 0.25])
)

# transition/transversion table (`src/Euka.cpp:453-468`), [graph, read]
T_T_RATIO = np.full((4, 4), 0.02381)
np.fill_diagonal(T_T_RATIO, 1.0)
T_T_RATIO[0, 2] = T_T_RATIO[2, 0] = 0.95238  # A<->G
T_T_RATIO[1, 3] = T_T_RATIO[3, 1] = 0.95238  # C<->T


@dataclass
class CladeInfo:
    """One line of euka_db.clade (`src/load.cpp:108-157`)."""

    id: int
    name: str
    dist: float
    n_paths: int
    start_node: int
    end_node: int


def load_clade_info(path: str) -> List[CladeInfo]:
    opener = gzip.open if path.endswith(".gz") else open
    out: List[CladeInfo] = []
    with opener(path, "rt") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            assert len(t) == 6, f"clade line must have 6 fields, got {len(t)}"
            out.append(
                CladeInfo(int(t[0]), t[1], float(t[2]), int(t[3]), int(t[4]), int(t[5]))
            )
    return out


def load_clade_chunks(path: str) -> List[List[Tuple[int, int, float]]]:
    """euka_db.bins: name then (start,end,entropy) triplets
    (`src/load.cpp:71-95`)."""
    opener = gzip.open if path.endswith(".gz") else open
    chunks: List[List[Tuple[int, int, float]]] = []
    with opener(path, "rt") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            row = []
            # node bounds are written as floats ("1836.0"); C++ stoi
            # parses the integer prefix
            for j in range(1, len(t) - 2, 3):
                row.append((int(float(t[j])), int(float(t[j + 1])), float(t[j + 2])))
            chunks.append(row)
    return chunks


# ---------------------------------------------------------------------------
# device scorer
# ---------------------------------------------------------------------------
def _score_batch_impl(
    g, r, q, n_pos, L_read, pair_dist, valid, sub5p, sub3p, qtab, bfreq, ttr
):
    """Vectorized two-model per-base scorer.

    g, r: [B, L] dna codes of graph/read aligned strings
    q: [B, L] int quality (aligned coordinate, reference quirk)
    n_pos: [B, L] damage position on the read
    L_read: [B] read length (subDeamDiNuc first index)
    pair_dist: [B] clade average pairwise distance
    valid: [B, L] in-bounds mask
    Returns (in_clade_lik[B], not_in_clade_lik[B]).
    """
    qv = qtab[jnp.clip(q, 0, 99)]  # [B, L]

    is_n = (g == dna.N) | (r == dna.N)
    is_gap = ~is_n & ((g == dna.GAP) | (r == dna.GAP))
    is_rare = ~is_n & ~is_gap & ((g == dna.RARE) | (r == dna.RARE))
    is_soft = ~is_n & ~is_gap & ~is_rare & ((g == dna.SOFTCLIP) | (r == dna.SOFTCLIP))
    is_acgt = ~is_n & ~is_gap & ~is_rare & ~is_soft

    pd = pair_dist[:, None]

    # --- model 1, ACGT: pre-damage x damage, marginalized with seq error
    g4 = jnp.clip(g, 0, 3)
    r4 = jnp.clip(r, 0, 3)
    eye = jnp.arange(4)
    pre = jnp.where(
        g4[..., None] == eye, 1.0 - pd[..., None], pd[..., None] * ttr[g4]
    )  # [B, L, 4]
    D = dinuc_gather(sub5p, sub3p, L_read[:, None], n_pos)  # [B, L, 4, 4]
    post = jnp.einsum(
        "blo,blod->bld", pre, D, precision=Precision.HIGHEST
    )  # [B, L, 4]
    err = jnp.where(r4[..., None] == eye, 1.0 - qv[..., None], qv[..., None] / 3.0)
    marg = jax.scipy.special.logsumexp(
        jnp.log(jnp.maximum(post, 1e-300)) + jnp.log(err), axis=-1
    )
    m1_acgt = marg
    m2_acgt = jnp.where(
        g == r, jnp.log(1.0 - MODEL2_MISMATCH), jnp.log(MODEL2_MISMATCH)
    )

    # --- specials
    bf = bfreq[r]  # N case: log base freq of the read char
    soft_cnt = jnp.cumsum(is_soft.astype(jnp.int32), axis=1)
    m1_soft = jnp.where(soft_cnt % 3 == 0, jnp.log1p(-qv), jnp.log(qv / 3.0))
    m1 = jnp.where(
        is_n,
        bf,
        jnp.where(
            is_gap,
            jnp.log(0.002),
            jnp.where(
                is_rare,
                jnp.log((1.0 - pd) * 0.001),
                jnp.where(is_soft, m1_soft, m1_acgt),
            ),
        ),
    )
    m2 = jnp.where(
        is_n,
        bf,
        jnp.where(
            is_gap,
            jnp.log(0.2),
            jnp.where(
                is_rare,
                jnp.log(0.001),
                jnp.where(is_soft, jnp.log(0.25), m2_acgt),
            ),
        ),
    )
    m1 = jnp.where(valid, m1, 0.0)
    m2 = jnp.where(valid, m2, 0.0)
    return m1.sum(axis=1), m2.sum(axis=1)


_score_batch = jax.jit(_score_batch_impl)


@dataclass
class ReadScore:
    name: str
    clade_idx: int
    in_lik: float
    not_lik: float
    mapping_quality: int
    length: int
    node_ids: List[int]
    n_mappings: int
    passed: bool = False


@dataclass
class EukaResult:
    clades: List[CladeInfo]
    chunks: List[List[Tuple[int, int, float]]]
    coverage: List[List[float]]  # per clade per bin fractional coverage
    counts: np.ndarray  # filtered read count per clade
    n_mapped: np.ndarray  # mapped read count per clade (clade_like size)
    clade_like: List[List[float]]  # per clade, per mapped read
    insert_sizes: List[List[int]]
    frag_names: List[List[str]]
    baseshift: np.ndarray  # [n_clades, 2*lengthToProf, 16]
    detected: List[int] = field(default_factory=list)


def detect_clades(
    chunks,
    coverage,
    counts,
    min_frag: int,
    min_bins: int,
    max_bins: int,
    entropy_threshold: float,
) -> List[int]:
    """Detection filter (`src/Euka.cpp:625-633`): a clade is detected
    when enough high-entropy bins are covered (int-truncation quirk
    preserved) and its filtered read count reaches min_frag. Shared by
    the object/columnar scorers and the multi-host merge (which must
    re-run detection on the globally summed accumulators)."""
    detected: List[int] = []
    for i in range(len(chunks)):
        qualified = [
            int(coverage[i][k])
            for k in range(len(chunks[i]) - 1)
            if chunks[i][k][2] > entropy_threshold
        ]
        n_zero = sum(1 for v in qualified if v == 0)
        if (
            n_zero > max_bins
            or len(qualified) < min_bins
            or counts[i] < min_frag
        ):
            continue
        detected.append(i)
    return detected


def assign_clade(chunks, first_node: int) -> Tuple[int, float]:
    """Bin lookup by first node id; LAST matching clade wins and the
    default is clade 0 (`src/readGAM_Euka.h:115-140`)."""
    c_n, entropy = 0, 0.0
    for i, row in enumerate(chunks):
        for lo, hi, ent in row:
            if lo <= first_node <= hi:
                c_n = i
                entropy = ent
    return c_n, entropy


def clade_lookup_table(chunks) -> np.ndarray:
    """Paint-once node-id -> clade table. Bins painted in scan order so
    later bins overwrite earlier ones — identical to assign_clade's
    last-match-wins loop, O(1) per lookup."""
    max_id = 0
    for row in chunks:
        for lo, hi, _ in row:
            max_id = max(max_id, hi)
    table = np.zeros(max_id + 2, dtype=np.int32)
    for i, row in enumerate(chunks):
        for lo, hi, _ in row:
            table[lo : hi + 1] = i
    return table


def baseshift_update(counts: np.ndarray, graph_seq: str, read_seq: str, ltp: int):
    """Baseshift::baseshift_calc (`src/baseshift.cpp:57-88`): 16-cell
    substitution counts at the first/last lengthToProf positions."""
    n = len(graph_seq)
    for p in range(2 * ltp):
        pos = p if p < ltp else n + (p - 2 * ltp)
        if pos < 0 or pos >= n or pos >= len(read_seq):
            continue  # short-sequence guard (reference reads OOB here)
        gb, rb = graph_seq[pos].upper(), read_seq[pos].upper()
        if gb in "SI-N" or rb in "SI-N":
            continue
        gi, ri = "ACGT".find(gb), "ACGT".find(rb)
        if gi < 0 or ri < 0:
            continue
        counts[p, gi * 4 + ri] += 1


def score_read_reference(graph, clades, chunks, a, dm):
    """Literal transcription of the readGAM3 per-base loop
    (`src/readGAM_Euka.h:184-492`) for one alignment: the plain oracle
    of the device scorer. Returns (in_clade, not_in_clade) log-likes."""
    qscore = phred.qscore_vec()
    graph_seq, read_seq, _ = reconstruct_graph_sequence(graph, a.path, a.sequence)
    first = a.path.mappings[0].position.node_id
    c_n, _ = assign_clade(chunks, first)
    pd = clades[c_n].dist
    isrev = a.path.mappings[0].position.is_reverse
    Lseq = len(a.sequence)
    n = Lseq - 1 if isrev else 0
    in_l = not_l = 0.0
    soft = 0
    qual = list(a.quality) + [0] * len(graph_seq)
    for m in range(len(graph_seq)):
        gb, rb = graph_seq[m], read_seq[m]
        bq = qual[m]
        if gb == "N" or rb == "N":
            ll = l2 = BASE_FREQ_LOG["ACGTN-S?".find(rb) if rb in "ACGTN-S" else 7]
        elif gb == "-" or rb == "-":
            ll, l2 = np.log(0.002), np.log(0.2)
        elif gb in "WMKRYBDHV" or rb in "WMKRYBDHV":
            ll, l2 = np.log((1 - pd) * 0.001), np.log(0.001)
        elif gb == "S" or rb == "S":
            soft += 1
            q = qscore[bq]
            ll = np.log(1 - q) if soft % 3 == 0 else np.log(q / 3)
            l2 = np.log(0.25)
        else:
            q = qscore[bq]
            pre = np.empty(4)
            for bpo, c in enumerate("ACGT"):
                pre[bpo] = (1 - pd) if c == gb else pd * T_T_RATIO["ACGT".find(gb), bpo]
            D = dm.dinuc(min(max(Lseq, 1), 1000), n)
            post = pre @ D
            terms = []
            for bpd, c in enumerate("ACGT"):
                e = (1 - q) if c == rb else q / 3
                terms.append(np.log(post[bpd] * e))
            mx = max(terms)
            ll = mx + np.log(sum(np.exp(t - mx) for t in terms))
            l2 = np.log(1 - MODEL2_MISMATCH) if gb == rb else np.log(
                MODEL2_MISMATCH
            )
        in_l += ll
        not_l += l2
        if rb != "-":
            n = n - 1 if isrev else n + 1
    return in_l, not_l


class EukaScorer:
    """Host-side batching wrapper around the device scorer."""

    def __init__(
        self,
        graph: PackedGraph,
        clades: List[CladeInfo],
        chunks: List[List[Tuple[int, int, float]]],
        damage: Optional[DamageModel] = None,
        length_to_prof: int = 5,
    ):
        self.graph = graph
        self.clades = clades
        self.chunks = chunks
        self.damage = damage or DamageModel.none()
        self.ltp = length_to_prof
        self.sub5p, self.sub3p = self.damage.tables(jnp.float64)
        self.qtab = jnp.asarray(phred.qscore_vec())
        self.bfreq = jnp.asarray(BASE_FREQ_LOG)
        self.ttr = jnp.asarray(T_T_RATIO)
        self._clade_table = clade_lookup_table(chunks)

    def score(
        self,
        alignments: Sequence[Alignment],
        min_mq: int = 29,
        min_frag: int = 10,
        min_bins: int = 6,
        max_bins: int = 0,
        entropy_threshold: float = 1.17,
        batch_size: int = 2048,
    ) -> EukaResult:
        nC = len(self.clades)
        coverage = [[0.0] * len(row) for row in self.chunks]
        counts = np.zeros(nC, dtype=np.int64)
        n_mapped = np.zeros(nC, dtype=np.int64)
        clade_like: List[List[float]] = [[] for _ in range(nC)]
        insert_sizes: List[List[int]] = [[] for _ in range(nC)]
        frag_names: List[List[str]] = [[] for _ in range(nC)]
        baseshift = np.zeros((nC, 2 * self.ltp, 16), dtype=np.int64)
        incorrect = phred.incorrect_mapping_vec()

        mapped = [a for a in alignments if a.identity != 0 and a.path.mappings]
        for off in range(0, len(mapped), batch_size):
            batch = mapped[off : off + batch_size]
            recon = [
                reconstruct_graph_sequence(self.graph, a.path, a.sequence)
                for a in batch
            ]
            in_lik, not_lik = self._score_device(batch, recon)

            for a, (graph_seq, read_seq, _), il, nl in zip(
                batch, recon, in_lik, not_lik
            ):
                first_node = a.path.mappings[0].position.node_id
                c_n = self._lookup_clade(first_node)
                n_mapped[c_n] += 1
                baseshift_update(baseshift[c_n], graph_seq, read_seq, self.ltp)

                map_q = 1.0 - incorrect[min(a.mapping_quality, 99)]
                # P(model1 | data) via logsumexp (`src/readGAM_Euka.h:491`)
                denom = np.logaddexp(il, nl)
                like = map_q * np.exp(il - denom)
                clade_like[c_n].append(float(like))

                if (il - nl) > 1 and a.mapping_quality > min_mq:
                    counts[c_n] += 1
                    insert_sizes[c_n].append(len(a.sequence))
                    frag_names[c_n].append(a.name)
                    n_mappings = len(a.path.mappings)
                    for m in a.path.mappings:
                        nid = m.position.node_id
                        for j, (lo, hi, _e) in enumerate(self.chunks[c_n]):
                            if lo <= nid <= hi:
                                coverage[c_n][j] += 1.0 / n_mappings

        detected = detect_clades(
            self.chunks, coverage, counts, min_frag, min_bins, max_bins,
            entropy_threshold,
        )

        return EukaResult(
            clades=self.clades,
            chunks=self.chunks,
            coverage=coverage,
            counts=counts,
            n_mapped=n_mapped,
            clade_like=clade_like,
            insert_sizes=insert_sizes,
            frag_names=frag_names,
            baseshift=baseshift,
            detected=detected,
        )

    def _lookup_clade(self, node_id: int) -> int:
        if 0 <= node_id < len(self._clade_table):
            return int(self._clade_table[node_id])
        return 0

    # ------------------------------------------------------------------
    def score_table(
        self,
        table,
        min_mq: int = 29,
        min_frag: int = 10,
        min_bins: int = 6,
        max_bins: int = 0,
        entropy_threshold: float = 1.17,
    ) -> EukaResult:
        """Columnar twin of score(): consumes the mapper's
        AlignmentTable directly — C++ batch reconstruction, vectorized
        [B, L] assembly, vectorized baseshift/accept/coverage — with
        identical outputs (tests/test_euka.py parity)."""
        from .hc_columnar import reconstruct_table

        nC = len(self.clades)
        t = table.select((table.identity != 0) & (table.nmap > 0))
        coverage = [[0.0] * len(row) for row in self.chunks]
        counts = np.zeros(nC, dtype=np.int64)
        n_mapped_v = np.zeros(nC, dtype=np.int64)
        clade_like: List[List[float]] = [[] for _ in range(nC)]
        insert_sizes: List[List[int]] = [[] for _ in range(nC)]
        frag_names: List[List[str]] = [[] for _ in range(nC)]
        baseshift = np.zeros((nC, 2 * self.ltp, 16), dtype=np.int64)
        if t.n == 0:
            return EukaResult(
                clades=self.clades, chunks=self.chunks, coverage=coverage,
                counts=counts, n_mapped=n_mapped_v, clade_like=clade_like,
                insert_sizes=insert_sizes, frag_names=frag_names,
                baseshift=baseshift, detected=[],
            )
        B = t.n
        g_cat, g_off, g_len, r_cat, r_off, r_len, _sz, _so, _sl = (
            reconstruct_table(self.graph, t)
        )
        Lmax = max(8, -(-int(g_len.max()) // 32) * 32)
        col = np.arange(Lmax, dtype=np.int64)
        gpos = g_off[:-1][:, None] + col[None, :]
        valid = col[None, :] < g_len[:, None]
        np.clip(gpos, 0, max(len(g_cat) - 1, 0), out=gpos)
        g = np.where(valid, g_cat[gpos], 0).astype(np.int32)
        rpos = r_off[:-1][:, None] + col[None, :]
        in_r = col[None, :] < r_len[:, None]
        np.clip(rpos, 0, max(len(r_cat) - 1, 0), out=rpos)
        r = np.where(valid & in_r, r_cat[rpos], 0).astype(np.int32)
        # quality at the ALIGNED coordinate (reference quirk)
        qlen = np.array([len(qb) for qb in t.quals], dtype=np.int64)
        q_off2 = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(np.maximum(qlen, 1), out=q_off2[1:])
        q_cat = np.zeros(int(q_off2[-1]), dtype=np.uint8)
        for i, qb in enumerate(t.quals):
            if qb:
                q_cat[q_off2[i] : q_off2[i] + len(qb)] = np.frombuffer(
                    qb, dtype=np.uint8
                )
        qpos = q_off2[:-1][:, None] + col[None, :]
        in_q = col[None, :] < qlen[:, None]
        np.clip(qpos, 0, max(len(q_cat) - 1, 0), out=qpos)
        q = np.where(valid & in_q, q_cat[qpos], 0).astype(np.int32)
        # damage position: non-gap read chars before each position;
        # minus-strand reads count down (`src/readGAM_Euka.h:211-216`)
        nongap = ((r != dna.GAP) & valid).astype(np.int64)
        before = np.cumsum(nongap, axis=1) - nongap
        first_m = t.map_off[:-1]
        isrev = t.m_rev[np.minimum(first_m, len(t.m_rev) - 1)].astype(bool)
        Lseq = np.array([len(s) for s in t.seqs], dtype=np.int64)
        n_pos = np.where(
            isrev[:, None], Lseq[:, None] - 1 - before, before
        ).astype(np.int32)
        L_read = np.clip(Lseq, 1, 1000).astype(np.int32)
        first_node = t.m_node[np.minimum(first_m, len(t.m_node) - 1)]
        ct = self._clade_table
        c_n = np.where(
            (first_node >= 0) & (first_node < len(ct)),
            ct[np.clip(first_node, 0, len(ct) - 1)],
            0,
        ).astype(np.int64)
        dist_tab = np.array([c.dist for c in self.clades], dtype=np.float64)
        pair_dist = dist_tab[c_n]
        il_d, nl_d = self._score_arrays(
            jnp.asarray(g), jnp.asarray(r), jnp.asarray(q),
            jnp.asarray(n_pos), jnp.asarray(L_read),
            jnp.asarray(pair_dist), jnp.asarray(valid),
        )
        # ONE blocked download: each np.asarray is a device-to-host
        # copy and a sync, and il/nl are tiny
        both = np.asarray(jnp.stack([il_d, nl_d]))
        il, nl = both[0], both[1]
        guards.check_loglik(il, "euka model-1 log-likelihood")
        guards.check_loglik(nl, "euka model-2 log-likelihood")

        # --- vectorized per-read roll-ups (identical to score())
        np.add.at(n_mapped_v, c_n, 1)
        # baseshift counts at the first/last ltp ALIGNED positions
        p = np.arange(2 * self.ltp)
        pos = np.where(
            p[None, :] < self.ltp,
            p[None, :],
            g_len[:, None] + (p[None, :] - 2 * self.ltp),
        )
        okp = (pos >= 0) & (pos < g_len[:, None]) & (pos < r_len[:, None])
        posc = np.clip(pos, 0, Lmax - 1)
        rows = np.arange(B)[:, None]
        gb = g[rows, posc]
        rb = r[rows, posc]
        okp &= (gb < 4) & (rb < 4)
        bi, pi = np.nonzero(okp)
        np.add.at(
            baseshift,
            (c_n[bi], pi, gb[bi, pi] * 4 + rb[bi, pi]),
            1,
        )
        incorrect = phred.incorrect_mapping_vec()
        map_q = 1.0 - incorrect[np.minimum(t.mq, 99)]
        denom = np.logaddexp(il, nl)
        like = map_q * np.exp(il - denom)
        accept = ((il - nl) > 1) & (t.mq > min_mq)
        for i in range(B):
            clade_like[c_n[i]].append(float(like[i]))
        acc_idx = np.nonzero(accept)[0]
        np.add.at(counts, c_n[acc_idx], 1)
        for i in acc_idx:
            insert_sizes[c_n[i]].append(int(Lseq[i]))
            frag_names[c_n[i]].append(t.names[i])
        # coverage: every matching bin gets 1/n_mappings per mapping
        nmap_r = t.nmap.astype(np.int64)
        if len(acc_idx):
            # flat (read, mapping) pairs of accepted reads
            pair_read = np.repeat(acc_idx, nmap_r[acc_idx])
            starts = t.map_off[acc_idx]
            from ..mapper.batch_map import AlignmentTable

            mrows = AlignmentTable._ranges(starts, nmap_r[acc_idx])
            nid = t.m_node[mrows]
            w_frac = 1.0 / nmap_r[pair_read]
            pc = c_n[pair_read]
            for c in np.unique(pc):
                sel = pc == c
                ch = self.chunks[c]
                if not ch:
                    continue
                lo = np.array([x[0] for x in ch], dtype=np.int64)
                hi = np.array([x[1] for x in ch], dtype=np.int64)
                hitmat = (nid[sel][:, None] >= lo[None, :]) & (
                    nid[sel][:, None] <= hi[None, :]
                )
                contrib = (hitmat * w_frac[sel][:, None]).sum(axis=0)
                for j in range(len(ch)):
                    coverage[c][j] += float(contrib[j])

        detected = detect_clades(
            self.chunks, coverage, counts, min_frag, min_bins, max_bins,
            entropy_threshold,
        )
        return EukaResult(
            clades=self.clades, chunks=self.chunks, coverage=coverage,
            counts=counts, n_mapped=n_mapped_v, clade_like=clade_like,
            insert_sizes=insert_sizes, frag_names=frag_names,
            baseshift=baseshift, detected=detected,
        )

    def score_table_stream(
        self,
        tables,
        min_mq: int = 29,
        min_frag: int = 10,
        min_bins: int = 6,
        max_bins: int = 0,
        entropy_threshold: float = 1.17,
    ) -> EukaResult:
        """Streaming twin of score_table: consumes an iterator of
        AlignmentTables (the mapper's map_table_chunks generator) and
        accumulates per-chunk partial results, so the scorer's host
        assembly + device dispatch overlap the next chunks' mapping —
        the euka analogue of hc_columnar.score_table_stream (r5).
        Every roll-up is additive and chunks arrive in read order, so
        ints/lists merge exactly; per-bin coverage sums per-chunk
        partials (same values up to fp summation order — parity-tested
        with allclose). Detection runs once on the merged result."""
        agg: EukaResult = None
        nC = len(self.clades)
        for t in tables:
            res = self.score_table(
                t, min_mq=min_mq, min_frag=min_frag, min_bins=1,
                max_bins=max_bins, entropy_threshold=entropy_threshold,
            )
            if agg is None:
                agg = res
                continue
            agg.counts += res.counts
            agg.n_mapped += res.n_mapped
            agg.baseshift += res.baseshift
            for c in range(nC):
                agg.clade_like[c].extend(res.clade_like[c])
                agg.insert_sizes[c].extend(res.insert_sizes[c])
                agg.frag_names[c].extend(res.frag_names[c])
                for j in range(len(agg.coverage[c])):
                    agg.coverage[c][j] += res.coverage[c][j]
        if agg is None:
            return EukaResult(
                clades=self.clades, chunks=self.chunks,
                coverage=[[0.0] * len(row) for row in self.chunks],
                counts=np.zeros(nC, dtype=np.int64),
                n_mapped=np.zeros(nC, dtype=np.int64),
                clade_like=[[] for _ in range(nC)],
                insert_sizes=[[] for _ in range(nC)],
                frag_names=[[] for _ in range(nC)],
                baseshift=np.zeros((nC, 2 * self.ltp, 16), dtype=np.int64),
                detected=[],
            )
        agg.detected = detect_clades(
            self.chunks, agg.coverage, agg.counts, min_frag, min_bins,
            max_bins, entropy_threshold,
        )
        return agg

    # ------------------------------------------------------------------
    def _score_device(self, batch, recon):
        B = len(batch)
        Lmax = max(len(r[0]) for r in recon)
        Lmax = max(Lmax, 8)
        g = np.zeros((B, Lmax), dtype=np.int32)
        r = np.zeros((B, Lmax), dtype=np.int32)
        q = np.zeros((B, Lmax), dtype=np.int32)
        n_pos = np.zeros((B, Lmax), dtype=np.int32)
        L_read = np.zeros(B, dtype=np.int32)
        pair_dist = np.zeros(B, dtype=np.float64)
        valid = np.zeros((B, Lmax), dtype=bool)

        for b, (a, (graph_seq, read_seq, _)) in enumerate(zip(batch, recon)):
            L = len(graph_seq)
            gc = dna.encode(graph_seq)
            rc = dna.encode(read_seq)
            g[b, :L] = gc
            r[b, :L] = rc
            qual = np.frombuffer(a.quality, dtype=np.uint8)
            # quality at the ALIGNED coordinate m (reference quirk);
            # out-of-range -> 0
            qm = np.zeros(L, dtype=np.int32)
            qm[: min(L, len(qual))] = qual[: min(L, len(qual))]
            q[b, :L] = qm
            # damage position: counts read (non '-') chars, reverse
            # reads count down from len(seq)-1 (`src/readGAM_Euka.h:211-216`)
            isrev = a.path.mappings[0].position.is_reverse
            nongap = (rc != dna.GAP).astype(np.int64)
            before = np.concatenate([[0], np.cumsum(nongap)[:-1]])
            Lseq = len(a.sequence)
            n_pos[b, :L] = (Lseq - 1 - before) if isrev else before
            # subDeamDiNuc first index: read length, clamped to table
            L_read[b] = min(max(Lseq, 1), 1000)
            first_node = a.path.mappings[0].position.node_id
            c_n = self._lookup_clade(first_node)
            pair_dist[b] = self.clades[c_n].dist
            valid[b, :L] = True

        return self._score_arrays(g, r, q, n_pos, L_read, pair_dist, valid)

    def _score_arrays(self, g, r, q, n_pos, L_read, pair_dist, valid):
        from ..parallel.mesh import auto_mesh

        mesh = auto_mesh()
        if mesh is not None:
            # production multi-chip path: reads shard over the mesh
            # (SURVEY §2.9 data-parallel row; replaces euka's OpenMP
            # read loop)
            from ..parallel.mesh import shard_euka_batch, sharded_euka_score_fn

            fn = getattr(self, "_sharded_fn", None)
            if fn is None or getattr(self, "_sharded_mesh", None) is not mesh:
                fn = sharded_euka_score_fn(mesh)
                self._sharded_fn = fn
                self._sharded_mesh = mesh
            (gs, rs, qs, ns, Ls, ps, vs), B0 = shard_euka_batch(
                mesh, g, r, q, n_pos, L_read, pair_dist, valid
            )
            il, nl = fn(
                gs, rs, qs, ns, Ls, ps, vs,
                self.sub5p, self.sub3p, self.qtab, self.bfreq, self.ttr,
            )
            il, nl = np.asarray(il)[:B0], np.asarray(nl)[:B0]
        else:
            il, nl = _score_batch(
                jnp.asarray(g),
                jnp.asarray(r),
                jnp.asarray(q),
                jnp.asarray(n_pos),
                jnp.asarray(L_read),
                jnp.asarray(pair_dist),
                jnp.asarray(valid),
                self.sub5p,
                self.sub3p,
                self.qtab,
                self.bfreq,
                self.ttr,
            )
            il, nl = np.asarray(il), np.asarray(nl)
        # batch-boundary equivalent of the reference's per-base NaN/Inf
        # gate (`src/readGAM_Euka.h` throws on bad log-likes)
        guards.check_loglik(il, "euka model-1 log-likelihood")
        guards.check_loglik(nl, "euka model-2 log-likelihood")
        return il, nl


def compute_init_vec(counts: np.ndarray, detected: List[int]) -> np.ndarray:
    """`Euka::compute_init_vec` (`src/compute_init_vec.cpp:9-84`):
    detected-taxa read-count proportions."""
    c = counts[np.array(detected, dtype=np.int64)]
    total = c.sum()
    return c / total if total > 0 else np.full(len(c), 1.0 / max(len(c), 1))
