"""HaploCart: mtDNA haplogroup classification.

Device reformulation of `src/HaploCart.cpp` + `src/update_likelihood.cpp`
+ `src/process_mapping.cpp`.

Key observation driving the design: the reference's innermost loop over
all paths (`src/process_mapping.cpp:54-88`) adds, per mapping m, a
*path-independent* scalar A_m to every supported path and a
*path-independent* scalar B_m to every unsupported path. Hence

    final_vec = (sum_m B_m) * 1  +  c^T S,     c[node] = sum_{m on node} (A_m - B_m)

where S is the [n_nodes, n_paths] support bitmatrix. The reads x bases
per-base probability math produces the per-mapping scalars (elementwise);
the path dimension collapses to ONE matrix-vector product against S
(one contraction) — instead of the reference's reads x mappings x 5,179
scalar loop (`src/HaploCart.cpp:408-421`).

Reference quirks preserved for output parity (documented inline):
* process_mapping receives the FULL reconstructed read string as
  `mapping_seq`, so base j of every mapping is compared against read
  base j *from the read start* (`src/update_likelihood.cpp:46` passes
  `algnseq`); quality scores, by contrast, are correctly sliced.
* the unsupported-path penalty iterates over the whole
  `quality_scores` vector (length = remaining read), not the mapping
  (`src/process_mapping.cpp:10`), and its `counter % 4 == 4` match
  cycle is never true so every base is scored as a mismatch.
* `get_p_no_seq_error_mapping` returns the *error* probability for
  matches and (1 - error) for mismatches (`src/get_p_obs_base.cpp:14-23`).
* mutation-model integer-division quirks live in models/mutation.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.packed import PackedGraph
from ..graph.reconstruct import reconstruct_graph_sequence
from ..io.gam import Alignment
from ..models import mutation, phred
from ..utils import guards
from ..utils import dna

_LOG_QUARTER = float(np.log(0.25))


@dataclass
class HaplocartDB:
    """Graph + sidecars (`src/load.cpp`), packed for device use."""

    graph: PackedGraph
    path_names: List[str]
    # pangenome coordinate of each node (node index -> rCRS base, +1
    # offset already applied as in load_pangenome_map `src/load.cpp:37`)
    pangenome_base: np.ndarray
    # per-rCRS-position mappability (GenMap scores, `src/load.cpp:6-24`)
    mappabilities: np.ndarray
    parents: Dict[str, List[str]] = field(default_factory=dict)
    children: Dict[str, List[str]] = field(default_factory=dict)

    def __post_init__(self):
        self.match_prob = mutation.match_prob_table(
            max(mutation.PANGENOME_LEN, int(self.pangenome_base.max()) + 1)
        )
        self.qscore = phred.qscore_vec()
        self.incorrect_map = phred.incorrect_mapping_vec()
        if len(self.mappabilities) < len(self.match_prob):
            self.mappabilities = np.concatenate(
                [
                    self.mappabilities,
                    np.ones(len(self.match_prob) - len(self.mappabilities)),
                ]
            )
        # device-resident support matrix
        self.support_f32 = jnp.asarray(self.graph.path_support, jnp.float32)
        self.support_f64 = jnp.asarray(self.graph.path_support, jnp.float64)

    @property
    def n_paths(self) -> int:
        return len(self.path_names)


# ---------------------------------------------------------------------------
# sidecar loaders (file formats of `src/load.cpp`)
# ---------------------------------------------------------------------------
def load_mappabilities(path: str) -> np.ndarray:
    import gzip

    vals: List[float] = []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            t = line.split()
            if len(t) < 4:
                continue
            vals.extend([float(t[3])] * (int(t[2]) - int(t[1])))
    return np.array(vals, dtype=np.float64)


def load_pangenome_map(path: str) -> Dict[str, int]:
    import gzip

    out: Dict[str, int] = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            t = line.split()
            if len(t) >= 2:
                out[t[0]] = int(t[1]) + 1
    return out


def load_parents_children(path: str) -> Dict[str, List[str]]:
    import gzip

    out: Dict[str, List[str]] = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            out[t[0]] = [x for x in t[1:] if "[" not in x]
    return out


# ---------------------------------------------------------------------------
# duplicate removal (`src/rmdup.cpp:20-124`)
# ---------------------------------------------------------------------------
def remove_duplicates(alignments: Sequence[Alignment]) -> List[Alignment]:
    """Keep the first read per identical start coordinate
    (node id, offset) for single-end reads; paired reads additionally
    compare the final mapping's coordinate. (The reference indexes
    mapping[n] out of bounds for the stop coordinate,
    `src/rmdup.cpp:50-51`; we use the last valid mapping.)
    Hash-set formulation of the reference's O(n^2) scan — same output."""
    seen = set()
    out: List[Alignment] = []
    for a in alignments:
        if not a.path.mappings:
            out.append(a)
            continue
        p0 = a.path.mappings[0].position
        if a.read_paired:
            pl = a.path.mappings[-1].position
            key = (True, p0.node_id, p0.offset, pl.node_id, pl.offset)
        else:
            key = (False, p0.node_id, p0.offset)
        if key in seen:
            continue
        seen.add(key)
        out.append(a)
    return out


# ---------------------------------------------------------------------------
# per-read -> per-mapping scalars (host, vectorized numpy)
# ---------------------------------------------------------------------------
def mapping_scalars(
    db: HaplocartDB,
    a: Alignment,
    use_background_error_prob: bool = False,
    background_error_prob: float = 0.0001,
    is_consensus_fasta: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (node_idx[m], A[m], B[m]) for one alignment: the
    supported / unsupported per-mapping log-likelihood increments of
    `src/process_mapping.cpp`."""
    graph_seq, read_seq, mppg_sizes = reconstruct_graph_sequence(
        db.graph, a.path, a.sequence
    )
    gcodes = dna.encode(graph_seq)
    rcodes = dna.encode(read_seq)
    qual = np.frombuffer(a.quality, dtype=np.uint8).astype(np.int64)
    L = len(read_seq)
    # quality indexed by aligned position; the reference walks off the
    # end of the quality string for later mappings (see module doc) —
    # emulate with zero padding (phred 0 -> p_err 0.25)
    qual_ext = np.zeros(2 * L + 8, dtype=np.int64)
    qual_ext[: len(qual)] = qual
    # sticky flag: any quality >= 90 switches to background error prob
    # (`src/update_likelihood.cpp:42`)
    if (qual >= 90).any():
        use_background_error_prob = True

    mappings = a.path.mappings
    n_m = len(mappings)
    node_idx = np.empty(n_m, dtype=np.int64)
    A = np.zeros(n_m, dtype=np.float64)
    B = np.zeros(n_m, dtype=np.float64)

    pos = 0
    for i, mppg in enumerate(mappings):
        # QUIRK: mppg_sizes is per-edit; indexing by mapping reproduces
        # `src/update_likelihood.cpp:36`
        size = mppg_sizes[i] if i < len(mppg_sizes) else 0
        node_id = mppg.position.node_id
        node_idx[i] = node_id - db.graph.min_id

        g = gcodes[pos : pos + size]
        # QUIRK: read bases come from the START of the read, not from
        # the mapping's slice (mapping_seq == full algnseq)
        r = rcodes[:size]
        q = db.qscore[np.clip(qual_ext[pos : pos + size], 0, 99)]

        pangenome_base = int(db.pangenome_base[node_idx[i]])
        mappability = db.mappabilities[pangenome_base]
        p_correct = (
            1.0 - db.incorrect_map[min(a.mapping_quality, 99)]
        ) * mappability

        valid = (g < 4) & (r < 4)  # both plain ACGT (N/-/S/rare skipped)
        if valid.any():
            if use_background_error_prob:
                # consensus / qual>=90 reads take eps from the
                # background error prob (`src/get_p_obs_base.cpp:14-17`)
                eps = np.where(
                    g == r, background_error_prob, 1.0 - background_error_prob
                )
            else:
                eps = np.where(g == r, q, 1.0 - q)  # quirk: error-prob on match
            p_obs = db.match_prob[pangenome_base] * (1.0 - eps)
            if not is_consensus_fasta:
                bg = mutation.BACKGROUND_FREQ[np.minimum(r, 4)]
                term = np.log((1.0 - p_correct) * bg + p_correct * p_obs)
            else:
                term = np.log((1.0 - background_error_prob) * p_obs)
            A[i] = term[valid].sum()

        # unsupported penalty: whole remaining read scored as mismatch
        # (`src/process_mapping.cpp:4-24`)
        qs = db.qscore[np.clip(qual_ext[pos : pos + L], 0, 99)]
        B[i] = np.log(qs).sum()

        pos += size

    return node_idx, A, B


# ---------------------------------------------------------------------------
# device reduction: per-node accumulation + one matvec against S
# ---------------------------------------------------------------------------
@jax.jit
def _reduce_paths_f64(c, total_b, support):
    return total_b + c @ support


@jax.jit
def _reduce_paths_f32(c, total_b, support):
    # two-float compensated split keeps ~1e-7 relative error in f32
    c_hi = c.astype(jnp.float32)
    c_lo = (c - c_hi.astype(jnp.float64)).astype(jnp.float32)
    acc = c_hi @ support + c_lo @ support
    return total_b.astype(jnp.float32) + acc


def score_alignments(
    db: HaplocartDB,
    alignments: Sequence[Alignment],
    use_background_error_prob: bool = False,
    background_error_prob: float = 0.0001,
    is_consensus_fasta: bool = False,
    precise: bool = True,
) -> np.ndarray:
    """final_vec over paths (`src/HaploCart.cpp:408-421` equivalent)."""
    n_nodes = db.graph.n_nodes
    c = np.zeros(n_nodes, dtype=np.float64)
    total_b = 0.0
    for a in alignments:
        if a.identity < 1e-10:  # discard unmapped (`HaploCart.cpp:411`)
            continue
        node_idx, A, B = mapping_scalars(
            db, a, use_background_error_prob, background_error_prob,
            is_consensus_fasta,
        )
        np.add.at(c, node_idx, A - B)
        total_b += B.sum()
    if precise:
        out = _reduce_paths_f64(
            jnp.asarray(c, jnp.float64), jnp.float64(total_b), db.support_f64
        )
    else:
        out = _reduce_paths_f32(
            jnp.asarray(c, jnp.float64), jnp.float64(total_b), db.support_f32
        )
    out = np.asarray(out, dtype=np.float64)
    # reference asserts every computed log-likelihood is finite
    guards.check_finite(out, "haplocart final_vec")
    return out


def predict(db: HaplocartDB, final_vec: np.ndarray) -> str:
    return db.path_names[int(np.argmax(final_vec))]


# ---------------------------------------------------------------------------
# clade posterior roll-up (`src/get_posterior.cpp`)
# ---------------------------------------------------------------------------
def _logsumexp(v: np.ndarray) -> float:
    m = np.max(v)
    return float(m + np.log(np.exp(v - m).sum()))


def _descendants(preds, children) -> set:
    """Transitive closure of get_children (`src/get_posterior.cpp:36-76`)."""
    out = set()
    frontier = set(preds)
    while frontier:
        nxt = set()
        for p in frontier:
            for ch in children.get(p, []):
                if ch not in out:
                    out.add(ch)
                    nxt.add(ch)
        frontier = nxt
    return out


def get_posterior(
    db: HaplocartDB, final_vec: np.ndarray, predicted: str
) -> List[Tuple[str, float]]:
    """Returns [(clade, confidence)] walking the predicted haplogroup's
    ancestor chain, confidence = exp(clade LL - total LL)."""
    total_ll = _logsumexp(final_vec)
    name_to_idx = {n: i for i, n in enumerate(db.path_names)}
    out: List[Tuple[str, float]] = []
    # the prediction itself
    out.append((predicted, float(np.exp(final_vec[name_to_idx[predicted]] - total_ll))))
    parent_vec = db.parents.get(predicted, [])
    prev = None
    for p in parent_vec:
        desc = _descendants({p}, db.children)
        idxs = [name_to_idx[d] for d in desc if d in name_to_idx]
        if idxs:
            ll = _logsumexp(final_vec[np.array(idxs)])
            conf = float(np.exp(ll - total_ll))
        else:
            conf = 0.0
        if p != prev:
            out.append((p, conf))
        prev = p
    return out
