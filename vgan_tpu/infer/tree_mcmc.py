"""soibean's tree MCMC as a jax scan with vmapped chains.

Reimplements `MCMC::run_tree_proportion` (`src/MCMC.cpp:522-1088`),
`MCMC::updatePosition` (`src/MCMC.cpp:169-469`) and
`MCMC::computeBaseLogLike` (`src/MCMC.h:111-296`) on device:

* state per source: tree node, branch position in (0,1), proportion.
* proposals: branch-position random walk N(0, sd) with the reference's
  tree-traversal semantics (cross into children / parent / siblings,
  leaf and root bounces), annealed sd schedule (precomputed per
  iteration: burn-in linear decay initSD -> 0.1, then 0.1 -> 1e-5 with
  a reset to 1 every 100k iterations, `src/MCMC.cpp:544-596`);
  proportions via truncated N(theta, 0.1) on [0,1] renormalized
  (QUIRK: `sample_normal` ignores its alpha argument and uses 0.1,
  `src/MCMC.cpp:500`).
* likelihood: per source y with child path c and parent path p,
  t = dist[c] (1e-5 at the root), t1 = pos*t, t2 = t - t1:
    LL_c[r] = path_map[r,c] + counts25[r,c] . hky25(t2)
    LL_p[r] = path_map[r,p] + counts25[r,p] . hky25(t1)
    read LL  = logsumexp_y( log theta_y
                + logaddexp(log pos_y + LL_c, log(1-pos_y) + LL_p) )
  (k=1 uses theta=1, which reduces to the reference's
  calculateLogWeightedAverage since the weights sum to 1).
* HKY85 closed form with the reference's quirks: kappa = 1/22 integer
  division == 0, |jut1 - jut11| absolute difference for transition
  mismatches, 1e-8 floors, log(0.999999999) positive-clamp.
* recording: iterations > burn record the PRE-update state on both
  accept and reject (`src/MCMC.cpp:1022-1079`); iteration 0 is a
  forced accept; the loop runs maxIter+1 times.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp
from jax.lax import Precision
import numpy as np

from ..utils import precision


def _F():
    """Sampler float dtype (utils/precision.py). f32-vs-f64 estimate
    parity is test-asserted."""
    return precision.compute_dtype("sampler")


class TreeArrays(NamedTuple):
    parent: jnp.ndarray  # [N] int32, -1 at root
    dist: jnp.ndarray  # [N] f64
    children: jnp.ndarray  # [N, C] int32, -1 padded
    n_children: jnp.ndarray  # [N] int32


class MCMCTrace(NamedTuple):
    node: np.ndarray  # [iters, k]
    pos: np.ndarray  # [iters, k]
    theta: np.ndarray  # [iters, k]
    loglike: np.ndarray  # [iters]


def hky25(t, con, freqs: Dict[str, float]):
    """[25] log-likelihood vector over (graph-class, read-class) pairs,
    classes {A,C,G,T,other}. Mirrors computeBaseLogLike exactly."""
    fA, fC, fG, fT = freqs["A"], freqs["C"], freqs["G"], freqs["T"]
    R, Y, mu = freqs["R"], freqs["Y"], freqs["M"]
    f = jnp.array([fA, fC, fG, fT], dtype=_F())
    kappa = 0.0  # QUIRK: double kappa = 1/22 (int division) `src/MCMC.h:66`
    AR = 1.0 + R * (kappa - 1.0)
    AY = 1.0 + Y * (kappa - 1.0)
    emt = jnp.exp(-(mu * t))

    purine = jnp.array([True, False, True, False])
    grp_f = jnp.where(purine, R, Y)  # purine/pyrimidine group freq
    grp_A = jnp.where(purine, AR, AY)
    e_grp = jnp.exp(-(mu * t * grp_A))

    # match: bpo == refb
    jut1_m = f + f * (1.0 / grp_f - 1.0) * emt
    jut11_m = ((grp_f - f) / grp_f) * e_grp
    p_match = jnp.maximum(jut1_m + jut11_m, 1e-8)  # [4], value for bpo==ref

    # transition mismatch (A<->G / C<->T): value for bpo given refb=partner
    jut1_t = f + f * (1.0 / grp_f - 1.0) * emt
    jut11_t = (f / grp_f) * e_grp
    p_transition = jnp.maximum(jnp.abs(jut1_t - jut11_t), 1e-8)  # [4]

    # transversion / "trash": f[bpo] * (1 - e^{-mu t})
    p_other = jnp.maximum(f * (1.0 - emt), 1e-8)  # [4]

    partner = jnp.array([2, 3, 0, 1])  # A<->G, C<->T

    def P_for_ref(refb):
        bpo = jnp.arange(4)
        return jnp.where(
            bpo == refb,
            p_match,
            jnp.where(bpo == partner[refb], p_transition, p_other),
        )

    P_acgt = jax.vmap(P_for_ref)(jnp.arange(4))  # [ref 4, bpo 4]
    P_rare = p_other[None, :]  # graph-class 'other': all trash branch
    P = jnp.concatenate([P_acgt, P_rare], axis=0)  # [5, 4]

    log_con_match = jnp.log1p(-con)
    log_con_mis = jnp.log(con / 3.0)

    def marg_for_read(rc):
        w = jnp.where(jnp.arange(4) == rc, log_con_match, log_con_mis)
        return jax.scipy.special.logsumexp(jnp.log(P) + w[None, :], axis=1)

    m_acgt = jax.vmap(marg_for_read, out_axes=1)(jnp.arange(4))  # [5, 4]
    m_rare = jax.scipy.special.logsumexp(jnp.log(P) + log_con_mis, axis=1)
    m = jnp.concatenate([m_acgt, m_rare[:, None]], axis=1)  # [5 graph, 5 read]
    m = jnp.where(m > 1e-8, jnp.log(0.999999999), m)
    return m.reshape(25)


# ---------------------------------------------------------------------------
# tree walk (updatePosition)
# ---------------------------------------------------------------------------
WALK_HOPS = 32  # max bound (the C++ loop is unbounded; moves rarely
                # need more than ~10 branch hops)
POST_BURN_HOPS = 8  # post-burn-in proposal sd <= 1 -> short walks


def burn_walk_hops(num_paths: int) -> int:
    """Burn-in walk bound adapted to the annealing start sd: a move of
    |N(0, init_sd)| exhausts within ~init_sd branch crossings, so
    4*init_sd + 8 hops truncates with probability < 1e-10 per proposal
    (the reference's loop is unbounded; WALK_HOPS caps it the same way
    32 always did). For the default small-tree init_sd = 3 this cuts
    the 32-hop burn body by ~1/3 of its unrolled ops."""
    init_sd = 3.0 if num_paths <= 30 else num_paths * (3.0 / 30.0)
    return int(min(WALK_HOPS, max(POST_BURN_HOPS, 4 * init_sd + 8)))


def pack_tree_table(tree: TreeArrays):
    """[N, 2+C] float table (parent, n_children, children...): the walk
    reads tree structure as one-hot select+reduce rows of this table
    instead of ~10 gathers per hop, so each lookup fuses into the
    surrounding elementwise work (values are small exact ints)."""
    return jnp.concatenate(
        [
            tree.parent[:, None].astype(_F()),
            tree.n_children[:, None].astype(_F()),
            tree.children.astype(_F()),
        ],
        axis=1,
    )


def update_position(tt, node, pos, move, forward, walk_u):
    """One proposal move of `move` (>0) in direction `forward`.

    tt: pack_tree_table output. walk_u: [hops, 4] pregenerated uniforms
    (child pick, parent-vs-sibling pick, root-bounce child pick,
    sibling-child pick per hop). The hop loop is a PYTHON loop unrolled
    into the enclosing scan body (hops is static): a nested
    fori_loop/while op inside the sampler scan costs per-hop control
    overhead on the serial critical path, and pregenerated uniforms
    keep threefry off that path entirely (see SAMPLER DESIGN
    below). Masked no-ops make any walk shorter than `hops` identical
    to the reference's unbounded loop."""
    N = tt.shape[0]
    Cc = tt.shape[1] - 2
    iota_n = jnp.arange(N)
    iota_c = jnp.arange(Cc)

    def row_of(n):
        # select+reduce, NOT a matmul: an f32 matmul may run in
        # reduced precision (TF32), which rounds node ids above 2048
        return jnp.sum(jnp.where((iota_n == n)[:, None], tt, 0.0), axis=0)

    def pick(kids, nc, u):
        ncm = jnp.maximum(nc, 1.0)
        j = jnp.minimum(jnp.floor(u.astype(_F()) * ncm), ncm - 1.0)
        return jnp.sum(jnp.where(iota_c == j, kids, 0.0))

    # node walks as an exact small integer in the float dtype (avoids
    # int<->float casts between hops)
    node = node.astype(_F())
    d, fwd = move, forward
    for h in range(walk_u.shape[0]):
        u = walk_u[h]
        active = d > 0.0
        row = row_of(node)
        par, nc, kids = row[0], row[1], row[2:]
        is_leaf = nc == 0
        is_root = par < 0

        # ---------------- forward ----------------
        f_stay = pos + d < 1.0
        # stay on branch
        f1_pos, f1_d, f1_node, f1_fwd = pos + d, 0.0, node, fwd
        # leaf bounce: flip direction, keep d
        f2_pos, f2_d, f2_node, f2_fwd = pos, d, node, False
        # cross into a random child
        rem = jnp.maximum(d - (1.0 - pos), 0.0)
        child = pick(kids, nc, u[0])
        f3_pos = jnp.where(rem > 1.0, 1.0, rem)
        f3_d = jnp.where(rem > 1.0, rem - 1.0, 0.0)
        f3_node, f3_fwd = child, fwd

        fw_pos = jnp.where(f_stay, f1_pos, jnp.where(is_leaf, f2_pos, f3_pos))
        fw_d = jnp.where(f_stay, f1_d, jnp.where(is_leaf, f2_d, f3_d))
        fw_node = jnp.where(f_stay, f1_node, jnp.where(is_leaf, f2_node, f3_node))
        fw_fwd = jnp.where(f_stay, f1_fwd, jnp.where(is_leaf, f2_fwd, f3_fwd))

        # ---------------- backward ----------------
        b_stay = pos - d > 0.0
        b1_pos, b1_d, b1_node, b1_fwd = pos - d, 0.0, node, fwd

        # root bounce: flip direction, hop to a random child, keep d/pos
        root_child = pick(kids, nc, u[2])
        b2_pos, b2_d, b2_node, b2_fwd = pos, d, root_child, True

        # choose parent or a sibling: possible = [parent] (+ siblings if
        # this node is internal, `src/MCMC.cpp:320-330`)
        row_par = row_of(jnp.maximum(par, 0.0))
        nc_par, kids_par = row_par[1], row_par[2:]
        nsib = jnp.where(is_leaf, 0.0, jnp.maximum(nc_par, 1.0) - 1.0)
        n_possible = 1.0 + nsib
        pickv = jnp.minimum(
            jnp.floor(u[1].astype(_F()) * n_possible),
            jnp.maximum(n_possible, 1.0) - 1.0,
        )
        chose_parent = pickv == 0

        # parent move
        remb = jnp.maximum(d - pos, 0.0)
        bp_pos = jnp.where(remb > 1.0, 0.0, jnp.clip(1.0 - remb, 1e-12, 1.0))
        bp_d = jnp.where(remb > 1.0, remb - 1.0, 0.0)
        bp_node = par
        bp_fwd = fwd  # stays backward

        # sibling move: position of node among parent's children
        sib_j = pickv - 1.0
        self_pos = jnp.argmax(kids_par == node)
        sib_idx = sib_j + (sib_j >= self_pos)
        sib_idx = jnp.clip(sib_idx, 0.0, Cc - 1.0)
        sibling = jnp.sum(jnp.where(iota_c == sib_idx, kids_par, 0.0))
        rems = d - pos  # remaining after reaching the junction
        s_stay = rems < 1.0
        row_sib = row_of(sibling)
        sib_leaf = row_sib[1] == 0
        # cross into a random child of the sibling
        rems2 = jnp.maximum(d - 1.0, 0.0)  # d - (1 - 0) per `src/MCMC.cpp:420`
        sib_child = pick(row_sib[2:], row_sib[1], u[3])
        bs_pos = jnp.where(
            s_stay,
            jnp.maximum(rems, 0.0),
            jnp.where(sib_leaf, 0.0, jnp.where(rems2 > 1.0, 1.0, rems2)),
        )
        bs_d = jnp.where(
            s_stay, 0.0, jnp.where(sib_leaf, d, jnp.where(rems2 > 1.0, rems2 - 1.0, 0.0))
        )
        bs_node = jnp.where(s_stay, sibling, jnp.where(sib_leaf, sibling, sib_child))
        bs_fwd = jnp.where(s_stay, True, jnp.where(sib_leaf, False, True))

        bw_pos = jnp.where(
            b_stay, b1_pos,
            jnp.where(is_root, b2_pos, jnp.where(chose_parent, bp_pos, bs_pos)),
        )
        bw_d = jnp.where(
            b_stay, b1_d,
            jnp.where(is_root, b2_d, jnp.where(chose_parent, bp_d, bs_d)),
        )
        bw_node = jnp.where(
            b_stay, b1_node,
            jnp.where(is_root, b2_node, jnp.where(chose_parent, bp_node, bs_node)),
        )
        bw_fwd = jnp.where(
            b_stay, b1_fwd,
            jnp.where(is_root, b2_fwd, jnp.where(chose_parent, bp_fwd, bs_fwd)),
        )

        pos2 = jnp.where(fwd, fw_pos, bw_pos)
        d2 = jnp.where(fwd, fw_d, bw_d)
        node2 = jnp.where(fwd, fw_node, bw_node)
        fwd2 = jnp.where(fwd, fw_fwd, bw_fwd)
        # masked no-op once the move is exhausted
        pos = jnp.where(active, pos2, pos)
        d = jnp.where(active, d2, d)
        node = jnp.where(active, node2, node)
        fwd = jnp.where(active, fwd2, fwd)
    return node.astype(jnp.int32), pos


# ---------------------------------------------------------------------------
# main sampler
# ---------------------------------------------------------------------------
def sd_schedule(max_iter: int, burn: int, num_paths: int) -> np.ndarray:
    """Annealed proposal sd per iteration (`src/MCMC.cpp:544-596`)."""
    init_sd = 3.0 if num_paths <= 30 else num_paths * (3.0 / 30.0)
    step = (init_sd - 0.1) / max(1, burn - 1)
    step2 = (0.1 - 1e-5) / max(1, (max_iter - burn) - 1)
    it = np.arange(max_iter + 1, dtype=np.float64)
    sd = np.where(
        it < burn,
        np.maximum(1e-5, init_sd - it * step),
        np.maximum(1e-5, 0.1 - (it - burn) * step2),
    )
    sd[(it % 100000 == 0) & (it >= burn)] = 1.0
    return sd


def run_tree_mcmc(
    tree,
    stats_path_map: np.ndarray,
    stats_counts25: np.ndarray,
    sources: np.ndarray,
    freqs: Dict[str, float],
    con: float,
    max_iter: int,
    burn: int,
    num_paths: int,
    init_loglike: float,
    seed: int = 0,
) -> MCMCTrace:
    """Run one chain (thin wrapper over the vmapped segment runner)."""
    tr = run_tree_mcmc_chains(
        tree, stats_path_map, stats_counts25,
        np.asarray(sources, np.int32)[None, :], freqs, con,
        max_iter, burn, num_paths, init_loglike,
        seeds=np.asarray([seed]),
    )
    return MCMCTrace(node=tr.node[0], pos=tr.pos[0], theta=tr.theta[0],
                     loglike=tr.loglike[0])


# ---------------------------------------------------------------------------
# SAMPLER DESIGN. One MH iteration is inherently SERIAL: state -> walk
# -> likelihood -> accept -> state, so throughput is bounded by the
# per-step latency of the scan body, not by FLOPs (the likelihood is
# ~4*R*25 MACs ~= 20-200 kFLOP). The levers are therefore (a) keeping
# everything off the serial path that can be precomputed, and (b)
# minimizing the number of separate kernels in the body:
#   * ALL per-iteration randomness (walk deltas + per-hop child picks,
#     truncated-normal uniforms, accept uniforms) is pregenerated
#     OUTSIDE the scan in one embarrassingly-parallel vmapped threefry
#     pass keyed counter-style as fold_in(chain_key, iteration) — the
#     body consumes them as scan xs. This removes ~20 sequential
#     threefry invocations (5 splits + per-hop split(3)) per step.
#   * the tree-walk hop loop is a PYTHON loop unrolled into the body
#     (a nested fori_loop would put a nested while op's per-hop
#     control overhead on the critical path).
#   * tree-structure lookups in the walk are one-hot SELECT+REDUCE rows
#     of a packed [N, 2+C] table (pack_tree_table), not gathers and not
#     matmuls (see update_position.row_of).
#   * the scan runs with unroll=4 post-burn-in, amortizing while-op
#     bookkeeping; segments are NOISE_SEG iterations so pregenerated
#     noise stays bounded; fold_in(key, absolute_iter) keying makes
#     the stream segmentation-invariant (checkpoint/resume bit-parity).
# Per-step time on the GPU is in PERF.md.
# ---------------------------------------------------------------------------
NOISE_SEG = 32768  # iterations per jitted segment (bounds noise HBM)


@partial(jax.jit, static_argnames=("k", "hops"))
def _gen_noise(key, iters, k: int, hops: int):
    """Pregenerate one segment's per-iteration randomness, keyed
    counter-style by absolute iteration so any segmentation of the same
    chain key yields the same stream."""

    def one(it):
        kk = jax.random.fold_in(key, it)
        kd, kw, kt, ku = jax.random.split(kk, 4)
        deltas = jax.random.normal(kd, (k,), dtype=jnp.float32)
        walk_u = jax.random.uniform(kw, (k, hops, 4), dtype=jnp.float32)
        trunc_u = jax.random.uniform(kt, (k,), dtype=jnp.float32)
        acc_u = jax.random.uniform(ku, (), dtype=jnp.float32)
        return deltas, walk_u, trunc_u, acc_u

    return jax.vmap(one)(iters)


@partial(jax.jit, static_argnames=("k", "hops"))
def _gen_noise_batch(keys, iters, k: int, hops: int):
    """Per-chain noise for a segment. Module-level jit: re-invoking
    jax.vmap(lambda ...) per segment re-TRACES on the host each time;
    a cached jit makes every segment after the first a cache hit."""
    return jax.vmap(lambda kk: _gen_noise(kk, iters, k=k, hops=hops))(keys)


@partial(jax.jit, static_argnames=("walk_hops",))
def _run_segment_batch(
    nodes, pos, theta, ll, mask,  # batched [B, ...]
    iters, sd_seg, noise,  # noise batched [B, ...]
    path_map, counts25,
    tree_parent, tree_dist, tree_children, tree_nchildren,
    con, freq_arr,
    walk_hops: int = WALK_HOPS,
):
    """vmap of _run_segment over the chain/row axis, as ONE cached jit
    (same host-retracing rationale as _gen_noise_batch)."""
    return jax.vmap(
        lambda nn, pp, tt, l2, mm, nz: _run_segment(
            nn, pp, tt, l2, mm, iters, sd_seg, nz,
            path_map, counts25,
            tree_parent, tree_dist, tree_children, tree_nchildren,
            con, freq_arr, walk_hops=walk_hops,
        )
    )(nodes, pos, theta, ll, mask, noise)


def _init_theta_for_key(key, k: int):
    """Uniform random normalized start (`MCMC.h generateRandomNumbers`).

    Domain-separated from the per-iteration noise keys (fold_in(key,
    iteration)): iterations never reach 2^31 - 1, so this fold can
    never collide with an iteration's noise key (a fold_in(key, 17)
    here would have made iteration 17's proposal noise a deterministic
    function of the starting proportions)."""
    return jax.random.dirichlet(
        jax.random.fold_in(key, 2**31 - 1), jnp.ones(k, dtype=jnp.float32)
    ).astype(_F())


def run_tree_mcmc_chains(
    tree,
    stats_path_map: np.ndarray,
    stats_counts25: np.ndarray,
    sources_per_chain: np.ndarray,  # [C, k]
    freqs: Dict[str, float],
    con: float,
    max_iter: int,
    burn: int,
    num_paths: int,
    init_loglike: float,
    seeds: np.ndarray,  # [C]
    mesh=None,
) -> MCMCTrace:
    """Run C chains in one device program (vmap over chains).

    With a Mesh, the chain axis shards across devices (replacing the
    reference's sequential chain loop,
    `src/soibean.cpp:805-840`); traces come back stacked [C, ...].
    The run is split at the burn-in boundary: burn-in proposals use the
    full 32-hop tree walk (initSD can be several branch lengths), the
    post-burn-in phase (sd <= 1) uses an 8-hop walk. Within each phase
    the run proceeds in NOISE_SEG-iteration segments whose randomness
    is pregenerated off the serial path (see SAMPLER DESIGN)."""
    sd = sd_schedule(max_iter, burn, num_paths)
    freq_arr = jnp.asarray(
        [freqs[n] for n in ["A", "C", "G", "T", "R", "Y", "M"]], _F()
    )
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    srcs = jnp.asarray(sources_per_chain, jnp.int32)
    C, k = srcs.shape
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P("dp"))
        keys = jax.device_put(keys, sh)
        srcs = jax.device_put(srcs, sh)

    init_theta = jax.vmap(partial(_init_theta_for_key, k=k))(keys)
    carry = (
        srcs,
        jnp.full((C, k), 0.5, dtype=_F()),
        init_theta,
        jnp.full((C,), init_loglike, dtype=_F()),
    )
    args = (
        jnp.asarray(stats_path_map, _F()),
        jnp.asarray(stats_counts25, _F()),
        jnp.asarray(tree.parent, jnp.int32),
        jnp.asarray(tree.dist, _F()),
        jnp.asarray(tree.children, jnp.int32),
        jnp.asarray(tree.n_children, jnp.int32),
        jnp.asarray(con, _F()),
        freq_arr,
    )
    total = max_iter + 1
    split = min(burn + 1, total)
    recs_all = []
    ones_mask = jnp.ones((C, k), bool)
    for (p0, p1, hops) in ((0, split, burn_walk_hops(num_paths)),
                           (split, total, POST_BURN_HOPS)):
        i0 = p0
        while i0 < p1:
            i1 = min(i0 + NOISE_SEG, p1)
            iters = jnp.arange(i0, i1)
            noise = _gen_noise_batch(keys, iters, k=k, hops=hops)
            carry, recs = _run_segment_batch(
                *carry, ones_mask, iters, jnp.asarray(sd[i0:i1]), noise,
                *args, walk_hops=hops,
            )
            recs_all.append(recs)
            i0 = i1
    # concatenate ON DEVICE and download once per field: 4 transfers
    # instead of 4 x n_segments
    rn = np.asarray(jnp.concatenate([r[0] for r in recs_all], axis=1))
    rp = np.asarray(jnp.concatenate([r[1] for r in recs_all], axis=1))
    rt = np.asarray(jnp.concatenate([r[2] for r in recs_all], axis=1))
    rl = np.asarray(jnp.concatenate([r[3] for r in recs_all], axis=1))
    return MCMCTrace(
        node=rn[:, burn + 1 :], pos=rp[:, burn + 1 :],
        theta=rt[:, burn + 1 :], loglike=rl[:, burn + 1 :],
    )


def run_tree_mcmc_ksweep(
    tree,
    stats_path_map: np.ndarray,
    stats_counts25: np.ndarray,
    sources_per_k,  # list over k: [C, k_i] int32
    freqs: Dict[str, float],
    con: float,
    max_iter: int,
    burn: int,
    num_paths: int,
    init_logls,  # list over k: float
    seeds_per_k,  # list over k: [C]
    mesh=None,
):
    """Run the WHOLE k-sweep (k = 1..K, C chains each) as ONE vmapped
    device batch of K*C rows — the reference runs each k sequentially
    (`src/soibean.cpp:745-840`), multiplying the dominant sampler
    wall-clock by K. Rows pad their source axis to Kmax with a mask:
    padded slots keep theta = 0 and weigh -inf in the mixture, so each
    row's math equals the equivalent standalone k_i-source chain (the
    per-row latency of one MH step is unchanged by batch width at
    these sizes — see SAMPLER DESIGN). Returns a list of MCMCTrace,
    entry i holding that k's [C, iters, k_i] trace."""
    K = len(sources_per_k)
    Kmax = max(s.shape[1] for s in sources_per_k)
    C = sources_per_k[0].shape[0]
    B = K * C
    sd = sd_schedule(max_iter, burn, num_paths)
    freq_arr = jnp.asarray(
        [freqs[n] for n in ["A", "C", "G", "T", "R", "Y", "M"]], _F()
    )
    srcs = np.zeros((B, Kmax), dtype=np.int32)
    mask = np.zeros((B, Kmax), dtype=bool)
    ll0 = np.zeros(B, dtype=np.float64)
    seeds = np.zeros(B, dtype=np.int64)
    for i, s in enumerate(sources_per_k):
        ki = s.shape[1]
        rows = slice(i * C, (i + 1) * C)
        srcs[rows, :ki] = s
        mask[rows, :ki] = True
        ll0[rows] = init_logls[i]
        seeds[rows] = np.asarray(seeds_per_k[i])
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    srcs_j = jnp.asarray(srcs)
    mask_j = jnp.asarray(mask)
    if mesh is not None and B % mesh.size == 0:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P("dp"))
        keys = jax.device_put(keys, sh)
        srcs_j = jax.device_put(srcs_j, sh)
        mask_j = jax.device_put(mask_j, sh)

    # per-row init theta via the per-k formula (padded slots 0), so a
    # row with k_i == Kmax is BIT-IDENTICAL to the standalone chains
    # runner with the same seed (parity-tested)
    init_theta_np = np.zeros((B, Kmax), dtype=np.float64)
    for i, s in enumerate(sources_per_k):
        ki = s.shape[1]
        rows = slice(i * C, (i + 1) * C)
        th = jax.vmap(partial(_init_theta_for_key, k=ki))(keys[rows])
        init_theta_np[rows, :ki] = np.asarray(th)
    init_theta = jnp.asarray(init_theta_np, _F())
    if mesh is not None and B % mesh.size == 0:
        from jax.sharding import NamedSharding, PartitionSpec as P

        init_theta = jax.device_put(init_theta, NamedSharding(mesh, P("dp")))
    carry = (
        srcs_j,
        jnp.full((B, Kmax), 0.5, dtype=_F()),
        init_theta,
        jnp.asarray(ll0, _F()),
    )
    args = (
        jnp.asarray(stats_path_map, _F()),
        jnp.asarray(stats_counts25, _F()),
        jnp.asarray(tree.parent, jnp.int32),
        jnp.asarray(tree.dist, _F()),
        jnp.asarray(tree.children, jnp.int32),
        jnp.asarray(tree.n_children, jnp.int32),
        jnp.asarray(con, _F()),
        freq_arr,
    )
    total = max_iter + 1
    split = min(burn + 1, total)
    recs_all = []
    for (p0, p1, hops) in ((0, split, burn_walk_hops(num_paths)),
                           (split, total, POST_BURN_HOPS)):
        i0 = p0
        while i0 < p1:
            i1 = min(i0 + NOISE_SEG, p1)
            iters = jnp.arange(i0, i1)
            noise = _gen_noise_batch(keys, iters, k=Kmax, hops=hops)
            carry, recs = _run_segment_batch(
                *carry, mask_j, iters, jnp.asarray(sd[i0:i1]), noise,
                *args, walk_hops=hops,
            )
            recs_all.append(recs)
            i0 = i1
    rn = np.asarray(jnp.concatenate([r[0] for r in recs_all], axis=1))
    rp = np.asarray(jnp.concatenate([r[1] for r in recs_all], axis=1))
    rt = np.asarray(jnp.concatenate([r[2] for r in recs_all], axis=1))
    rl = np.asarray(jnp.concatenate([r[3] for r in recs_all], axis=1))
    out = []
    for i, s in enumerate(sources_per_k):
        ki = s.shape[1]
        rows = slice(i * C, (i + 1) * C)
        out.append(MCMCTrace(
            node=rn[rows, burn + 1 :, :ki],
            pos=rp[rows, burn + 1 :, :ki],
            theta=rt[rows, burn + 1 :, :ki],
            loglike=rl[rows, burn + 1 :],
        ))
    return out


# ---------------------------------------------------------------------------
# checkpoint / resume (SURVEY.md §5: the reference has none; long MCMC
# runs here snapshot chain state periodically and resume exactly)
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("walk_hops",))
def _run_segment(
    carry_nodes, carry_pos, carry_theta, carry_ll,
    mask,  # [k] bool: active source slots (all-true outside the k-sweep)
    iters,  # [S] absolute iteration numbers
    sd_seg,  # [S]
    noise,  # (deltas [S,k], walk_u [S,k,hops,4], trunc_u [S,k], acc_u [S])
    path_map, counts25,
    tree_parent, tree_dist, tree_children, tree_nchildren,
    con, freq_arr,
    walk_hops: int = WALK_HOPS,
):
    tree = TreeArrays(
        tree_parent, jnp.asarray(tree_dist, _F()), tree_children, tree_nchildren
    )
    tt = pack_tree_table(tree)
    sd_seg = jnp.asarray(sd_seg, _F())
    con = jnp.asarray(con, _F())
    # path-major layout: the per-step dynamic-slice [R, 25] at path c
    # is then one contiguous block instead of R strided rows (measured
    # 84us -> 47us per step at R=2000)
    path_map_t = jnp.asarray(path_map, _F()).T  # [P, R]
    counts25_t = jnp.transpose(jnp.asarray(counts25, _F()), (1, 0, 2))  # [P, R, 25]
    freq_arr = jnp.asarray(freq_arr, _F())
    freqs = {
        n: freq_arr[i] for i, n in enumerate(["A", "C", "G", "T", "R", "Y", "M"])
    }

    # [N, 2] (parent, dist) side table: one-hot select+reduce instead of two
    # per-step gathers (same rationale as pack_tree_table)
    pd = jnp.stack([tree.parent.astype(_F()), tree.dist], axis=1)

    def log_like(nodes, pos, theta):
        # per-source vmap keeps the path gather a cheap dynamic-slice;
        # a fused [2k]-batched gather/einsum was measured SLOWER (it
        # materializes an [R, 2k, 25] intermediate)
        sel = jnp.arange(pd.shape[0])[None, :] == nodes[:, None]  # [k, N]
        row = jnp.sum(
            jnp.where(sel[:, :, None], pd[None, :, :], 0.0), axis=1
        )  # [k, 2] — select+reduce, not matmul (see row_of)
        par = row[:, 0]
        par = jnp.where(par < 0, nodes.astype(_F()), par).astype(jnp.int32)
        t = row[:, 1]
        t = jnp.where(t == 0.0, 1e-5, t)
        t1 = pos * t
        t2 = t - t1

        def source_ll(c, p, t1_y, t2_y, pos_y):
            h_c = hky25(t2_y, con, freqs)
            h_p = hky25(t1_y, con, freqs)
            hi = Precision.HIGHEST
            llc = path_map_t[c] + jnp.dot(counts25_t[c], h_c, precision=hi)
            llp = path_map_t[p] + jnp.dot(counts25_t[p], h_p, precision=hi)
            return jnp.logaddexp(jnp.log(pos_y) + llc, jnp.log1p(-pos_y) + llp)

        per_src = jax.vmap(source_ll)(nodes, par, t1, t2, pos)
        # inactive (k-sweep padding) slots weigh -inf: excluded exactly
        theta_log = jnp.where(mask, jnp.log(theta), -jnp.inf)
        inter = jax.scipy.special.logsumexp(
            per_src + theta_log[:, None], axis=0
        )
        return inter.sum()

    def step(carry, inp):
        nodes, pos, theta, cur_ll = carry
        it, sd_it, delta_n, walk_u, trunc_u, acc_u = inp
        deltas = delta_n.astype(_F()) * sd_it

        def walk_one(n, p, d, wu):
            return update_position(tt, n, p, jnp.abs(d), d >= 0, wu)

        new_nodes, new_pos = jax.vmap(walk_one)(nodes, pos, deltas, walk_u)
        new_nodes = jnp.where(it == 0, nodes, new_nodes)
        new_pos = jnp.where(it == 0, pos, new_pos)
        new_pos = jnp.clip(new_pos, 1e-12, 1.0 - 1e-10)
        # truncated N(theta, 0.1) on [0,1] by inverse CDF from the
        # pregenerated uniform (same distribution as
        # jax.random.truncated_normal, which is also Phi^-1-based)
        lo = (0.0 - theta) / 0.1
        hi = (1.0 - theta) / 0.1
        plo = jax.scipy.special.ndtr(lo)
        phi = jax.scipy.special.ndtr(hi)
        u = jnp.clip(trunc_u.astype(_F()), 1e-7, 1.0 - 1e-7)
        z = jax.scipy.special.ndtri(plo + u * (phi - plo))
        z = jnp.clip(z, lo, hi)
        # padded slots stay at theta=0 (masked update; renormalizing
        # over all slots equals renormalizing over active ones)
        new_theta = theta + 0.1 * jnp.where(mask, z, 0.0)
        new_theta = new_theta / new_theta.sum()
        prop_ll = log_like(new_nodes, new_pos, new_theta)
        accept = (
            acc_u.astype(_F())
            <= jnp.minimum(1.0, jnp.exp(prop_ll - cur_ll))
        ) | (it == 0)
        # ONE packed trace row (node ids are exact small ints as floats):
        # four separate ys would cost four dynamic-update-slices per
        # step on the serial path
        rec = jnp.concatenate(
            [nodes.astype(_F()), pos, theta, cur_ll[None]]
        )
        nodes = jnp.where(accept, new_nodes, nodes)
        pos = jnp.where(accept, new_pos, pos)
        theta = jnp.where(accept, new_theta, theta)
        cur_ll = jnp.where(accept, prop_ll, cur_ll)
        return (nodes, pos, theta, cur_ll), rec

    carry0 = (carry_nodes, carry_pos, carry_theta, carry_ll)
    # unroll the post-burn-in scan (8-hop walks): several MH steps per
    # while-op trip amortize loop bookkeeping on the serial path; the
    # 32-hop burn-in body is already large, keep it unrolled=1
    unroll = 4 if walk_hops <= POST_BURN_HOPS else 1
    carry, recs = jax.lax.scan(
        step, carry0, (iters, sd_seg) + tuple(noise), unroll=unroll
    )
    k = carry_nodes.shape[0]
    return carry, (
        recs[:, :k].astype(jnp.int32),
        recs[:, k : 2 * k],
        recs[:, 2 * k : 3 * k],
        recs[:, 3 * k],
    )


def run_tree_mcmc_checkpointed(
    tree,
    stats_path_map: np.ndarray,
    stats_counts25: np.ndarray,
    sources: np.ndarray,
    freqs: Dict[str, float],
    con: float,
    max_iter: int,
    burn: int,
    num_paths: int,
    init_loglike: float,
    seed: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 100000,
) -> MCMCTrace:
    """Segmented sampler with exact resume: chain state + recorded
    samples snapshot to `checkpoint_path` every `checkpoint_every`
    iterations; rerunning with the same path continues where the last
    snapshot left off."""
    import os

    # np.savez appends .npz to suffix-less paths; normalize so the
    # resume check looks at the file that was actually written
    if checkpoint_path and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"

    sd = sd_schedule(max_iter, burn, num_paths)
    freq_arr = np.asarray([freqs[n] for n in ["A", "C", "G", "T", "R", "Y", "M"]])
    total = max_iter + 1
    k = len(sources)

    key = jax.random.PRNGKey(seed)
    start = 0
    segments: list = []
    if checkpoint_path and os.path.exists(checkpoint_path):
        z = np.load(checkpoint_path, allow_pickle=False)
        start = int(z["next_iter"])
        key = jnp.asarray(z["key"])  # base chain key (noise regen)
        carry = (
            jnp.asarray(z["nodes"], jnp.int32),
            jnp.asarray(z["pos"], _F()),
            jnp.asarray(z["theta"], _F()),
            jnp.asarray(z["ll"], _F()),
        )
        segments = [
            (z["rec_nodes"], z["rec_pos"], z["rec_theta"], z["rec_ll"])
        ]
    else:
        carry = (
            jnp.asarray(sources, jnp.int32),
            jnp.full((k,), 0.5, dtype=_F()),
            _init_theta_for_key(key, k),
            jnp.asarray(init_loglike, _F()),
        )

    args = (
        jnp.asarray(stats_path_map, _F()),
        jnp.asarray(stats_counts25, _F()),
        jnp.asarray(tree.parent, jnp.int32),
        jnp.asarray(tree.dist, _F()),
        jnp.asarray(tree.children, jnp.int32),
        jnp.asarray(tree.n_children, jnp.int32),
        jnp.asarray(con, _F()),
        jnp.asarray(freq_arr, _F()),
    )
    last_saved = start
    while start < total:
        end = min(start + min(checkpoint_every, NOISE_SEG), total)
        # same burn-boundary hop split as run_tree_mcmc_chains so a
        # checkpointed run matches the vmapped production sampler
        if start < burn + 1:
            end = min(end, burn + 1)
            hops = burn_walk_hops(num_paths)
        else:
            hops = POST_BURN_HOPS
        iters = jnp.arange(start, end)
        noise = _gen_noise(key, iters, k=k, hops=hops)
        carry, recs = _run_segment(
            *carry, jnp.ones(k, bool), iters,
            jnp.asarray(sd[start:end]), noise, *args, walk_hops=hops,
        )
        rn, rp, rt, rl = (np.asarray(x) for x in recs)
        segments.append((rn, rp, rt, rl))
        start = end
        if checkpoint_path and (
            start - last_saved >= checkpoint_every or start >= total
        ):
            acc = [np.concatenate([seg[i] for seg in segments]) for i in range(4)]
            np.savez(
                checkpoint_path,
                next_iter=start,
                key=np.asarray(key),
                nodes=np.asarray(carry[0]),
                pos=np.asarray(carry[1]),
                theta=np.asarray(carry[2]),
                ll=np.asarray(carry[3]),
                rec_nodes=acc[0], rec_pos=acc[1], rec_theta=acc[2],
                rec_ll=acc[3],
            )
            segments = [tuple(acc)]
            last_saved = start

    rn, rp, rt, rl = (
        np.concatenate([seg[i] for seg in segments]) for i in range(4)
    )
    return MCMCTrace(
        node=rn[burn + 1 :], pos=rp[burn + 1 :], theta=rt[burn + 1 :],
        loglike=rl[burn + 1 :],
    )
