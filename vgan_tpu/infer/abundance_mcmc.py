"""euka's abundance MCMC as a jax scan.

Metropolis-Hastings on the abundance simplex, reimplementing
`MCMC::run` / `generate_proposal` / `get_proposal_likelihood`
(`src/MCMC.cpp:1095-1366`) with its exact effective semantics:

* proposal: componentwise Normal(log x, alpha=0.1) then softmax
  (`src/MCMC.cpp:1139-1153`).
* likelihood: sum over taxa of sum over that taxon's *mapped* reads of
  ``log(frac_t * clade_like[k] + clade_not_like[k] * (1/334))`` — and
  ``(1/334)`` is C++ integer division == 0 (`src/MCMC.cpp:1193`), so it
  collapses to ``n_t * log(frac_t) + sum_k log(clade_like[k])``.
  The first (dummy 0.0) element of each clade_like vector is skipped
  (loop starts at k=1, `src/MCMC.cpp:1192`) — our inputs exclude it.
* QUIRK: during burn-in the loop `continue`s before the accept step
  (`src/MCMC.cpp:1251-1260`), so the state never moves until
  iteration > burnin; the recorded samples are the post-burn-in
  *proposals* (recorded before accept/reject, `src/MCMC.cpp:1253-1254`).
* posterior summary: per-taxon median + 85%/95% linear-interpolated
  quantiles over the recorded proposals (`src/MCMC.cpp:1311-1361`,
  `quant` from `src/miscfunc.h:239-251`).

The RNG is counter-based (threefry); the reference seeds from
std::random_device and its tests assert only statistical windows
(SURVEY.md §7 "RNG parity"), so stream-level parity is not required.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import precision


def _F():
    """Sampler float dtype (utils/precision.py). f32-vs-f64 estimate
    parity is test-asserted."""
    return precision.compute_dtype("sampler")


class AbundanceResult(NamedTuple):
    estimate: np.ndarray  # [T] posterior median
    ci85: np.ndarray  # [T, 2]
    ci95: np.ndarray  # [T, 2]
    samples: np.ndarray  # [n_recorded, T]


def _proposal_and_loglik(key, current, alpha, n_reads_f, const_ll):
    z = jax.random.normal(key, current.shape, dtype=current.dtype)
    prop = jax.nn.softmax(jnp.log(current) + alpha * z)
    # sum_t n_t * log(frac_t) + const   (const = sum log clade_like)
    ll = jnp.sum(n_reads_f * jnp.log(prop)) + const_ll
    return prop, ll


@jax.jit
def _run_seg(current, cur_ll, ks, alpha, n_reads_f, const_ll):
    """One scan segment over a slice of per-iteration keys; segmenting
    over key slices is stream-identical to one long scan (keys are scan
    xs), which is what makes the checkpointed runner bit-exact."""

    def step(carry, key):
        current, cur_ll = carry
        kp, ku = jax.random.split(key)
        prop, prop_ll = _proposal_and_loglik(
            kp, current, alpha, n_reads_f, const_ll
        )
        u = jax.random.uniform(ku, dtype=_F())
        accept = u <= jnp.minimum(1.0, jnp.exp(prop_ll - cur_ll))  # NaN -> False
        new = jnp.where(accept, prop, current)
        new_ll = jnp.where(accept, prop_ll, cur_ll)
        return (new, new_ll), prop  # record the PROPOSAL (reference quirk)

    return jax.lax.scan(step, (current, cur_ll), ks)


def _summarize(samples: np.ndarray) -> AbundanceResult:
    # simplex-sum assertion, `src/MCMC.cpp:1164-1169`
    from ..utils.guards import check_simplex

    check_simplex(
        samples, "abundance proposal",
        atol=1e-6 if samples.dtype == np.float64 else 1e-4,
    )
    T = samples.shape[1]
    est = np.empty(T)
    ci85 = np.empty((T, 2))
    ci95 = np.empty((T, 2))
    for t in range(T):
        s = np.sort(samples[:, t])
        est[t] = s[len(s) // 2]
        ci85[t] = [_quant(s, 0.15), _quant(s, 0.85)]
        ci95[t] = [_quant(s, 0.05), _quant(s, 0.95)]
    return AbundanceResult(est, ci85, ci95, samples)


def run_mcmc(
    n_reads_per_taxon: np.ndarray,
    sum_log_like_per_taxon: np.ndarray,
    init_vec: np.ndarray,
    n_iter: int = 10000,
    burnin: int = 100,
    alpha: float = 0.1,
    seed: int = 0,
) -> AbundanceResult:
    """n_reads_per_taxon: number of mapped reads per detected taxon
    (size of clade_like minus the dummy element); sum_log_like_per_taxon:
    sum of log(clade_like[k]) (-inf if any like is 0, reproducing the
    reference's log(0) behavior — proposals are then never accepted but
    still recorded)."""
    n_reads_f = jnp.asarray(n_reads_per_taxon, _F())
    const_ll = jnp.asarray(np.sum(sum_log_like_per_taxon), _F())
    init = jnp.asarray(init_vec, _F())
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iter)
    # burn-in: proposals generated but never accepted (reference quirk);
    # state stays at init. We emulate by starting the chain at init with
    # -inf-ish likelihood from iteration burnin+1 onward.
    _, samples = _run_seg(
        init, jnp.asarray(-9999999.0, _F()), keys[burnin + 1 :],
        jnp.asarray(alpha, _F()), n_reads_f, const_ll,
    )
    return _summarize(np.asarray(samples))


def run_mcmc_checkpointed(
    n_reads_per_taxon: np.ndarray,
    sum_log_like_per_taxon: np.ndarray,
    init_vec: np.ndarray,
    n_iter: int = 10000,
    burnin: int = 100,
    alpha: float = 0.1,
    seed: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 100000,
) -> AbundanceResult:
    """Segmented abundance sampler with exact resume (SURVEY §5; the
    reference restarts from zero): chain state + recorded proposals
    snapshot to `checkpoint_path` every `checkpoint_every` iterations;
    rerunning with the same path continues from the last snapshot and
    produces the identical trace (keys are scan xs, so segment slicing
    is stream-invariant)."""
    import os

    # np.savez appends .npz to suffix-less paths; normalize so the
    # resume check looks at the file that was actually written
    if checkpoint_path and not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"

    n_reads_f = jnp.asarray(n_reads_per_taxon, _F())
    const_ll = jnp.asarray(np.sum(sum_log_like_per_taxon), _F())
    keys = jax.random.split(jax.random.PRNGKey(seed), n_iter)
    total = max(n_iter - (burnin + 1), 0)

    start = 0
    segments: list = []
    carry = (jnp.asarray(init_vec, _F()), jnp.asarray(-9999999.0, _F()))
    if checkpoint_path and os.path.exists(checkpoint_path):
        z = np.load(checkpoint_path, allow_pickle=False)
        start = int(z["next_iter"])
        carry = (jnp.asarray(z["current"], _F()), jnp.asarray(z["ll"], _F()))
        segments = [z["samples"]]
    while start < total:
        end = min(start + checkpoint_every, total)
        carry, samples = _run_seg(
            *carry, keys[burnin + 1 + start : burnin + 1 + end],
            jnp.asarray(alpha, _F()), n_reads_f, const_ll,
        )
        segments.append(np.asarray(samples))
        start = end
        if checkpoint_path:
            acc = np.concatenate(segments)
            np.savez(
                checkpoint_path, next_iter=start,
                current=np.asarray(carry[0]), ll=np.asarray(carry[1]),
                samples=acc,
            )
            segments = [acc]
    return _summarize(
        np.concatenate(segments) if segments
        else np.zeros((0, len(init_vec)))
    )


def _quant(sorted_x: np.ndarray, q: float) -> float:
    """`quant` from `src/miscfunc.h:239-251` (linear interpolation)."""
    n = len(sorted_x)
    idx = (n - 1) * q
    lo = int(np.floor(idx))
    hi = int(np.ceil(idx))
    h = idx - lo
    return float((1.0 - h) * sorted_x[lo] + h * sorted_x[hi])
