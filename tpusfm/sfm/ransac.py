"""Fixed-size batched hypothesize-and-verify RANSAC.

The reference's robust estimation is OpenMVG AC-RANSAC inside ``filter()``
(src/sparseBuilder/sparseBuilder.cpp:1160-1237: F-model, 4 px, 2048 iters)
and cv::findEssentialMat / solvePnPRansac in the hand-rolled path
(src/actuator/SequentialActuator.h:108-110, 175-177).  Those are
data-dependent sequential loops; here the whole hypothesis set becomes one
batched array program (SURVEY.md §7 hard part 1):

  1. draw (n_iters, sample_size) correspondence indices at once,
  2. run the minimal solver vmapped over hypotheses,
  3. score all hypotheses against all correspondences as one (I, N) matrix,
  4. argmax inlier count, then one weighted least-squares refit on the
     winner's inliers.

Degenerate samples yield low-scoring models and lose the argmax — no
rejection branching needed.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp


def _sample_indices(key, valid: jnp.ndarray, n_iters: int, sample_size: int):
    """Draw correspondence indices ~ uniform over valid slots. (I, S) int32.
    Uses Gumbel-top-k per hypothesis so samples are without replacement."""
    n = valid.shape[-1]
    g = jax.random.gumbel(key, (n_iters, n))
    logits = jnp.where(valid, 0.0, -jnp.inf) + g
    _, idx = jax.lax.top_k(logits, sample_size)
    return idx


@partial(jax.jit, static_argnames=(
    "solver", "scorer", "sample_size", "n_iters", "refit", "n_candidates",
    "refit_solver", "score_subset",
))
def ransac(
    key: jax.Array,
    x0: jnp.ndarray,
    x1: jnp.ndarray,
    valid: jnp.ndarray,
    solver: Callable,
    scorer: Callable,
    sample_size: int,
    n_iters: int = 512,
    inlier_thresh: float = 4.0,
    refit: bool = True,
    n_candidates: int = 1,
    refit_solver: Callable | None = None,
    score_subset: int = 0,
):
    """Generic two-array RANSAC.

    solver(x0s, x1s, w=None) -> model (batched over a leading dim);
    scorer(model, x0, x1) -> squared errors (..., N).
    inlier_thresh is in the scorer's units (threshold on sqrt(error)).

    Multi-root minimal solvers (P3P: 4, 5-point E: 10, 7-point F: 3) set
    n_candidates = K and return (model_tree with leading dims (I, K),
    ok (I, K)); every candidate becomes an independent hypothesis and
    invalid roots are disqualified from the argmax — degenerate samples
    lose the vote rather than branching.  `refit_solver` (e.g. the
    weighted 8-point / DLT) fits the winner's inliers when the minimal
    solver itself has no least-squares form.

    Returns (model, inliers (N,) bool, n_inliers).
    """
    k1, k_sub = jax.random.split(key)
    idx = _sample_indices(k1, valid, n_iters, sample_size)  # (I, S)
    if n_candidates > 1:
        models, ok = solver(x0[idx], x1[idx])  # tree (I, K, ...), (I, K)
        models = jax.tree_util.tree_map(
            lambda m: m.reshape((n_iters * n_candidates,) + m.shape[2:]), models
        )
        ok = ok.reshape(n_iters * n_candidates)
    else:
        models = solver(x0[idx], x1[idx])  # (I, ...)
        ok = None
    t2 = inlier_thresh * inlier_thresh
    n_pts = x0.shape[0]
    if score_subset and score_subset < n_pts:
        # Hypothesis selection on a random subset of the valid matches (the
        # LO-RANSAC/SPRT-style trick): full hypothesis x match scoring is
        # the dominant FLOP cost at thousands of pairs; the winner's inliers
        # are classified exactly on ALL matches below.  Subset-count std is
        # ~sqrt(p(1-p)/M) (~3% at M=256); the full refit absorbs a
        # near-best pick.
        r = jnp.where(valid, jax.random.uniform(k_sub, (n_pts,)), 2.0)
        sub = jnp.argsort(r)[:score_subset]
        errs_s = scorer(models, x0[sub][None], x1[sub][None])
        counts = jnp.sum((errs_s < t2) & valid[sub][None], axis=-1)
        if ok is not None:
            counts = jnp.where(ok, counts, -1)
        best = jnp.argmax(counts)
        best_model = jax.tree_util.tree_map(lambda m: m[best], models)
        errs_b = scorer(best_model, x0, x1)
        best_inl = (errs_b < t2) & valid
    else:
        errs = scorer(models, x0[None], x1[None])  # (I[*K], N)
        inl = (errs < t2) & valid[None]
        counts = jnp.sum(inl, axis=-1)
        if ok is not None:
            counts = jnp.where(ok, counts, -1)
        best = jnp.argmax(counts)
        best_model = jax.tree_util.tree_map(lambda m: m[best], models)
        best_inl = inl[best]
    if refit:
        fit = refit_solver if refit_solver is not None else solver
        w = best_inl.astype(x0.dtype)
        refit_model = fit(x0, x1, w)
        errs_r = scorer(refit_model, x0, x1)
        inl_r = (errs_r < t2) & valid
        # Keep the refit only if it didn't lose support (guards degenerate
        # all-inlier LSQ on contaminated sets).
        better = jnp.sum(inl_r) >= jnp.sum(best_inl)
        best_model = jax.tree_util.tree_map(
            lambda a, b: jnp.where(better, a, b), refit_model, best_model
        )
        best_inl = jnp.where(better, inl_r, best_inl)
    return best_model, best_inl, jnp.sum(best_inl)


@partial(jax.jit, static_argnames=(
    "solver", "scorer", "sample_size", "n_iters", "error_dim", "refit",
    "n_candidates", "refit_solver",
))
def ransac_ac(
    key: jax.Array,
    x0: jnp.ndarray,
    x1: jnp.ndarray,
    valid: jnp.ndarray,
    solver: Callable,
    scorer: Callable,
    sample_size: int,
    n_iters: int = 512,
    error_dim: int = 1,
    alpha0: float = 1.0,
    max_thresh: float = 16.0,
    min_thresh: float = 0.0,
    refit: bool = True,
    n_candidates: int = 1,
    refit_solver: Callable | None = None,
):
    """A-contrario RANSAC (ORSA / AC-RANSAC, Moisan-Stival-Monasse) — the
    adaptive-threshold scoring OpenMVG uses in the reference's filter()
    (src/sparseBuilder/sparseBuilder.cpp:1160-1237).  Instead of counting
    inliers under a fixed threshold, each hypothesis is scored by its
    Number of False Alarms over every candidate inlier count k:

        NFA(M, k) = (N - s) C(N, k) C(k, s) (alpha0 * eps_k^d)^(k - s)

    with eps_k the k-th smallest error.  The (hypothesis, k) pair with the
    smallest log-NFA wins, and eps_k* becomes the data-driven inlier
    threshold — tight for clean pairs, loose for noisy ones, with no knob.

    The whole (I, N) log-NFA surface is one batched sort + cumulative
    expression; the reference's sequential early-exit loop dissolves.

    alpha0: probability that a random correspondence has error <= 1 unit —
    2*diag/area for point-to-epipolar-line (F/E), pi/area for point transfer
    (H).  error_dim: 1 for line distance, 2 for point distance.
    max_thresh bounds the adaptive threshold (units of sqrt(scorer output)).
    min_thresh floors the *inlier-collection* threshold only (NFA model
    selection stays pure): on near-exact data eps* can shrink below the
    true noise floor and starve downstream stages of valid support.

    Returns (model, inliers, n_inliers, log10_nfa, eps_star).
    """
    k1, _ = jax.random.split(key)
    idx = _sample_indices(k1, valid, n_iters, sample_size)  # (I, S)
    if n_candidates > 1:
        models, ok = solver(x0[idx], x1[idx])
        models = jax.tree_util.tree_map(
            lambda m: m.reshape((n_iters * n_candidates,) + m.shape[2:]), models
        )
        ok = ok.reshape(n_iters * n_candidates)
    else:
        models = solver(x0[idx], x1[idx])
        ok = None

    n = x0.shape[0]
    s = sample_size
    n_valid = jnp.sum(valid)

    def lognfa_surface(errs):
        """errs (..., N) squared -> (log-NFA (...,), k*, eps* ) minimized
        over k (in natural log; reported as log10)."""
        e = jnp.sqrt(jnp.maximum(errs, 0.0))
        e = jnp.where(valid, e, jnp.inf)
        e_sorted = jnp.sort(e, axis=-1)  # (..., N)
        kk = jnp.arange(1, n + 1, dtype=e.dtype)  # k = 1..N
        nv = n_valid.astype(e.dtype)
        # log C(nv, k) + log C(k, s) with lgamma (nv is data-dependent).
        lgam = jax.scipy.special.gammaln
        logC_nk = lgam(nv + 1) - lgam(kk + 1) - lgam(jnp.maximum(nv - kk, 0.0) + 1)
        logC_ks = lgam(kk + 1) - lgam(float(s) + 1) - lgam(jnp.maximum(kk - s, 0.0) + 1)
        log_eps = jnp.log(jnp.maximum(e_sorted, 1e-12))
        log_nfa = (
            jnp.log(jnp.maximum(nv - s, 1.0))
            + logC_nk
            + logC_ks
            + (kk - s) * (error_dim * log_eps + jnp.log(alpha0))
        )
        bad = (kk <= s) | (kk > nv) | (e_sorted > max_thresh) | ~jnp.isfinite(e_sorted)
        log_nfa = jnp.where(bad, jnp.inf, log_nfa)
        k_star = jnp.argmin(log_nfa, axis=-1)
        best_nfa = jnp.take_along_axis(log_nfa, k_star[..., None], axis=-1)[..., 0]
        eps_star = jnp.take_along_axis(e_sorted, k_star[..., None], axis=-1)[..., 0]
        return best_nfa, eps_star

    errs = scorer(models, x0[None], x1[None])  # (I[*K], N)
    nfa, eps = lognfa_surface(errs)
    if ok is not None:
        nfa = jnp.where(ok, nfa, jnp.inf)
    best = jnp.argmin(nfa)
    best_model = jax.tree_util.tree_map(lambda m: m[best], models)
    best_eps = eps[best]
    best_nfa = nfa[best]
    best_errs = errs[best]
    collect = jnp.maximum(best_eps, min_thresh)
    best_inl = (best_errs <= collect * collect) & valid

    if refit:
        fit = refit_solver if refit_solver is not None else solver
        w = best_inl.astype(x0.dtype)
        refit_model = fit(x0, x1, w)
        errs_r = scorer(refit_model, x0, x1)
        nfa_r, eps_r = lognfa_surface(errs_r)
        better = nfa_r <= best_nfa
        best_model = jax.tree_util.tree_map(
            lambda a, b: jnp.where(better, a, b), refit_model, best_model
        )
        best_eps = jnp.where(better, eps_r, best_eps)
        best_nfa = jnp.where(better, nfa_r, best_nfa)
        errs_f = jnp.where(better, errs_r, best_errs)
        collect = jnp.maximum(best_eps, min_thresh)
        best_inl = (errs_f <= collect * collect) & valid

    # NFA > 1 (log > 0) means the best model is not statistically
    # meaningful — report an empty support like OpenMVG's filter prune.
    meaningful = best_nfa <= 0.0
    best_inl = best_inl & meaningful
    log10_nfa = best_nfa / jnp.log(10.0)
    return best_model, best_inl, jnp.sum(best_inl), log10_nfa, best_eps


# ---------------------------------------------------------------------------
# Ready-made robust estimators (capability parity with filter()'s
# f/e/h model options, sparseBuilder.cpp:1037-1040)
# ---------------------------------------------------------------------------

def ransac_fundamental(key, uv0, uv1, valid, n_iters=512, thresh_px=4.0):
    from ..core import epipolar

    return ransac(
        key, uv0, uv1, valid,
        solver=epipolar.fundamental_8pt,
        scorer=epipolar.sampson_error,
        sample_size=8, n_iters=n_iters, inlier_thresh=thresh_px,
    )


def ransac_essential(key, x0n, x1n, valid, n_iters=512, thresh_norm=4.0 / 800.0):
    """On normalized coords; thresh defaults to ~4px at f=800."""
    from ..core import epipolar

    return ransac(
        key, x0n, x1n, valid,
        solver=epipolar.essential_8pt,
        scorer=epipolar.sampson_error,
        sample_size=8, n_iters=n_iters, inlier_thresh=thresh_norm,
    )


def ransac_homography(key, uv0, uv1, valid, n_iters=512, thresh_px=4.0):
    from ..core import homography

    return ransac(
        key, uv0, uv1, valid,
        solver=homography.homography_dlt,
        scorer=homography.homography_transfer_error,
        sample_size=4, n_iters=n_iters, inlier_thresh=thresh_px,
    )


def ransac_essential_5pt(key, x0n, x1n, valid, n_iters=256, thresh_norm=4.0 / 800.0):
    """Minimal (Nistér 5-point) essential RANSAC: each sample yields up to
    ten hypotheses; the winner's inliers are refit with the weighted
    8-point.  Prefer over ransac_essential when outlier rates are high —
    5-point samples are clean far more often than 8-point ones."""
    from ..core import epipolar

    return ransac(
        key, x0n, x1n, valid,
        solver=epipolar.essential_5pt,
        scorer=epipolar.sampson_error,
        sample_size=5, n_iters=n_iters, inlier_thresh=thresh_norm,
        n_candidates=10, refit_solver=epipolar.essential_8pt,
    )


def ransac_fundamental_7pt(key, uv0, uv1, valid, n_iters=256, thresh_px=4.0):
    """Minimal (7-point) fundamental RANSAC; up to three hypotheses per
    sample, weighted 8-point refit on the winner's inliers."""
    from ..core import epipolar

    return ransac(
        key, uv0, uv1, valid,
        solver=epipolar.fundamental_7pt,
        scorer=epipolar.sampson_error,
        sample_size=7, n_iters=n_iters, inlier_thresh=thresh_px,
        n_candidates=3, refit_solver=epipolar.fundamental_8pt,
    )
