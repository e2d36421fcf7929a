"""Camera resection (PnP): batched DLT solver + RANSAC + Gauss-Newton polish.

Capability parity with the reference's registration step:
cv::solvePnPRansac (100 iters, 8 px, conf .99 — src/actuator/
SequentialActuator.h:175-191) and OpenMVG's P3P AC-RANSAC resection inside
the incremental engine.  The minimal solver here is the 6-point DLT
(linear, eigh-based — batches over hypotheses on the device; a closed-form P3P
is a later optimization), followed by a fixed-iteration Gauss-Newton
refinement of (axis-angle, t) on the inlier set.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import lie

MIN_PNP_SAMPLE = 6


def pnp_dlt(X: jnp.ndarray, xn: jnp.ndarray, w: jnp.ndarray | None = None):
    """DLT pose from 2D-3D correspondences in *normalized* camera coords.

    X (..., N >= 6, 3) world points, xn (..., N, 2).  Returns (R, t) with
    x_cam = R X + t (world -> camera).  Solves P = [M|p] up to scale from
    A vec(P) = 0, then projects M onto a scaled rotation via SVD.
    """
    if w is None:
        w = jnp.ones(X.shape[:-1], dtype=X.dtype)
    ones = jnp.ones(X.shape[:-1] + (1,), dtype=X.dtype)
    Xh = jnp.concatenate([X, ones], axis=-1)  # (..., N, 4)
    zeros = jnp.zeros_like(Xh)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    r1 = jnp.concatenate([Xh, zeros, -u * Xh], axis=-1)  # (..., N, 12)
    r2 = jnp.concatenate([zeros, Xh, -v * Xh], axis=-1)
    A = jnp.concatenate([r1 * w[..., None], r2 * w[..., None]], axis=-2)
    AtA = jnp.swapaxes(A, -1, -2) @ A
    from ..core.triangulate import smallest_eigvec_sym

    p = smallest_eigvec_sym(AtA, iters=8)
    P = p.reshape(*p.shape[:-1], 3, 4)
    M = P[..., :, :3]
    t = P[..., :, 3]
    sgn = jnp.sign(jnp.linalg.det(M))[..., None, None]
    sgn = jnp.where(sgn == 0, 1.0, sgn)
    M = M * sgn
    t = t * sgn[..., 0]
    U, S, Vt = jnp.linalg.svd(M)
    R = U @ Vt
    scale = jnp.mean(S, axis=-1)
    t = t / jnp.maximum(scale[..., None], 1e-12)
    return R, t


def pnp_reproj_error(model, X: jnp.ndarray, xn: jnp.ndarray) -> jnp.ndarray:
    """Squared reprojection error in normalized coords; points behind the
    camera get infinite error (cheirality built into the score)."""
    R, t = model
    Xc = jnp.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z = Xc[..., 2]
    proj = Xc[..., :2] / jnp.where(jnp.abs(z[..., None]) < 1e-9, 1e-9, z[..., None])
    d = proj - xn
    err = jnp.sum(d * d, axis=-1)
    return jnp.where(z > 1e-6, err, jnp.float32(3.4e38))


def _p3p_solver(X, xn):
    from ..core.p3p import p3p_grunert

    R, t, ok = p3p_grunert(X, xn)
    return (R, t), ok


@partial(jax.jit, static_argnames=("n_iters", "refine_steps", "minimal"))
def pnp_ransac(
    key: jax.Array,
    X: jnp.ndarray,
    xn: jnp.ndarray,
    valid: jnp.ndarray,
    n_iters: int = 256,
    thresh_norm: float = 8.0 / 800.0,
    refine_steps: int = 10,
    minimal: str = "dlt",
):
    """Robust resection. X (N, 3), xn (N, 2) normalized coords, valid (N,).

    Returns (aa, t, inliers, n_inliers): axis-angle + translation
    (world -> camera), inlier mask.  Threshold default mirrors the
    reference's 8 px at a nominal f = 800 (SequentialActuator.h:176).

    minimal = "p3p" samples 3-point Grunert hypotheses (4 candidates each;
    OpenMVG-resection parity) instead of the 6-point DLT — cleaner samples
    under contamination at identical batched cost.
    """
    from .ransac import ransac

    if minimal == "p3p":
        (R, t), inl, n_inl = ransac(
            key, X, xn, valid,
            solver=_p3p_solver,
            scorer=pnp_reproj_error,
            sample_size=3,
            n_iters=n_iters,
            inlier_thresh=thresh_norm,
            n_candidates=4,
            refit_solver=pnp_dlt,
        )
    else:
        (R, t), inl, n_inl = ransac(
            key, X, xn, valid,
            solver=pnp_dlt,
            scorer=pnp_reproj_error,
            sample_size=MIN_PNP_SAMPLE,
            n_iters=n_iters,
            inlier_thresh=thresh_norm,
        )
    aa = lie.so3_log(R)

    # Fixed-iteration Gauss-Newton polish on inliers (substitutes the
    # reference's implicit reliance on Ceres BA to clean up after PnP).
    w = inl.astype(X.dtype)

    def residual(params):
        aa_, t_ = params[:3], params[3:]
        Xc = lie.rotate_aa(aa_[None], X) + t_[None]
        z = Xc[..., 2:3]
        proj = Xc[..., :2] / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        return ((proj - xn) * w[:, None]).reshape(-1)

    def gn_step(params, _):
        r = residual(params)
        J = jax.jacfwd(residual)(params)  # (2N, 6)
        H = J.T @ J + 1e-8 * jnp.eye(6)
        g = J.T @ r
        step = jnp.linalg.solve(H, g)
        new = params - step
        better = jnp.sum(residual(new) ** 2) <= jnp.sum(r ** 2)
        return jnp.where(better, new, params), None

    params0 = jnp.concatenate([aa, t])
    params, _ = jax.lax.scan(gn_step, params0, None, length=refine_steps)
    aa, t = params[:3], params[3:]
    # Recompute inliers under the polished pose.
    R = lie.so3_exp(aa)
    errs = pnp_reproj_error((R, t), X, xn)
    inl = (errs < thresh_norm * thresh_norm) & valid
    return aa, t, inl, jnp.sum(inl)
