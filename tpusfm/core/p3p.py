"""Batched closed-form P3P (Grunert / Haralick) absolute-pose minimal solver.

Capability parity with OpenMVG's P3P resection used by the incremental
engine's AC-RANSAC localization (reference: engine->Process(),
src/sparseBuilder/sparseBuilder.cpp:1579, which resects with P3P-RANSAC) and
with cv::solvePnPRansac (src/actuator/SequentialActuator.h:175-177).

Batched design: the quartic in the distance ratio is solved for the whole
hypothesis batch at once with the Durand–Kerner sweeps in core.polynomial —
each 3-point sample yields up to 4 candidate poses; invalid roots yield
low-scoring junk poses that lose the RANSAC argmax instead of branching.
"""

from __future__ import annotations

import jax.numpy as jnp

from .polynomial import real_roots


def _triad(P: jnp.ndarray) -> jnp.ndarray:
    """Orthonormal frame (rows) from 3 points (..., 3, 3): e1 along P2-P1,
    e3 normal to the triangle, e2 = e3 x e1."""
    u = P[..., 1, :] - P[..., 0, :]
    v = P[..., 2, :] - P[..., 0, :]
    e1 = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
    n = jnp.cross(e1, v)
    e3 = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    e2 = jnp.cross(e3, e1)
    return jnp.stack([e1, e2, e3], axis=-2)


def align_3pts(Xw: jnp.ndarray, Xc: jnp.ndarray):
    """Rigid transform (R, t) with Xc_i = R @ Xw_i + t from exactly three
    non-collinear point pairs (..., 3, 3).  Branch-free triad method."""
    Rw = _triad(Xw)
    Rc = _triad(Xc)
    R = jnp.swapaxes(Rc, -1, -2) @ Rw
    t = Xc[..., 0, :] - jnp.einsum("...ij,...j->...i", R, Xw[..., 0, :])
    return R, t


def p3p_grunert(X: jnp.ndarray, xn: jnp.ndarray):
    """Grunert's P3P.  X (..., 3, 3) world points, xn (..., 3, 2) normalized
    image coords.  Returns (R (..., 4, 3, 3), t (..., 4, 3), ok (..., 4)):
    up to four candidate world->camera poses per sample; `ok` flags roots
    that were real and produced positive distances.

    Quartic coefficients follow Haralick et al., "Review and Analysis of
    Solutions of the Three Point Perspective Pose Estimation Problem"
    (Grunert 1841 section): with s2 = u*s1, s3 = v*s1 the law-of-cosines
    system reduces to A4 v^4 + ... + A0 = 0.
    """
    ones = jnp.ones(xn.shape[:-1] + (1,), dtype=xn.dtype)
    f = jnp.concatenate([xn, ones], axis=-1)
    f = f / jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-12)
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    X1, X2, X3 = X[..., 0, :], X[..., 1, :], X[..., 2, :]

    # Side lengths: a opposite P1 (between X2, X3), b opposite P2, c opposite P3.
    a2 = jnp.sum((X2 - X3) ** 2, axis=-1)
    b2 = jnp.sum((X1 - X3) ** 2, axis=-1)
    c2 = jnp.sum((X1 - X2) ** 2, axis=-1)
    b2 = jnp.maximum(b2, 1e-12)
    ca = jnp.sum(f2 * f3, axis=-1)  # cos(alpha): angle subtending side a
    cb = jnp.sum(f1 * f3, axis=-1)  # cos(beta)
    cg = jnp.sum(f1 * f2, axis=-1)  # cos(gamma)

    ab = a2 / b2
    cbb = c2 / b2
    q = (a2 - c2) / b2  # (a^2 - c^2) / b^2
    s = (a2 + c2) / b2

    A4 = (q - 1.0) ** 2 - 4.0 * cbb * ca**2
    A3 = 4.0 * (q * (1.0 - q) * cb - (1.0 - s) * ca * cg + 2.0 * cbb * ca**2 * cb)
    A2 = 2.0 * (
        q**2
        - 1.0
        + 2.0 * q**2 * cb**2
        + 2.0 * (1.0 - cbb) * ca**2
        - 4.0 * s * ca * cb * cg
        + 2.0 * (1.0 - ab) * cg**2
    )
    A1 = 4.0 * (-q * (1.0 + q) * cb + 2.0 * ab * cg**2 * cb - (1.0 - s) * ca * cg)
    A0 = (1.0 + q) ** 2 - 4.0 * ab * cg**2

    coeffs = jnp.stack([A4, A3, A2, A1, A0], axis=-1)  # (..., 5)
    v, real_ok = real_roots(coeffs, iters=60)  # (..., 4)

    # Back-substitute: u from v (Haralick eq. for Grunert), then distances.
    qv = q[..., None]
    denom_u = 2.0 * (cg[..., None] - v * ca[..., None])
    denom_u = jnp.where(jnp.abs(denom_u) < 1e-9, 1e-9, denom_u)
    u = ((-1.0 + qv) * v**2 - 2.0 * qv * cb[..., None] * v + 1.0 + qv) / denom_u

    s1_den = 1.0 + v**2 - 2.0 * v * cb[..., None]
    s1 = jnp.sqrt(b2[..., None] / jnp.maximum(s1_den, 1e-12))
    s2 = u * s1
    s3 = v * s1
    ok = real_ok & (s1 > 0) & (s2 > 0) & (s3 > 0) & (s1_den > 1e-12)

    # Newton polish in distance space: the quartic's roots cluster badly in
    # float32 near-degenerate configurations; the law-of-cosines system
    #   s2^2 + s3^2 - 2 s2 s3 ca = a2   (and cyclic)
    # is well-conditioned in (s1, s2, s3) directly, so a few 3x3 Newton
    # steps recover full float precision per candidate.
    dists = jnp.stack([s1, s2, s3], axis=-1)  # (..., 4, 3)
    cosv = jnp.stack(
        [jnp.broadcast_to(x[..., None], s1.shape) for x in (ca, cb, cg)], axis=-1
    )  # (..., 4, 3)
    rhs = jnp.stack(
        [jnp.broadcast_to(x[..., None], s1.shape) for x in (a2, b2, c2)], axis=-1
    )

    def _locos_resid(d):
        d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2]
        r1 = d2 * d2 + d3 * d3 - 2.0 * d2 * d3 * cosv[..., 0] - rhs[..., 0]
        r2 = d1 * d1 + d3 * d3 - 2.0 * d1 * d3 * cosv[..., 1] - rhs[..., 1]
        r3 = d1 * d1 + d2 * d2 - 2.0 * d1 * d2 * cosv[..., 2] - rhs[..., 2]
        return jnp.stack([r1, r2, r3], axis=-1)

    for _ in range(3):
        d1, d2, d3 = dists[..., 0], dists[..., 1], dists[..., 2]
        zero = jnp.zeros_like(d1)
        J = jnp.stack(
            [
                jnp.stack([zero, 2 * d2 - 2 * d3 * cosv[..., 0], 2 * d3 - 2 * d2 * cosv[..., 0]], axis=-1),
                jnp.stack([2 * d1 - 2 * d3 * cosv[..., 1], zero, 2 * d3 - 2 * d1 * cosv[..., 1]], axis=-1),
                jnp.stack([2 * d1 - 2 * d2 * cosv[..., 2], 2 * d2 - 2 * d1 * cosv[..., 2], zero], axis=-1),
            ],
            axis=-2,
        )
        r = _locos_resid(dists)
        JtJ = jnp.swapaxes(J, -1, -2) @ J + 1e-9 * jnp.eye(3, dtype=dists.dtype)
        g = jnp.einsum("...ji,...j->...i", J, r)
        step = jnp.linalg.solve(JtJ, g[..., None])[..., 0]
        new = dists - jnp.clip(step, -0.5, 0.5)
        better = jnp.sum(_locos_resid(new) ** 2, -1) <= jnp.sum(r * r, -1)
        dists = jnp.where(better[..., None], new, dists)
    Xc = dists[..., :, None] * f[..., None, :, :]
    Xw = jnp.broadcast_to(X[..., None, :, :], Xc.shape)
    R, t = align_3pts(Xw, Xc)
    return R, t, ok
