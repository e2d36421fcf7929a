"""Batched polynomial root finding for minimal solvers.

The reference's minimal solvers live inside OpenMVG/OpenCV (P3P resection,
5-point essential, 7-point fundamental — linked libraries, SURVEY.md §2.2
"OpenMVG libraries") and bottom out in sequential eigenvalue / companion-
matrix routines.  JAX's nonsymmetric `eig` runs on the CPU only, and RANSAC needs
thousands of tiny independent solves, so we use the Durand–Kerner
(Weierstrass) simultaneous-iteration method instead: a fixed number of
branch-free sweeps that find ALL roots of each polynomial in a batch at
once.  Complex arithmetic is carried as explicit (real, imag) float pairs,
which stay plain fused elementwise float math.  Degenerate hypotheses produce garbage roots that simply lose
the RANSAC argmax — no rejection branching.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = jnp.maximum(br * br + bi * bi, 1e-30)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def poly_eval_c(coeffs: jnp.ndarray, zr: jnp.ndarray, zi: jnp.ndarray):
    """Horner evaluation at complex points. coeffs (..., d+1) real,
    highest-degree first; zr/zi (..., R).  Returns (pr, pi)."""
    d = coeffs.shape[-1] - 1
    pr = jnp.broadcast_to(coeffs[..., 0:1], zr.shape)
    pi = jnp.zeros_like(zr)
    for i in range(1, d + 1):
        pr, pi = _cmul(pr, pi, zr, zi)
        pr = pr + coeffs[..., i : i + 1]
    return pr, pi


def poly_roots(coeffs: jnp.ndarray, iters: int = 80):
    """All roots of each real polynomial in a batch.

    coeffs: (..., d+1) real, highest-degree coefficient first.
    Returns (roots_re (..., d), roots_im (..., d)).

    Durand–Kerner: z_i <- z_i - p(z_i) / prod_{j!=i} (z_i - z_j), run a fixed
    `iters` sweeps from the standard (0.4 + 0.9i)^k initialization scaled by
    the Cauchy root bound.  Near-zero leading coefficients are regularized;
    such polynomials return junk roots rather than NaN-poisoning the batch.
    """
    d = coeffs.shape[-1] - 1
    scale = jnp.max(jnp.abs(coeffs), axis=-1, keepdims=True)
    scale = jnp.where(scale > 0, scale, 1.0)
    c = coeffs / scale
    lead = c[..., 0:1]
    lead = jnp.where(jnp.abs(lead) < 1e-12, jnp.where(lead >= 0, 1e-12, -1e-12), lead)
    monic = c / lead  # (..., d+1), monic[..., 0] = 1

    # Cauchy bound: all roots lie within 1 + max |a_i|.
    bound = 1.0 + jnp.max(jnp.abs(monic[..., 1:]), axis=-1)  # (...,)
    w = np.power(0.4 + 0.9j, np.arange(1, d + 1))
    w = w / np.abs(w) ** 0.5
    z0r = bound[..., None] * jnp.asarray(w.real, dtype=coeffs.dtype)
    z0i = bound[..., None] * jnp.asarray(w.imag, dtype=coeffs.dtype)

    eye = jnp.eye(d, dtype=coeffs.dtype)

    def body(z, _):
        zr, zi = z
        pr, pi = poly_eval_c(monic, zr, zi)  # (..., d)
        # Pairwise differences, diagonal -> 1 + 0i.
        dr = zr[..., :, None] - zr[..., None, :] + eye
        di = zi[..., :, None] - zi[..., None, :]
        # Product over the last axis (d is tiny: unrolled complex product).
        qr = dr[..., 0]
        qi = di[..., 0]
        for k in range(1, d):
            qr, qi = _cmul(qr, qi, dr[..., k], di[..., k])
        sr, si = _cdiv(pr, pi, qr, qi)
        # Trust-region clip: keeps divergent iterates (degenerate inputs)
        # from overflowing to inf and breaking later sweeps.
        mag = jnp.sqrt(sr * sr + si * si)
        lim = 10.0 * bound[..., None]
        f = jnp.where(mag > lim, lim / jnp.maximum(mag, 1e-30), 1.0)
        return (zr - sr * f, zi - si * f), None

    (zr, zi), _ = lax.scan(body, (z0r, z0i), None, length=iters)
    return zr, zi


def real_roots(coeffs: jnp.ndarray, iters: int = 80, imag_tol: float = 1e-3,
               polish_iters: int = 3):
    """poly_roots + realness mask.  Returns (roots_real (..., d), is_real
    (..., d) bool); complex-pair roots still appear (as their real parts)
    but flagged False so callers can mask candidate models.

    Real roots get a few Newton steps against the real polynomial — DK in
    float32 can leave ~1e-3 relative error on clustered roots; Newton
    quadratically tightens exactly the roots we keep."""
    zr, zi = poly_roots(coeffs, iters=iters)
    ok = jnp.abs(zi) <= imag_tol * (1.0 + jnp.abs(zr))
    d = coeffs.shape[-1] - 1
    dcoeffs = coeffs[..., :-1] * jnp.arange(d, 0, -1, dtype=coeffs.dtype)
    zero = jnp.zeros_like(zr)
    for _ in range(polish_iters):
        p, _ = poly_eval_c(coeffs, zr, zero)
        dp, _ = poly_eval_c(dcoeffs, zr, zero)
        step = p / jnp.where(jnp.abs(dp) < 1e-20, 1e-20, dp)
        # Only step where Newton is contracting (guards multiple roots).
        zr = zr - jnp.clip(step, -0.5, 0.5) * ok
    return zr, ok
