"""Two-view epipolar geometry: normalized 8-point F/E, E decomposition,
pose recovery, and epipolar error metrics.

Capability parity with the reference's geometric filtering and bootstrap:
cv::findEssentialMat / recoverPose (src/actuator/SequentialActuator.h:108-131)
and OpenMVG's F/E AC-RANSAC filter models
(src/sparseBuilder/sparseBuilder.cpp:1037-1040, 1168-1237).

Solvers are written to batch over hypothesis sets: a leading batch dimension on
the correspondence arrays yields one model per batch row — the unit of work for
fixed-size RANSAC (SURVEY.md §7 hard part 1).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _normalize_points(x: jnp.ndarray, w: jnp.ndarray | None = None):
    """Hartley normalization: translate centroid to origin, scale mean norm to
    sqrt(2).  x: (..., N, 2), optional weights (..., N) for masked samples.
    Returns (x_norm, T) with T (..., 3, 3) such that x_norm_h = T @ x_h."""
    if w is None:
        w = jnp.ones(x.shape[:-1], dtype=x.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    mean = jnp.sum(x * w[..., None], axis=-2, keepdims=True) / wsum[..., None]
    centered = x - mean
    dist = jnp.sqrt(jnp.sum(centered * centered, axis=-1) + 1e-18)
    mean_dist = jnp.sum(dist * w, axis=-1, keepdims=True) / wsum
    scale = jnp.sqrt(2.0) / jnp.maximum(mean_dist, 1e-9)
    xn = centered * scale[..., None]
    s = scale[..., 0]
    mx = mean[..., 0, 0]
    my = mean[..., 0, 1]
    zeros = jnp.zeros_like(s)
    ones = jnp.ones_like(s)
    T = jnp.stack(
        [
            jnp.stack([s, zeros, -s * mx], axis=-1),
            jnp.stack([zeros, s, -s * my], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
    return xn, T


def _solve_epipolar_lstsq(x0n: jnp.ndarray, x1n: jnp.ndarray, w: jnp.ndarray):
    """Least-squares epipolar constraint: rows a_i = kron(x1h, x0h); the
    null vector of the 9x9 A^T A comes from shifted inverse iteration
    (batched, eigh-free — see core.triangulate.smallest_eigvec_sym)."""
    ones = jnp.ones(x0n.shape[:-1] + (1,), dtype=x0n.dtype)
    p0 = jnp.concatenate([x0n, ones], axis=-1)  # (..., N, 3)
    p1 = jnp.concatenate([x1n, ones], axis=-1)
    A = (p1[..., :, None] * p0[..., None, :]).reshape(*x0n.shape[:-1], 9)
    A = A * w[..., None]
    AtA = jnp.swapaxes(A, -1, -2) @ A
    from .triangulate import smallest_eigvec_sym

    f = smallest_eigvec_sym(AtA, iters=8)
    return f.reshape(*f.shape[:-1], 3, 3)


def _drop_smallest_singular(F: jnp.ndarray) -> jnp.ndarray:
    """Rank-2 projection without SVD: F2 = F - sigma3 u3 v3^T, where u3/v3
    are the smallest singular vectors from inverse iteration on F F^T / F^T F
    (a batched 3x3 SVD is the hypothesis solver's hot spot; this form is a
    handful of fused elementwise ops)."""
    from .triangulate import smallest_eigvec_sym

    Ft = jnp.swapaxes(F, -1, -2)
    v3 = smallest_eigvec_sym(Ft @ F, iters=6)      # right
    u3 = smallest_eigvec_sym(F @ Ft, iters=6)      # left
    Fv = jnp.einsum("...ij,...j->...i", F, v3)
    sigma3 = jnp.einsum("...i,...i->...", u3, Fv)
    return F - sigma3[..., None, None] * (u3[..., :, None] * v3[..., None, :])


def _enforce_rank2(F: jnp.ndarray) -> jnp.ndarray:
    return _drop_smallest_singular(F)


def _enforce_essential(E: jnp.ndarray) -> jnp.ndarray:
    """Project onto the essential manifold (singular values -> (s, s, 0))
    without SVD: drop the smallest singular value, then whiten the two
    remaining singular values EXACTLY with a linear polynomial in
    A = E2^T E2 — on A's 2-D range, p(A) = c0 I + c1 A maps sigma_i to
    sigma_i * p(sigma_i^2) = 1 when p interpolates 1/sqrt at A's two nonzero
    eigenvalues (closed form from the trace invariants; smooth as
    sigma1 -> sigma2).  E is scale-free, so unit singular values ARE the
    manifold; callers renormalize."""
    E2 = _drop_smallest_singular(E)
    A = jnp.swapaxes(E2, -1, -2) @ E2
    t1 = jnp.trace(A, axis1=-2, axis2=-1)
    t2 = jnp.trace(A @ A, axis1=-2, axis2=-1)
    disc = jnp.sqrt(jnp.maximum(2.0 * t2 - t1 * t1, 0.0))
    a = jnp.maximum(0.5 * (t1 + disc), 1e-30)
    b = jnp.clip(0.5 * (t1 - disc), 1e-6 * a, a)
    sa = jnp.sqrt(a)
    sb = jnp.sqrt(b)
    c1 = -1.0 / (sa * sb * (sa + sb))
    c0 = 1.0 / sa - c1 * a
    W = c0[..., None, None] * jnp.eye(3, dtype=E.dtype) + c1[..., None, None] * A
    return E2 @ W


def fundamental_8pt(x0: jnp.ndarray, x1: jnp.ndarray, w: jnp.ndarray | None = None) -> jnp.ndarray:
    """Normalized 8-point fundamental matrix. x0, x1: (..., N>=8, 2) pixels.
    Returns F (..., 3, 3) with x1h^T F x0h = 0."""
    if w is None:
        w = jnp.ones(x0.shape[:-1], dtype=x0.dtype)
    x0n, T0 = _normalize_points(x0, w)
    x1n, T1 = _normalize_points(x1, w)
    Fn = _solve_epipolar_lstsq(x0n, x1n, w)
    Fn = _enforce_rank2(Fn)
    F = jnp.swapaxes(T1, -1, -2) @ Fn @ T0
    norm = jnp.linalg.norm(F.reshape(*F.shape[:-2], 9), axis=-1)[..., None, None]
    return F / jnp.maximum(norm, 1e-12)


def essential_8pt(x0n: jnp.ndarray, x1n: jnp.ndarray, w: jnp.ndarray | None = None) -> jnp.ndarray:
    """Essential matrix from >= 8 normalized-coordinate correspondences,
    projected onto the essential manifold. Returns E with x1h^T E x0h = 0."""
    if w is None:
        w = jnp.ones(x0n.shape[:-1], dtype=x0n.dtype)
    x0h, T0 = _normalize_points(x0n, w)
    x1h, T1 = _normalize_points(x1n, w)
    En = _solve_epipolar_lstsq(x0h, x1h, w)
    E = jnp.swapaxes(T1, -1, -2) @ En @ T0
    E = _enforce_essential(E)
    norm = jnp.linalg.norm(E.reshape(*E.shape[:-2], 9), axis=-1)[..., None, None]
    return E / jnp.maximum(norm, 1e-12)


# ---------------------------------------------------------------------------
# Minimal solvers: 7-point F (3 roots) and 5-point E (10 roots)
#
# Capability parity with OpenMVG's minimal solvers (linked libraries the
# reference uses for AC-RANSAC filtering and essential estimation,
# SURVEY.md §2.2).  Both are fully batched: polynomial roots come from the
# Durand–Kerner sweeps in core.polynomial (JAX's nonsymmetric eig runs on
# the CPU only),
# and every root becomes an independent RANSAC hypothesis.
# ---------------------------------------------------------------------------


def _epipolar_nullspace(x0: jnp.ndarray, x1: jnp.ndarray, k: int):
    """Last-k right singular vectors of the (..., N, 9) epipolar constraint
    matrix, reshaped to k candidate 3x3s."""
    ones = jnp.ones(x0.shape[:-1] + (1,), dtype=x0.dtype)
    p0 = jnp.concatenate([x0, ones], axis=-1)
    p1 = jnp.concatenate([x1, ones], axis=-1)
    A = (p1[..., :, None] * p0[..., None, :]).reshape(*x0.shape[:-1], 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    null = Vt[..., 9 - k :, :]  # (..., k, 9)
    return null.reshape(*null.shape[:-1], 3, 3)


# Fixed interpolation nodes for extracting cubic coefficients of
# det(F1 + lam*F2): deg-3 Vandermonde inverse, precomputed exactly.
_L7 = np.array([-1.5, -0.5, 0.5, 1.5])
_V7INV = np.linalg.inv(np.stack([_L7**3, _L7**2, _L7, np.ones(4)], axis=1))


def fundamental_7pt(x0: jnp.ndarray, x1: jnp.ndarray):
    """7-point fundamental solver.  x0, x1: (..., 7, 2) pixels.
    Returns (F (..., 3, 3, 3), ok (..., 3)): up to three real candidates
    (det(F1 + lam F2) = 0 cubic), Hartley-normalized for conditioning."""
    x0n, T0 = _normalize_points(x0)
    x1n, T1 = _normalize_points(x1)
    null = _epipolar_nullspace(x0n, x1n, 2)  # (..., 2, 3, 3)
    F2, F1 = null[..., 0, :, :], null[..., 1, :, :]

    lam = jnp.asarray(_L7, dtype=x0.dtype)
    Fl = F1[..., None, :, :] + lam[:, None, None] * F2[..., None, :, :]
    dets = jnp.linalg.det(Fl)  # (..., 4)
    coeffs = jnp.einsum("ij,...j->...i", jnp.asarray(_V7INV, x0.dtype), dets)
    from .polynomial import real_roots

    roots, ok = real_roots(coeffs, iters=40)  # (..., 3)
    F = F1[..., None, :, :] + roots[..., :, None, None] * F2[..., None, :, :]
    F = jnp.swapaxes(T1, -1, -2)[..., None, :, :] @ F @ T0[..., None, :, :]
    norm = jnp.linalg.norm(F.reshape(*F.shape[:-2], 9), axis=-1)[..., None, None]
    return F / jnp.maximum(norm, 1e-12), ok


def _e_constraints(E: jnp.ndarray) -> jnp.ndarray:
    """The ten cubic essential-matrix constraints: det(E) and the nine
    entries of 2 E E^T E - tr(E E^T) E.  (..., 3, 3) -> (..., 10)."""
    det = jnp.linalg.det(E)
    EEt = E @ jnp.swapaxes(E, -1, -2)
    tr = jnp.trace(EEt, axis1=-2, axis2=-1)[..., None, None]
    C = 2.0 * (EEt @ E) - tr * E
    return jnp.concatenate([det[..., None], C.reshape(*C.shape[:-2], 9)], axis=-1)


def _e_constraints_dir(E: jnp.ndarray, D: jnp.ndarray) -> jnp.ndarray:
    """Directional derivative of _e_constraints at E along D (analytic)."""
    # d det = <cofactor(E), D>; cofactor rows are cross products of E's rows.
    cof = jnp.stack(
        [
            jnp.cross(E[..., 1, :], E[..., 2, :]),
            jnp.cross(E[..., 2, :], E[..., 0, :]),
            jnp.cross(E[..., 0, :], E[..., 1, :]),
        ],
        axis=-2,
    )
    ddet = jnp.sum(cof * D, axis=(-1, -2))
    Et = jnp.swapaxes(E, -1, -2)
    Dt = jnp.swapaxes(D, -1, -2)
    EEt = E @ Et
    trEEt = jnp.trace(EEt, axis1=-2, axis2=-1)[..., None, None]
    trEDt = jnp.trace(E @ Dt, axis1=-2, axis2=-1)[..., None, None]
    dC = (
        2.0 * (D @ Et @ E + E @ Dt @ E + EEt @ D)
        - 2.0 * trEDt * E
        - trEEt * D
    )
    return jnp.concatenate([ddet[..., None], dC.reshape(*dC.shape[:-2], 9)], axis=-1)


def _mono20(p: np.ndarray) -> np.ndarray:
    """Evaluate the 20 Stewénius monomials at points p (M, 3): ten cubics
    [x3 x2y xy2 y3 x2z xyz y2z xz2 yz2 z3] then the ten-element quotient
    basis [x2 xy y2 xz yz z2 x y z 1]."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    one = np.ones_like(x)
    return np.stack(
        [
            x**3, x**2 * y, x * y**2, y**3, x**2 * z, x * y * z, y**2 * z,
            x * z**2, y * z**2, z**3,
            x**2, x * y, y**2, x * z, y * z, z**2, x, y, z, one,
        ],
        axis=1,
    )


# Fixed generic interpolation nodes: the 20x20 monomial matrix is inverted
# once in float64 at import; constraint-polynomial coefficients then come
# from 20 evaluations instead of symbolic expansion.
_P5 = np.random.default_rng(7).uniform(-1.0, 1.0, (20, 3))
_V5INV = np.linalg.inv(_mono20(_P5))
_Q5 = np.linalg.qr(np.random.default_rng(11).normal(size=(4, 4)))[0]


def essential_5pt(x0n: jnp.ndarray, x1n: jnp.ndarray):
    """Nistér/Stewénius 5-point essential solver, batched.

    x0n, x1n: (..., 5, 2) normalized camera coords.  Returns
    (E (..., 10, 3, 3), ok (..., 10)) — up to ten real candidates.

    Pipeline: 4-dim nullspace -> constraint coefficients by interpolation
    at fixed generic nodes -> Gauss-Jordan to the 10x10 quotient-basis
    relation -> multiplication-by-x action matrix -> characteristic
    polynomial (Faddeev-LeVerrier) -> Durand-Kerner roots -> eigenvector
    nullspaces give (y, z) -> Gauss-Newton polish on the ten constraints.
    """
    nulls = _epipolar_nullspace(x0n, x1n, 4)  # (..., 4, 3, 3)
    # Rotate the nullspace basis by a fixed generic orthogonal matrix: the
    # quotient-ring normalization divides by the W coefficient, and SVD's
    # natural basis ordering regularly puts the true solution nearly
    # orthogonal to W (|x,y,z| up to ~1e2, which float32 charpoly roots
    # cannot survive).  A generic basis keeps solution coordinates O(1).
    Qrot = jnp.asarray(_Q5, x0n.dtype)
    flat = nulls.reshape(*nulls.shape[:-3], 4, 9)
    nulls = jnp.einsum("ab,...bj->...aj", Qrot, flat).reshape(*nulls.shape)
    X_, Y_, Z_, W_ = (nulls[..., i, :, :] for i in range(4))

    # Constraint values at the 20 nodes: E_p = x X + y Y + z Z + W.
    pts = jnp.asarray(_P5, x0n.dtype)  # (20, 3)
    Ep = (
        pts[:, 0, None, None] * X_[..., None, :, :]
        + pts[:, 1, None, None] * Y_[..., None, :, :]
        + pts[:, 2, None, None] * Z_[..., None, :, :]
        + W_[..., None, :, :]
    )  # (..., 20, 3, 3)
    vals = _e_constraints(Ep)  # (..., 20, 10)
    Vinv = jnp.asarray(_V5INV, x0n.dtype)
    M = jnp.einsum("mp,...pe->...em", Vinv, vals)  # (..., 10, 20)

    M10 = M[..., :, :10]
    tr = jnp.trace(jnp.swapaxes(M10, -1, -2) @ M10, axis1=-2, axis2=-1)
    reg = (1e-9 * tr + 1e-20)[..., None, None] * jnp.eye(10, dtype=M.dtype)
    B = jnp.linalg.solve(M10 + reg, M[..., :, 10:])  # (..., 10, 10)

    # Action matrix for multiplication by x on the quotient basis
    # [x2 xy y2 xz yz z2 x y z 1].
    e = jnp.eye(10, dtype=M.dtype)
    ebr = jnp.broadcast_to(e, B.shape)
    At = jnp.stack(
        [
            -B[..., 0, :], -B[..., 1, :], -B[..., 2, :],
            -B[..., 4, :], -B[..., 5, :], -B[..., 7, :],
            ebr[..., 0, :], ebr[..., 1, :], ebr[..., 3, :], ebr[..., 6, :],
        ],
        axis=-2,
    )  # (..., 10, 10)

    # Characteristic polynomial via Faddeev-LeVerrier — on a spectrally
    # scaled copy: eigenvalues of At can reach ~10, and charpoly
    # coefficients then span |lambda|^10 ~ 1e10, unrepresentable in
    # float32.  Dividing At by its inf-norm bounds all eigenvalues by 1,
    # keeps every coefficient O(C(10,k)), and the roots scale back exactly.
    n = 10
    s = jnp.max(jnp.sum(jnp.abs(At), axis=-1), axis=-1)  # (...,) inf-norm
    s = jnp.maximum(s, 1e-6)
    Ats = At / s[..., None, None]
    eye10 = jnp.eye(n, dtype=At.dtype)
    coeffs = [jnp.ones(At.shape[:-2], At.dtype)]  # c_n = 1
    Mk = jnp.zeros_like(At)
    for k in range(1, n + 1):
        Mk = Ats @ Mk + coeffs[-1][..., None, None] * eye10
        ck = -jnp.trace(Ats @ Mk, axis1=-2, axis2=-1) / k
        coeffs.append(ck)
    charpoly = jnp.stack(coeffs, axis=-1)  # (..., 11) highest-first

    from .polynomial import real_roots
    from .triangulate import smallest_eigvec_sym

    xr, ok = real_roots(charpoly, iters=100)  # (..., 10)
    xr = xr * s[..., None]

    # Eigenvector for each root: nullspace of (At - x I) gives the monomial
    # vector [.., x, y, z, 1] up to scale.  In float32 the charpoly roots
    # (and hence these vectors) are only ~1e-1..1e-3 starting guesses; the
    # LM polish below does the real work, so no filtering here beyond the
    # scale guard.
    Mx = At[..., None, :, :] - xr[..., :, None, None] * eye10
    G = jnp.swapaxes(Mx, -1, -2) @ Mx  # (..., 10, 10, 10)
    v = smallest_eigvec_sym(G, iters=8)  # (..., 10, 10)
    denom = v[..., 9]
    denom = jnp.where(jnp.abs(denom) < 1e-8, 1e-8, denom)
    ys = v[..., 7] / denom
    zs = v[..., 8] / denom

    def build_E(x, y, z):
        return (
            x[..., None, None] * X_[..., None, :, :]
            + y[..., None, None] * Y_[..., None, :, :]
            + z[..., None, None] * Z_[..., None, :, :]
            + W_[..., None, :, :]
        )

    # Levenberg-Marquardt on the ten constraints from each eigen start —
    # quadratic convergence recovers float64-grade solutions from float32
    # charpoly seeds; starts that converge to the same solution just
    # duplicate a hypothesis, starts that diverge fail the residual gate.
    x, y, z = xr, ys, zs
    lam_lm = jnp.full(x.shape, 1e-4, x.dtype)
    for _ in range(8):
        E = build_E(x, y, z)
        r = _e_constraints(E)  # (..., 10cand, 10)
        Jx = _e_constraints_dir(E, jnp.broadcast_to(X_[..., None, :, :], E.shape))
        Jy = _e_constraints_dir(E, jnp.broadcast_to(Y_[..., None, :, :], E.shape))
        Jz = _e_constraints_dir(E, jnp.broadcast_to(Z_[..., None, :, :], E.shape))
        J = jnp.stack([Jx, Jy, Jz], axis=-1)  # (..., 10, 10, 3)
        JtJ = jnp.swapaxes(J, -1, -2) @ J
        diag = jnp.maximum(jnp.diagonal(JtJ, axis1=-2, axis2=-1), 1e-12)
        H = JtJ + lam_lm[..., None, None] * (
            diag[..., :, None] * jnp.eye(3, dtype=J.dtype)
        )
        g = jnp.einsum("...ri,...r->...i", J, r)
        step = jnp.linalg.solve(H, g[..., None])[..., 0]
        xn_, yn_, zn_ = x - step[..., 0], y - step[..., 1], z - step[..., 2]
        rn = _e_constraints(build_E(xn_, yn_, zn_))
        better = jnp.sum(rn * rn, -1) <= jnp.sum(r * r, -1)
        x = jnp.where(better, xn_, x)
        y = jnp.where(better, yn_, y)
        z = jnp.where(better, zn_, z)
        lam_lm = jnp.where(better, lam_lm * 0.3, lam_lm * 8.0)
        lam_lm = jnp.clip(lam_lm, 1e-7, 1e3)

    E = build_E(x, y, z)
    norm = jnp.linalg.norm(E.reshape(*E.shape[:-2], 9), axis=-1)
    ok = norm > 1e-9
    E = E / jnp.maximum(norm, 1e-12)[..., None, None]
    # Validity = the scale-free constraint residual (all ten constraints are
    # homogeneous cubics, so on unit-norm E this is an absolute test).
    resid = jnp.linalg.norm(_e_constraints(E), axis=-1)
    ok = ok & (resid < 1e-3)
    return E, ok


def sampson_error(F: jnp.ndarray, x0: jnp.ndarray, x1: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) error of x1^T F x0.  F: (..., 3, 3),
    x0/x1: (..., N, 2).  Returns (..., N) squared errors — the RANSAC score
    (OpenMVG's AC-RANSAC scores a closely related residual)."""
    ones = jnp.ones(x0.shape[:-1] + (1,), dtype=x0.dtype)
    p0 = jnp.concatenate([x0, ones], axis=-1)
    p1 = jnp.concatenate([x1, ones], axis=-1)
    Fx0 = jnp.einsum("...ij,...nj->...ni", F, p0)
    Ftx1 = jnp.einsum("...ji,...nj->...ni", F, p1)
    num = jnp.einsum("...ni,...ni->...n", p1, Fx0)
    denom = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num * num / jnp.maximum(denom, 1e-12)


def epipolar_distance(F: jnp.ndarray, x0: jnp.ndarray, x1: jnp.ndarray) -> jnp.ndarray:
    """Symmetric point-to-epipolar-line squared distance."""
    ones = jnp.ones(x0.shape[:-1] + (1,), dtype=x0.dtype)
    p0 = jnp.concatenate([x0, ones], axis=-1)
    p1 = jnp.concatenate([x1, ones], axis=-1)
    l1 = jnp.einsum("...ij,...nj->...ni", F, p0)  # line in image 1
    l0 = jnp.einsum("...ji,...nj->...ni", F, p1)  # line in image 0
    s = jnp.einsum("...ni,...ni->...n", p1, l1)
    d1 = s * s / jnp.maximum(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12)
    d0 = s * s / jnp.maximum(l0[..., 0] ** 2 + l0[..., 1] ** 2, 1e-12)
    return 0.5 * (d0 + d1)


def decompose_essential(E: jnp.ndarray):
    """E -> the four (R, t) candidates (R1,t), (R1,-t), (R2,t), (R2,-t).
    Returns (R: (..., 4, 3, 3), t: (..., 4, 3)) with unit-norm t."""
    U, _, Vt = jnp.linalg.svd(E)
    # Make proper rotations.
    detU = jnp.linalg.det(U)
    detVt = jnp.linalg.det(Vt)
    U = U * jnp.where(detU < 0, -1.0, 1.0)[..., None, None]
    Vt = Vt * jnp.where(detVt < 0, -1.0, 1.0)[..., None, None]
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = jnp.stack([R1, R1, R2, R2], axis=-3)
    ts = jnp.stack([t, -t, t, -t], axis=-2)
    return Rs, ts


def pose_from_candidates(Rs: jnp.ndarray, ts: jnp.ndarray, x0n: jnp.ndarray,
                         x1n: jnp.ndarray, w: jnp.ndarray | None = None):
    """Choose the (R, t) candidate with maximal cheirality support among K
    candidate motions (Rs (K, 3, 3), ts (K, 3)) — the generic core behind
    cv::recoverPose (essential) and homography-decomposition selection.

    Returns (R, t, n_good, front_mask, X) with camera 0 at identity."""
    from .triangulate import triangulate_two_view

    if w is None:
        w = jnp.ones(x0n.shape[:-1], dtype=x0n.dtype)
    K = Rs.shape[0]
    P0 = jnp.concatenate(
        [jnp.eye(3, dtype=Rs.dtype), jnp.zeros((3, 1), dtype=Rs.dtype)], axis=1
    )

    def count_front(R, t):
        P1 = jnp.concatenate([R, t[:, None]], axis=1)
        X = triangulate_two_view(P0, P1, x0n, x1n)  # (N, 3)
        z0 = X[..., 2]
        z1 = jnp.einsum("j,nj->n", R[2], X) + t[2]
        # Reasonable-depth guard mirrors recoverPose's distanceThresh.
        front = (z0 > 1e-4) & (z1 > 1e-4) & (z0 < 1e4)
        return jnp.sum(front * w), front, X

    counts, fronts, Xs = [], [], []
    for i in range(K):
        c, f, X = count_front(Rs[i], ts[i])
        counts.append(c)
        fronts.append(f)
        Xs.append(X)
    counts = jnp.stack(counts)
    best = jnp.argmax(counts)
    R = Rs[best]
    t = ts[best]
    front = jnp.stack(fronts)[best]
    X = jnp.stack(Xs)[best]
    return R, t, counts[best], front, X


def recover_pose(E: jnp.ndarray, x0n: jnp.ndarray, x1n: jnp.ndarray, w: jnp.ndarray | None = None):
    """Choose the (R, t) candidate with maximal cheirality support
    (parity: cv::recoverPose, src/actuator/SequentialActuator.h:114).

    x0n, x1n: (N, 2) normalized coords (camera 0 is identity).  Returns
    (R, t, n_good, front_mask) where (R, t) maps camera-0 frame to camera-1.
    """
    Rs, ts = decompose_essential(E)  # (4,3,3), (4,3)
    return pose_from_candidates(Rs, ts, x0n, x1n, w)
