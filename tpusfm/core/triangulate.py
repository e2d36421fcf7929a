"""Triangulation: two-view DLT and masked N-view DLT.

Capability parity with cv::triangulatePoints usage in the reference
(src/actuator/SequentialActuator.h:212-221, normalized-coordinate variant) and
OpenMVG track triangulation inside ``reconstruction()``.  Everything is batched
and mask-driven so variable-length tracks become fixed-capacity array programs.
"""

from __future__ import annotations

import jax.numpy as jnp


def _chol_small(A: jnp.ndarray):
    """Unrolled batched Cholesky of a small SPD matrix (..., n, n) — pure
    elementwise ops.  XLA's batched `inv`/`solve` lower to pivoted LU
    library calls; the unrolled factorization fuses into the caller.  Returns the lower factor as an (n, n) python
    grid of (...,) scalars."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve_small(L, b: jnp.ndarray) -> jnp.ndarray:
    """Solve (L L^T) x = b with the unrolled factor; b (..., n)."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def smallest_eigvec_sym(A: jnp.ndarray, iters: int = 6) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of a symmetric PSD matrix
    (..., n, n) by shifted inverse iteration.

    jnp.linalg.eigh runs a full spectral decomposition; DLT only
    needs the bottom eigenvector, and the normal matrices here are tiny
    (3x3 / 4x4 / 9x9), so an unrolled Cholesky + a few triangular solves is
    both faster and ~100x cheaper to compile."""
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)
    tr = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None]
    B = A + (1e-7 * tr + 1e-20) * eye
    L = _chol_small(B)
    # Start from a fixed generic vector; fp asymmetry breaks pathological
    # orthogonality, and degenerate spectra are filtered by callers' gates.
    ones = jnp.ones(B.shape[:-1], dtype=A.dtype)
    v = _chol_solve_small(L, ones.at[..., -1].add(0.25))
    for _ in range(iters):
        v = _chol_solve_small(L, v)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
    return v


def triangulate_two_view(P0: jnp.ndarray, P1: jnp.ndarray, x0: jnp.ndarray, x1: jnp.ndarray) -> jnp.ndarray:
    """DLT triangulation for point batches from two cameras.

    P0, P1: (3, 4) projection matrices (K[R|t] for pixel coords, or [R|t] for
    normalized coords).  x0, x1: (N, 2) measurements.  Returns (N, 3).

    Solves the 4x4 homogeneous system per point via the eigenvector of A^T A
    with the smallest eigenvalue (a symmetric eigenproblem of the 4x4 normal
    matrix batches better than a full SVD of a tall A).
    """
    rows = []
    for P, x in ((P0, x0), (P1, x1)):
        P0r = P[..., None, 0, :]  # (..., 1, 4)
        P1r = P[..., None, 1, :]
        P2r = P[..., None, 2, :]
        rows.append(x[..., :, 0:1] * P2r - P0r)  # (..., N, 4)
        rows.append(x[..., :, 1:2] * P2r - P1r)
    A = jnp.stack(rows, axis=-2)  # (..., N, 4, 4)
    AtA = jnp.swapaxes(A, -1, -2) @ A
    Xh = smallest_eigvec_sym(AtA)
    w = Xh[..., 3:4]
    w = jnp.where(jnp.abs(w) < 1e-12, jnp.sign(w) * 1e-12 + (w == 0) * 1e-12, w)
    return Xh[..., :3] / w


def triangulate_n_view(P: jnp.ndarray, x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Masked N-view DLT: P (V, 3, 4), x (V, 2), mask (V,) -> (3,).

    Each valid view contributes two rows to A^T A; invalid views are zeroed
    out, so tracks of any length <= V share one fixed shape.  vmap over tracks.
    """
    r0 = x[..., 0:1, None] * P[..., 2:3, :] - P[..., 0:1, :]  # (V, 1, 4)
    r1 = x[..., 1:2, None] * P[..., 2:3, :] - P[..., 1:2, :]
    A = jnp.concatenate([r0, r1], axis=-2)  # (V, 2, 4)
    A = A * mask[..., None, None]
    A2 = A.reshape(*A.shape[:-3], -1, 4)  # (2V, 4)
    AtA = jnp.swapaxes(A2, -1, -2) @ A2
    Xh = smallest_eigvec_sym(AtA)
    w = Xh[..., 3:4]
    w = jnp.where(jnp.abs(w) < 1e-12, jnp.sign(w) * 1e-12 + (w == 0) * 1e-12, w)
    return Xh[..., :3] / w


def triangulation_angle(C0: jnp.ndarray, C1: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Parallax angle (radians) at X subtended by camera centers C0, C1."""
    a = C0 - X
    b = C1 - X
    cos = jnp.sum(a * b, axis=-1) / jnp.maximum(
        jnp.linalg.norm(a, axis=-1) * jnp.linalg.norm(b, axis=-1), 1e-12
    )
    return jnp.arccos(jnp.clip(cos, -1.0, 1.0))
