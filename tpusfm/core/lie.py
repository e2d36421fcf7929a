"""SO(3) / SE(3) operations, numerically stable near the identity.

The reference uses Sophus SE3d for poses (src/actuator/SequentialActuator.h:123,183)
and Ceres angle-axis parameterisation inside bundle adjustment
(src/adjuster/BundleAdjuster.h:40-68).  Here everything is a pure, jit-able,
vmappable function over jnp arrays; rotations are parameterised either as 3x3
matrices or as axis-angle 3-vectors (the BA parameterisation).

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-9


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of a 3-vector. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    Uses Taylor expansions of sin(t)/t and (1-cos(t))/t^2 below sqrt(eps) so the
    function (and its derivatives) are well defined at t = 0.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta_safe = jnp.sqrt(theta2_safe)
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks (autodiff-safe at 0).
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta_safe) / theta_safe)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta_safe)) / theta2_safe)
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Valid for rotation angles in [0, pi); near pi the axis is extracted from
    the symmetric part for stability.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # Antisymmetric part gives axis * sin(theta).
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)
    small = theta < 1e-5
    near_pi = theta > jnp.pi - 1e-3
    # Generic: w = theta / (2 sin theta) * v ; small-angle: w = v / 2.
    scale = jnp.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * jnp.maximum(sin_t, _EPS)))
    w_generic = scale[..., None] * v
    # Near pi: R ~ I + 2/pi^2 w w^T - ... ; use diagonal of (R + I)/2 = I + ww^T(1-cos)/t^2
    # axis_i^2 = (R_ii + 1) / 2 for theta = pi.
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_abs = jnp.sqrt(jnp.maximum((diag + 1.0) * 0.5, 0.0))
    # Fix signs from off-diagonal sums: sign(axis_i * axis_j) = sign(R_ij + R_ji).
    sx = jnp.ones_like(axis_abs[..., 0])
    sy = jnp.where(R[..., 0, 1] + R[..., 1, 0] >= 0, 1.0, -1.0)
    sz = jnp.where(R[..., 0, 2] + R[..., 2, 0] >= 0, 1.0, -1.0)
    axis_pi = axis_abs * jnp.stack([sx, sy, sz], axis=-1)
    norm = jnp.linalg.norm(axis_pi, axis=-1, keepdims=True)
    axis_pi = axis_pi / jnp.maximum(norm, _EPS)
    w_pi = theta[..., None] * axis_pi
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def so3_right_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian of SO(3) at axis-angle w: (..., 3) -> (..., 3, 3).

    Jr(w) = I - (1-cos t)/t^2 [w]x + (t - sin t)/t^3 [w]x^2, with Taylor
    fallbacks below sqrt(eps).  Satisfies R(w + dw) ~= R(w) Exp(Jr(w) dw),
    i.e. d(R(w) p)/dw = -R(w) [p]x Jr(w) — the closed-form pose Jacobian
    of the BA camera-center prior terms."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta_safe = jnp.sqrt(theta2_safe)
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta_safe)) / theta2_safe)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta_safe - jnp.sin(theta_safe)) / (theta2_safe * theta_safe))
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - b[..., None, None] * W + c[..., None, None] * (W @ W)


def rotate_aa(aa: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Rotate points by an axis-angle vector without forming the matrix.

    aa: (..., 3), x: (..., 3) -> (..., 3).  Mirrors the Ceres AngleAxisRotatePoint
    semantics used by the reference residual (src/adjuster/BundleAdjuster.h:44-50),
    with a Taylor-stable small-angle branch (autodiff-safe at 0).
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    small = theta2 < 1e-8
    # Safe denominators so the untaken branch stays finite under autodiff
    # (0 * inf = nan through jnp.where otherwise).
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta_safe = jnp.sqrt(theta2_safe)
    cos_t = jnp.where(small, 1.0 - theta2 / 2.0, jnp.cos(theta_safe))
    sinc = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta_safe) / theta_safe)
    # (1 - cos t)/t^2
    ccos = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / theta2_safe)
    cross = jnp.cross(aa, x)
    dot = jnp.sum(aa * x, axis=-1, keepdims=True)
    return cos_t * x + sinc * cross + ccos * dot * aa


def se3_apply(R: jnp.ndarray, t: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Apply rigid transform: (..., 3, 3) @ (..., 3) + (..., 3)."""
    return jnp.einsum("...ij,...j->...i", R, x) + t


def se3_inv(R: jnp.ndarray, t: jnp.ndarray):
    """Inverse rigid transform: (R, t) -> (R^T, -R^T t)."""
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) ∘ (Rb, tb): first apply b, then a."""
    return Ra @ Rb, jnp.einsum("...ij,...j->...i", Ra, tb) + ta


def pose_to_matrix(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Stack (R | t) into a (..., 3, 4) matrix (the reference's Tcw34,
    src/component/Image.h:87-99)."""
    return jnp.concatenate([R, t[..., None]], axis=-1)


def camera_center(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """World-frame camera center C = -R^T t for world->camera pose (R, t)."""
    return -jnp.einsum("...ji,...j->...i", R, t)
