"""Additional distortion models: Brown-Conrady and equidistant fisheye.

Capability parity with the reference's intrinsic factory
(src/sparseBuilder/sparseBuilder.cpp:469-502), which can instantiate
OpenMVG's PINHOLE / RADIAL1 / RADIAL3 / BROWN / FISHEYE camera models from
the EXIF-initialized focal (RADIAL3 is the wired default, .cpp:480).

Design: the bundle-adjusted core model stays the 7-vector RADIAL3 of
core.camera (the only model the reference pipeline actually instantiates);
views declared with richer distortion are normalized THROUGH these
transforms at ingest — undistort to ideal pinhole coordinates once, then
the whole array pipeline runs distortion-free.  That keeps every BA block
and obs table at a fixed parameter count (static shapes) while
accepting imagery from any of the factory's models.

All transforms are fixed-iteration (XLA-friendly) and batched.
"""

from __future__ import annotations

import jax.numpy as jnp


# -- Brown-Conrady: 3 radial + 2 tangential coefficients --------------------

def distort_brown(params: jnp.ndarray, xn: jnp.ndarray) -> jnp.ndarray:
    """params (..., 5) = [k1, k2, k3, t1, t2]; xn (..., 2) ideal normalized
    coords -> distorted normalized coords (OpenMVG Pinhole_Intrinsic_Brown_T2
    semantics)."""
    k1, k2, k3, t1, t2 = (params[..., i, None] for i in range(5))
    x = xn[..., 0:1]
    y = xn[..., 1:2]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dx = 2.0 * t1 * x * y + t2 * (r2 + 2.0 * x * x)
    dy = t1 * (r2 + 2.0 * y * y) + 2.0 * t2 * x * y
    return xn * radial + jnp.concatenate([dx, dy], axis=-1)


def undistort_brown(params: jnp.ndarray, xd: jnp.ndarray, iters: int = 12) -> jnp.ndarray:
    """Invert Brown-Conrady by fixed-point iteration (static trip count)."""
    xn = xd
    for _ in range(iters):
        delta = distort_brown(params, xn) - xn
        xn = xd - delta
    return xn


# -- Equidistant fisheye: 4 polynomial coefficients on theta ----------------

def distort_fisheye(params: jnp.ndarray, xn: jnp.ndarray, eps: float = 1e-9) -> jnp.ndarray:
    """params (..., 4) = [k1..k4]; ideal normalized coords -> fisheye
    (equidistant r = theta(1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8);
    OpenMVG Pinhole_Intrinsic_Fisheye / OpenCV cv::fisheye semantics)."""
    k1, k2, k3, k4 = (params[..., i, None] for i in range(4))
    r = jnp.sqrt(jnp.maximum(jnp.sum(xn * xn, axis=-1, keepdims=True), eps * eps))
    theta = jnp.arctan(r)
    th2 = theta * theta
    theta_d = theta * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    return xn * (theta_d / r)


def undistort_fisheye(params: jnp.ndarray, xd: jnp.ndarray, iters: int = 12,
                      eps: float = 1e-9) -> jnp.ndarray:
    """Invert the theta polynomial by fixed-iteration Newton, then undo the
    equidistant mapping."""
    k1, k2, k3, k4 = (params[..., i, None] for i in range(4))
    theta_d = jnp.sqrt(jnp.maximum(jnp.sum(xd * xd, axis=-1, keepdims=True), eps * eps))
    theta = theta_d
    for _ in range(iters):
        th2 = theta * theta
        poly = 1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))
        dpoly = 2.0 * theta * (k1 + th2 * (2.0 * k2 + th2 * (3.0 * k3 + th2 * 4.0 * k4)))
        f = theta * poly - theta_d
        df = poly + theta * dpoly
        theta = theta - f / jnp.where(jnp.abs(df) < 1e-9, 1e-9, df)
    r = jnp.tan(theta)
    return xd * (r / theta_d)


# -- Factory dispatch ---------------------------------------------------------

MODELS = ("pinhole", "radial1", "radial3", "brown", "fisheye")


def undistort_to_pinhole(model: str, dist_params, xd: jnp.ndarray) -> jnp.ndarray:
    """Normalize distorted coords from any factory model to ideal pinhole.

    model: one of MODELS; dist_params: model-specific coefficient vector
    ([k1] / [k1,k2,k3] / [k1,k2,k3,t1,t2] / [k1..k4]); xd (..., 2).
    """
    from . import camera

    if model == "pinhole":
        return xd
    if model in ("radial1", "radial3"):
        k = jnp.zeros(xd.shape[:-2] + (3,), xd.dtype) if dist_params is None else jnp.asarray(dist_params)
        if model == "radial1":
            k = jnp.concatenate([k[..., :1], jnp.zeros_like(k[..., :2])], axis=-1)
        intr = jnp.concatenate(
            [jnp.ones(k.shape[:-1] + (2,), k.dtype),
             jnp.zeros(k.shape[:-1] + (2,), k.dtype), k], axis=-1
        )
        return camera.undistort_radial(intr, xd)
    if model == "brown":
        return undistort_brown(jnp.asarray(dist_params), xd)
    if model == "fisheye":
        return undistort_fisheye(jnp.asarray(dist_params), xd)
    raise ValueError(f"unknown camera model {model!r} (supported: {MODELS})")
