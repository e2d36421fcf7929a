"""Image array ops: separable Gaussian blur, resampling, bilinear gather.

Replacements for the vlfeat image kernels
(src/nonFree/sift/vl/imopv.c: vl_imconvcol — column convolution with SSE2
fast paths): here convolution is expressed as XLA `conv_general_dilated`,
which the compiler lowers for the device directly, so no hand-SIMD is needed
(SURVEY.md §2.2).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
from jax import lax


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """Static (trace-time) 1-D Gaussian taps, matching vlfeat's truncation of
    4*sigma (vl/imopv.c usage in sift.c:795 _vl_sift_smooth)."""
    if radius is None:
        radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(sigma, 1e-8)) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur(images: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur over (..., H, W) with SAME edge-replicate
    padding (vlfeat uses VL_PAD_BY_CONTINUITY, sift.c:800)."""
    if sigma <= 0:
        return images
    k = jnp.asarray(gaussian_kernel1d(sigma))
    r = (k.shape[0] - 1) // 2
    batch_shape = images.shape[:-2]
    h, w = images.shape[-2:]
    x = images.reshape((-1, 1, h, w))
    xp = jnp.pad(x, ((0, 0), (0, 0), (r, r), (0, 0)), mode="edge")
    x = lax.conv_general_dilated(xp, k.reshape(1, 1, -1, 1), (1, 1), "VALID")
    xp = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (r, r)), mode="edge")
    x = lax.conv_general_dilated(xp, k.reshape(1, 1, 1, -1), (1, 1), "VALID")
    return x.reshape(*batch_shape, h, w)


def downsample2(images: jnp.ndarray) -> jnp.ndarray:
    """Decimate by 2 (every other pixel — vl_sift_process_next_octave's
    copy_and_downsample, sift.c:750-777)."""
    return images[..., ::2, ::2]


def upsample2(images: jnp.ndarray) -> jnp.ndarray:
    """Bilinear 2x upsample (for first_octave = -1, sift.c:805-862)."""
    h, w = images.shape[-2:]
    return resize_bilinear(images, (2 * h, 2 * w))


def resize_bilinear(images: jnp.ndarray, shape: tuple[int, int]) -> jnp.ndarray:
    import jax

    return jax.image.resize(images, images.shape[:-2] + shape, method="bilinear")


def bilinear_sample(img: jnp.ndarray, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Bilinear gather from img (H, W) at float coords y, x (any shape).
    Coordinates are clamped to the image (edge padding semantics)."""
    h, w = img.shape[-2:]
    y = jnp.clip(y, 0.0, h - 1.0)
    x = jnp.clip(x, 0.0, w - 1.0)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    fy = y - y0
    fx = x - x0
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def bilinear_sample_level(vol: jnp.ndarray, lvl, y: jnp.ndarray, x: jnp.ndarray,
                          h_lim=None, w_lim=None) -> jnp.ndarray:
    """Bilinear gather from one level of a stack vol (L, H, W) at float
    coords y, x — the level index is part of the gather, so vmapping over
    keypoints never materializes a per-keypoint (H, W) slice.

    h_lim/w_lim (optional traced int scalars) clamp the sample coordinates
    to a sub-rectangle [0, h_lim) x [0, w_lim) — used when levels of
    different resolutions are zero-padded into one stack and each level's
    true extent is smaller than the array (edge-replicate semantics against
    the true border, never reading the padding)."""
    h, w = vol.shape[-2:]
    hm = (h - 1.0) if h_lim is None else (h_lim - 1.0)
    wm = (w - 1.0) if w_lim is None else (w_lim - 1.0)
    y = jnp.clip(y, 0.0, hm)
    x = jnp.clip(x, 0.0, wm)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    hi = (h - 1) if h_lim is None else (h_lim - 1)
    wi = (w - 1) if w_lim is None else (w_lim - 1)
    y1 = jnp.minimum(y0 + 1, hi)
    x1 = jnp.minimum(x0 + 1, wi)
    fy = y - y0
    fx = x - x0
    v00 = vol[lvl, y0, x0]
    v01 = vol[lvl, y0, x1]
    v10 = vol[lvl, y1, x0]
    v11 = vol[lvl, y1, x1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def gradients(images: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Central-difference gradient magnitude and angle over (..., H, W)
    (vl_sift_update_gradient, sift.c:1458-1544).  Angle in [0, 2pi)."""
    gx = 0.5 * (jnp.roll(images, -1, axis=-1) - jnp.roll(images, 1, axis=-1))
    gy = 0.5 * (jnp.roll(images, -1, axis=-2) - jnp.roll(images, 1, axis=-2))
    # Zero the wrap-around borders so roll artifacts never leak into
    # orientation/descriptor windows sampled near the image edge.
    h, w = images.shape[-2:]
    xs = jnp.arange(w)
    ys = jnp.arange(h)
    interior = ((xs > 0) & (xs < w - 1))[None, :] & ((ys > 0) & (ys < h - 1))[:, None]
    gx = gx * interior
    gy = gy * interior
    mag = jnp.sqrt(gx * gx + gy * gy + 1e-20)
    ang = jnp.mod(jnp.arctan2(gy, gx), 2.0 * np.pi)
    return mag, ang


def to_grayscale(images: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W, 3) uint8/float -> (..., H, W) float32 in [0, 1]."""
    images = jnp.asarray(images)
    if images.dtype == jnp.uint8:
        images = images.astype(jnp.float32) / 255.0
    if images.ndim >= 3 and images.shape[-1] == 3:
        images = (
            0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
        )
    return images.astype(jnp.float32)


def undistort_image(image: jnp.ndarray, intr: jnp.ndarray,
                    fill: float = 0.0, model: str = "auto") -> jnp.ndarray:
    """Resample a captured (distorted) image onto the ideal pinhole grid.

    The dense stage consumes ideal-pinhole images, like the reference's
    `openMVG_main_openMVG2openMVS -d undistorted_images` export
    (src/main.cpp:157-158).  Output pixel p gets the value at the captured
    position of p's ideal ray: src = K * distort(K^-1 p) — forward radial
    distortion, so no iterative inversion is needed in the remap.

    image: (H, W) or (H, W, C) float; intr: (7,) fx fy cx cy k1 k2 k3 or
    (9,) Brown [.. t1 t2] / fisheye [.. k1..k4 0] per `model` (the camera
    factory parity dispatch, core.camera._resolve_model).  Out-of-bounds
    samples get `fill`.
    """
    from ..core import camera as _cam

    h, w = image.shape[:2]
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32), jnp.arange(w, dtype=jnp.float32),
        indexing="ij",
    )
    f = jnp.stack([intr[0], intr[1]])
    c = jnp.stack([intr[2], intr[3]])
    xn = (jnp.stack([xs, ys], axis=-1) - c) / f          # ideal normalized
    m = _cam._resolve_model(intr, model)
    if m == "fisheye":
        from ..core import distortion as _dist

        xd = _dist.distort_fisheye(intr[4:8], xn)
    elif m == "brown":
        from ..core import distortion as _dist

        xd = _dist.distort_brown(intr[4:9], xn)
    else:
        xd = _cam.distort_radial(intr, xn)
    src = xd * f + c                                     # captured pixels
    sx, sy = src[..., 0], src[..., 1]
    # Half-pixel tolerance: float round-trip puts exact border pixels at
    # +-1e-6, and any source within half a pixel of the frame still has a
    # meaningful clamped-bilinear value.
    inb = (sx > -0.5) & (sx < w - 0.5) & (sy > -0.5) & (sy < h - 0.5)
    if image.ndim == 2:
        out = bilinear_sample(image, sy, sx)
        return jnp.where(inb, out, fill)
    out = jnp.stack(
        [bilinear_sample(image[..., ch], sy, sx) for ch in range(image.shape[-1])],
        axis=-1,
    )
    return jnp.where(inb[..., None], out, fill)


def bilinear_sample_level_ch(vol: jnp.ndarray, lvl, y: jnp.ndarray, x: jnp.ndarray,
                             h_lim=None, w_lim=None) -> jnp.ndarray:
    """`bilinear_sample_level` over a channel-packed stack vol (L, H, W, C):
    one gather row fetches all C channels (the SIFT describe stage packs
    magnitude+angle to halve its gather count — a gather pays per row more
    than per byte).  Returns (..., C)."""
    h, w = vol.shape[-3:-1]
    hm = (h - 1.0) if h_lim is None else (h_lim - 1.0)
    wm = (w - 1.0) if w_lim is None else (w_lim - 1.0)
    y = jnp.clip(y, 0.0, hm)
    x = jnp.clip(x, 0.0, wm)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    hi = (h - 1) if h_lim is None else (h_lim - 1)
    wi = (w - 1) if w_lim is None else (w_lim - 1)
    y1 = jnp.minimum(y0 + 1, hi)
    x1 = jnp.minimum(x0 + 1, wi)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    v00 = vol[lvl, y0, x0]
    v01 = vol[lvl, y0, x1]
    v10 = vol[lvl, y1, x0]
    v11 = vol[lvl, y1, x1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )
