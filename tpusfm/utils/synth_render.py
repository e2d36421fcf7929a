"""Synthetic image rendering for benchmarks and end-to-end tests.

Renders a textured "corner room" (three mutually orthogonal textured quads)
from an orbiting camera: every view is an exact perspective rendering with
known ground-truth poses, and the multi-scale random textures give SIFT
distinctive, matchable structure.  This stands in for the reference's
benchmark image sequences (the reference ships none, SURVEY.md §6).
"""

from __future__ import annotations

import numpy as np

def _resize_cubic(src: np.ndarray, size: int) -> np.ndarray:
    """Bicubic resize of a square image to (size, size): half-pixel centres,
    Keys kernel with a = -0.75 and replicated borders (OpenCV's
    INTER_CUBIC), as one separable matrix product."""
    n = src.shape[0]
    x = (np.arange(size) + 0.5) * (n / size) - 0.5
    x0 = np.floor(x).astype(np.int64)
    f = x - x0
    a = -0.75
    w = np.stack([((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a,
                  ((a + 2) * f - (a + 3)) * f * f + 1,
                  ((a + 2) * (1 - f) - (a + 3)) * (1 - f) * (1 - f) + 1], 1)
    w = np.concatenate([w, 1.0 - w.sum(1, keepdims=True)], 1)
    taps = np.clip(x0[:, None] + np.arange(-1, 3), 0, n - 1)
    m = np.zeros((size, n))
    np.add.at(m, (np.repeat(np.arange(size)[:, None], 4, 1), taps), w)
    return (m @ src.astype(np.float64) @ m.T).astype(np.float32)


def _perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography taking the four points src (4, 2) to dst (4, 2)."""
    A = np.zeros((8, 8))
    rhs = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src.astype(np.float64),
                                             dst.astype(np.float64))):
        A[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        A[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        rhs[i], rhs[i + 4] = u, v
    return np.append(np.linalg.solve(A, rhs), 1.0).reshape(3, 3)


def _warp_perspective(src: np.ndarray, H: np.ndarray, pix_h: np.ndarray,
                      border: float) -> np.ndarray:
    """dst(p) = src(H^-1 p), bilinear; taps outside src read `border`
    (OpenCV's warpPerspective with INTER_LINEAR and BORDER_CONSTANT).
    pix_h (H, W, 3) are the homogeneous dst pixels."""
    q = pix_h @ np.linalg.inv(H).T
    with np.errstate(divide="ignore", invalid="ignore"):
        x = q[..., 0] / q[..., 2]
        y = q[..., 1] / q[..., 2]
    ok = np.isfinite(x) & np.isfinite(y) & (np.abs(x) < 1e9) & (np.abs(y) < 1e9)
    x = np.where(ok, x, -2.0)
    y = np.where(ok, y, -2.0)
    sx = np.floor(x).astype(np.int64)
    sy = np.floor(y).astype(np.int64)
    fx = (x - sx).astype(np.float32)
    fy = (y - sy).astype(np.float32)
    h, w = src.shape

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return np.where(inside, src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)],
                        np.float32(border))

    return ((1 - fy) * ((1 - fx) * tap(sy, sx) + fx * tap(sy, sx + 1))
            + fy * ((1 - fx) * tap(sy + 1, sx) + fx * tap(sy + 1, sx + 1)))


def _multiscale_texture(size: int, seed: int) -> np.ndarray:
    """Distinctive smooth random texture in [0,1]: sum of band-passed noise."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    for s, w in ((4, 0.2), (8, 0.35), (16, 0.5), (32, 0.7), (64, 1.0)):
        n = rng.normal(size=(s, s)).astype(np.float32)
        tex += w * _resize_cubic(n, size)
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-9)
    return tex


def _orbit_poses(n_views, radius, arc_deg, height_amp=0.5):
    angles = np.radians(np.linspace(0, arc_deg, n_views))
    centers = np.stack(
        [radius * np.sin(angles), height_amp * np.sin(2 * angles), -radius * np.cos(angles)],
        axis=1,
    )
    Rs, ts = [], []
    for c in centers:
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=0)
        Rs.append(R)
        ts.append(-R @ c)
    return np.asarray(Rs, np.float32), np.asarray(ts, np.float32), centers.astype(np.float32)


def render_orbit_images(
    n_views: int = 20,
    img_h: int = 480,
    img_w: int = 640,
    focal: float = 600.0,
    radius: float = 8.0,
    arc_deg: float = 120.0,
    seed: int = 0,
    tex_size: int = 512,
    n_dots: int | None = None,  # kept for API compat; unused
):
    """Returns (images (V, H, W) float32 in [0,1], gt dict with
    intr (7,), R (V,3,3), t (V,3), centers (V,3))."""
    del n_dots
    R, t, centers = _orbit_poses(n_views, radius, arc_deg)
    intr = np.array([focal, focal, img_w / 2, img_h / 2, 0, 0, 0], np.float32)
    K = np.array([[focal, 0, img_w / 2], [0, focal, img_h / 2], [0, 0, 1]], np.float64)

    # Three orthogonal quads forming a corner around the origin, each a
    # (origin, U-axis, V-axis) frame with its own texture.
    e = 2.2  # half extent
    planes = [
        # back-left wall (normal +x side)
        dict(O=np.array([-e, -e, -e]), U=np.array([0, 0, 2 * e]), Vv=np.array([0, 2 * e, 0])),
        # back-right wall (normal +z side)
        dict(O=np.array([-e, -e, e]), U=np.array([2 * e, 0, 0]), Vv=np.array([0, 2 * e, 0])),
        # floor
        dict(O=np.array([-e, -e, -e]), U=np.array([2 * e, 0, 0]), Vv=np.array([0, 0, 2 * e])),
    ]
    for i, p in enumerate(planes):
        p["tex"] = _multiscale_texture(tex_size, seed + 7 * i)

    tex_corners = np.array(
        [[0, 0], [tex_size - 1, 0], [0, tex_size - 1], [tex_size - 1, tex_size - 1]],
        np.float32,
    )

    xs, ys = np.meshgrid(np.arange(img_w), np.arange(img_h))
    pix_h = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)  # (H, W, 3)

    images = np.full((n_views, img_h, img_w), 0.5, np.float32)
    depth = np.full((n_views, img_h, img_w), np.inf, np.float64)
    for v in range(n_views):
        P = K @ np.hstack([R[v], t[v][:, None]]).astype(np.float64)
        for p in planes:
            corners3d = np.stack(
                [p["O"], p["O"] + p["U"], p["O"] + p["Vv"], p["O"] + p["U"] + p["Vv"]]
            )
            proj = (P @ np.hstack([corners3d, np.ones((4, 1))]).T).T
            if np.any(proj[:, 2] <= 0.1):
                continue
            img_quad = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)
            H = _perspective_transform(tex_corners, img_quad)
            warped = _warp_perspective(p["tex"], H, pix_h, border=-1.0)
            valid = warped >= 0
            if not valid.any():
                continue
            # Per-pixel depth: invert H to texture coords -> 3D -> camera z.
            Hinv = np.linalg.inv(H)
            uvw = pix_h @ Hinv.T
            uu = uvw[..., 0] / uvw[..., 2] / (tex_size - 1)
            vv = uvw[..., 1] / uvw[..., 2] / (tex_size - 1)
            X3 = (
                p["O"][None, None]
                + uu[..., None] * p["U"][None, None]
                + vv[..., None] * p["Vv"][None, None]
            )
            z = X3 @ R[v][2].astype(np.float64) + t[v][2]
            closer = valid & (z > 0.1) & (z < depth[v])
            images[v][closer] = warped[closer]
            depth[v][closer] = z[closer]
    images = np.clip(images, 0.0, 1.0)
    return images, dict(intr=intr, R=R, t=t, centers=centers, depth=depth.astype(np.float32))
