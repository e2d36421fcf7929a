"""SIFT-class feature detection + description, batched on-device.

Array-program rebuild of the reference's native feature kernel:
- vlfeat scale-space + DoG detector (src/nonFree/sift/vl/sift.c:884-1456)
- orientation assignment (sift.c:1570) and 4x4x8 descriptor (sift.c:1931)
- the OpenMVG describer wrapper semantics: presets NORMAL/HIGH/ULTRA,
  peak/edge thresholds, RootSIFT u8 quantization
  (src/nonFree/sift/SIFT_describer.hpp:53-117, 31-45)

Design (SURVEY.md §7 layer 3, hard part 4 — statistical, not bit-exact,
parity with vlfeat):
- The Gaussian pyramid is XLA separable convolution over a static
  octave loop; shapes halve per octave.
- Extremum detection is a vectorized 26-neighbor scan via reduce_window
  min/max pooling, not a scalar triple loop.
- Keypoints are fixed-capacity: top-K |DoG| scores per octave, masked.
- Subpixel refinement is a fixed 4-step re-centering loop + final 3x3 solve
  (vlfeat runs at most 5 data-dependent iterations).
- Orientation histograms and descriptors avoid scatter entirely: gradients
  are gathered on a fixed sample grid per keypoint (the pyramid-level index
  fused into the gather, never a per-keypoint map slice) and soft-binned
  with matmuls, instead of vlfeat's per-pixel
  trilinear scatter accumulation.
- Up to ``n_orientations`` peaks per keypoint (80%-of-max rule like
  vlfeat's 4-peak emission); default 1 keeps capacity flat.

Output coordinates are in input-image pixels (x right, y down), sigma in
input-pixel units, angle in radians.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import image as imops
from ..utils.pytree import pytree_dataclass


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    n_octaves: int = 4
    n_scales: int = 3          # S: detectable scales per octave (vlfeat Nlevels)
    sigma0: float = 1.6        # base blur at s=0
    sigma_n: float = 0.5       # assumed input blur
    first_octave: int = 0      # -1 upsamples the input 2x (HIGH/ULTRA presets)
    peak_thresh: float = 0.04  # contrast threshold (SIFT_describer.hpp:60);
                               # applied as peak_thresh/n_scales on [0,1] images
                               # (parity: SIFT_describer.hpp:155 passes
                               # 255*peak/num_scales to vlfeat on u8 images)
    edge_thresh: float = 10.0  # curvature ratio threshold (SIFT_describer.hpp:59)
    max_per_octave: int = 1024
    max_features: int = 2048
    root_sift: bool = True     # SIFT_describer.hpp:31-45
    orient_bins: int = 36
    orient_grid: int = 12      # sample grid side for the orientation window
    desc_grid: int = 12        # sample grid side for the descriptor window
                               # (12x12 matches 16x16 on registration/ATE
                               # quality at 44% fewer gathers — the describe
                               # stage is gather-heavy)
    magnif: float = 3.0        # descriptor bin width in units of sigma
    refine_iters: int = 4
    n_orientations: int = 1    # emit up to this many orientation peaks per
                               # keypoint (vlfeat emits up to 4 peaks >= 80%
                               # of the max, sift.c:1684-1700; capacity cost
                               # is linear so the default stays 1)


def preset(name: str, **overrides) -> SiftConfig:
    """NORMAL / HIGH / ULTRA presets (parity: SIFT_describer.hpp:99-117)."""
    name = name.upper()
    if name == "NORMAL":
        cfg = SiftConfig(peak_thresh=0.04, first_octave=0)
    elif name == "HIGH":
        cfg = SiftConfig(peak_thresh=0.01, first_octave=0)
    elif name == "ULTRA":
        cfg = SiftConfig(peak_thresh=0.01, first_octave=-1)
    else:
        raise ValueError(f"unknown SIFT preset {name!r}")
    return dataclasses.replace(cfg, **overrides)


@pytree_dataclass
class Features:
    """Fixed-capacity per-image feature set.

    kp: (..., N, 4) = (x, y, sigma, angle); desc: (..., N, 128) float32
    (RootSIFT, u8-quantized values stored as float); score: (..., N) |DoG|;
    mask: (..., N) validity."""

    kp: jnp.ndarray
    desc: jnp.ndarray
    score: jnp.ndarray
    mask: jnp.ndarray

    @property
    def n_valid(self):
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)


# ---------------------------------------------------------------------------
# Scale space
# ---------------------------------------------------------------------------

def _level_sigmas(cfg: SiftConfig) -> np.ndarray:
    """Blur of each pyramid level l = 0..S+2 in octave-0 pixel units;
    level l has continuous scale s = l - 1 (so s=0 at l=1)."""
    S = cfg.n_scales
    return np.array([cfg.sigma0 * 2.0 ** ((l - 1) / S) for l in range(S + 3)])


def build_scale_space(images: jnp.ndarray, cfg: SiftConfig):
    """images (B, H, W) in [0,1] -> list of per-octave dicts with
    'levels' (B, S+3, Ho, Wo) and 'dogs' (B, S+2, Ho, Wo)."""
    S = cfg.n_scales
    sig = _level_sigmas(cfg)
    base = images
    if cfg.first_octave < 0:
        base = imops.upsample2(base)
        sigma_in = cfg.sigma_n * 2.0
    else:
        sigma_in = cfg.sigma_n
    # Pre-smooth to the first level's blur.
    delta = math.sqrt(max(sig[0] ** 2 - sigma_in ** 2, 1e-10))
    current = imops.blur(base, delta)
    octaves = []
    for _ in range(cfg.n_octaves):
        levels = [current]
        for l in range(1, S + 3):
            inc = math.sqrt(max(sig[l] ** 2 - sig[l - 1] ** 2, 1e-10))
            levels.append(imops.blur(levels[-1], inc))
        lv = jnp.stack(levels, axis=-3)  # (B, S+3, H, W)
        octaves.append({"levels": lv, "dogs": lv[..., 1:, :, :] - lv[..., :-1, :, :]})
        # Next octave seeds from the level with twice the base blur (l = S).
        current = imops.downsample2(levels[S])
        if min(current.shape[-2:]) < 8:
            break
    return octaves


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

def _extrema_score(dogs: jnp.ndarray, cfg: SiftConfig) -> jnp.ndarray:
    """Vectorized 26-neighbor extremum scan (replaces the scalar loop at
    vl/sift.c:1163-1270).  dogs (B, S+2, H, W) -> score (B, S, H, W) for
    dog indices i = 1..S; zero where not an extremum."""
    S = dogs.shape[-3] - 2

    def _axis_ext(x, axis, op):
        # Separable 3-tap window extremum via two elementwise ops (the 27-tap
        # reduce_window decomposes exactly for max/min and lowers to cheap
        # elementwise shifts instead of a windowed reduction).
        lo = jnp.roll(x, 1, axis=axis)
        hi = jnp.roll(x, -1, axis=axis)
        # Wrap-around values are masked by the border kill below for H/W and
        # never selected for S (dog ends are padding levels).
        return op(op(lo, x), hi)

    mx = dogs
    mn = dogs
    for ax in (-3, -2, -1):
        mx = _axis_ext(mx, ax, jnp.maximum)
        mn = _axis_ext(mn, ax, jnp.minimum)
    center = dogs[..., 1 : S + 1, :, :]
    th = 0.8 * cfg.peak_thresh / cfg.n_scales  # 80% pre-threshold (sift.c:1232)
    is_max = (center >= mx[..., 1 : S + 1, :, :]) & (center > th)
    is_min = (center <= mn[..., 1 : S + 1, :, :]) & (center < -th)
    score = jnp.abs(center) * (is_max | is_min)
    # Kill borders (need a full 3x3x3 cube).
    h, w = dogs.shape[-2:]
    ym = (jnp.arange(h) >= 1) & (jnp.arange(h) <= h - 2)
    xm = (jnp.arange(w) >= 1) & (jnp.arange(w) <= w - 2)
    return score * ym[:, None] * xm[None, :]


def _topk_keypoints(score: jnp.ndarray, k: int):
    """score (B, S, H, W) -> (vals, si, yi, xi) each (B, k)."""
    b = score.shape[0]
    S, h, w = score.shape[-3:]
    flat = score.reshape(b, -1)
    kk = min(k, flat.shape[-1])
    if flat.shape[-1] > 4 * kk:
        # approx_max_k: a partial-reduction selector, cheaper than the full
        # sort behind top_k on ~1M-element octaves.
        # Recall ~0.95 only drops near-threshold candidates, which the
        # global top-max_features cut discards anyway.
        vals, idx = jax.lax.approx_max_k(flat, kk, recall_target=0.95)
    else:
        vals, idx = jax.lax.top_k(flat, kk)
    si = idx // (h * w)
    rem = idx % (h * w)
    yi = rem // w
    xi = rem % w
    return vals, si + 1, yi, xi  # si back to dog index 1..S


def _refine_one(dog: jnp.ndarray, si, yi, xi, cfg: SiftConfig):
    """Subpixel refinement of one keypoint against a (S+2, H, W) DoG volume.
    Fixed-iteration re-centering + quadratic fit (vl/sift.c:1272-1456).
    Returns (x, y, s_cont, value, valid)."""
    n_dog, h, w = dog.shape
    S = n_dog - 2
    # 3x3x3 neighborhood offsets, flattened: the cube load is ONE 27-element
    # scalar gather (the dynamic_slice form it replaces serialized per
    # keypoint).
    off = jnp.stack(
        jnp.meshgrid(jnp.arange(-1, 2), jnp.arange(-1, 2), jnp.arange(-1, 2),
                     indexing="ij"), axis=-1,
    ).reshape(27, 3)

    def load_cube(s, y, x):
        idx = jnp.stack([s, y, x]) + off
        return dog[idx[:, 0], idx[:, 1], idx[:, 2]].reshape(3, 3, 3)

    def grad_hess(c):
        g = 0.5 * jnp.array(
            [c[2, 1, 1] - c[0, 1, 1], c[1, 2, 1] - c[1, 0, 1], c[1, 1, 2] - c[1, 1, 0]]
        )
        ctr = c[1, 1, 1]
        Hss = c[2, 1, 1] + c[0, 1, 1] - 2 * ctr
        Hyy = c[1, 2, 1] + c[1, 0, 1] - 2 * ctr
        Hxx = c[1, 1, 2] + c[1, 1, 0] - 2 * ctr
        Hsy = 0.25 * (c[2, 2, 1] - c[2, 0, 1] - c[0, 2, 1] + c[0, 0, 1])
        Hsx = 0.25 * (c[2, 1, 2] - c[2, 1, 0] - c[0, 1, 2] + c[0, 1, 0])
        Hyx = 0.25 * (c[1, 2, 2] - c[1, 2, 0] - c[1, 0, 2] + c[1, 0, 0])
        H = jnp.array([[Hss, Hsy, Hsx], [Hsy, Hyy, Hyx], [Hsx, Hyx, Hxx]])
        return g, H

    def solve(g, H):
        # Closed-form symmetric 3x3 solve (Cramer / adjugate): elementwise
        # ops that fuse, instead of the batched LU behind jnp.linalg.solve.
        a, b_, c_ = H[0, 0] + 1e-10, H[0, 1], H[0, 2]
        e, f_ = H[1, 1] + 1e-10, H[1, 2]
        i_ = H[2, 2] + 1e-10
        A = e * i_ - f_ * f_
        Bc = c_ * f_ - b_ * i_
        Cc = b_ * f_ - c_ * e
        E = a * i_ - c_ * c_
        F = b_ * c_ - a * f_
        I = a * e - b_ * b_
        det = a * A + b_ * Bc + c_ * Cc
        inv_det = jnp.where(jnp.abs(det) > 1e-20, 1.0 / det, 0.0)
        d = -inv_det * jnp.stack([
            A * g[0] + Bc * g[1] + Cc * g[2],
            Bc * g[0] + E * g[1] + F * g[2],
            Cc * g[0] + F * g[1] + I * g[2],
        ])
        return jnp.where(jnp.all(jnp.isfinite(d)), d, jnp.zeros(3))

    def body(_, carry):
        s, y, x = carry
        c = load_cube(s, y, x)
        g, H = grad_hess(c)
        d = solve(g, H)
        # Re-center by one cell where the offset leaves the cell (|d| > 0.6).
        s = jnp.clip(s + jnp.where(d[0] > 0.6, 1, 0) - jnp.where(d[0] < -0.6, 1, 0), 1, S)
        y = jnp.clip(y + jnp.where(d[1] > 0.6, 1, 0) - jnp.where(d[1] < -0.6, 1, 0), 1, h - 2)
        x = jnp.clip(x + jnp.where(d[2] > 0.6, 1, 0) - jnp.where(d[2] < -0.6, 1, 0), 1, w - 2)
        return (s, y, x)

    si, yi, xi = jax.lax.fori_loop(0, cfg.refine_iters, body, (si, yi, xi))
    c = load_cube(si, yi, xi)
    g, H = grad_hess(c)
    d = solve(g, H)
    val = c[1, 1, 1] + 0.5 * jnp.dot(g, d)
    # Edge (curvature) test on the spatial 2x2 Hessian (sift.c:1435-1444).
    Hyy = H[1, 1]
    Hxx = H[2, 2]
    Hyx = H[1, 2]
    det = Hxx * Hyy - Hyx * Hyx
    tr = Hxx + Hyy
    r = cfg.edge_thresh
    edge_ok = (det > 0) & (tr * tr / jnp.where(det > 0, det, 1.0) < (r + 1.0) ** 2 / r)
    in_cell = jnp.all(jnp.abs(d) < 1.5)
    peak_ok = jnp.abs(val) >= cfg.peak_thresh / cfg.n_scales
    valid = edge_ok & in_cell & peak_ok
    x = xi + d[2]
    y = yi + d[1]
    s_cont = (si - 1).astype(jnp.float32) + d[0]
    return x, y, s_cont, val, valid, si


# ---------------------------------------------------------------------------
# Orientation + descriptor (gather + soft-bin einsum, no scatter)
# ---------------------------------------------------------------------------

def _soft_bin_circular(fbin: jnp.ndarray, n_bins: int) -> jnp.ndarray:
    """Fractional circular bin coordinate (...,) -> weights (..., n_bins)
    with linear (tent) interpolation between the two nearest bins."""
    centers = jnp.arange(n_bins, dtype=fbin.dtype)
    d = jnp.abs(fbin[..., None] - centers)
    d = jnp.minimum(d, n_bins - d)  # circular distance
    return jnp.maximum(0.0, 1.0 - d)


def _soft_bin_linear(fbin: jnp.ndarray, n_bins: int) -> jnp.ndarray:
    """Non-circular tent soft-binning."""
    centers = jnp.arange(n_bins, dtype=fbin.dtype)
    return jnp.maximum(0.0, 1.0 - jnp.abs(fbin[..., None] - centers))


def _orientation_one(grad: jnp.ndarray, lvl, x, y, sigma, cfg: SiftConfig,
                     h_lim=None, w_lim=None):
    """Orientation peaks for one keypoint (vl/sift.c:1570-1703): returns
    (thetas (n_orientations,), ori_mask (n_orientations,)) — the dominant
    peak plus secondary local maxima >= 80% of it.
    mag/ang: (L, H, W) gradient stacks; lvl selects the keypoint's level
    inside the gather (never slicing out a per-keypoint map); h_lim/w_lim
    bound the level's true extent when octaves share a padded stack."""
    G = cfg.orient_grid
    win_r = 3.0 * 1.5 * sigma  # vlfeat window radius
    lin = jnp.linspace(-1.0, 1.0, G)
    du = lin[None, :] * win_r
    dv = lin[:, None] * win_r
    ys = y + dv
    xs = x + du
    ma = imops.bilinear_sample_level_ch(grad, lvl, ys, xs, h_lim, w_lim)
    m, a = ma[..., 0], ma[..., 1]
    r2 = (du / jnp.maximum(win_r, 1e-6)) ** 2 + (dv / jnp.maximum(win_r, 1e-6)) ** 2
    wgt = jnp.exp(-r2 * (win_r ** 2) / (2.0 * (1.5 * sigma) ** 2)) * (r2 <= 1.0)
    fbin = a / (2.0 * np.pi) * cfg.orient_bins
    wb = _soft_bin_circular(fbin, cfg.orient_bins)  # (G, G, B)
    hist = jnp.einsum("gh,ghb->b", m * wgt, wb)
    # Smooth the circular histogram (vlfeat smooths 6x with a box filter).
    for _ in range(6):
        hist = (jnp.roll(hist, 1) + hist + jnp.roll(hist, -1)) / 3.0
    def interp_peak(peak):
        hp = hist[(peak + 1) % cfg.orient_bins]
        hm = hist[(peak - 1) % cfg.orient_bins]
        h0 = hist[peak]
        denom = hm - 2.0 * h0 + hp
        dp = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (hm - hp) / denom, 0.0)
        dp = jnp.clip(dp, -0.5, 0.5)
        return jnp.mod((peak + dp) / cfg.orient_bins * 2.0 * np.pi, 2.0 * np.pi)

    n_bins = cfg.orient_bins
    is_local_max = (hist >= jnp.roll(hist, 1)) & (hist >= jnp.roll(hist, -1))
    peak0 = jnp.argmax(hist)
    thetas = [interp_peak(peak0)]
    masks = [jnp.bool_(True)]
    h_max = hist[peak0]
    excluded = jnp.abs(jnp.arange(n_bins) - peak0)
    excluded = jnp.minimum(excluded, n_bins - excluded) <= 1
    for _ in range(cfg.n_orientations - 1):
        cand = jnp.where(is_local_max & ~excluded, hist, -1.0)
        pk = jnp.argmax(cand)
        ok = cand[pk] >= 0.8 * h_max  # vlfeat's 80% rule
        thetas.append(interp_peak(pk))
        masks.append(ok)
        d = jnp.abs(jnp.arange(n_bins) - pk)
        excluded = excluded | (jnp.minimum(d, n_bins - d) <= 1)
    return jnp.stack(thetas), jnp.stack(masks)


def _descriptor_one(grad, lvl, x, y, sigma, theta, cfg: SiftConfig,
                    h_lim=None, w_lim=None):
    """128-D descriptor for one keypoint (vl/sift.c:1931-2080), sampled on a
    fixed GxG grid in the rotated keypoint frame and soft-binned into
    4 x 4 x 8 via matmuls instead of trilinear scatter.  mag/ang are
    (L, H, W) stacks with the level inside the gather."""
    NBP, NBO = 4, 8
    G = cfg.desc_grid
    sbp = cfg.magnif * sigma  # spatial bin size in pixels
    half = (NBP + 1) / 2.0  # sample out to the bin support edge (2.5 bins)
    lin = jnp.linspace(-half, half, G)
    nx = lin[None, :] * jnp.ones((G, 1))  # bin-unit coords
    ny = lin[:, None] * jnp.ones((1, G))
    ct, st = jnp.cos(theta), jnp.sin(theta)
    xs = x + (ct * nx - st * ny) * sbp
    ys = y + (st * nx + ct * ny) * sbp
    ma = imops.bilinear_sample_level_ch(grad, lvl, ys, xs, h_lim, w_lim)
    m, a = ma[..., 0], ma[..., 1]
    # Gaussian window over the descriptor support (sigma_win = NBP/2 bins).
    wgt = jnp.exp(-(nx ** 2 + ny ** 2) / (2.0 * (NBP / 2.0) ** 2))
    rel = jnp.mod(a - theta, 2.0 * np.pi)
    wo = _soft_bin_circular(rel / (2.0 * np.pi) * NBO, NBO)  # (G, G, 8)
    wx = _soft_bin_linear(nx + (NBP - 1) / 2.0, NBP)  # (G, G, 4)
    wy = _soft_bin_linear(ny + (NBP - 1) / 2.0, NBP)
    # Two-step contraction: spatial weights -> (S, 16), then ONE (16, S) @
    # (S, 8) matmul per keypoint.  (The naive 4-operand einsum let XLA pick
    # a contraction order with large per-keypoint intermediates — this form
    # is a clean batched matmul under vmap.)
    S = G * G
    wxy = (wy[..., :, None] * wx[..., None, :]).reshape(S, NBP * NBP)  # (S, 16)
    weighted = wxy * (m * wgt).reshape(S, 1)
    desc = jnp.dot(weighted.T, wo.reshape(S, NBO),
                   preferred_element_type=jnp.float32)  # (16, 8)
    d = desc.reshape(-1)
    # Normalize -> clip 0.2 -> renormalize (sift.c:2054-2069).
    d = d / jnp.maximum(jnp.linalg.norm(d), 1e-12)
    d = jnp.minimum(d, 0.2)
    d = d / jnp.maximum(jnp.linalg.norm(d), 1e-12)
    if cfg.root_sift:
        # RootSIFT (SIFT_describer.hpp:31-45): sqrt of L1-normalized.
        d = jnp.sqrt(d / jnp.maximum(jnp.sum(d), 1e-12))
    # u8 quantization x512 (SIFT_describer.hpp:204-210), kept as float.
    return jnp.minimum(jnp.floor(512.0 * d), 255.0)


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def _detect_octave_candidates(oct_data, cfg: SiftConfig):
    """One octave, detection only: DoG extrema -> top-K -> subpixel refine.
    Returns per-image candidate arrays (all (B, K)) in octave coordinates."""
    dogs = oct_data["dogs"]
    S = cfg.n_scales
    k = min(cfg.max_per_octave, dogs.shape[-1] * dogs.shape[-2] * S)
    score = _extrema_score(dogs, cfg)
    vals, si, yi, xi = _topk_keypoints(score, k)
    refine = jax.vmap(jax.vmap(partial(_refine_one, cfg=cfg), in_axes=(None, 0, 0, 0)))
    x, y, s_cont, val, valid, s_idx = refine(dogs, si, yi, xi)
    return dict(x=x, y=y, s_cont=s_cont, val=val, valid=valid & (vals > 0),
                s_idx=s_idx)


def sift_features(images: jnp.ndarray, cfg: SiftConfig = SiftConfig(),
                  masks: jnp.ndarray | None = None) -> Features:
    """Full detector+describer over a batch: images (B, H, W) float32 in
    [0, 1] -> Features with capacity cfg.max_features per image.

    masks (B, H, W), optional: keypoints on zero-mask pixels are discarded
    BEFORE the capacity top-k, so masked regions don't consume feature
    slots (parity: the reference's per-image feature mask,
    sparseBuilder.cpp:701-740).

    The array-program equivalent of SIFT_Image_describer::Describe
    (src/nonFree/sift/SIFT_describer.hpp:126-216): one jit-able array program
    instead of an OpenMP loop over octaves and keypoints.

    Structure: detect candidates in every octave, select the global
    top-``max_features`` by refined |DoG| score, and only then run the
    gather-bound orientation/descriptor stage on the selected set.  All
    octaves' gradient levels are zero-padded into one (L_total, H0, W0)
    stack so one fused gather serves every octave (per-keypoint h/w limits
    preserve edge-replicate semantics at each octave's true border) — vs.
    describing all n_octaves*max_per_octave candidates, this cuts the
    describe work ~n_octaves-fold."""
    octaves = build_scale_space(images, cfg)
    S = cfg.n_scales
    L = S + 3
    B = images.shape[0]
    H0, W0 = octaves[0]["levels"].shape[-2:]
    cands = [_detect_octave_candidates(o, cfg) for o in octaves]

    # Concatenate candidates across octaves with their octave index.
    def cat(field):
        return jnp.concatenate([c[field] for c in cands], axis=-1)

    x = cat("x")
    y = cat("y")
    s_cont = cat("s_cont")
    val = cat("val")
    valid = cat("valid")
    s_idx = cat("s_idx")
    oct_idx = jnp.concatenate(
        [jnp.full(c["x"].shape, i, jnp.int32) for i, c in enumerate(cands)], axis=-1
    )
    oh = jnp.asarray([o["levels"].shape[-2] for o in octaves], jnp.int32)
    ow = jnp.asarray([o["levels"].shape[-1] for o in octaves], jnp.int32)
    scale = 2.0 ** (oct_idx.astype(jnp.float32) + cfg.first_octave)

    if masks is not None:
        H, W = images.shape[-2:]
        xi = jnp.clip(jnp.round(x * scale).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(jnp.round(y * scale).astype(jnp.int32), 0, H - 1)
        inside = jax.vmap(lambda m, yy, xx: m[yy, xx])(masks, yi, xi)
        valid = valid & (inside > 0)

    # Global top max_features BEFORE the (expensive) describe stage.
    n = cfg.max_features
    masked_score = jnp.where(valid, jnp.abs(val), -1.0)
    if masked_score.shape[-1] > n:
        score, sel = jax.lax.top_k(masked_score, n)
        take = lambda v: jnp.take_along_axis(v, sel, axis=-1)
        x, y, s_cont, s_idx, oct_idx, valid, scale = (
            take(x), take(y), take(s_cont), take(s_idx), take(oct_idx),
            take(valid), take(scale),
        )
    else:
        score = masked_score

    # One padded gradient stack for all octaves: (B, n_oct * L, H0, W0).
    grads = []
    for o in octaves:
        m, a = imops.gradients(o["levels"])
        ph, pw = H0 - m.shape[-2], W0 - m.shape[-1]
        pad = ((0, 0), (0, 0), (0, ph), (0, pw), (0, 0))
        grads.append(jnp.pad(jnp.stack([m, a], axis=-1), pad))
    grad = jnp.concatenate(grads, axis=-4)  # (B, n_oct*L, H0, W0, 2)

    lvl = oct_idx * L + s_idx
    h_lim = oh[oct_idx]
    w_lim = ow[oct_idx]

    def per_kp(grad_l, x, y, s_cont, lvl, hl, wl):
        sigma_oct = cfg.sigma0 * 2.0 ** (s_cont / S)
        thetas, ori_mask = _orientation_one(
            grad_l, lvl, x, y, sigma_oct, cfg, hl, wl)
        descs = jax.vmap(
            lambda th: _descriptor_one(
                grad_l, lvl, x, y, sigma_oct, th, cfg, hl, wl)
        )(thetas)
        return thetas, ori_mask, descs, sigma_oct

    theta, ori_mask, desc, sigma_oct = jax.vmap(
        jax.vmap(per_kp, in_axes=(None, 0, 0, 0, 0, 0, 0))
    )(grad, x, y, s_cont, lvl, h_lim, w_lim)
    # Shapes: theta/ori_mask (B, K, n_ori), desc (B, K, n_ori, 128).

    n_ori = cfg.n_orientations
    K = x.shape[-1]

    def tile(v):  # (B, K) -> (B, K * n_ori)
        return jnp.repeat(v[..., None], n_ori, axis=-1).reshape(B, K * n_ori)

    kp = jnp.stack(
        [tile(x * scale), tile(y * scale), tile(sigma_oct * scale),
         theta.reshape(B, K * n_ori)],
        axis=-1,
    )
    desc = desc.reshape(B, K * n_ori, -1)
    score = tile(score)
    mask = tile(valid) & ori_mask.reshape(B, K * n_ori)

    # Multi-orientation overflows capacity: re-select top max_features.
    if n_ori > 1 and kp.shape[-2] > n:
        masked_score = jnp.where(mask, score, -1.0)
        score, sel = jax.lax.top_k(masked_score, n)
        kp = jnp.take_along_axis(kp, sel[..., None], axis=-2)
        desc = jnp.take_along_axis(desc, sel[..., None], axis=-2)
        mask = jnp.take_along_axis(mask, sel, axis=-1)
    return Features(kp=kp, desc=desc, score=score, mask=mask & (score > 0))


@partial(jax.jit, static_argnums=(1,))
def detect_and_describe(images: jnp.ndarray, cfg: SiftConfig = SiftConfig(),
                        masks: jnp.ndarray | None = None) -> Features:
    """Jitted entry point; accepts (B, H, W[, 3]) uint8 or float, plus an
    optional (B, H, W) feature mask (nonzero = keep)."""
    gray = imops.to_grayscale(images)
    return sift_features(gray, cfg, masks=masks)
