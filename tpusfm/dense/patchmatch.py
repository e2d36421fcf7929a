"""PatchMatch multi-view stereo refinement: slanted-plane hypotheses with
red-black checkerboard propagation.

Capability parity with the reference's dense stage — OpenMVS
``DensifyPointCloud`` (spawned at src/main.cpp:161) *is* PatchMatch MVS.
The plane-sweep stage (tpusfm.dense.depth) recovers fronto-parallel depth;
this module refines it with per-pixel slanted planes, which removes the
staircase/fattening bias on oblique surfaces.

Array formulation (SURVEY.md §7 hard part 6): PatchMatch's sequential
spatial propagation becomes *checkerboard sweeps* — every pixel of one
parity updates simultaneously from its 4 neighbors of the other parity, so
each half-iteration is a fully regular, vectorizable array program.

Performance design (an earlier version evaluated every candidate on the
FULL pixel grid with 4-gather bilinear reference sampling):

  - **parity compaction**: each half-sweep gathers the active checkerboard
    parity into dense (H, W/2) fields, evaluates candidates there, and
    scatters the winners back — halving all sampling work and peak
    residency per candidate evaluation,
  - **hoisted reference statistics**: the NCC terms that depend only on the
    reference window (mean, variance, per-offset values) are computed once
    per half-sweep with static edge-clamped shifts (no gathers) instead of
    once per candidate with bilinear gathers,
  - **sparse diamond window**: the NCC window is a dilated diamond plus the
    4 far corners (17 samples at radius 6 / dilation 3) instead of a full
    square (25 at radius 4) — wider extent with fewer samples measurably
    IMPROVES the recovered normals (corner samples have the largest slant
    lever arm) while cutting sampling cost 32%,
  - **unrolled offset loop**: the window loop is a static Python loop, so
    the only remaining gathers per candidate are the unavoidable
    source-texture samples.

Sampling design: per-element gathers dominate the stage, so the candidate
evaluation samples with ONE gather each from a pre-upsampled source
pyramid ("up8": 1/16-px effective precision, built by gather-free XLA
resize convs) instead of 4-gather bilinear; the checkerboard parity
gather/scatter is replaced by strided lane slices + selects (zero gather/
scatter ops); and view batching uses lax.map, not vmap (batched operands
knock XLA's gather lowering off its best path, ~1.45x).

State per pixel: inverse depth + unit normal (a plane through the
backprojected point).  Candidates per half-sweep: the 4 neighbor planes
re-intersected with the pixel's own ray (true slanted propagation), a joint
depth+normal perturbation with geometrically shrinking scale, a full-range
random restart, and a normal-only perturbation.  Cost: zero-mean NCC over
the window, best-k aggregated over source views, evaluated by intersecting
each window ray with the hypothesis plane and bilinearly sampling the
sources.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class PatchMatchConfig:
    n_iters: int = 4            # full iterations (each = 2 parity sweeps)
    window_radius: int = 6      # window half-extent in px
    dilation: int = 3           # sample spacing inside the window
    window_pattern: str = "diamond"  # "diamond"+corners (sparse) or "square"
    best_k: int = 2             # best-k source aggregation (as plane sweep)
    perturb_depth: float = 0.20     # initial relative inv-depth perturbation
    perturb_normal_deg: float = 25.0
    cost_invalid: float = 2.0
    min_ndotr: float = 0.05     # reject grazing plane/ray intersections
    min_sigma: float = 1e-3     # reject textureless NCC windows
    # Fine-level candidate set (coarse-to-fine): after a good coarse init,
    # drop the full-range random restart and the normal-only perturbation —
    # 5 candidates instead of 7 (the neighbors + a small joint perturb
    # polish the upsampled solution).
    fine: bool = False
    # Two-phase candidate evaluation (round-5): score ALL candidates on a
    # cheap inner-window subset first, then full-window-score only the
    # per-pixel winner against the incumbent.  Sampling is the stage's
    # measured wall clock (gather floor), and per half-sweep this cuts
    # sample sets from Nc*No to Nc*Np + No (7 cands, 21/9 offsets:
    # 147 -> 84).  The winner is always re-scored on the FULL window, so
    # accept decisions stay windows-comparable; only the candidate RANKING
    # uses the subset.
    presel: bool = True
    # Neighbor candidates per half-sweep: 2 = alternating (down,right)/
    # (up,left) direction pairs (sequential PatchMatch's raster
    # alternation — halves propagation sampling; one extra iteration
    # recovers the normal quality at ~55% of the old cost), 4 = all.
    neighbors: int = 2
    # Source sampling for candidate NCC evaluation.  Gathers dominate the
    # stage and bilinear costs FOUR gathers per window sample (whether
    # "up8" still beats "bilinear" on the GPU is open, ROADMAP.md):
    #   "bilinear" — exact 4-tap sampling;
    #   "nearest"  — 1 gather, half-pixel quantization (slant/normal
    #                recovery degrades: 20 deg median vs 13 with bilinear);
    #   "up2"/"up4" — 1 gather from a 2x/4x bilinearly pre-upsampled source
    #                (jax.image.resize = gather-free convs, built once per
    #                view): bilinear quantized to 1/2 / 1/4 px at nearest's
    #                gather cost — the software form of texture-unit
    #                filtering.  Quality guard: tests/test_patchmatch.py.
    sampling: str = "up8"


def _window_offsets(cfg: PatchMatchConfig) -> list[tuple[int, int]]:
    """Static window offset list (unrolled in the compiled program)."""
    r, d = cfg.window_radius, cfg.dilation
    steps = list(range(-r, r + 1, d))
    offs = [(dy, dx) for dy in steps for dx in steps]
    if cfg.window_pattern == "diamond":
        # Dilated diamond + the 4 far corners + a 1-px inner cross: the
        # corners carry the largest lever arm for the slant (normal)
        # estimate and the inner cross restores near-field depth
        # sensitivity — measured 13.4 deg median normal error / 0.0026
        # median relative depth error at 21 samples vs 15.3 deg / 0.0026
        # for the full 25-sample square at radius 4.
        offs = [(dy, dx) for dy, dx in offs if abs(dy) + abs(dx) <= r]
        offs += [(-r, -r), (-r, r), (r, -r), (r, r)]
        if d > 1:
            offs += [(-1, 0), (1, 0), (0, -1), (0, 1)]
    return offs


def _presel_offsets(cfg: PatchMatchConfig) -> list[tuple[int, int]]:
    """Subset for candidate pre-selection: the 1-px cross (near-field depth
    sensitivity) + the 4 far corners (the largest slant lever arm — without
    them normal-perturbation candidates misrank and normal recovery
    degrades, measured 20 vs 13 deg median)."""
    r = cfg.window_radius
    offs = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
            (-r, -r), (-r, r), (r, -r), (r, r)]
    seen = []
    for o in offs:
        if o not in seen:
            seen.append(o)
    return seen


def _shift_edge(img, dy: int, dx: int):
    """Static shift with edge clamp: out[y, x] = img[clip(y+dy), clip(x+dx)]."""
    if dy == 0 and dx == 0:
        return img
    H, W = img.shape
    p = jnp.pad(img, ((abs(dy), abs(dy)), (abs(dx), abs(dx))), mode="edge")
    return jax.lax.dynamic_slice(p, (abs(dy) + dy, abs(dx) + dx), (H, W))


def _bilinear(img, vv, uu):
    """Sample img (H, W) at float coords (vv, uu) of any shape (clamped)."""
    H, W = img.shape
    return bilinear_flat(img.reshape(1, -1), 0, vv, uu, H, W)


def bilinear_flat(flat, src_off, vv, uu, H: int, W: int):
    """Bilinear sample from a FLATTENED single-row image stack.

    flat (1, S*H*W); src_off = s*H*W per element (broadcastable to vv);
    vv/uu float coords of any shape.  All four taps ride ONE
    take_along_axis call on the single-row flattened operand; the bigger
    lever is needing FEWER gathers — see make_sampler's "upN" modes."""
    v0 = jnp.clip(jnp.floor(vv).astype(jnp.int32), 0, H - 2)
    u0 = jnp.clip(jnp.floor(uu).astype(jnp.int32), 0, W - 2)
    fv = jnp.clip(vv - v0, 0.0, 1.0)
    fu = jnp.clip(uu - u0, 0.0, 1.0)
    base = src_off + v0 * W + u0
    sh = base.shape
    idx = jnp.stack([base, base + 1, base + W, base + W + 1], 0).reshape(1, -1)
    g = jnp.take_along_axis(flat, idx, axis=1).reshape((4,) + sh)
    return (g[0] * (1 - fv) * (1 - fu) + g[1] * (1 - fv) * fu
            + g[2] * fv * (1 - fu) + g[3] * fv * fu)


def nearest_flat(flat, src_off, vv, uu, H: int, W: int):
    """Nearest-neighbour sample from a flattened single-row image stack —
    one gather per sample (see bilinear_flat for the layout rationale)."""
    v0 = jnp.clip(jnp.round(vv).astype(jnp.int32), 0, H - 1)
    u0 = jnp.clip(jnp.round(uu).astype(jnp.int32), 0, W - 1)
    idx = (src_off + v0 * W + u0).reshape(1, -1)
    return jnp.take_along_axis(flat, idx, axis=1).reshape(vv.shape)


def make_sampler(src_imgs, mode: str):
    """Build a per-source sampler `sample(vv, uu) -> values` over a source
    stack (S, H, W); vv/uu are float pixel coords in the ORIGINAL
    resolution with leading source axis (S, ...).

    Modes (see PatchMatchConfig.sampling): "bilinear" (4 gathers/sample),
    "nearest" (1 gather, 1/2 px), "upN" (1 gather from an N-x bilinearly
    pre-upsampled copy — 1/(2N) px quantization; the upsample is gather-free
    XLA convs amortized over every candidate evaluation)."""
    S, H, W = src_imgs.shape

    def off(ndim, hw):
        return (jnp.arange(S, dtype=jnp.int32) * hw).reshape(
            (S,) + (1,) * (ndim - 1))

    if mode.startswith("up"):
        k = int(mode[2:])
        Hs, Ws = H * k, W * k
        # bf16 storage: the pyramid is k^2 * 4 bytes/px/src in f32 (up8 at
        # 0.3 MP x 3 src = 236 MB); bf16 halves it for ~0.4% value noise —
        # below the 1/(2k) px interpolation quantization already accepted.
        up = jax.image.resize(src_imgs, (S, Hs, Ws), "bilinear")
        flat = up.astype(jnp.bfloat16).reshape(1, -1)
        half = (k - 1) * 0.5  # pixel-center alignment of the upsampled grid

        def sample(vv, uu):
            out = nearest_flat(flat, off(vv.ndim, Hs * Ws),
                               vv * k + half, uu * k + half, Hs, Ws)
            return out.astype(jnp.float32)
    elif mode == "nearest":
        flat = src_imgs.reshape(1, -1)

        def sample(vv, uu):
            return nearest_flat(flat, off(vv.ndim, H * W), vv, uu, H, W)
    elif mode == "bilinear":
        flat = src_imgs.reshape(1, -1)

        def sample(vv, uu):
            return bilinear_flat(flat, off(vv.ndim, H * W), vv, uu, H, W)
    else:
        raise ValueError(f"unknown sampling mode {mode!r}")
    return sample


def _parity_even(H: int, phase):
    """(H,) bool: rows whose ACTIVE checkerboard column offset is 0."""
    return (jnp.arange(H, dtype=jnp.int32) + phase) % 2 == 0


def _gather_parity(x, phase):
    """Checkerboard gather WITHOUT a gather op: the active cells of `phase`
    are column offset (y+phase)%2 in each row, so two strided lane slices +
    one select replace the take_along_axis (a gather pays per element;
    strided slices and selects are plain fused elementwise work).
    x (H, W[, k]) -> (H, Wh[, k])."""
    H = x.shape[0]
    even = _parity_even(H, phase)
    a = x[:, 0::2]
    b = x[:, 1::2]
    cond = even[:, None] if x.ndim == 2 else even[:, None, None]
    return jnp.where(cond, a, b)


def _scatter_parity(x, val, phase):
    """Inverse of _gather_parity: write `val` (H, Wh[, k]) into the active
    checkerboard cells of x (H, W[, k]), leaving the other parity as-is —
    interleave via stack+reshape, no scatter op."""
    H = x.shape[0]
    even = _parity_even(H, phase)
    a = x[:, 0::2]
    b = x[:, 1::2]
    cond = even[:, None] if x.ndim == 2 else even[:, None, None]
    a2 = jnp.where(cond, val, a)
    b2 = jnp.where(cond, b, val)
    return jnp.stack([a2, b2], axis=2).reshape(x.shape)


def _plane_from_state(inv_d, n, rpx, rpy):
    """Plane constant c = n . X_p with X_p = r_p / inv_d (ray z-component 1)."""
    ndotr = n[..., 0] * rpx + n[..., 1] * rpy + n[..., 2]
    return ndotr / jnp.maximum(inv_d, 1e-9)


def _state_from_plane(n, c, rpx, rpy, min_ndotr):
    """Inverse depth of pixel p's ray intersected with plane (n, c)."""
    ndotr = n[..., 0] * rpx + n[..., 1] * rpy + n[..., 2]
    safe = jnp.abs(ndotr) > min_ndotr
    inv_d = jnp.where(safe, ndotr / jnp.where(jnp.abs(c) < 1e-9, 1e-9, c), 0.0)
    return inv_d, safe


def _random_unit_normal(key, shape):
    """Camera-facing (n_z < 0) random unit normals within ~60 deg of -z."""
    k1, k2 = jax.random.split(key)
    nx = 0.7 * (jax.random.uniform(k1, shape) * 2.0 - 1.0)
    ny = 0.7 * (jax.random.uniform(k2, shape) * 2.0 - 1.0)
    n = jnp.stack([nx, ny, -jnp.ones(shape)], axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def _perturb_normal(key, n, max_deg):
    """Small random rotation of each normal, kept camera-facing."""
    d = jax.random.normal(key, n.shape) * jnp.radians(max_deg) * 0.5
    out = n + d
    out = out / jnp.maximum(jnp.linalg.norm(out, axis=-1, keepdims=True), 1e-9)
    # Keep facing the camera (n_z < 0); a flip is plane-equivalent anyway.
    return jnp.where(out[..., 2:3] < -0.05, out, n)


def _cost_active(n_a, c_a, xs_a, ys_a, rv_stack, mr_a, varr_a, sample, S,
                 fx, fy, cx, cy, fxs, fys, cxs, cys, R_rel, t_rel,
                 offsets, cfg: PatchMatchConfig, HW):
    """NCC cost of candidate planes (n_a (..,3), c_a) on the active pixel
    field with coordinates (ys_a, xs_a) (float (H, Wh)).

    rv_stack (No, H, Wh): reference intensities at each window offset for
    the active pixels (candidate-independent, hoisted by the caller).
    mr_a/varr_a: reference window mean/variance on the active field.
    Returns cost (H, Wh) in [0, 2] (cost_invalid = invalid)."""
    H, W = HW
    No = len(offsets)
    sh = c_a.shape
    offs_arr = jnp.asarray(offsets, jnp.float32)  # (No, 2) static values
    # Note (round 4): grouping G=8 offsets per scan step so each gather op
    # carries 8x the indices was measured SLOWER end-to-end (12.4 vs 8
    # s/batch at the bench config) — the (S, G, H, Wh) transients push the
    # whole chain through HBM, while the per-offset scan keeps each
    # iteration's elementwise work fused around one modest gather.

    def accum(sums, xs_in):
        s_s, s_ss, s_rs, oob = sums
        off, rv = xs_in
        dy, dx = off[0], off[1]
        # Window ray at q = p + (dx, dy) — intersect with p's plane.
        rqx = (xs_a + dx - cx) / fx
        rqy = (ys_a + dy - cy) / fy
        ndotr = n_a[..., 0] * rqx + n_a[..., 1] * rqy + n_a[..., 2]
        safe = jnp.abs(ndotr) > cfg.min_ndotr
        s = c_a / jnp.where(safe, ndotr,
                            jnp.where(ndotr >= 0, cfg.min_ndotr, -cfg.min_ndotr))
        # Intersection point X = s * (rqx, rqy, 1), projected to each source.
        Xs = (
            R_rel[:, None, None, :, 0] * (s * rqx)[None, ..., None]
            + R_rel[:, None, None, :, 1] * (s * rqy)[None, ..., None]
            + R_rel[:, None, None, :, 2] * s[None, ..., None]
            + t_rel[:, None, None, :]
        )  # (S, H, Wh, 3)
        z = Xs[..., 2]
        zsafe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        us = Xs[..., 0] / zsafe * fxs[:, None, None] + cxs[:, None, None]
        vs = Xs[..., 1] / zsafe * fys[:, None, None] + cys[:, None, None]
        inb = (us >= 0) & (us <= W - 1) & (vs >= 0) & (vs <= H - 1) & (z > 0) & safe
        sv = jnp.where(inb, sample(vs, us), 0.0)
        return (
            s_s + sv, s_ss + sv * sv, s_rs + sv * rv[None],
            oob + (~inb).astype(jnp.float32),
        ), None

    init = tuple(jnp.zeros((S,) + sh) for _ in range(4))
    (s_s, s_ss, s_rs, oob), _ = jax.lax.scan(accum, init, (offs_arr, rv_stack))

    N = float(No)
    ms = s_s / N
    var_s = jnp.maximum(s_ss / N - ms * ms, 0.0)
    cov = s_rs / N - mr_a[None] * ms
    sig = jnp.sqrt(varr_a[None] * var_s)
    ncc = jnp.clip(cov / jnp.maximum(sig, cfg.min_sigma**2), -1.0, 1.0)
    # A window is valid when most samples landed in-bounds and has texture.
    ok = (oob < 0.3 * N) & (varr_a[None] > cfg.min_sigma**2)
    cost_s = jnp.where(ok, 1.0 - ncc, cfg.cost_invalid)  # (S, H, Wh)

    return _best_k_mean(cost_s, min(cfg.best_k, S))  # (H, Wh)


def _best_k_mean(cost_s, k: int):
    """Mean of the k smallest values along axis 0 (source aggregation).
    S is tiny (3-6 sources), so a leading-axis sort is an elementwise
    min/max sorting network — measurably cheaper than lax.top_k, which
    moves the axis minor and runs a general sort per call (this sits in
    the per-candidate inner loop: ~150 calls per half-sweep)."""
    S = cost_s.shape[0]
    if k >= S:
        return jnp.mean(cost_s, axis=0)
    if k == 1:
        return jnp.min(cost_s, axis=0)
    if k == S - 1:
        return (jnp.sum(cost_s, axis=0) - jnp.max(cost_s, axis=0)) / k
    return jnp.mean(jnp.sort(cost_s, axis=0)[:k], axis=0)


@partial(jax.jit, static_argnames=("cfg",))
def patchmatch_refine(
    ref_img: jnp.ndarray,     # (H, W) float32 raw intensities
    src_imgs: jnp.ndarray,    # (S, H, W)
    K: jnp.ndarray,           # (3, 3) reference-view intrinsics
    K_src: jnp.ndarray,       # (S, 3, 3) per-source intrinsics
    R_rel: jnp.ndarray,       # (S, 3, 3) ref-cam -> src-cam
    t_rel: jnp.ndarray,       # (S, 3)
    inv_d_init: jnp.ndarray,  # (H, W) plane-sweep inverse depth init
    inv_lo: jnp.ndarray,      # scalar: min inverse depth of the search range
    inv_hi: jnp.ndarray,      # scalar: max inverse depth
    key: jnp.ndarray,
    cfg: PatchMatchConfig = PatchMatchConfig(),
    n_init: jnp.ndarray | None = None,  # (H, W, 3) normal init (e.g. an
                                        # upsampled coarse level); None =
                                        # fronto-parallel
):
    """Refine a fronto-parallel depth init into slanted-plane depth.

    Returns (depth (H, W), cost (H, W), normal (H, W, 3))."""
    H, W = ref_img.shape
    if W % 2:  # parity compaction needs an even width: edge-pad one column
        ref_img = jnp.pad(ref_img, ((0, 0), (0, 1)), mode="edge")
        src_imgs = jnp.pad(src_imgs, ((0, 0), (0, 0), (0, 1)), mode="edge")
        inv_d_init = jnp.pad(inv_d_init, ((0, 0), (0, 1)), mode="edge")
        if n_init is not None:
            n_init = jnp.pad(n_init, ((0, 0), (0, 1), (0, 0)), mode="edge")
        d, c, n = patchmatch_refine(ref_img, src_imgs, K, K_src, R_rel, t_rel,
                                    inv_d_init, inv_lo, inv_hi, key, cfg,
                                    n_init)
        return d[:, :W], c[:, :W], n[:, :W]

    Wh = W // 2
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    fxs, fys = K_src[:, 0, 0], K_src[:, 1, 1]
    cxs, cys = K_src[:, 0, 2], K_src[:, 1, 2]
    ys = jnp.arange(H, dtype=jnp.float32)[:, None] * jnp.ones((1, W), jnp.float32)
    xs = jnp.arange(W, dtype=jnp.float32)[None, :] * jnp.ones((H, 1), jnp.float32)
    rpx = (xs - cx) / fx
    rpy = (ys - cy) / fy
    offsets = _window_offsets(cfg)
    No = len(offsets)

    # Candidate-independent reference window statistics (static shifts).
    s_r = jnp.zeros((H, W))
    s_rr = jnp.zeros((H, W))
    for dy, dx in offsets:
        rv = _shift_edge(ref_img, dy, dx)
        s_r = s_r + rv
        s_rr = s_rr + rv * rv
    mr = s_r / No
    var_r = jnp.maximum(s_rr / No - mr * mr, 0.0)

    sample = make_sampler(src_imgs, cfg.sampling)
    cost_kw = dict(sample=sample, S=src_imgs.shape[0], fx=fx, fy=fy, cx=cx,
                   cy=cy, fxs=fxs, fys=fys, cxs=cxs, cys=cys, R_rel=R_rel,
                   t_rel=t_rel, offsets=offsets, cfg=cfg, HW=(H, W))

    def _active_x(phase):
        """Float x-coordinates of parity `phase`'s active cells (H, Wh):
        row y holds active columns x with (x + y + phase) % 2 == 0."""
        off = ((jnp.arange(H, dtype=jnp.int32) + phase) % 2).astype(jnp.float32)
        return 2.0 * jnp.arange(Wh, dtype=jnp.float32)[None, :] + off[:, None]

    def eval_parity(phase, n_full, c_full):
        """Cost of the (n_full, c_full) plane field on parity `phase`'s
        active cells; returns cost_a (H, Wh)."""
        xs_a = _active_x(phase)
        ys_a = ys[:, :Wh]
        rv_stack = jnp.stack([
            _gather_parity(_shift_edge(ref_img, dy, dx), phase)
            for dy, dx in offsets
        ])
        c_a = _cost_active(_gather_parity(n_full, phase),
                           _gather_parity(c_full, phase),
                           xs_a, ys_a, rv_stack, _gather_parity(mr, phase),
                           _gather_parity(var_r, phase), **cost_kw)
        return c_a

    if n_init is None:
        n0 = jnp.zeros((H, W, 3)).at[..., 2].set(-1.0)  # fronto-parallel
    else:
        nl = jnp.linalg.norm(n_init, axis=-1, keepdims=True)
        n0 = n_init / jnp.maximum(nl, 1e-9)
    inv0 = jnp.clip(inv_d_init, inv_lo, inv_hi)
    c0_full = _plane_from_state(inv0, n0, rpx, rpy)
    # Initial cost: one evaluation per parity, interleaved into the grid.
    cost0 = jnp.zeros((H, W))
    for ph in (0, 1):
        ca = eval_parity(jnp.int32(ph), n0, c0_full)
        cost0 = _scatter_parity(cost0, ca, jnp.int32(ph))

    def half_sweep(state, xs_in):
        inv_d, n, cost = state
        key, phase, scale, sweep_idx = xs_in
        xs_a = _active_x(phase)
        ys_a = ys[:, :Wh]
        c_cur = _plane_from_state(inv_d, n, rpx, rpy)
        rpx_a = (xs_a - cx) / fx
        rpy_a = (ys_a - cy) / fy
        # Hoisted reference stats / values on the active field.
        rv_stack = jnp.stack([
            _gather_parity(_shift_edge(ref_img, dy, dx), phase)
            for dy, dx in offsets
        ])
        mr_a = _gather_parity(mr, phase)
        varr_a = _gather_parity(var_r, phase)
        inv_a = _gather_parity(inv_d, phase)
        n_a = _gather_parity(n, phase)
        cost_a = _gather_parity(cost, phase)

        # Candidate planes on the active field, stacked (Ncand, H, Wh, ...):
        cand_n, cand_c = [], []
        # Neighbor propagation (checkerboard: neighbors are the other
        # parity).  Round 5: TWO alternating directions per half-sweep
        # ((down,right) then (up,left)) instead of all four — sequential
        # PatchMatch's classic raster alternation.  Halves the dominant
        # candidate-evaluation sampling; information still crosses the
        # grid in both directions every full iteration.  The shifts are
        # static (cheap); only the EVALUATED candidate count shrinks.
        nb = []
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nn = jnp.stack([_shift_edge(n[..., i], dy, dx) for i in range(3)],
                           axis=-1)
            nb.append((_gather_parity(nn, phase),
                       _gather_parity(_shift_edge(c_cur, dy, dx), phase)))
        if cfg.neighbors >= 4:
            for a in range(4):
                cand_n.append(nb[a][0])
                cand_c.append(nb[a][1])
        else:
            fwd = (sweep_idx % 2) == 0
            for a, bq in ((0, 2), (1, 3)):  # (down,right) vs (up,left)
                cand_n.append(jnp.where(fwd, nb[a][0], nb[bq][0]))
                cand_c.append(jnp.where(fwd, nb[a][1], nb[bq][1]))
        # Joint depth+normal perturbation (shrinking scale).
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        sh = (H, Wh)
        inv_p = jnp.clip(
            inv_a * jnp.exp(jax.random.normal(k1, sh) * cfg.perturb_depth * scale),
            inv_lo, inv_hi,
        )
        n_p = _perturb_normal(k2, n_a, cfg.perturb_normal_deg * scale)
        cand_n.append(n_p)
        cand_c.append(_plane_from_state(inv_p, n_p, rpx_a, rpy_a))
        if not cfg.fine:
            # Random restart (full-range exploration).
            inv_r = inv_lo + (inv_hi - inv_lo) * jax.random.uniform(k3, sh)
            n_r = _random_unit_normal(k4, sh)
            cand_n.append(n_r)
            cand_c.append(_plane_from_state(inv_r, n_r, rpx_a, rpy_a))
            # Normal-only perturbation at the current depth.
            n_o = _perturb_normal(k5, n_a, cfg.perturb_normal_deg * scale)
            cand_n.append(n_o)
            cand_c.append(_plane_from_state(inv_a, n_o, rpx_a, rpy_a))

        def eval_cand(st, cand):
            inv_b, n_b, cost_b = st
            nn, cc = cand
            c_cost = _cost_active(nn, cc, xs_a, ys_a, rv_stack, mr_a, varr_a,
                                  **cost_kw)
            inv_c, ok = _state_from_plane(nn, cc, rpx_a, rpy_a, cfg.min_ndotr)
            ok = ok & (inv_c > inv_lo * 0.5) & (inv_c < inv_hi * 2.0)
            better = ok & (c_cost < cost_b)
            return (
                jnp.where(better, inv_c, inv_b),
                jnp.where(better[..., None], nn, n_b),
                jnp.where(better, c_cost, cost_b),
            ), None

        cand_n_st = jnp.stack(cand_n)
        cand_c_st = jnp.stack(cand_c)
        if cfg.presel and len(cand_n) > 2:
            # Phase 1: rank every candidate on the cheap inner window.
            p_offs = _presel_offsets(cfg)
            rvp = jnp.stack([
                _gather_parity(_shift_edge(ref_img, dy, dx), phase)
                for dy, dx in p_offs
            ])
            s_rp = sum(rvp[i] for i in range(len(p_offs)))
            s_rrp = sum(rvp[i] * rvp[i] for i in range(len(p_offs)))
            mr_p = s_rp / len(p_offs)
            var_p = jnp.maximum(s_rrp / len(p_offs) - mr_p * mr_p, 0.0)
            presel_kw = dict(cost_kw, offsets=p_offs)

            def presel_one(cand):
                nn, cc = cand
                return _cost_active(nn, cc, xs_a, ys_a, rvp, mr_p, var_p,
                                    **presel_kw)

            costs_p = jax.lax.map(presel_one, (cand_n_st, cand_c_st))
            # Phase 2: the TOP-2 subset-ranked candidates get the full-window
            # score and the usual incumbent comparison (windows stay
            # comparable; top-2 instead of top-1 preserves normal-candidate
            # diversity — winner-take-all measured 17-20 vs 13 deg median
            # normal error on the slanted-plane test).
            nc = costs_p.shape[0]
            sel1 = jnp.argmin(costs_p, axis=0)  # (H, Wh)
            masked = costs_p + (jnp.arange(nc)[:, None, None] == sel1[None]
                                ) * 1e9
            sel2 = jnp.argmin(masked, axis=0)
            for sel in (sel1, sel2):
                nn_sel = jnp.take_along_axis(
                    cand_n_st, sel[None, ..., None], axis=0)[0]
                cc_sel = jnp.take_along_axis(cand_c_st, sel[None], axis=0)[0]
                (inv_a, n_a, cost_a), _ = eval_cand(
                    (inv_a, n_a, cost_a), (nn_sel, cc_sel))
        else:
            (inv_a, n_a, cost_a), _ = jax.lax.scan(
                eval_cand, (inv_a, n_a, cost_a),
                (cand_n_st, cand_c_st),
            )
        # Interleave the winners back into the full-resolution state.
        inv_d = _scatter_parity(inv_d, inv_a, phase)
        n = _scatter_parity(n, n_a, phase)
        cost = _scatter_parity(cost, cost_a, phase)
        return (inv_d, n, cost), None

    n_sweeps = 2 * cfg.n_iters
    keys = jax.random.split(key, n_sweeps)
    phases = jnp.arange(n_sweeps, dtype=jnp.int32) % 2
    scales = 0.5 ** (jnp.arange(n_sweeps, dtype=jnp.float32) // 2)
    sweep_ids = jnp.arange(n_sweeps, dtype=jnp.int32)
    (inv_d, n, cost), _ = jax.lax.scan(
        half_sweep, (inv0, n0, cost0), (keys, phases, scales, sweep_ids)
    )
    depth = 1.0 / jnp.maximum(inv_d, 1e-9)
    return depth, cost, n
