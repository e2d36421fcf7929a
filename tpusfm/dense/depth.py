"""Dense multi-view stereo: plane-sweep depth maps + consistency filtering
+ fused colored point cloud.

Capability parity with the reference's out-of-process dense stage —
``DensifyPointCloud`` (OpenMVS PatchMatch MVS spawned at src/main.cpp:161)
fed by the ``DenseBuilder`` scene exporter (src/denseBuilder/DenseBuilder.h:
54-146).  The array formulation here (SURVEY.md §7 layer 8, hard part 6):
PatchMatch's sequential propagation is replaced by a *plane sweep* — a
regular, fully vectorizable cost volume over inverse-depth planes:

  - per reference view, K nearest source views are warped through
    fronto-parallel plane homographies (one gather per source x plane),
  - photometric cost is zero-mean NCC, computed as a box-filtered product
    of locally normalized images (one conv per source x plane),
  - per-pixel costs aggregate over the best-2 sources (occlusion robust),
  - argmin over planes + parabolic sub-plane refinement gives the depth,
  - cross-view geometric consistency (>= min_consistent views) filters the
    maps before fusion into a colored cloud.

Everything is jit over fixed shapes; reference views shard over the device
mesh by view cluster (tpusfm.parallel.dist_dense).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import lie
from . import patchmatch as pm_mod
from .patchmatch import PatchMatchConfig, make_sampler


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    n_planes: int = 64
    n_sources: int = 4          # source views per reference view
    window: int = 5             # NCC window
    best_k: int = 2             # best-k source aggregation
    min_consistent: int = 2     # cross-view consistency votes
    rel_depth_tol: float = 0.02
    cost_thresh: float = 0.6    # max accepted (1 - NCC) cost
    depth_margin: float = 0.25  # widen the sparse depth range by this factor
    subsample: int = 1          # pixel stride for fusion
    # Plane-warp sampling: "nearest" and the pre-upsampled "upN" modes take
    # 1 gather per sample vs bilinear's 4 (the sweep is gather-heavy), and
    # the box-filtered NCC plus parabolic sub-plane refinement absorb the
    # sub-pixel sampling noise (quality guard: tests/test_dense.py).
    # "bilinear" restores exact warps.
    sweep_sampling: str = "up4"
    # Slanted-plane PatchMatch refinement of the plane-sweep init
    # (checkerboard propagation, tpusfm.dense.patchmatch) — removes the
    # fronto-parallel bias on oblique surfaces.  ON by default: the
    # reference's dense stage (OpenMVS DensifyPointCloud, main.cpp:161)
    # IS PatchMatch MVS.
    patchmatch: bool = True
    pm: PatchMatchConfig = dataclasses.field(default_factory=PatchMatchConfig)
    # Reference views per device dispatch on the packed/vmapped sweep path
    # (scaled by the mesh width when sharded).
    view_batch: int = 4
    # Above this many pixels per view, PatchMatch dispatches ONE view per
    # device, which bounds the program's working set; per-view dispatch
    # costs only host-loop overhead (~ms) against the PM compute.
    pm_batch_px: int = 200_000
    # Coarse-to-fine PatchMatch above this many pixels per view: the full
    # candidate schedule runs at HALF resolution (1/4 the sampling cost),
    # then one fine full-resolution iteration with the reduced candidate
    # set polishes the upsampled planes.  OpenMVS densifies multi-scale the
    # same way.
    pm_multiscale: bool = True
    pm_coarse_px: int = 120_000
    # With the multiscale PatchMatch engaged, the plane sweep exists only
    # to SEED the coarse PM level — so run it at half resolution too (1/4
    # the sampling cost; the full-res sweep was ~15% of the stage).  The
    # sweep-only config (patchmatch=False) always sweeps at full res.
    sweep_coarse: bool = True


def _box_mean(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """Box filter over trailing 2 dims via reduce_window (SAME)."""
    s = jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1,) * (x.ndim - 2) + (w, w), (1,) * x.ndim, "SAME"
    )
    return s / (w * w)


def local_normalize(img: jnp.ndarray, w: int) -> jnp.ndarray:
    """Zero-mean, unit-variance per window: NCC becomes a box-filtered dot
    product of normalized images."""
    m = _box_mean(img, w)
    v = _box_mean(img * img, w) - m * m
    return (img - m) / jnp.sqrt(jnp.maximum(v, 1e-6))


@partial(jax.jit, static_argnames=("cfg",))
def plane_sweep_depth(
    ref_img: jnp.ndarray,      # (H, W) float32, locally pre-normalized
    src_imgs: jnp.ndarray,     # (S, H, W) float32, locally pre-normalized
    K_ref: jnp.ndarray,        # (3, 3) reference-view intrinsics (pinhole)
    K_src: jnp.ndarray,        # (S, 3, 3) per-source intrinsics — mixed-
                               # camera collections carry a different K per
                               # view (the reference exports one platform/K
                               # per camera, DenseBuilder.h:67-84)
    R_rel: jnp.ndarray,        # (S, 3, 3) ref-cam -> src-cam rotation
    t_rel: jnp.ndarray,        # (S, 3)
    inv_depths: jnp.ndarray,   # (D,) inverse depth planes (in ref frame)
    cfg: DenseConfig = DenseConfig(),
):
    """Returns (depth (H, W), cost (H, W)): per-pixel depth of the best
    plane (parabolic sub-plane refined) and its aggregated matching cost."""
    H, W = ref_img.shape
    Kinv = jnp.linalg.inv(K_ref)
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32), indexing="ij"
    )
    pix = jnp.stack([xs, ys, jnp.ones_like(xs)], axis=0).reshape(3, -1)  # (3, HW)
    rays = Kinv @ pix  # (3, HW)
    w = cfg.window
    # Flat take_along_axis sampling at 1 gather/sample (see
    # PatchMatchConfig.sampling / dense/patchmatch.make_sampler — the sweep
    # is gather-heavy and parabolic sub-plane refinement absorbs the
    # sub-pixel quantization).
    sample = make_sampler(src_imgs, cfg.sweep_sampling)

    def cost_at_plane(inv_d):
        # Homography transfer: x_src ~ K_s (R_rel + t_rel * inv_d * n^T)
        # Kref^-1 x with n = [0,0,1] in the reference frame.
        p = jnp.einsum("sij,jn->sin", R_rel, rays) + t_rel[..., None] * inv_d  # (S,3,HW)
        uv = jnp.einsum("sij,sjn->sin", K_src, p)
        z = uv[:, 2]
        u = uv[:, 0] / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        v = uv[:, 1] / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 0)
        warped = sample(v, u)  # (S, HW); coords clamp at edges, oob pixels
        warped = warped.reshape(-1, H, W)  # are masked out of the cost below
        inb = inb.reshape(-1, H, W)
        # NCC via box-filtered product of pre-normalized images: in [-1, 1].
        ncc = _box_mean(warped * ref_img[None], w)
        cost_s = jnp.where(inb, 1.0 - ncc, 2.0)  # (S, H, W), 2.0 = invalid
        # Best-k aggregation over sources (elementwise, see _best_k_mean).
        return pm_mod._best_k_mean(cost_s, min(cfg.best_k, cost_s.shape[0]))

    costs = jax.lax.map(cost_at_plane, inv_depths)  # (D, H, W)
    best = jnp.argmin(costs, axis=0)  # (H, W)
    best_cost = jnp.min(costs, axis=0)
    # Parabolic refinement over inverse depth.
    D = inv_depths.shape[0]
    bm = jnp.clip(best, 1, D - 2)
    c0 = jnp.take_along_axis(costs, (bm - 1)[None], axis=0)[0]
    c1 = jnp.take_along_axis(costs, bm[None], axis=0)[0]
    c2 = jnp.take_along_axis(costs, (bm + 1)[None], axis=0)[0]
    denom = c0 - 2 * c1 + c2
    delta = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (c0 - c2) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    step = inv_depths[1] - inv_depths[0]
    inv_d = inv_depths[bm] + delta * step
    depth = 1.0 / jnp.maximum(inv_d, 1e-9)
    return depth, best_cost


def select_source_views(scene, ref: int, n: int) -> list[int]:
    """Nearest registered views by camera-center distance with a nonzero
    baseline (the reference delegates neighbor selection to OpenMVS)."""
    reg = np.nonzero(np.asarray(scene.cam_mask))[0]
    centers = np.asarray(scene.camera_centers())
    d = np.linalg.norm(centers[reg] - centers[ref], axis=1)
    order = [int(reg[i]) for i in np.argsort(d) if reg[i] != ref and d[i] > 1e-6]
    return order[:n]


def depth_ranges_all(scene, margin: float):
    """Vectorized per-view depth search ranges from the sparse scene.
    Returns (lo (V,), hi (V,), valid (V,)) — one pass over the obs table
    instead of one scan per view (O(V * O) host time at pod scale)."""
    from ..core import lie as _lie

    obs_mask = np.asarray(scene.obs_mask)
    ocam = np.asarray(scene.obs_cam)[obs_mask]
    opt = np.asarray(scene.obs_pt)[obs_mask]
    V = scene.intr.shape[0]
    R = np.asarray(_lie.so3_exp(scene.cam_rot))
    t = np.asarray(scene.cam_t)
    pts = np.asarray(scene.points)[opt]
    z = np.einsum("oj,oj->o", R[ocam][:, 2, :], pts) + t[ocam][:, 2]
    keep = z > 1e-3
    ocam, z = ocam[keep], z[keep]
    lo = np.zeros(V)
    hi = np.zeros(V)
    valid = np.zeros(V, bool)
    order = np.argsort(ocam, kind="stable")
    ocam_s, z_s = ocam[order], z[order]
    uniq, starts, counts = np.unique(ocam_s, return_index=True,
                                     return_counts=True)
    for v, s, c in zip(uniq, starts, counts):  # O(V) small python, O(O) numpy
        if c < 5:
            continue
        zl, zh = np.percentile(z_s[s:s + c], [2, 98])
        span = zh - zl
        lo[v] = max(zl - margin * span, 0.05 * zl)
        hi[v] = zh + margin * span
        valid[v] = True
    return lo, hi, valid


def depth_range_from_sparse(scene, view: int, margin: float):
    """Depth search range for a view from its sparse observations."""
    mask = np.asarray(scene.obs_mask) & (np.asarray(scene.obs_cam) == view)
    pts = np.asarray(scene.points)[np.asarray(scene.obs_pt)[mask]]
    R = np.asarray(lie.so3_exp(scene.cam_rot[view]))
    t = np.asarray(scene.cam_t[view])
    z = pts @ R[2] + t[2]
    z = z[z > 1e-3]
    if len(z) < 5:
        return None
    lo, hi = np.percentile(z, [2, 98])
    span = hi - lo
    return max(lo - margin * span, 0.05 * lo), hi + margin * span


@partial(jax.jit, static_argnames=("cfg",))
def consistency_filter(
    depths: jnp.ndarray,   # (V, H, W) depth maps (0 where invalid)
    costs: jnp.ndarray,    # (V, H, W)
    K: jnp.ndarray,        # (V, 3, 3) per-view intrinsics, or (3, 3) shared
    R: jnp.ndarray,        # (V, 3, 3) world->cam
    t: jnp.ndarray,        # (V, 3)
    neighbors: jnp.ndarray,  # (V, S) neighbor view indices
    cfg: DenseConfig = DenseConfig(),
):
    """Geometric cross-view consistency: a pixel survives if >=
    min_consistent neighbor maps agree on its 3D location."""
    V, H, W = depths.shape
    if K.ndim == 2:
        K = jnp.broadcast_to(K, (V, 3, 3))
    Kinv = jnp.linalg.inv(K)
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32), indexing="ij"
    )
    pix = jnp.stack([xs, ys, jnp.ones_like(xs)], 0).reshape(3, -1)

    def per_view(v):
        rays = Kinv[v] @ pix  # (3, HW)
        d = depths[v].reshape(-1)
        Xc = rays * d[None]
        Xw = jnp.einsum("ji,jn->in", R[v], Xc - t[v][:, None])  # cam -> world

        def check(nv):
            Xn = jnp.einsum("ij,jn->in", R[nv], Xw) + t[nv][:, None]
            zn = Xn[2]
            uvn = K[nv] @ Xn
            un = uvn[0] / jnp.where(jnp.abs(uvn[2]) < 1e-6, 1e-6, uvn[2])
            vn = uvn[1] / jnp.where(jnp.abs(uvn[2]) < 1e-6, 1e-6, uvn[2])
            inb = (un >= 0) & (un <= W - 1) & (vn >= 0) & (vn <= H - 1) & (zn > 0)
            ui = jnp.clip(jnp.round(un).astype(jnp.int32), 0, W - 1)
            vi = jnp.clip(jnp.round(vn).astype(jnp.int32), 0, H - 1)
            idx = (nv * (H * W) + vi * W + ui).reshape(1, -1)
            dn = jnp.take_along_axis(depths.reshape(1, -1), idx, axis=1)[0]
            ok = inb & (dn > 0) & (jnp.abs(dn - zn) < cfg.rel_depth_tol * zn)
            return ok

        votes = jnp.sum(jax.vmap(check)(neighbors[v]).astype(jnp.int32), axis=0)
        valid = (
            (votes >= cfg.min_consistent)
            & (d > 0)
            & (costs[v].reshape(-1) < cfg.cost_thresh)
        )
        return valid.reshape(H, W)

    return jax.vmap(per_view)(jnp.arange(V))


def dense_reconstruct(scene, images, rgb_images, cfg: DenseConfig = DenseConfig(),
                      progress=None, views: list[int] | None = None,
                      return_maps: bool = False, key=None, mesh=None):
    """Full dense stage over all registered views -> (points (N, 3) float32,
    colors (N, 3) uint8)[, maps dict when return_maps].

    The sweep (and PatchMatch refinement) runs through the PACKED per-view
    path — a vmapped batch of `view_batch` reference views per device
    dispatch — instead of one dispatch per view; with a mesh, each batch is
    sharded across devices (view-cluster DP, SURVEY.md §2.3 item 5).
    Intrinsics are per-view throughout (mixed-camera parity,
    DenseBuilder.h:67-84)."""
    import os as _os
    import time as _time

    from ..parallel import dist_dense

    _trace = _os.environ.get("TPUSFM_DENSE_TIMING") == "1"
    _t0 = _time.time()

    def _mark(label):
        nonlocal _t0
        if _trace:
            now = _time.time()
            print(f"[dense-timing] {label}: {now - _t0:.2f}s", flush=True)
            _t0 = now

    progress = progress or (lambda *a, **k: None)
    key = jax.random.PRNGKey(0) if key is None else key
    images = np.asarray(images, np.float32)
    V, H, W = images.shape
    reg = np.nonzero(np.asarray(scene.cam_mask))[0]
    views = [v for v in (views if views is not None else reg) if scene.cam_mask[v]]
    intr = np.asarray(scene.intr)
    Ks = np.zeros((V, 3, 3), np.float32)
    Ks[:, 0, 0] = intr[:V, 0]
    Ks[:, 1, 1] = intr[:V, 1]
    Ks[:, 0, 2] = intr[:V, 2]
    Ks[:, 1, 2] = intr[:V, 3]
    Ks[:, 2, 2] = 1.0
    R_all = np.asarray(lie.so3_exp(scene.cam_rot))
    t_all = np.asarray(scene.cam_t)

    norm_images = np.asarray(
        jax.jit(jax.vmap(partial(local_normalize, w=cfg.window)))(jnp.asarray(images))
    )

    # Eligibility: enough sources and a usable sparse depth range (one
    # vectorized pass over the obs table for all views).
    lo_all, hi_all, rng_ok = depth_ranges_all(scene, cfg.depth_margin)
    computed = [
        v for v in views
        if rng_ok[v] and len(select_source_views(scene, v, cfg.n_sources)) >= 2
    ]
    # Depth/cost maps stay ON DEVICE through the batch loop and the
    # consistency filter; the host sees them once, as float16, after
    # filtering.
    depths_j = jnp.zeros((V, H, W), jnp.float32)
    costs_j = jnp.full((V, H, W), 2.0, jnp.float32)
    if computed:
        src_idx, R_rel, t_rel, inv_d, inv_lo, inv_hi = \
            dist_dense.pack_sweep_inputs(scene, computed, cfg, cfg.n_planes,
                                         ranges=(lo_all, hi_all, rng_ok))
        n_dev = mesh.shape["shard"] if mesh is not None else 1
        B = max(cfg.view_batch, 1) * n_dev
        norm_j = jnp.asarray(norm_images)
        imgs_j = jnp.asarray(images) if cfg.patchmatch else None
        Ks_j = jnp.asarray(Ks)
        pm_ms = (cfg.patchmatch and cfg.pm_multiscale
                 and H * W > cfg.pm_coarse_px)
        if pm_ms:
            H2, W2 = H // 2, W // 2
            imgs_half_j = jnp.asarray(
                images[:, :H2 * 2, :W2 * 2].reshape(V, H2, 2, W2, 2).mean((2, 4)))
            Ks_half = Ks.copy()
            # Pixel-center mapping u_half = (u_full - 0.5) / 2.
            Ks_half[:, 0, 0] /= 2
            Ks_half[:, 1, 1] /= 2
            Ks_half[:, 0, 2] = (Ks[:, 0, 2] - 0.5) / 2
            Ks_half[:, 1, 2] = (Ks[:, 1, 2] - 0.5) / 2
            Ks_half_j = jnp.asarray(Ks_half)

            def up2(x):
                x = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
                ph = H - x.shape[1]
                pw = W - x.shape[2]
                if ph > 0 or pw > 0:
                    widths = [(0, 0), (0, max(ph, 0)), (0, max(pw, 0))]
                    widths += [(0, 0)] * (x.ndim - 3)
                    x = jnp.pad(x, widths, mode="edge")
                return x[:, :H, :W]
        sweep_half = pm_ms and cfg.sweep_coarse
        if sweep_half:
            norm_half_j = jax.jit(jax.vmap(
                partial(local_normalize, w=cfg.window)))(imgs_half_j)
        _mark("setup+normalize+pack")
        for s in range(0, len(computed), B):
            sl = slice(s, s + B)
            n_sl = len(computed[sl])
            # Pad the batch to full size so one compiled shape serves all.
            def pad(a):
                out = a[sl]
                if len(out) < B:
                    out = np.concatenate(
                        [out, np.repeat(out[:1], B - len(out), axis=0)])
                return jnp.asarray(out)

            args = (pad(src_idx), pad(R_rel), pad(t_rel), pad(inv_d))
            sw_norm, sw_K = (norm_half_j, Ks_half_j) if sweep_half \
                else (norm_j, Ks_j)
            if mesh is not None:
                d, c = dist_dense.plane_sweep_sharded(
                    mesh, sw_norm, sw_K, *args, cfg=cfg)
            else:
                d, c = dist_dense.plane_sweep_all_views(
                    sw_norm, sw_K, *args, cfg=cfg)
            if _trace:
                d.block_until_ready()
                _mark(f"sweep batch {s}")
            if cfg.patchmatch:
                import dataclasses as _dc

                keys = jax.random.split(jax.random.fold_in(key, s), B)
                inv_init = 1.0 / jnp.maximum(d, 1e-9)
                lo_p, hi_p = pad(inv_lo), pad(inv_hi)
                n_up = None
                fine_cfg = cfg.pm
                if pm_ms:
                    # Coarse level: full candidate schedule at half res,
                    # batched (quarter the pixels — fits one dispatch).
                    keys_c = jax.random.split(
                        jax.random.fold_in(key, 100003 + s), B)
                    inv_c = inv_init if sweep_half else inv_init[:, ::2, ::2]
                    c_args = (args[0], args[1], args[2],
                              inv_c, lo_p, hi_p, keys_c)
                    if mesh is not None:
                        dch, _cch, nch = dist_dense.patchmatch_sharded(
                            mesh, imgs_half_j, Ks_half_j, *c_args,
                            pm_cfg=cfg.pm)
                    else:
                        dch, _cch, nch = dist_dense.patchmatch_all_views(
                            imgs_half_j, Ks_half_j, *c_args, pm_cfg=cfg.pm)
                    inv_init = jnp.clip(up2(1.0 / jnp.maximum(dch, 1e-9)),
                                        lo_p[:, None, None],
                                        hi_p[:, None, None])
                    n_up = up2(nch)
                    fine_cfg = _dc.replace(cfg.pm, n_iters=1, fine=True)
                # One view per device at high resolution (see pm_batch_px).
                pm_B = B if H * W <= cfg.pm_batch_px else max(n_dev, 1)
                d_parts, c_parts = [], []
                for q in range(0, B, pm_B):
                    qs = slice(q, q + pm_B)
                    pm_args = (args[0][qs], args[1][qs], args[2][qs],
                               inv_init[qs], lo_p[qs], hi_p[qs], keys[qs])
                    n0 = None if n_up is None else n_up[qs]
                    if mesh is not None:
                        dq, cq, _nq = dist_dense.patchmatch_sharded(
                            mesh, imgs_j, Ks_j, *pm_args, pm_cfg=fine_cfg,
                            n_init=n0)
                    else:
                        dq, cq, _nq = dist_dense.patchmatch_all_views(
                            imgs_j, Ks_j, *pm_args, pm_cfg=fine_cfg,
                            n_init=n0)
                    d_parts.append(dq)
                    c_parts.append(cq)
                d = jnp.concatenate(d_parts)
                c = jnp.concatenate(c_parts)
            if _trace:
                d.block_until_ready()
                _mark(f"patchmatch batch {s}")
            vids = jnp.asarray(np.asarray(computed[sl], np.int32))
            depths_j = depths_j.at[vids].set(d[:n_sl])
            costs_j = costs_j.at[vids].set(c[:n_sl])
            progress("dense", min(1.0, (s + B) / len(computed)) * 0.8)

    # Consistency neighbors must themselves have computed depth maps.
    centers = np.asarray(scene.camera_centers())
    n_nb = max(1, min(cfg.n_sources, len(computed) - 1))
    neighbors = np.zeros((V, n_nb), np.int32)
    for v in computed:
        others = [c_ for c_ in computed if c_ != v]
        order = np.argsort(np.linalg.norm(centers[others] - centers[v], axis=1))
        nb = [others[o] for o in order[:n_nb]]
        while len(nb) < n_nb:
            nb.append(nb[-1] if nb else v)
        neighbors[v] = nb

    _mark("neighbor selection")
    valid_j = consistency_filter(
        depths_j, costs_j, jnp.asarray(Ks),
        jnp.asarray(R_all.astype(np.float32)), jnp.asarray(t_all.astype(np.float32)),
        jnp.asarray(neighbors), cfg,
    )
    # Single host fetch: f16 depths (5e-4 relative — far below the PM
    # depth error), packed valid bits.
    valid = np.asarray(valid_j)
    depths = np.asarray(depths_j.astype(jnp.float16)).astype(np.float32)
    progress("dense", 0.9)
    _mark("consistency+fetch")

    # Fusion: backproject surviving pixels (per-view K).
    pts_out, col_out = [], []
    Kinv_all = np.linalg.inv(Ks)
    ss = cfg.subsample
    for v in computed:
        m = valid[v][::ss, ::ss]
        if not m.any():
            continue
        ys, xs = np.nonzero(m)
        ys = ys * ss
        xs = xs * ss
        d = depths[v][ys, xs]
        pix = np.stack([xs, ys, np.ones_like(xs)], 0).astype(np.float64)
        Xc = Kinv_all[v] @ pix * d[None]
        Xw = R_all[v].T @ (Xc - t_all[v][:, None])
        pts_out.append(Xw.T.astype(np.float32))
        if rgb_images is not None:
            col_out.append(np.asarray(rgb_images)[v, ys, xs])
    if not pts_out:
        pts = np.zeros((0, 3), np.float32)
        cols = np.zeros((0, 3), np.uint8)
    else:
        pts = np.concatenate(pts_out)
        cols = np.concatenate(col_out) if col_out else np.full((len(pts), 3), 200, np.uint8)
    _mark("fusion")
    if return_maps:
        costs = np.asarray(costs_j)
        maps = dict(depths=depths, costs=costs, valid=valid, K=Ks, R=R_all,
                    t=t_all,
                    computed=np.asarray(computed, np.int32))
        return pts, cols, maps
    return pts, cols
