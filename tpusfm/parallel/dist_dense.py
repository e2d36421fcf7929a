"""View-cluster sharded dense depth estimation.

SURVEY.md §2.3 item 5: each device computes plane-sweep (and PatchMatch-
refined) depth maps for its cluster of reference views (DP over views); the
consistency filter and fusion read all maps afterwards.  The per-view sweep
inputs (source poses, depth ranges) are packed into per-view arrays so the
whole stage is one shard_map over the ``views`` axis — images are
replicated (each device needs arbitrary source views), depth-map outputs
are sharded.

Packed input format (pack_sweep_inputs): src_idx is (V, S+1) int32 with the
S source view ids followed by the reference view id in the last slot.
Intrinsics are per-view (V, 3, 3) — mixed-camera collections carry a
different K per view (the reference exports one platform/K per camera,
src/denseBuilder/DenseBuilder.h:67-84).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..dense import depth as depth_mod


def _sweep_packed(imgs, Ks, sidx, R_rel, t_rel, inv_depths, cfg):
    """Sweep over a (local) batch of packed per-view inputs.

    lax.map, NOT vmap: the sweep is gather-heavy and a vmap batch dim on
    the gather operand gave XLA a slower gather lowering.  Each view is a
    large program already, so sequential execution inside one dispatch
    loses little."""

    def sweep(x):
        s, Rr, tr, d = x
        ref = imgs[s[-1]]
        srcs = imgs[s[:-1]]
        return depth_mod.plane_sweep_depth(
            ref, srcs, Ks[s[-1]], Ks[s[:-1]], Rr, tr, d, cfg)

    return jax.lax.map(sweep, (sidx, R_rel, t_rel, inv_depths))


def plane_sweep_all_views(norm_images, Ks, src_idx, R_rel, t_rel, inv_depths,
                          cfg: depth_mod.DenseConfig = depth_mod.DenseConfig()):
    """Single-device packed path: (depths (V, H, W), costs (V, H, W))."""
    return _sweep_packed(norm_images, Ks, src_idx, R_rel, t_rel, inv_depths, cfg)


def plane_sweep_sharded(
    mesh: Mesh,
    norm_images, Ks, src_idx, R_rel, t_rel, inv_depths,
    cfg: depth_mod.DenseConfig = depth_mod.DenseConfig(),
    axis: str = "shard",
):
    """Same contract as plane_sweep_all_views with the view axis sharded
    over the mesh (V must divide the axis size; pad with repeated views)."""
    n_dev = mesh.shape[axis]
    assert src_idx.shape[0] % n_dev == 0, (
        f"view count {src_idx.shape[0]} must divide mesh axis {n_dev} "
        "(pad with repeated views)"
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    )
    def _run(imgs, K_, sidx, Rr, tr, invd):
        return _sweep_packed(imgs, K_, sidx, Rr, tr, invd, cfg)

    return jax.jit(_run)(norm_images, Ks, src_idx, R_rel, t_rel, inv_depths)


def _pm_packed(imgs_raw, Ks, sidx, R_rel, t_rel, inv_init, inv_lo, inv_hi,
               keys, pm_cfg, n_init=None):
    # lax.map, NOT vmap — same gather-lowering rationale as _sweep_packed.
    from ..dense import patchmatch as pm_mod

    if n_init is None:
        def one(x):
            s, Rr, tr, d0, lo, hi, k = x
            ref = imgs_raw[s[-1]]
            srcs = imgs_raw[s[:-1]]
            return pm_mod.patchmatch_refine(
                ref, srcs, Ks[s[-1]], Ks[s[:-1]], Rr, tr, d0, lo, hi, k,
                pm_cfg)

        return jax.lax.map(one, (sidx, R_rel, t_rel, inv_init, inv_lo,
                                 inv_hi, keys))

    def one_n(x):
        s, Rr, tr, d0, lo, hi, k, n0 = x
        ref = imgs_raw[s[-1]]
        srcs = imgs_raw[s[:-1]]
        return pm_mod.patchmatch_refine(
            ref, srcs, Ks[s[-1]], Ks[s[:-1]], Rr, tr, d0, lo, hi, k, pm_cfg,
            n0)

    return jax.lax.map(one_n, (sidx, R_rel, t_rel, inv_init, inv_lo, inv_hi,
                               keys, n_init))


def patchmatch_all_views(images_raw, Ks, src_idx, R_rel, t_rel, inv_init,
                         inv_lo, inv_hi, keys, pm_cfg, n_init=None):
    """Packed PatchMatch refinement over a batch of reference views.
    inv_init (V, H, W) is the plane-sweep inverse-depth init; inv_lo/inv_hi
    (V,) the per-view search range.  Returns (depth, cost, normals)."""
    return _pm_packed(images_raw, Ks, src_idx, R_rel, t_rel, inv_init,
                      inv_lo, inv_hi, keys, pm_cfg, n_init)


def patchmatch_sharded(mesh: Mesh, images_raw, Ks, src_idx, R_rel, t_rel,
                       inv_init, inv_lo, inv_hi, keys, pm_cfg,
                       n_init=None, axis: str = "shard"):
    """Packed PatchMatch with the view axis sharded over the mesh.
    Returns (depth, cost, normals)."""
    n_dev = mesh.shape[axis]
    assert src_idx.shape[0] % n_dev == 0
    with_n = n_init is not None

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(axis), P(axis)) + ((P(axis),) if with_n else ()),
        out_specs=(P(axis), P(axis), P(axis)),
    )
    def _run(imgs, K_, sidx, Rr, tr, d0, lo, hi, ks, *maybe_n):
        return _pm_packed(imgs, K_, sidx, Rr, tr, d0, lo, hi, ks, pm_cfg,
                          maybe_n[0] if maybe_n else None)

    args = (images_raw, Ks, src_idx, R_rel, t_rel, inv_init, inv_lo, inv_hi,
            keys) + ((n_init,) if with_n else ())
    return jax.jit(_run)(*args)


def pack_sweep_inputs(scene, views, cfg: depth_mod.DenseConfig, n_planes: int,
                      ranges=None):
    """Host-side packing of per-view sweep inputs for the packed/sharded
    paths.  Returns (src_idx (V, S+1) with the ref id in the last slot,
    R_rel, t_rel, inv_depths (V, D), inv_lo (V,), inv_hi (V,)) as numpy
    arrays over the given views.  ranges: optional precomputed
    (lo (V,), hi (V,), valid (V,)) from depth_ranges_all — avoids one
    obs-table scan per view."""
    import numpy as np

    from ..core import lie

    R_all = np.asarray(lie.so3_exp(scene.cam_rot))
    t_all = np.asarray(scene.cam_t)
    S = cfg.n_sources
    out_idx = np.zeros((len(views), S + 1), np.int32)
    out_R = np.zeros((len(views), S, 3, 3), np.float32)
    out_t = np.zeros((len(views), S, 3), np.float32)
    out_d = np.zeros((len(views), n_planes), np.float32)
    out_lo = np.zeros(len(views), np.float32)
    out_hi = np.zeros(len(views), np.float32)
    for k, v in enumerate(views):
        srcs = depth_mod.select_source_views(scene, v, S)
        while len(srcs) < S:
            srcs.append(srcs[-1] if srcs else v)
        if ranges is not None:
            lo_a, hi_a, ok_a = ranges
            lo, hi = (lo_a[v], hi_a[v]) if ok_a[v] else (1.0, 10.0)
        else:
            rng = depth_mod.depth_range_from_sparse(scene, v, cfg.depth_margin)
            lo, hi = rng if rng else (1.0, 10.0)
        out_idx[k, :S] = srcs
        out_idx[k, S] = v
        R_rel = np.einsum("sij,kj->sik", R_all[srcs], R_all[v])
        out_R[k] = R_rel
        out_t[k] = t_all[srcs] - np.einsum("sij,j->si", R_rel, t_all[v])
        out_d[k] = np.linspace(1.0 / hi, 1.0 / lo, n_planes)
        out_lo[k] = 1.0 / hi
        out_hi[k] = 1.0 / lo
    return out_idx, out_R, out_t, out_d, out_lo, out_hi
