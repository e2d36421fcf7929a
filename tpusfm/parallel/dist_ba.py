"""Distributed bundle adjustment over a device mesh.

SURVEY.md §2.3 item 4: the observation table is partitioned across devices;
each device assembles partial normal-equation blocks for its observation
shard, psum reduces the camera system and the point blocks across devices, and
the (small, replicated) preconditioned-CG camera solve proceeds identically
on every device.  Point elimination stays embarrassingly parallel.

This reuses tpusfm.ba.bundle_adjust verbatim — the solver was written
against segment-sum + psum hooks (BAConfig.axis_name), so the distributed
variant is a shard_map around the very same LM loop.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ba import bundle_adjust as ba


def bundle_adjust_sharded(
    mesh: Mesh,
    intr, cam_rot, cam_t, cam_mask,
    points, point_mask,
    obs_cam, obs_pt, obs_uv, obs_mask,
    cfg: ba.BAConfig = ba.BAConfig(),
    cam_free_mask=None,
    cam_group=None,
    n_groups: int | None = None,
    prior_pos=None,
    prior_weight=None,
    axis: str = "shard",
):
    """Same contract as ba.bundle_adjust; the observation arrays are sharded
    over `axis` (their length must divide the mesh axis size — pad with
    parallel.mesh.pad_to_multiple, padded rows masked out).  cam_group /
    n_groups pass through to the shared-intrinsics machinery (replicated)."""
    cfg = dataclasses.replace(cfg, axis_name=axis)
    n_dev = mesh.shape[axis]
    assert obs_cam.shape[0] % n_dev == 0, (
        f"obs table length {obs_cam.shape[0]} must be divisible by mesh axis {n_dev}"
    )

    free = cam_mask if cam_free_mask is None else cam_free_mask
    if cam_group is None:
        cam_group = jnp.arange(intr.shape[0], dtype=jnp.int32)
        n_groups = intr.shape[0]
    has_prior = prior_pos is not None
    if has_prior and prior_weight is None:
        prior_weight = jnp.ones(intr.shape[0], jnp.float32)
    if not has_prior:
        # Dummies keep the shard_map signature static; weight 0 disables.
        prior_pos = jnp.zeros((intr.shape[0], 3), jnp.float32)
        prior_weight = jnp.zeros(intr.shape[0], jnp.float32)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(), P(),       # cameras replicated
            P(), P(),                 # points replicated
            P(axis), P(axis), P(axis), P(axis),  # observations sharded
            P(), P(), P(), P(),       # free/group + GPS priors (replicated)
        ),
        out_specs=(P(), P(), P(), P(), P()),
    )
    def _run(intr, rot, t, cmask, pts, pmask, ocam, opt, ouv, omask, freem,
             cgrp, ppos, pw):
        intr2, rot2, t2, pts2, info = ba.bundle_adjust(
            intr, rot, t, cmask, pts, pmask, ocam, opt, ouv, omask,
            cfg=cfg, cam_free_mask=freem, cam_group=cgrp, n_groups=n_groups,
            prior_pos=ppos, prior_weight=pw,
        )
        return intr2, rot2, t2, pts2, info

    return jax.jit(_run)(
        intr, cam_rot, cam_t, cam_mask, points, point_mask,
        obs_cam, obs_pt, obs_uv, obs_mask, free, cam_group,
        prior_pos, prior_weight,
    )


def shard_obs_table(obs_cam, obs_pt, obs_uv, obs_mask, n_dev: int):
    """Pad the observation table so its length divides n_dev; padded rows are
    masked out (they reference camera 0 / point 0 with zero weight)."""
    O = len(obs_cam)
    m = ((O + n_dev - 1) // n_dev) * n_dev
    pad = m - O
    if pad:
        obs_cam = np.concatenate([np.asarray(obs_cam), np.zeros(pad, np.int32)])
        obs_pt = np.concatenate([np.asarray(obs_pt), np.zeros(pad, np.int32)])
        obs_uv = np.concatenate([np.asarray(obs_uv), np.zeros((pad, 2), np.float32)])
        obs_mask = np.concatenate([np.asarray(obs_mask), np.zeros(pad, bool)])
    return (
        jnp.asarray(obs_cam), jnp.asarray(obs_pt),
        jnp.asarray(obs_uv), jnp.asarray(obs_mask),
    )
