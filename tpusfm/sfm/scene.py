"""Fixed-capacity SoA scene containers.

The reference keeps its map as pointer-chasing hash maps of shared_ptrs
(src/world/WorldStructure.h:31-35, WorldPoint.h:20-24).  Here that becomes a
struct-of-arrays with static capacities and validity masks (SURVEY.md §7 hard
part 2): cameras, 3D points, and observations live in flat arrays; "growth" is
masked insertion; track identity is an integer table instead of pointers.

The observation table is the BA working set: one row per (camera, point, uv)
— the array analog of WorldPoint::obs (src/world/WorldPoint.h:23).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from ..core import camera as cam
from ..core import lie
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class Scene:
    """SoA scene. All arrays are fixed-capacity with explicit masks.

    Pose convention: world -> camera, ``x_cam = R @ x_world + t``; rotation is
    stored as axis-angle (the BA parameterisation, like the reference's 6-param
    extrinsic blocks, src/adjuster/BundleAdjuster.h:87-91).
    """

    # Cameras
    intr: jnp.ndarray        # (C, 7) fx fy cx cy k1 k2 k3
    cam_rot: jnp.ndarray     # (C, 3) axis-angle world->cam
    cam_t: jnp.ndarray       # (C, 3)
    cam_mask: jnp.ndarray    # (C,) bool — registered cameras

    # Points
    points: jnp.ndarray      # (P, 3)
    colors: jnp.ndarray      # (P, 3) uint8
    point_mask: jnp.ndarray  # (P,) bool

    # Observations (the track structure, flattened)
    obs_cam: jnp.ndarray     # (O,) int32 camera index
    obs_pt: jnp.ndarray      # (O,) int32 point index
    obs_uv: jnp.ndarray      # (O, 2) float32 pixel measurement
    obs_mask: jnp.ndarray    # (O,) bool

    @property
    def max_cams(self) -> int:
        return self.intr.shape[0]

    @property
    def max_points(self) -> int:
        return self.points.shape[0]

    @property
    def max_obs(self) -> int:
        return self.obs_cam.shape[0]

    @property
    def n_cams(self) -> jnp.ndarray:
        return jnp.sum(self.cam_mask.astype(jnp.int32))

    @property
    def n_points(self) -> jnp.ndarray:
        return jnp.sum(self.point_mask.astype(jnp.int32))

    @property
    def n_obs(self) -> jnp.ndarray:
        return jnp.sum(self.obs_mask.astype(jnp.int32))

    def rotations(self) -> jnp.ndarray:
        return lie.so3_exp(self.cam_rot)

    def camera_centers(self) -> jnp.ndarray:
        return lie.camera_center(self.rotations(), self.cam_t)

    def project_obs(self) -> jnp.ndarray:
        """Project every observation's point into its camera. (O, 2)."""
        R = self.rotations()[self.obs_cam]
        t = self.cam_t[self.obs_cam]
        intr = self.intr[self.obs_cam]
        X = self.points[self.obs_pt]
        return cam.project(intr, R, t, X)

    def reprojection_errors(self) -> jnp.ndarray:
        """Masked per-observation reprojection error norms. (O,)"""
        d = self.project_obs() - self.obs_uv
        return jnp.where(self.obs_mask, jnp.linalg.norm(d, axis=-1), 0.0)


def empty_scene(max_cams: int, max_points: int, max_obs: int) -> Scene:
    return Scene(
        intr=jnp.zeros((max_cams, cam.NUM_INTR), jnp.float32),
        cam_rot=jnp.zeros((max_cams, 3), jnp.float32),
        cam_t=jnp.zeros((max_cams, 3), jnp.float32),
        cam_mask=jnp.zeros((max_cams,), bool),
        points=jnp.zeros((max_points, 3), jnp.float32),
        colors=jnp.zeros((max_points, 3), jnp.uint8),
        point_mask=jnp.zeros((max_points,), bool),
        obs_cam=jnp.zeros((max_obs,), jnp.int32),
        obs_pt=jnp.zeros((max_obs,), jnp.int32),
        obs_uv=jnp.zeros((max_obs, 2), jnp.float32),
        obs_mask=jnp.zeros((max_obs,), bool),
    )


def scene_to_numpy(scene: Scene) -> dict[str, np.ndarray]:
    return {f: np.asarray(getattr(scene, f)) for f in scene.__dataclass_fields__}


def save_scene_npz(path: str, scene: Scene, extra: dict[str, Any] | None = None) -> None:
    arrays = {f: np.asarray(getattr(scene, f)) for f in scene.__dataclass_fields__}
    if extra:
        arrays.update({k: np.asarray(v) for k, v in extra.items()})
    np.savez_compressed(path, **arrays)


def load_scene_npz(path: str) -> Scene:
    data = np.load(path)
    kwargs = {f: jnp.asarray(data[f]) for f in Scene.__dataclass_fields__}
    return Scene(**kwargs)


def compact_points(scene: Scene) -> Scene:
    """Push valid points to the front (periodic compaction of the masked
    free-list — replaces the reference's hash-map erase)."""
    order = jnp.argsort(~scene.point_mask, stable=True)
    remap = jnp.zeros((scene.max_points,), jnp.int32).at[order].set(
        jnp.arange(scene.max_points, dtype=jnp.int32)
    )
    return scene.replace(
        points=scene.points[order],
        colors=scene.colors[order],
        point_mask=scene.point_mask[order],
        obs_pt=remap[scene.obs_pt],
    )
