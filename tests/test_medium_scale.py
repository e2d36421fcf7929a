"""Medium-scale ladder test (BASELINE.md config 3): 200-view scene with
global Schur-complement BA on one device.

Heavy for the 2-core CPU CI mesh, so it runs only with TPUSFM_SLOW=1
(bench.py runs this scale on the GPU)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from tpusfm.ba import bundle_adjust as ba
from tpusfm.core import lie
from tpusfm.utils import metrics
from synth import orbit_scene

pytestmark = pytest.mark.skipif(
    os.environ.get("TPUSFM_SLOW") != "1", reason="set TPUSFM_SLOW=1 for medium-scale tests"
)


def test_200_view_global_ba():
    C, P = 200, 20000
    s = orbit_scene(n_cams=C, n_points=P, noise_px=0.5, seed=3, arc_deg=350.0,
                    vis_prob=0.25)
    O = len(s["obs_cam"])
    assert O > 100_000
    r = np.random.default_rng(0)
    args = dict(
        intr=jnp.asarray(np.tile(s["intr"], (C, 1))),
        cam_rot=jnp.asarray(s["aa"] + r.normal(scale=0.01, size=(C, 3)), dtype=jnp.float32),
        cam_t=jnp.asarray(s["t"] + r.normal(scale=0.01, size=(C, 3)), dtype=jnp.float32),
        cam_mask=jnp.ones(C, bool),
        points=jnp.asarray(s["points"] + r.normal(scale=0.02, size=(P, 3)), dtype=jnp.float32),
        point_mask=jnp.asarray(s["point_valid"]),
        obs_cam=jnp.asarray(s["obs_cam"]), obs_pt=jnp.asarray(s["obs_pt"]),
        obs_uv=jnp.asarray(s["obs_uv"]), obs_mask=jnp.ones(O, bool),
    )
    cfg = ba.BAConfig(max_iters=10, cg_iters=30, obs_chunk=32768)
    intr, rot, t, pts, info = ba.bundle_adjust(cfg=cfg, **args)
    rmse = float(np.sqrt(2 * float(info["final_cost"]) / O))
    assert rmse < 0.8, f"rmse {rmse}px at the 0.5px noise floor"
    centers = np.asarray(lie.camera_center(lie.so3_exp(rot), t))
    ate = metrics.ate_rmse(centers, s["centers"])
    assert ate < 0.01, f"ATE {ate}"
