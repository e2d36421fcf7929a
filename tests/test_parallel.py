"""Distributed layer tests on the virtual 8-device CPU mesh
(SURVEY.md §4: multi-host logic without a real pod)."""

import numpy as np
import jax
import jax.numpy as jnp

from tpusfm.ba import bundle_adjust as ba
from tpusfm.parallel import dist_ba, dist_matching, mesh as mesh_mod
from synth import orbit_scene

rng = np.random.default_rng(11)


def test_mesh_creation():
    m = mesh_mod.make_mesh()
    assert m.shape["shard"] == len(jax.devices())
    m2 = mesh_mod.make_mesh(4)
    assert m2.shape["shard"] == 4


def test_sharded_matching_matches_local():
    P_, N, D = 16, 64, 128
    da = rng.normal(size=(P_, N, D)).astype(np.float32) * 20
    db = rng.normal(size=(P_, N, D)).astype(np.float32) * 20
    # Plant exact matches for half the rows.
    db[:, : N // 2] = da[:, : N // 2] + rng.normal(size=(P_, N // 2, D)).astype(np.float32) * 0.1
    ma = np.ones((P_, N), bool)
    from tpusfm.matching import match as local_match

    m = mesh_mod.make_mesh(8)
    idx_s, ok_s = dist_matching.match_pairs_sharded(
        m, jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(ma)
    )
    idx_l, ok_l = local_match.match_descriptors(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(ma)
    )
    np.testing.assert_array_equal(np.asarray(ok_s), np.asarray(ok_l))
    np.testing.assert_array_equal(
        np.asarray(idx_s)[np.asarray(ok_s)], np.asarray(idx_l)[np.asarray(ok_l)]
    )
    assert np.asarray(ok_s)[:, : N // 2].mean() > 0.9


def _ba_problem(n_cams=10, n_points=200, seed=2):
    s = orbit_scene(n_cams=n_cams, n_points=n_points, noise_px=0.3, seed=seed)
    r = np.random.default_rng(seed)
    C, P_ = n_cams, n_points
    aa = s["aa"] + r.normal(scale=0.02, size=(C, 3))
    t = s["t"] + r.normal(scale=0.02, size=(C, 3))
    pts = s["points"] + r.normal(scale=0.03, size=(P_, 3))
    aa[0] = s["aa"][0]
    t[0] = s["t"][0]
    return s, dict(
        intr=jnp.asarray(np.tile(s["intr"], (C, 1))),
        cam_rot=jnp.asarray(aa.astype(np.float32)),
        cam_t=jnp.asarray(t.astype(np.float32)),
        cam_mask=jnp.ones(C, bool),
        points=jnp.asarray(pts.astype(np.float32)),
        point_mask=jnp.asarray(s["point_valid"]),
    )


def test_distributed_ba_matches_single_device():
    s, args = _ba_problem()
    O = len(s["obs_cam"])
    cfg = ba.BAConfig(max_iters=6)

    # Single-device reference.
    intr1, rot1, t1, pts1, info1 = ba.bundle_adjust(
        obs_cam=jnp.asarray(s["obs_cam"]), obs_pt=jnp.asarray(s["obs_pt"]),
        obs_uv=jnp.asarray(s["obs_uv"]), obs_mask=jnp.ones(O, bool), cfg=cfg, **args
    )

    m = mesh_mod.make_mesh(8)
    ocam, opt, ouv, omask = dist_ba.shard_obs_table(
        s["obs_cam"], s["obs_pt"], s["obs_uv"], np.ones(O, bool), 8
    )
    intr2, rot2, t2, pts2, info2 = dist_ba.bundle_adjust_sharded(
        m, obs_cam=ocam, obs_pt=opt, obs_uv=ouv, obs_mask=omask, cfg=cfg, **args
    )
    # Same optimization trajectory up to float reduction-order noise.
    assert float(info2["final_cost"]) < float(info2["initial_cost"]) * 0.01
    np.testing.assert_allclose(np.asarray(rot2), np.asarray(rot1), atol=5e-3)
    np.testing.assert_allclose(np.asarray(t2), np.asarray(t1), atol=5e-3)
    rel = abs(float(info2["final_cost"]) - float(info1["final_cost"])) / max(
        float(info1["final_cost"]), 1e-9
    )
    assert rel < 0.05


def test_sharded_matching_runs_the_fused_kernel(monkeypatch):
    """On GPUs dist_matching runs the Pallas matcher inside shard_map; here
    the same path with the kernel in interpret mode on 4 CPU devices."""
    from functools import partial

    from tpusfm.matching import match as local_match
    from tpusfm.ops import pallas_match

    monkeypatch.setattr(local_match, "matcher_for", lambda platform: partial(
        pallas_match.match_descriptors_fused, interpret=True))
    P_, N = 8, 96
    da = rng.integers(0, 256, (P_, N, 128)).astype(np.float32)
    db = np.clip(da[:, ::-1] + rng.integers(-3, 4, (P_, N, 128)), 0, 255)
    ma = np.ones((P_, N), bool)
    idx_s, ok_s = dist_matching.match_pairs_sharded(
        mesh_mod.make_mesh(4), jnp.asarray(da), jnp.asarray(db.astype(np.float32)),
        jnp.asarray(ma), jnp.asarray(ma), quantized=True)
    assert len(idx_s.sharding.device_set) == 4
    idx_l, ok_l = local_match.match_descriptors(
        jnp.asarray(da), jnp.asarray(db.astype(np.float32)), jnp.asarray(ma),
        jnp.asarray(ma))
    np.testing.assert_array_equal(np.asarray(ok_s), np.asarray(ok_l))
    np.testing.assert_array_equal(np.asarray(idx_s), np.asarray(idx_l))
    assert np.asarray(ok_l).mean() > 0.9
