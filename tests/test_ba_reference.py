"""The XLA bundle adjuster against plain float64 numpy references: the cost
it reports, the numpy Schur-LM solver for the pinhole case, and the sharded
solver on four virtual devices."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpusfm.ba import bundle_adjust as ba
from tpusfm.parallel import dist_ba, mesh as mesh_mod
from tpusfm.utils.cpu_baseline import _project_np, _schur_lm_ba, _so3_exp_np, ba_cost_np
from synth import orbit_scene

# Distortion lanes past [fx, fy, cx, cy] and the model name bundle_adjust
# takes; "auto" picks RADIAL3 for 7 lanes and Brown-T2 for 9.
MODELS = {
    "radial3": (np.array([-0.08, 0.01, 0.0]), "auto"),
    "brown": (np.array([-0.08, 0.01, 0.0, 1e-3, -5e-4]), "auto"),
    "fisheye": (np.array([0.02, -0.01, 0.0, 0.0]), "fisheye"),
}


def make_problem(model: str, n_cams=10, n_points=240, noise_px=0.3, seed=4,
                 perturb=0.02, pinhole=False, exact=(0,)):
    """Orbit geometry with observations projected by `model` in float64
    (with all distortion coefficients zero if `pinhole`); the cameras in
    `exact` start at their true poses, the others perturbed."""
    s = orbit_scene(n_cams=n_cams, n_points=n_points, seed=seed, vis_prob=0.9)
    dist, bmodel = MODELS[model]
    dist = 0.0 * dist if pinhole else dist
    intr = np.tile(np.concatenate([s["intr"][:4], dist]), (n_cams, 1))
    R = _so3_exp_np(s["aa"].astype(np.float64))
    ocam, opt = s["obs_cam"], s["obs_pt"]
    Xc = np.einsum("oij,oj->oi", R[ocam], s["points"][opt]) + s["t"][ocam]
    r = np.random.default_rng(seed)
    uv = _project_np(intr[ocam], Xc, model) + r.normal(scale=noise_px,
                                                       size=(len(ocam), 2))
    aa = s["aa"] + r.normal(scale=perturb, size=(n_cams, 3))
    t = s["t"] + r.normal(scale=perturb, size=(n_cams, 3))
    aa[list(exact)], t[list(exact)] = s["aa"][list(exact)], s["t"][list(exact)]
    pts = s["points"] + r.normal(scale=2 * perturb, size=(n_points, 3))
    args = dict(
        intr=jnp.asarray(intr, jnp.float32),
        cam_rot=jnp.asarray(aa, jnp.float32), cam_t=jnp.asarray(t, jnp.float32),
        cam_mask=jnp.ones(n_cams, bool),
        points=jnp.asarray(pts, jnp.float32),
        point_mask=jnp.asarray(s["point_valid"]),
        obs_cam=jnp.asarray(ocam), obs_pt=jnp.asarray(opt),
        obs_uv=jnp.asarray(uv, jnp.float32),
        obs_mask=jnp.ones(len(ocam), bool),
    )
    return args, bmodel


@pytest.mark.parametrize("solver", ["dense_schur", "pcg"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_reported_cost_matches_float64_numpy(model, solver):
    """Masked observations and points and frozen cameras, per camera model
    and per reduced-system solver: the initial and final costs the device
    reports equal a float64 evaluation at the same parameters, the cost
    falls, and frozen or masked blocks do not move."""
    args, bmodel = make_problem(model, exact=(0, 3, 7))
    r = np.random.default_rng(1)
    O, P = args["obs_cam"].shape[0], args["points"].shape[0]
    args["obs_mask"] = jnp.asarray(r.random(O) > 0.1)
    pmask = np.asarray(args["point_mask"]) & (r.random(P) > 0.05)
    args["point_mask"] = jnp.asarray(pmask)
    free = np.ones(args["cam_rot"].shape[0], bool)
    free[[3, 7]] = False
    cfg = ba.BAConfig(max_iters=15, camera_model=bmodel,
                      dense_schur_max_dim=384 if solver == "dense_schur" else 0)
    intr, rot, t, pts, info = ba.bundle_adjust(
        cfg=cfg, cam_free_mask=jnp.asarray(free), **args)
    ref_model = "radial3" if model == "radial3" else model
    obs = (args["obs_cam"], args["obs_pt"], args["obs_uv"], args["obs_mask"])
    c0 = ba_cost_np(args["intr"], args["cam_rot"], args["cam_t"],
                    args["points"], *obs, huber=cfg.huber_delta, model=ref_model)
    c1 = ba_cost_np(intr, rot, t, pts, *obs, huber=cfg.huber_delta,
                    model=ref_model)
    assert abs(float(info["initial_cost"]) - c0) <= 1e-4 * c0
    assert abs(float(info["final_cost"]) - c1) <= 1e-4 * c1
    assert c1 < 0.1 * c0  # masked points keep their perturbed positions
    if solver == "pcg":
        assert int(info["cg_iterations"]) > 0
    for a, b in ((rot, args["cam_rot"]), (t, args["cam_t"])):
        np.testing.assert_array_equal(np.asarray(a)[~free], np.asarray(b)[~free])
        np.testing.assert_array_equal(np.asarray(a)[0], np.asarray(b)[0])
    np.testing.assert_array_equal(np.asarray(pts)[~pmask],
                                  np.asarray(args["points"])[~pmask])


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
def test_pinhole_matches_numpy_schur_lm(noise_px):
    """Pinhole problems: the device solver and the numpy Schur-LM stand-in
    for Ceres SPARSE_SCHUR (utils/cpu_baseline._schur_lm_ba) reach the same
    cost and poses."""
    args, _ = make_problem("radial3", noise_px=noise_px, pinhole=True)
    intr = np.asarray(args["intr"], np.float64)
    s_obs = [np.asarray(args[k]) for k in ("obs_cam", "obs_pt", "obs_uv")]
    cfg = ba.BAConfig(max_iters=25)
    _, rot, t, _, info = ba.bundle_adjust(cfg=cfg, **args)
    K = np.array([[intr[0, 0], 0, intr[0, 2]], [0, intr[0, 1], intr[0, 3]],
                  [0, 0, 1]])
    cams0 = np.concatenate([np.asarray(args["cam_rot"], np.float64),
                            np.asarray(args["cam_t"], np.float64)], 1)
    cams, _, c0, c1, _ = _schur_lm_ba(cams0, np.asarray(args["points"],
                                                        np.float64),
                                      *s_obs, K, huber=cfg.huber_delta)
    assert abs(float(info["initial_cost"]) - c0) <= 1e-4 * c0
    assert abs(float(info["final_cost"]) - c1) <= 1e-3 * max(c1, 1.0)
    np.testing.assert_allclose(np.asarray(rot), cams[:, :3], atol=2e-3)
    np.testing.assert_allclose(np.asarray(t), cams[:, 3:], atol=2e-3)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_sharded_matches_single_device_on_four_devices(model):
    args, bmodel = make_problem(model, n_cams=8, n_points=200)
    cfg = ba.BAConfig(max_iters=8, camera_model=bmodel)
    _, rot1, t1, _, info1 = ba.bundle_adjust(cfg=cfg, **args)
    obs = [np.asarray(args.pop(k)) for k in
           ("obs_cam", "obs_pt", "obs_uv", "obs_mask")]
    ocam, opt, ouv, omask = dist_ba.shard_obs_table(*obs, 4)
    m = mesh_mod.make_mesh(4)
    _, rot4, t4, _, info4 = dist_ba.bundle_adjust_sharded(
        m, obs_cam=ocam, obs_pt=opt, obs_uv=ouv, obs_mask=omask, cfg=cfg,
        **args)
    f1, f4 = float(info1["final_cost"]), float(info4["final_cost"])
    assert f4 < 0.05 * float(info4["initial_cost"])
    assert abs(f4 - f1) <= 0.05 * f1
    np.testing.assert_allclose(np.asarray(rot4), np.asarray(rot1), atol=5e-3)
    np.testing.assert_allclose(np.asarray(t4), np.asarray(t1), atol=5e-3)
