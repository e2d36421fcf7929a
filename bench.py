#!/usr/bin/env python
"""Benchmark: end-to-end sparse SfM throughput on one GPU.

Headline metric (BASELINE.json): frames/s of end-to-end sparse SfM on a
synthetic 20-image sequence (config 2) — SIFT features, exhaustive
ratio-test matching, geometric filtering, incremental reconstruction with
Schur-complement BA, colorization.  Further sections: bundle adjustment at
500 cameras / 1.48M observations, dense MVS on the bench scene, and the
200-view (medium) and 1000-view (pod) sequences.

``vs_baseline`` is computed against a MEASURED CPU baseline: the reference
publishes no numbers and its exact C++ stack is not buildable here, so an
equivalent CPU pipeline (cv2.SIFT + BF ratio matching + F-RANSAC + PnP
incremental + numpy Schur-LM BA — stage-for-stage stand-ins for
vlfeat/OpenMVG/Ceres; see tpusfm/utils/cpu_baseline.py) was run on the SAME
rendered scene.  The measurement is kept in BASELINE_MEASURED.json;
methodology and caveats in BASELINE.md.

Everything runs in this one process, on JAX's default devices, which must
be GPUs: a JAX process reserves most of the card's memory when it starts,
so a second process could not use the card.  A section that fails ends the
run with a nonzero exit.  Every result line names the device and the
card's name and power limit.  Prints one JSON line on stdout (the last
line); diagnostics go to stderr.

Env knobs: BENCH_VIEWS, BENCH_H, BENCH_W, BENCH_FEATURES, BENCH_PRESET=small,
BENCH_SKIP_{BA,DENSE,MEDIUM,POD}=1.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent
_BASELINE_CACHE = _ROOT / "BASELINE_MEASURED.json"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def measured_baseline(images) -> dict:
    """The CPU-reference measurement on this scene shape, if recorded."""
    key = f"{images.shape[0]}x{images.shape[1]}x{images.shape[2]}"
    d = json.loads(_BASELINE_CACHE.read_text())
    if d.get("config") != key:
        return {"fps": None, "config": key, "note": "no measured baseline"}
    return d


def ba_problem(n_cams: int = 500, n_points: int = 50000,
               vis_prob: float = 0.06, seed: int = 3) -> dict:
    """The bench's BA problem as bundle_adjust keyword arguments: an orbit
    of n_cams cameras around n_points points (at 500 / 50k / 0.06 about
    3k observations per camera, 1.48M in all), 0.5 px pixel noise, and
    poses and points perturbed from the truth (reference config: Ceres
    SPARSE_SCHUR, BundleAdjuster.h:167-174)."""
    import jax.numpy as jnp

    sys.path.insert(0, str(_ROOT / "tests"))
    from synth import orbit_scene

    s = orbit_scene(n_cams=n_cams, n_points=n_points, noise_px=0.5,
                    seed=seed, arc_deg=350.0, vis_prob=vis_prob)
    r = np.random.default_rng(0)
    O = len(s["obs_cam"])
    return dict(
        intr=jnp.asarray(np.tile(s["intr"], (n_cams, 1))),
        cam_rot=jnp.asarray(s["aa"] + r.normal(scale=0.01, size=(n_cams, 3)),
                            jnp.float32),
        cam_t=jnp.asarray(s["t"] + r.normal(scale=0.01, size=(n_cams, 3)),
                          jnp.float32),
        cam_mask=jnp.ones(n_cams, bool),
        points=jnp.asarray(s["points"] + r.normal(scale=0.02,
                                                  size=(n_points, 3)),
                           jnp.float32),
        point_mask=jnp.asarray(s["point_valid"]),
        obs_cam=jnp.asarray(s["obs_cam"]), obs_pt=jnp.asarray(s["obs_pt"]),
        obs_uv=jnp.asarray(s["obs_uv"]), obs_mask=jnp.ones(O, bool),
    )


def ba_bench(small: bool) -> dict:
    """Seconds per LM iteration and CG iterations per LM step of the
    500-camera solve (100 cameras in the small preset)."""
    from tpusfm.ba import bundle_adjust as ba

    args = (ba_problem(100, 8000, 0.12) if small else ba_problem())
    cfg = ba.BAConfig(max_iters=20, cg_iters=30)
    t0 = time.perf_counter()
    out = ba.bundle_adjust(cfg=cfg, **args)
    np.asarray(out[3])
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = ba.bundle_adjust(cfg=cfg, **args)
    np.asarray(out[3])
    dt = time.perf_counter() - t0
    info = {k: float(v) for k, v in out[4].items()}
    n_it = max(info["iterations"], 1.0)
    return {"cams": int(args["intr"].shape[0]), "obs": int(info["n_obs"]),
            "lm_iters": int(n_it), "s_per_lm_iter": dt / n_it,
            "cg_per_lm_iter": info["cg_iterations"] / n_it,
            "initial_cost": info["initial_cost"],
            "final_cost": info["final_cost"], "first_call_s": compile_s}


def _depth_quality(depths, views, gt, scale) -> float | None:
    """Median relative depth error vs the renderer's ground-truth depth.

    depths: (V, H, W) array or {view: (H, W)} dict in SCENE units; scale
    converts scene units -> gt units (from camera-center alignment)."""
    errs = []
    for v in views:
        d = depths[v] if not isinstance(depths, dict) else depths.get(v)
        if d is None:
            continue
        d = np.asarray(d, np.float64)
        g = np.asarray(gt["depth"][v], np.float64)
        if d.shape != g.shape:
            continue
        m = np.isfinite(g) & (g > 1e-3) & np.isfinite(d) & (d > 1e-6)
        if m.sum() < 100:
            continue
        rel = np.abs(d[m] * scale - g[m]) / g[m]
        errs.append(float(np.median(rel)))
    return float(np.median(errs)) if errs else None


def gt_scale(scene, gt) -> float | None:
    """Scene-to-ground-truth scale from the registered camera centres."""
    reg = np.asarray(scene.cam_mask)
    sc = np.asarray(scene.camera_centers())[reg]
    gc_ = np.asarray(gt["centers"])[reg]
    scd = sc - sc.mean(0)
    gcd = gc_ - gc_.mean(0)
    denom = float(np.sum(scd * scd))
    return float(np.sqrt(np.sum(gcd * gcd) / denom)) if denom > 1e-12 else None


def dense_bench(scene, images, small: bool, gt) -> dict:
    """Dense stage (BASELINE config 4 scaled to the bench scene): PatchMatch-
    refined plane-sweep depth maps + consistency + fusion over up to six
    registered views, and the sweep-only configuration."""
    import dataclasses

    from tpusfm.dense import depth as dense_depth
    from tpusfm.dense.patchmatch import PatchMatchConfig

    views = [int(v) for v in np.nonzero(np.asarray(scene.cam_mask))[0]][:6]
    if len(views) < 3:
        raise RuntimeError(f"dense: only {len(views)} registered views")
    cfg = dense_depth.DenseConfig(n_planes=32 if small else 64,
                                  n_sources=3, view_batch=2,
                                  pm=PatchMatchConfig(n_iters=3))
    scale = gt_scale(scene, gt)
    out = {"views": len(views), "pm_iters": cfg.pm.n_iters}
    for name, c in (("patchmatch", cfg),
                    ("sweep_only", dataclasses.replace(cfg, patchmatch=False))):
        dense_depth.dense_reconstruct(scene, images, None, cfg=c, views=views)
        t0 = time.perf_counter()
        pts, _, maps = dense_depth.dense_reconstruct(
            scene, images, None, cfg=c, views=views, return_maps=True)
        dt = time.perf_counter() - t0
        out[name] = {"views_per_s": len(views) / dt, "points": int(len(pts)),
                     "depth_med_rel_err": None if scale is None else
                     _depth_quality(maps["depths"], views, gt, scale)}
    return out


def sequence_bench(n_views: int, window: int, loop_closure: bool,
                   seed: int) -> dict:
    """A contiguous-pair sequence through run_sparse (the medium and pod
    rungs, BASELINE.md configs 3 and 5): one warm run that compiles, one
    timed run, and a global-BA rate on the resulting scene.  The arc keeps
    0.6 deg between neighbouring views so the two-view bootstrap has
    parallax; loop closure adds retrieval pairs for multi-loop orbits."""
    import jax

    from tpusfm.ba import bundle_adjust as ba
    from tpusfm.pipeline.config import config_from_overrides
    from tpusfm.pipeline.sparse import run_sparse
    from tpusfm.utils import metrics
    from tpusfm.utils.synth_render import render_orbit_images

    images, gt = render_orbit_images(n_views=n_views, img_h=240, img_w=320,
                                     focal=0.9 * 320,
                                     arc_deg=max(120.0, 0.6 * n_views),
                                     seed=seed)
    cfg = config_from_overrides(**{
        "sift.n_octaves": 3, "sift.max_per_octave": 512,
        "sift.max_features": 512,
        "matching.pair_mode": "contiguous",
        "matching.contiguous_window": window,
        "matching.loop_closure": loop_closure, "matching.loop_top_k": 5,
        "matching.pair_chunk": 32, "filter.max_iterations": 128,
        "feature_batch": 10, "engine_type": "incremental"})
    t0 = time.perf_counter()
    run_sparse(images, gt["intr"], cfg, key=jax.random.PRNGKey(0))
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene, report = run_sparse(images, gt["intr"], cfg,
                               key=jax.random.PRNGKey(1))
    dt = time.perf_counter() - t0
    reg = np.asarray(scene.cam_mask)
    ate = (metrics.ate_rmse(np.asarray(scene.camera_centers())[reg],
                            gt["centers"][reg]) if reg.sum() >= 3 else None)
    bcfg = ba.BAConfig(max_iters=10, cg_iters=30, converge_rtol=0.0)
    args = (scene.intr, scene.cam_rot, scene.cam_t, scene.cam_mask,
            scene.points, scene.point_mask, scene.obs_cam, scene.obs_pt,
            scene.obs_uv, scene.obs_mask)
    np.asarray(ba.bundle_adjust(*args, cfg=bcfg)[3][:1])
    t0 = time.perf_counter()
    out = ba.bundle_adjust(*args, cfg=bcfg)
    np.asarray(out[3][:1])
    ba_s = time.perf_counter() - t0
    return {"n_views": n_views, "fps": n_views / dt, "seconds": dt,
            "warm_s": warm, "registered": int(reg.sum()),
            "ate": None if ate is None else float(ate),
            "stage_times_s": report["times_s"],
            "ba_lm_iters_per_s": max(float(out[4]["iterations"]), 1.0) / ba_s,
            "n_obs": int(np.asarray(scene.obs_mask).sum())}


def main():
    from tpusfm.utils import compile_cache, device

    small = os.environ.get("BENCH_PRESET") == "small"
    n_views = int(os.environ.get("BENCH_VIEWS", 8 if small else 20))
    img_h = int(os.environ.get("BENCH_H", 240 if small else 480))
    img_w = int(os.environ.get("BENCH_W", 320 if small else 640))
    n_feat = int(os.environ.get("BENCH_FEATURES", 768 if small else 1024))

    dev = device.describe()
    if dev["platform"] != "gpu":  # a measurement never falls back to the CPU
        sys.exit(f"bench.py needs a GPU; JAX's default devices are {dev}")
    dev["card"] = device.card_name_and_power_limit()
    log(f"device: {json.dumps(dev)}")
    log(f"compile cache: {compile_cache.enable()}")

    import jax

    from tpusfm.pipeline.config import config_from_overrides
    from tpusfm.pipeline.sparse import run_sparse
    from tpusfm.utils import metrics
    from tpusfm.utils.synth_render import render_orbit_images

    images, gt = render_orbit_images(
        n_views=n_views, img_h=img_h, img_w=img_w,
        focal=0.9 * img_w, arc_deg=110.0, seed=0,
    )
    cfg = config_from_overrides(**{
        "sift.n_octaves": 3 if small else 4,
        "sift.max_per_octave": n_feat,
        "sift.max_features": n_feat,
        "matching.pair_chunk": 16 if small else 32,
        "filter.max_iterations": 128 if small else 256,
        "feature_batch": 10,
    })

    # Warm-up compiles every program at the bench shapes; then three timed
    # runs with fresh keys, of which the fastest is reported.
    t0 = time.perf_counter()
    run_sparse(images, gt["intr"], cfg, key=jax.random.PRNGKey(0))
    warm = time.perf_counter() - t0
    dts = []
    for rep in (1, 2, 3):
        t0 = time.perf_counter()
        scene, report = run_sparse(images, gt["intr"], cfg,
                                   key=jax.random.PRNGKey(rep))
        dts.append(time.perf_counter() - t0)
    dt = min(dts)
    fps = n_views / dt
    reg = np.asarray(scene.cam_mask)
    ate = metrics.ate_rmse(np.asarray(scene.camera_centers())[reg],
                           gt["centers"][reg])
    sparse = {"views": n_views, "img": f"{img_h}x{img_w}",
              "features": n_feat, "fps": fps, "seconds": dts,
              "warm_s": warm, "registered": int(reg.sum()),
              "points": int(report["n_points"]), "ate": float(ate),
              "stage_times_s": report["times_s"]}
    log("sparse: " + json.dumps(sparse))
    baseline = measured_baseline(images)
    base_fps = baseline.get("fps")

    sections = {}
    if os.environ.get("BENCH_SKIP_DENSE") != "1":
        sections["dense"] = dense_bench(scene, images, small, gt)
    del scene
    gc.collect()
    if os.environ.get("BENCH_SKIP_BA") != "1":
        sections["ba"] = ba_bench(small)
    if os.environ.get("BENCH_SKIP_MEDIUM") != "1":
        sections["medium"] = sequence_bench(60 if small else 200, 6, False, 2)
    if os.environ.get("BENCH_SKIP_POD") != "1":
        sections["pod"] = sequence_bench(120 if small else 1000, 8, True, 5)
    for name, sec in sections.items():
        log(f"{name}: " + json.dumps(sec))
        gc.collect()

    def pick(d, *keys):
        return {k: d[k] for k in keys if k in d}

    print(json.dumps({
        "metric": "sparse_sfm_frames_per_s", "value": fps,
        "unit": "frames/s",
        "vs_baseline": None if not base_fps else fps / base_fps,
        "device": dev,
        "detail": {
            "registered": sparse["registered"], "ate": sparse["ate"],
            "stage_times_s": sparse["stage_times_s"],
            "dense": None if "dense" not in sections else {
                k: pick(v, "views_per_s", "depth_med_rel_err")
                for k, v in sections["dense"].items() if isinstance(v, dict)},
            "ba": pick(sections.get("ba", {}), "s_per_lm_iter",
                       "cg_per_lm_iter", "final_cost"),
            **{k: pick(sections[k], "fps", "registered", "ate")
               for k in ("medium", "pod") if k in sections},
        },
    }), flush=True)


if __name__ == "__main__":
    main()
