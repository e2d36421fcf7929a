#!/usr/bin/env python
"""Smoke test of the whole system on one NVIDIA GPU, in one process.

    python chip_smoke.py               # every phase, on one GPU
    python chip_smoke.py --cards 4     # only the sharded paths users reach
                                       # with --devices 4, and what they are
                                       # compared with, on four GPUs
    python chip_smoke.py --rehearse    # the same phases at tiny size on the
                                       # CPU, kernels in interpret mode

Phases (one card):
  device    the default JAX device must be a GPU; prints the card's name
            and power limit (nvidia-smi, read by a child process)
  pipeline  renders the bench scene (20 views, 480x640, seed 0), writes it
            as PPM and runs `tpusfm reconstruct --dense --mesh` in-process:
            20/20 views registered, ATE against the renderer's
            poses (Sizes.ate_max), median relative dense depth error
            <= DEPTH_ERR_MAX
            against the renderer's depth, non-empty dense.ply and mesh.ply
  service   the HTTP service in a thread of this process: POST /upload,
            GET /preprocessing and /sparse, /event followed to completion,
            the colorized PLY fetched back
  ba        bundle adjustment at 500 cameras / 1.48M observations: final
            cost against a float64 numpy evaluation at the returned
            parameters (BA_COST_RTOL), and against a second solve under
            jax.default_matmul_precision("highest") (BA_PRECISION_RTOL)
  matcher   the fused Pallas matcher against matching.match under
            "highest" precision at 1,024 and 8,192 features, D = 128:
            u8-grid descriptors give bit-identical d1/d2 and the same
            argmin except at exact ties; float descriptors agree within
            MATCH_FLOAT_RTOL

Each phase prints its set-up (first call, compilation included) and
steady-state seconds.  A failed phase raises, and the script exits nonzero.
The last line of a card run is the JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}};
a rehearsal never prints it.  Workspaces go under --out.
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import io
import json
import shutil
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEPTH_ERR_MAX = 0.02      # median |d - d_gt| / d_gt over the dense views
BA_COST_RTOL = 1e-3       # float32 device sum vs float64 numpy, 1.48M terms
BA_PRECISION_RTOL = 1e-2  # default vs "highest" matmul precision
MATCH_FLOAT_RTOL = 1e-5   # of |a|^2 + |b|^2: f32 products, other sum order


@dataclasses.dataclass(frozen=True)
class Sizes:
    views: int
    height: int
    width: int
    features: int
    ba: tuple[int, int, float]          # cameras, points, visibility
    matcher: tuple[tuple[int, int], ...]  # (features, pairs)
    ate_max: float                      # scene units; the orbit radius is 8


FULL = Sizes(20, 480, 640, 1024, (500, 50000, 0.06), ((1024, 190), (8192, 8)),
             ate_max=0.08)
# Six small views pin the poses less well: a looser ATE bound.
REHEARSAL = Sizes(6, 240, 320, 512, (20, 2000, 0.5), ((256, 4), (320, 2)),
                  ate_max=0.15)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def render_scene(sz: Sizes):
    from tpusfm.utils.synth_render import render_orbit_images

    return render_orbit_images(n_views=sz.views, img_h=sz.height,
                               img_w=sz.width, focal=0.9 * sz.width,
                               arc_deg=110.0, seed=0)


def write_ppm_dir(images, d: Path) -> list[Path]:
    from tpusfm.io.images import write_pnm

    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    paths = []
    for i, img in enumerate(images):
        g = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
        paths.append(d / f"view_{i:03d}.ppm")
        write_pnm(paths[-1], np.repeat(g[..., None], 3, -1))
    return paths


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def _ply_counts(path: Path) -> dict:
    counts = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.decode(errors="replace").strip()
            if line.startswith("element"):
                _, name, n = line.split()
                counts[name] = int(n)
            if line == "end_header":
                break
    return counts


def phase_pipeline(sz: Sizes, out: Path, rehearse: bool) -> dict:
    """The CLI's reconstruct command on the bench scene, dense and mesh on."""
    import bench
    from tpusfm import cli
    from tpusfm.pipeline.staged import StagedPipeline
    from tpusfm.utils import metrics

    images, gt = render_scene(sz)
    img_dir = out / "images"
    write_ppm_dir(images, img_dir)
    ws = out / "cli_ws"
    argv = ["reconstruct", str(img_dir), "--workspace", str(ws), "--dense",
            "--mesh", "--max-features", str(sz.features),
            "--focal", str(0.9 * sz.width), "--force"]
    _, setup = _timed(lambda: cli.main(argv))
    steady = None
    if not rehearse:
        _, steady = _timed(lambda: cli.main(argv))
    scene = StagedPipeline(ws).load_scene()
    reg = np.asarray(scene.cam_mask)
    _check(reg.sum() == sz.views, f"registered {reg.sum()}/{sz.views}")
    ate = metrics.ate_rmse(np.asarray(scene.camera_centers())[reg],
                           gt["centers"][reg])
    _check(ate <= sz.ate_max, f"ATE {ate} > {sz.ate_max}")
    maps = np.load(ws / "depth_maps.npz")
    dense_views = [v for v in range(sz.views) if maps["valid"][v].any()]
    scale = bench.gt_scale(scene, gt)
    err = bench._depth_quality(
        np.where(maps["valid"], maps["depths"], np.nan), dense_views, gt,
        scale)
    _check(err is not None and err <= DEPTH_ERR_MAX,
           f"dense median depth error {err} > {DEPTH_ERR_MAX}")
    dense = _ply_counts(ws / "dense.ply")
    mesh = _ply_counts(ws / "mesh.ply")
    _check(dense.get("vertex", 0) > 0, f"empty dense.ply {dense}")
    _check(mesh.get("vertex", 0) > 0 and mesh.get("face", 0) > 0,
           f"empty mesh.ply {mesh}")
    return {"setup_s": setup, "steady_s": steady, "registered": int(reg.sum()),
            "ate": ate, "depth_med_rel_err": err,
            "dense_points": dense["vertex"], "mesh_faces": mesh["face"]}


def _get(port: int, path: str, timeout: float = 30.0):
    try:
        with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_files(port: int, files) -> tuple[int, bytes]:
    boundary = "chipsmokeboundary"
    body = io.BytesIO()
    for name, data in files:
        body.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                   f'name="file"; filename="{name}"\r\n'
                   "Content-Type: application/octet-stream\r\n\r\n".encode())
        body.write(data + b"\r\n")
    body.write(f"--{boundary}--\r\n".encode())
    req = urllib.request.Request(
        f"http://localhost:{port}/upload", data=body.getvalue(),
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _follow_events(port: int, until, deadline_s: float) -> dict:
    """Read /event until an event satisfies `until`; an error event raises."""
    conn = http.client.HTTPConnection("localhost", port, timeout=60)
    try:
        conn.request("GET", "/event")
        resp = conn.getresponse()
        _check(resp.status == 200, f"/event status {resp.status}")
        t_end = time.time() + deadline_s
        while time.time() < t_end:
            line = resp.readline()
            if not line:
                raise AssertionError("/event stream closed")
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[len(b"data: "):])
            if ev.get("type") == "error":
                raise AssertionError(f"service error event: {ev}")
            if until(ev):
                return ev
        raise AssertionError("timed out following /event")
    finally:
        conn.close()


def _wait_idle(port: int, deadline_s: float = 60.0) -> dict:
    t_end = time.time() + deadline_s
    while time.time() < t_end:
        code, body = _get(port, "/status")
        st = json.loads(body)
        if code == 200 and st["busy"] is None:
            _check(st["error"] is None, f"service error: {st['error']}")
            return st
        time.sleep(0.2)
    raise AssertionError("service stayed busy")


def phase_service(sz: Sizes, out: Path) -> dict:
    from tpusfm.pipeline.config import config_from_overrides
    from tpusfm.service.http_server import start_background

    images, _ = render_scene(sz)
    paths = write_ppm_dir(images, out / "service_images")
    ws = out / "service_ws"
    if ws.exists():
        shutil.rmtree(ws)
    cfg = config_from_overrides(**{
        "sift.max_per_octave": sz.features, "sift.max_features": sz.features,
        "focal_prior_px": 0.9 * sz.width})
    httpd, _state, port = start_background(str(ws), cfg)
    try:
        t0 = time.perf_counter()
        code, body = _post_files(port, [(p.name, p.read_bytes()) for p in paths])
        _check(code == 200 and len(json.loads(body)["saved"]) == sz.views,
               f"/upload -> {code} {body[:200]!r}")
        code, body = _get(port, "/preprocessing")
        _check(code == 200, f"/preprocessing -> {code} {body!r}")
        _follow_events(port, lambda e: e["type"] == "preprocessing"
                       and e["progress"] >= 1.0, 1200)
        _wait_idle(port)
        code, body = _get(port, "/sparse")
        _check(code == 200, f"/sparse -> {code} {body!r}")
        result = json.loads(body)["result"]
        done = _follow_events(port, lambda e: e["type"] == "done", 1200)
        _wait_idle(port)
        code, ply = _get(port, result)
        _check(code == 200 and ply.startswith(b"ply"),
               f"GET {result} -> {code}")
        dt = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
    return {"steady_s": dt, "n_points": done.get("n_points"),
            "ply_bytes": len(ply)}


def phase_ba(sz: Sizes) -> dict:
    import jax

    import bench
    from tpusfm.ba import bundle_adjust as ba
    from tpusfm.utils.cpu_baseline import ba_cost_np

    args = bench.ba_problem(*sz.ba)
    cfg = ba.BAConfig(max_iters=20, cg_iters=30)

    def solve():
        out = ba.bundle_adjust(cfg=cfg, **args)
        jax.block_until_ready(out)
        return out

    _, setup = _timed(solve)
    out, steady = _timed(solve)
    intr, rot, t, pts, info = out
    info = {k: float(v) for k, v in info.items()}
    _check(info["final_cost"] < 0.5 * info["initial_cost"],
           f"BA did not converge: {info}")
    ref = ba_cost_np(intr, rot, t, pts, args["obs_cam"], args["obs_pt"],
                     args["obs_uv"], args["obs_mask"], cfg.huber_delta)
    rel = abs(info["final_cost"] - ref) / ref
    _check(rel <= BA_COST_RTOL,
           f"BA cost {info['final_cost']} vs float64 {ref} (rel {rel})")
    with jax.default_matmul_precision("highest"):
        out_h = solve()
    final_h = float(out_h[4]["final_cost"])
    rel_h = abs(info["final_cost"] - final_h) / final_h
    _check(rel_h <= BA_PRECISION_RTOL,
           f"BA cost default {info['final_cost']} vs highest {final_h}")
    stats = jax.devices()[0].memory_stats() or {}
    n_it = max(info["iterations"], 1.0)
    return {"setup_s": setup, "steady_s": steady,
            "cams": int(intr.shape[0]), "obs": int(info["n_obs"]),
            "lm_iters": int(n_it), "s_per_lm_iter": steady / n_it,
            "cg_per_lm_iter": info["cg_iterations"] / n_it,
            "initial_cost": info["initial_cost"],
            "final_cost": info["final_cost"], "float64_cost": ref,
            "highest_precision_final_cost": final_h,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def _planted_descriptors(rng, n_pairs: int, n: int, u8: bool):
    """Pairs of descriptor sets where ~60% of B rows are noisy copies of A
    rows, with ~10% of rows masked on each side."""
    if u8:
        da = rng.integers(0, 256, (n_pairs, n, 128)).astype(np.float32)
        noise = rng.integers(-6, 7, (n_pairs, n, 128))
        db = np.clip(da[:, rng.permutation(n)] + noise, 0, 255)
        fresh = rng.integers(0, 256, (n_pairs, n, 128))
    else:
        da = rng.normal(size=(n_pairs, n, 128)).astype(np.float32) * 20
        db = da[:, rng.permutation(n)] + rng.normal(size=da.shape) * 2.0
        fresh = rng.normal(size=da.shape) * 20
    keep = rng.random((n_pairs, n, 1)) < 0.6
    db = np.where(keep, db, fresh).astype(np.float32)
    ma = rng.random((n_pairs, n)) > 0.1
    mb = rng.random((n_pairs, n)) > 0.1
    return da, db, ma, mb


def phase_matcher(sz: Sizes, rehearse: bool) -> dict:
    import jax
    import jax.numpy as jnp

    from tpusfm.matching import match
    from tpusfm.ops import pallas_match

    rng = np.random.default_rng(0)
    out = {}

    @jax.jit
    def reference(da, db, ma, mb):
        d = match.distance_matrix(da, db)
        d = jnp.where(mb[..., None, :], d, match.INF)
        d1, d2, i1 = match._top2_min(d)
        n_ties = jnp.sum(d == d1[..., None], axis=-1)
        return d1, d2, i1.astype(jnp.int32), n_ties

    for n, n_pairs in sz.matcher:
        for u8 in (True, False):
            arrs = [jnp.asarray(a) for a in
                    _planted_descriptors(rng, n_pairs, n, u8)]
            with jax.default_matmul_precision("highest"):
                d1r, d2r, i1r, ties = [np.asarray(x) for x in reference(*arrs)]
            d1, d2, i1, _ = [np.asarray(x) for x in pallas_match.match_top2(
                *arrs, quantized=u8, interpret=rehearse)]
            fin = d1r < 1e38
            if u8:
                _check(np.array_equal(d1[fin], d1r[fin])
                       and np.array_equal(d2[d2r < 1e38], d2r[d2r < 1e38]),
                       f"u8 d1/d2 differ from the reference at N={n}")
                bad = (i1 != i1r) & fin & (ties == 1)
                _check(not bad.any(),
                       f"u8 argmin differs off ties at {bad.sum()} rows, N={n}")
            else:  # float32 cancellation error scales with |a|^2 + |b|^2
                a2 = np.sum(np.asarray(arrs[0], np.float64) ** 2, axis=-1)
                err = np.abs(d1 - d1r)[fin] / (2.0 * a2 + 2.0 * d1r)[fin]
                _check(err.max() <= MATCH_FLOAT_RTOL,
                       f"float d1 rel err {err.max()} at N={n}")
            key = f"{n}x{n_pairs}_{'u8' if u8 else 'f32'}"
            out[key] = {"i1_agree": float((i1 == i1r)[fin].mean())}
            if u8:
                out[key].update(_time_matchers(arrs, rehearse))
    return out


def _time_matchers(arrs, rehearse: bool) -> dict:
    """Set-up and steady seconds of the fused kernel and of the XLA matcher
    on the same batch (cross-check on, as the pipeline runs them)."""
    import jax

    from tpusfm.matching import match
    from tpusfm.ops import pallas_match

    runs = {
        "fused": lambda: pallas_match.match_descriptors_fused(
            *arrs, quantized=True, interpret=rehearse),
        "xla": lambda: match.match_descriptors(*arrs),
    }
    res = {}
    for name, fn in runs.items():
        _, setup = _timed(lambda: jax.block_until_ready(fn()))
        steady = min(_timed(lambda: jax.block_until_ready(fn()))[1]
                     for _ in range(3))
        res[f"{name}_setup_s"] = setup
        res[f"{name}_steady_s"] = steady
    return res


def phase_cards(sz: Sizes, n_cards: int, rehearse: bool) -> dict:
    """The sharded paths (`--devices N`) against their single-device paths."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from tpusfm.ba import bundle_adjust as ba
    from tpusfm.dense import depth as depth_mod
    from tpusfm.matching import match as match_mod
    from tpusfm.parallel import dist_ba, dist_dense, dist_matching
    from tpusfm.parallel import mesh as mesh_mod, ring_match
    from tpusfm.pipeline.config import config_from_overrides
    from tpusfm.pipeline.sparse import detect_features, run_sparse
    from tpusfm.utils import metrics

    _check(len(jax.devices()) >= n_cards,
           f"{n_cards} devices needed, {len(jax.devices())} present")
    mesh = mesh_mod.make_mesh(n_cards)
    res = {}

    # run_sparse with devices=N against devices=1 on the bench scene.
    images, gt = render_scene(sz)
    cfg = config_from_overrides(**{
        "sift.max_per_octave": sz.features, "sift.max_features": sz.features,
        "feature_batch": 10})
    scenes = {}
    for n in (1, n_cards):
        c = dataclasses.replace(cfg, devices=n)
        (scene, rep), dt = _timed(lambda: run_sparse(
            images, gt["intr"], c, key=jax.random.PRNGKey(0)))
        reg = np.asarray(scene.cam_mask)
        ate = metrics.ate_rmse(np.asarray(scene.camera_centers())[reg],
                               gt["centers"][reg])
        _check(reg.sum() == sz.views and ate <= sz.ate_max,
               f"devices={n}: registered {reg.sum()}, ATE {ate}")
        scenes[n] = scene
        res[f"sparse_{n}dev"] = {"first_run_s": dt, "ate": ate,
                                 "times_s": rep["times_s"]}
        log(f"sparse devices={n}: {json.dumps(res[f'sparse_{n}dev'])}")

    # Sharded matching lands on every device and equals the local matcher.
    feats = detect_features(images, cfg)
    ia, ib = np.triu_indices(sz.views, 1)
    n_p = (len(ia) // n_cards) * n_cards
    da, db = feats.desc[ia[:n_p]], feats.desc[ib[:n_p]]
    ma, mb = feats.mask[ia[:n_p]], feats.mask[ib[:n_p]]
    idx_s, ok_s = dist_matching.match_pairs_sharded(mesh, da, db, ma, mb,
                                                    quantized=True)
    _check(len(idx_s.sharding.device_set) == n_cards,
           f"matching ran on {idx_s.sharding.device_set}")
    idx_l, ok_l = match_mod.match_batch(da, db, ma, mb, quantized=True)
    ok_s, ok_l = np.asarray(ok_s), np.asarray(ok_l)
    _check(np.array_equal(ok_s, ok_l)
           and np.array_equal(np.asarray(idx_s)[ok_l], np.asarray(idx_l)[ok_l]),
           "sharded matching differs from the local matcher")
    log("sharded matching equals the local matcher")

    # Ring all-pairs matching against the local matcher.
    V = (sz.views // n_cards) * n_cards
    ridx, rok = ring_match.ring_match_all_pairs(mesh, feats.desc[:V],
                                                feats.mask[:V])
    _check(len(ridx.sharding.device_set) == n_cards, "ring ran off-mesh")
    ridx, rok = np.asarray(ridx), np.asarray(rok)
    for a, b in ((0, 1), (1, V - 1), (V - 1, 2)):
        i_ref, ok_ref = match_mod.match_descriptors(
            feats.desc[a], feats.desc[b], feats.mask[a], feats.mask[b],
            cross_check=False)
        ok_ref = np.asarray(ok_ref)
        _check(np.array_equal(rok[a, b], ok_ref)
               and np.array_equal(ridx[a, b][ok_ref], np.asarray(i_ref)[ok_ref]),
               f"ring match differs from the local matcher at ({a}, {b})")
    log("ring matching equals the local matcher")

    # Sharded plane sweep against the local sweep.
    scene = scenes[1]
    views = [int(v) for v in np.nonzero(np.asarray(scene.cam_mask))[0]]
    views = views[: (len(views) // n_cards) * n_cards]
    dcfg = depth_mod.DenseConfig()
    norm = jax.jit(jax.vmap(lambda x: depth_mod.local_normalize(
        x, w=dcfg.window)))(jnp.asarray(images))
    intr = np.asarray(scene.intr)
    Ks = np.zeros((sz.views, 3, 3), np.float32)
    Ks[:, 0, 0], Ks[:, 1, 1] = intr[:, 0], intr[:, 1]
    Ks[:, 0, 2], Ks[:, 1, 2], Ks[:, 2, 2] = intr[:, 2], intr[:, 3], 1.0
    packed = dist_dense.pack_sweep_inputs(scene, views, dcfg, dcfg.n_planes)
    sw = [jnp.asarray(a) for a in packed[:4]]
    d_l, c_l = dist_dense.plane_sweep_all_views(norm, jnp.asarray(Ks), *sw,
                                                dcfg)
    d_s, c_s = dist_dense.plane_sweep_sharded(mesh, norm, jnp.asarray(Ks),
                                              *sw, dcfg)
    _check(len(d_s.sharding.device_set) == n_cards, "sweep ran off-mesh")
    d_l, d_s = np.asarray(d_l), np.asarray(d_s)
    agree = float((np.abs(d_s - d_l) / np.maximum(d_l, 1e-6) < 2e-3).mean())
    _check(agree > 0.995, f"sharded sweep agrees at {agree} of pixels")
    res["sweep_agree"] = agree
    log(f"sharded sweep agrees on {agree} of pixels")

    # Sharded BA against single-device BA on the BA problem.
    args = bench.ba_problem(*sz.ba)
    bcfg = ba.BAConfig(max_iters=20, cg_iters=30)
    single, t1 = _timed(lambda: jax.block_until_ready(
        ba.bundle_adjust(cfg=bcfg, **args)))
    obs = dist_ba.shard_obs_table(args.pop("obs_cam"), args.pop("obs_pt"),
                                  args.pop("obs_uv"), args.pop("obs_mask"),
                                  n_cards)
    obs = [jax.device_put(o, NamedSharding(mesh, P("shard"))) for o in obs]
    _check(all(len(o.sharding.device_set) == n_cards for o in obs),
           "observation shards are not on every device")
    sharded, tn = _timed(lambda: jax.block_until_ready(
        dist_ba.bundle_adjust_sharded(mesh, obs_cam=obs[0], obs_pt=obs[1],
                                      obs_uv=obs[2], obs_mask=obs[3],
                                      cfg=bcfg, **args)))
    f1 = float(single[4]["final_cost"])
    fn = float(sharded[4]["final_cost"])
    _check(abs(fn - f1) / f1 <= BA_PRECISION_RTOL,
           f"sharded BA cost {fn} vs single-device {f1}")
    res["ba"] = {"single_s": t1, "sharded_s": tn, "cost_1dev": f1,
                 f"cost_{n_cards}dev": fn}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU, kernels in interpret mode")
    ap.add_argument("--cards", type=int, default=1,
                    help="1: every phase; N > 1: only the sharded paths")
    ap.add_argument("--phases", default="pipeline,service,ba,matcher",
                    help="comma-separated subset of the one-card phases")
    ap.add_argument("--out", default=str(ROOT / ".chip_smoke"),
                    help="directory for the workspaces")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from tpusfm.utils import compile_cache, device

    dev = device.describe()
    if not args.rehearse and dev["platform"] != "gpu":
        log(f"chip_smoke: no GPU (JAX's default devices are {dev}); "
            "use --rehearse for the CPU rehearsal")
        return 2
    compile_cache.enable()
    card = device.card_name_and_power_limit()
    print(f"card: {card or 'no nvidia-smi'}", flush=True)
    sz = REHEARSAL if args.rehearse else FULL
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    results = {}
    if args.cards > 1:
        results["cards"] = phase_cards(sz, args.cards, args.rehearse)
        dev["count"] = args.cards
    else:
        phases = {
            "pipeline": lambda: phase_pipeline(sz, out, args.rehearse),
            "service": lambda: phase_service(sz, out),
            "ba": lambda: phase_ba(sz),
            "matcher": lambda: phase_matcher(sz, args.rehearse),
        }
        for name in args.phases.split(","):
            t0 = time.perf_counter()
            results[name] = phases[name]()
            log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")
    for name, r in results.items():
        print(f"{name} [{dev['kind']}, {card}]: {json.dumps(r)}", flush=True)
    if args.rehearse:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
