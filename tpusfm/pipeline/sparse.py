"""The staged sparse-reconstruction pipeline.

Stage-for-stage parity with the reference's sparseBuilder
(src/sparseBuilder/sparseBuilder.cpp; call stacks in SURVEY.md §3):

  detect_features   ~ detectFeature (.cpp:575)  — batched SIFT on device
  generate_pairs    ~ matchPair     (.cpp:758)  — exhaustive / contiguous
  match_pairs       ~ match         (.cpp:809)  — ratio-test matching, device
  filter_pairs      ~ filter        (.cpp:1025) — robust F/E/H RANSAC, device
  reconstruct       ~ reconstruction(.cpp:1283) — incremental engine + BA
  colorize          ~ colorize      (.cpp:1601) — mean track color

Where the reference stages communicate through files per stage, these are
functions over arrays; pipeline.artifacts adds the same file-staging
contract (resume) on top."""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import epipolar, homography
from ..features import sift
from ..matching import match as match_mod
from ..matching import pairs as pairs_mod
from ..sfm import incremental, ransac as ransac_mod, tracks as tracks_mod
from .config import PipelineConfig


def _noop_progress(type, progress, **kw):
    del type, progress, kw


def get_mesh(cfg: PipelineConfig):
    """Device mesh for the pipeline's data-parallel mode (cfg.devices > 1),
    or None for the single-device path."""
    if not cfg.devices or cfg.devices <= 1:
        return None
    from ..parallel import mesh as mesh_mod

    return mesh_mod.make_mesh(cfg.devices)


def detect_features(images, cfg: PipelineConfig, progress=_noop_progress,
                    masks=None) -> sift.Features:
    """Batched SIFT over all views, chunked to bound device memory.
    masks (V, H, W), optional: nonzero = detect here (parity: the
    reference's optional per-image feature masks, sparseBuilder.cpp:701-740)."""
    images = np.asarray(images)
    V = images.shape[0]
    out = []
    bs = cfg.feature_batch
    for i in range(0, V, bs):
        chunk = jnp.asarray(images[i : i + bs])
        mchunk = None if masks is None else jnp.asarray(np.asarray(masks)[i : i + bs])
        # Stay on device: matching consumes the descriptors there.
        out.append(sift.detect_and_describe(chunk, cfg.sift, mchunk))
        progress("features", min(1.0, (i + bs) / V))
    if len(out) == 1:
        return out[0]
    return sift.Features(
        kp=jnp.concatenate([o.kp for o in out]),
        desc=jnp.concatenate([o.desc for o in out]),
        score=jnp.concatenate([o.score for o in out]),
        mask=jnp.concatenate([o.mask for o in out]),
    )


def generate_pairs(n_views: int, cfg: PipelineConfig,
                   feats: sift.Features | None = None) -> np.ndarray:
    if cfg.matching.pair_mode == "contiguous":
        pairs = pairs_mod.contiguous_pairs(n_views, cfg.matching.contiguous_window)
        if cfg.matching.loop_closure and feats is not None and n_views > 2:
            loops = pairs_mod.retrieval_pairs(
                feats.desc, feats.mask,
                exclude=2 * cfg.matching.contiguous_window,
                top_k=cfg.matching.loop_top_k,
                min_sim=cfg.matching.loop_min_sim)
            if len(loops):
                pairs = np.unique(np.concatenate([pairs, loops]), axis=0)
        return pairs
    return pairs_mod.exhaustive_pairs(n_views)


def preemptive_filter_pairs(feats: sift.Features, pair_list: np.ndarray,
                            cfg: PipelineConfig, progress=_noop_progress) -> np.ndarray:
    """Preemptive matching prefilter (parity: the reference's preemptive
    option, sparseBuilder.cpp:819-820, 965-981): match only the strongest
    `preemptive_features` per view (features are already score-sorted) and
    keep pairs with at least `preemptive_min_matches` survivors.  One
    cheap (P, K, D) matmul pass prunes the O(V^2) pair list before full
    matching — the reference's scale lever for large collections.

    Returns keep (P,) bool."""
    mcfg = cfg.matching
    K = min(mcfg.preemptive_features, feats.desc.shape[1])
    P = len(pair_list)
    keep = np.zeros(P, bool)
    # Larger chunks than full matching: the K-feature tiles are tiny.
    ch = max(mcfg.pair_chunk * 4, 32)
    desc = feats.desc[:, :K]
    mask = feats.mask[:, :K]
    for s in range(0, P, ch):
        pl = pair_list[s : s + ch]
        pl_pad = np.concatenate([pl, np.repeat(pl[:1], ch - len(pl), 0)]) if len(pl) < ch else pl
        ia = jnp.asarray(pl_pad[:, 0])
        ib = jnp.asarray(pl_pad[:, 1])
        _, ok = match_mod.match_batch(
            desc[ia], desc[ib], mask[ia], mask[ib],
            mcfg.ratio, mcfg.cross_check, quantized=True,
        )
        counts = np.asarray(jnp.sum(ok, axis=-1))[: len(pl)]
        keep[s : s + len(pl)] = counts >= mcfg.preemptive_min_matches
        progress("preemptive", min(1.0, (s + ch) / P))
    return keep


def match_pairs(feats: sift.Features, pair_list: np.ndarray, cfg: PipelineConfig,
                progress=_noop_progress, mesh=None):
    """Ratio-test matching for every pair, chunked over the pair list.
    Returns (match_idx (P, N) int32, match_valid (P, N) bool).

    With cfg.matching.preemptive, pairs failing the strongest-K prefilter
    are skipped entirely (their rows come back all-invalid).

    With a mesh, each chunk of pairs is sharded across devices
    (view-parallel matching, SURVEY.md §2.3 item 3) — the chunk size scales
    by the mesh width so every device matches a full local batch."""
    P = len(pair_list)
    N = feats.kp.shape[1]
    idx_out = np.zeros((P, N), np.int32)
    valid_out = np.zeros((P, N), bool)
    ch = cfg.matching.pair_chunk
    if P >= 16 * ch:
        # Large pair lists: bigger batches, fewer dispatches.
        ch = min(8 * ch, 256)
    elif P <= 256:
        # Small collections: one dispatch for the whole pair list, bucketed
        # to 32 so reruns with slightly different pair counts reuse the
        # compiled shape.
        ch = max(ch, 32 * ((P + 31) // 32))
    n_dev = 1
    if mesh is not None:
        from ..parallel import dist_matching

        n_dev = mesh.shape["shard"]
        ch = ch * n_dev
    desc = feats.desc
    mask = feats.mask
    rows = np.arange(P)
    if cfg.matching.preemptive and P > 0:
        keep = preemptive_filter_pairs(feats, pair_list, cfg, progress)
        rows = rows[keep]
    work = pair_list[rows] if len(rows) < P else pair_list
    for s in range(0, len(work), ch):
        pl = work[s : s + ch]
        # Pad the chunk to full size so one compiled shape serves all chunks.
        pl_pad = np.concatenate([pl, np.repeat(pl[:1], ch - len(pl), 0)]) if len(pl) < ch else pl
        ia = jnp.asarray(pl_pad[:, 0])
        ib = jnp.asarray(pl_pad[:, 1])
        if mesh is not None:
            idx, ok = dist_matching.match_pairs_sharded(
                mesh, desc[ia], desc[ib], mask[ia], mask[ib],
                ratio=cfg.matching.ratio, cross_check=cfg.matching.cross_check,
                quantized=True,
            )
        else:
            # quantized: SIFT descriptors are u8-grid (features/sift.py).
            idx, ok = match_mod.match_batch(
                desc[ia], desc[ib], mask[ia], mask[ib],
                cfg.matching.ratio, cfg.matching.cross_check, quantized=True,
            )
        out_rows = rows[s : s + len(pl)]
        idx_out[out_rows] = np.asarray(idx)[: len(pl)]
        valid_out[out_rows] = np.asarray(ok)[: len(pl)]
        progress("matching", min(1.0, (s + ch) / max(len(work), 1)))
    return idx_out, valid_out


@partial(jax.jit, static_argnames=("model", "n_iters", "minimal", "adaptive",
                                   "score_subset"))
def _filter_chunk(keys, x0, x1, valid, model: str, n_iters: int, thresh,
                  minimal: bool = False, adaptive: bool = False, alpha0=1.0,
                  score_subset: int = 0):
    """Vmapped robust model fit over a chunk of pairs (pixel-space F/H).
    minimal=True uses the 7-point minimal solver for 'f' (3 roots per
    sample, 8-point refit) — OpenMVG's AC-RANSAC samples 7-point too.
    adaptive=True scores by a-contrario NFA (adaptive per-pair threshold
    bounded by `thresh`) exactly like the reference's AC-RANSAC filter."""
    extra = {}
    if model == "h":
        solver, scorer = homography.homography_dlt, homography.homography_transfer_error
        sample = 4
        err_dim = 2
    elif minimal:  # 'f' minimal
        solver, scorer = epipolar.fundamental_7pt, epipolar.sampson_error
        sample = 7
        err_dim = 1
        extra = dict(n_candidates=3, refit_solver=epipolar.fundamental_8pt)
    else:  # 'f'
        solver, scorer = epipolar.fundamental_8pt, epipolar.sampson_error
        sample = 8
        err_dim = 1

    def one(key, a, b, v):
        if adaptive:
            m, inl, n_inl, _, _ = ransac_mod.ransac_ac(
                key, a, b, v, solver=solver, scorer=scorer,
                sample_size=sample, n_iters=n_iters, error_dim=err_dim,
                alpha0=alpha0, max_thresh=thresh, min_thresh=1.0, **extra,
            )
            return m, inl, n_inl
        return ransac_mod.ransac(
            key, a, b, v, solver=solver, scorer=scorer,
            sample_size=sample, n_iters=n_iters, inlier_thresh=thresh,
            score_subset=score_subset, **extra,
        )

    model_out, inl, n_inl = jax.vmap(one)(keys, x0, x1, valid)
    return inl, n_inl


@partial(jax.jit, static_argnames=("n_iters", "minimal", "adaptive",
                                   "score_subset"))
def _filter_chunk_essential(keys, x0, x1, valid, intr_a, intr_b, n_iters: int,
                            thresh_px, minimal: bool = False,
                            adaptive: bool = False, alpha0_px=1.0,
                            score_subset: int = 0):
    """Essential-model geometric filter ('e', ESSENTIAL_MATRIX parity,
    sparseBuilder.cpp:1188-1212): correspondences are normalized with each
    view's intrinsics and scored on the essential manifold.  minimal=True
    samples Nistér 5-point hypotheses (10 roots each, 8-point refit)."""
    from ..core import camera as cam_mod

    extra = {}
    solver, sample = epipolar.essential_8pt, 8
    if minimal:
        solver, sample = epipolar.essential_5pt, 5
        extra = dict(n_candidates=10, refit_solver=epipolar.essential_8pt)

    def one(key, a, b, v, ia, ib):
        an = cam_mod.pixel_to_normal(ia, a)
        bn = cam_mod.pixel_to_normal(ib, b)
        f_mean = 0.25 * (ia[0] + ia[1] + ib[0] + ib[1])
        if adaptive:
            # alpha0 converts to normalized units: probability density of a
            # 1-unit point-to-line band scales by the focal length.
            m, inl, n_inl, _, _ = ransac_mod.ransac_ac(
                key, an, bn, v,
                solver=solver, scorer=epipolar.sampson_error,
                sample_size=sample, n_iters=n_iters, error_dim=1,
                alpha0=alpha0_px * f_mean, max_thresh=thresh_px / f_mean,
                min_thresh=1.0 / f_mean, **extra,
            )
            return m, inl, n_inl
        return ransac_mod.ransac(
            key, an, bn, v,
            solver=solver, scorer=epipolar.sampson_error,
            sample_size=sample, n_iters=n_iters, inlier_thresh=thresh_px / f_mean,
            score_subset=score_subset, **extra,
        )

    model_out, inl, n_inl = jax.vmap(one)(keys, x0, x1, valid, intr_a, intr_b)
    return inl, n_inl


def filter_pairs(feats: sift.Features, pair_list, match_idx, match_valid,
                 cfg: PipelineConfig, key=None, progress=_noop_progress,
                 intr=None, img_hw=None):
    """Geometric verification per pair (parity: filter(), .cpp:1025-1281).
    Prunes matches to RANSAC inliers; drops pairs with < min_matches or
    < min_inlier_ratio support.  Model 'e' needs per-view intrinsics
    (falls back to 'f' without them).  cfg.filter.adaptive scores with
    a-contrario NFA (AC-RANSAC parity) using img_hw for the alpha0 prior."""
    if cfg.filter.model == "none":
        return match_idx, match_valid, np.ones(len(pair_list), bool)
    model = cfg.filter.model
    if model == "e" and intr is None:
        model = "f"
    if img_hw is None:
        kp_np = np.asarray(feats.kp)
        img_hw = (float(kp_np[..., 1].max()) + 1.0, float(kp_np[..., 0].max()) + 1.0)
    area = float(img_hw[0]) * float(img_hw[1])
    diag = float(np.hypot(img_hw[0], img_hw[1]))
    # alpha0: probability a random point lies within 1 unit of a line
    # (F/E models) or of a point (H) — the a-contrario background model.
    alpha0 = (np.pi / area) if model == "h" else (2.0 * diag / area)
    key = jax.random.PRNGKey(0) if key is None else key
    P = len(pair_list)
    N = feats.kp.shape[1]
    ch = cfg.matching.pair_chunk
    if P >= 16 * ch:
        ch = min(8 * ch, 256)  # fewer dispatches (see match_pairs)
    elif P <= 128:
        # One-or-two-dispatch filtering for small collections (the RANSAC
        # chunk is compute-heavier than matching, so the fold-up stops at
        # 128 pairs per dispatch).
        ch = max(ch, 32 * ((min(P, 128) + 31) // 32))
    kp = feats.kp
    out_valid = np.zeros_like(match_valid)
    pair_ok = np.zeros(P, bool)
    for s in range(0, P, ch):
        pl = pair_list[s : s + ch]
        n = len(pl)
        pl_pad = np.concatenate([pl, np.repeat(pl[:1], ch - n, 0)]) if n < ch else pl
        mi = match_idx[s : s + ch]
        mv = match_valid[s : s + ch]
        if n < ch:
            mi = np.concatenate([mi, np.repeat(mi[:1], ch - n, 0)])
            mv = np.concatenate([mv, np.zeros((ch - n, N), bool)])
        ia = jnp.asarray(pl_pad[:, 0])
        ib = jnp.asarray(pl_pad[:, 1])
        x0, x1, _ = match_mod.gather_matched_points(
            kp[ia], kp[ib], jnp.asarray(mi), jnp.asarray(mv)
        )
        key, k = jax.random.split(key)
        keys = jax.random.split(k, ch)
        if model == "e":
            intr_np = np.asarray(intr, np.float32)
            inl, n_inl = _filter_chunk_essential(
                keys, x0, x1, jnp.asarray(mv),
                jnp.asarray(intr_np[pl_pad[:, 0]]), jnp.asarray(intr_np[pl_pad[:, 1]]),
                cfg.filter.max_iterations, cfg.filter.thresh_px,
                cfg.filter.minimal_solver, cfg.filter.adaptive, alpha0,
                score_subset=cfg.filter.score_subset,
            )
        else:
            inl, n_inl = _filter_chunk(
                keys, x0, x1, jnp.asarray(mv), model,
                cfg.filter.max_iterations, cfg.filter.thresh_px,
                cfg.filter.minimal_solver, cfg.filter.adaptive, alpha0,
                score_subset=cfg.filter.score_subset,
            )
        out_valid[s : s + n] = np.asarray(inl)[:n] & mv[:n]
        progress("filtering", min(1.0, (s + ch) / P))
    n_put = match_valid.sum(axis=1)
    n_geo = out_valid.sum(axis=1)
    ratio = n_geo / np.maximum(n_put, 1)
    pair_ok = (n_geo >= cfg.filter.min_matches) & (ratio >= cfg.filter.min_inlier_ratio)
    out_valid[~pair_ok] = False
    return match_idx, out_valid, pair_ok


def reconstruct(feats: sift.Features, intr, pair_list, match_idx, match_valid,
                cfg: PipelineConfig, key=None, progress=_noop_progress,
                cam_group=None, mesh=None, init_scene=None):
    """Tracks + reconstruction engine (parity: reconstruction(), .cpp:1283;
    engine selected per cfg.engine_type like the ESfMEngine enum).
    cam_group: optional (V,) intrinsic-group ids — views sharing an id share
    one self-calibrating BA intrinsic block (GroupSharedIntrinsics,
    sparseBuilder.cpp:554-556).
    init_scene: optional prior Scene over the same track table — the
    incremental engine seeds its poses/points from it and registers only
    the remaining views (EXISTING_POSES initializer parity,
    sparseBuilder.cpp:188-193)."""
    V, N = np.asarray(feats.mask).shape
    track_ids, n_tracks = tracks_mod.build_tracks(V, N, pair_list, match_idx, match_valid)
    eng_cfg = cfg.engine
    if cfg.self_calibrate and cam_group is not None:
        # RADIAL3 self-calibration end-to-end (ADJUST_ALL parity,
        # sparseBuilder.cpp:1292-1293).
        import dataclasses as _dc

        eng_cfg = _dc.replace(eng_cfg, ba=_dc.replace(
            eng_cfg.ba, refine_intrinsics=True, refine_params="all"))
    if cfg.engine_type == "global":
        from ..sfm import global_sfm

        engine = global_sfm.GlobalEngine(
            np.asarray(feats.kp), np.asarray(intr), track_ids, n_tracks,
            progress=progress, cam_group=cam_group, inc_cfg=eng_cfg,
            mesh=mesh,
        )
    elif cfg.engine_type == "stellar":
        from ..sfm import stellar

        engine = stellar.StellarEngine(
            np.asarray(feats.kp), np.asarray(intr), track_ids, n_tracks,
            progress=progress, cam_group=cam_group, inc_cfg=eng_cfg,
            mesh=mesh,
        )
    else:
        engine = incremental.IncrementalEngine(
            np.asarray(feats.kp), np.asarray(intr), track_ids, n_tracks,
            eng_cfg, progress=progress, cam_group=cam_group, mesh=mesh,
        )
        if init_scene is not None:
            engine.seed_from_scene(init_scene)
    scene = engine.run(key)
    return scene, engine


def run_sparse(images, intr, cfg: PipelineConfig = PipelineConfig(), key=None,
               progress=_noop_progress, cam_group=None):
    """Full sparse pipeline: images -> colorized sparse scene.

    images: (V, H, W[, 3]); intr: (7,) shared or (V, 7); cam_group:
    optional (V,) shared-intrinsic group ids (see reconstruct).
    Returns (scene, report dict)."""
    t0 = time.time()
    images = np.asarray(images)
    intr = np.asarray(intr, np.float32)
    if intr.ndim == 1:
        intr = np.tile(intr, (images.shape[0], 1))
    key = jax.random.PRNGKey(0) if key is None else key
    times = {}
    mesh = get_mesh(cfg)

    progress("preprocessing", 0.0)
    feats = detect_features(images, cfg, progress)
    # block: detect_features returns device arrays asynchronously — without
    # this the stamp records dispatch time and the real feature cost hides
    # inside the matching stage (it consumes the descriptors).
    jax.block_until_ready(feats.desc)
    times["features"] = time.time() - t0
    progress("preprocessing", 1.0)

    t1 = time.time()
    pair_list = generate_pairs(images.shape[0], cfg, feats=feats)
    match_idx, match_valid = match_pairs(feats, pair_list, cfg, progress, mesh=mesh)
    times["matching"] = time.time() - t1

    t2 = time.time()
    match_idx, match_valid, pair_ok = filter_pairs(
        feats, pair_list, match_idx, match_valid, cfg, key, progress, intr=intr,
        img_hw=images.shape[1:3],
    )
    times["filtering"] = time.time() - t2

    t3 = time.time()
    key, k = jax.random.split(key)
    scene, engine = reconstruct(
        feats, intr, pair_list[pair_ok], match_idx[pair_ok], match_valid[pair_ok],
        cfg, k, progress, cam_group=cam_group, mesh=mesh,
    )
    times["reconstruction"] = time.time() - t3

    t4 = time.time()
    gray = np.asarray(images)
    if gray.ndim == 3:
        rgb = np.repeat((np.clip(gray, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1)
    else:
        rgb = np.asarray(images).astype(np.uint8)
    scene = engine.colorize(scene, rgb)
    times["colorize"] = time.time() - t4
    times["total"] = time.time() - t0
    report = {
        "n_views": int(images.shape[0]),
        "n_registered": int(np.asarray(scene.cam_mask).sum()),
        "n_points": int(np.asarray(scene.point_mask).sum()),
        "n_obs": int(np.asarray(scene.obs_mask).sum()),
        "n_pairs_kept": int(pair_ok.sum()),
        "times_s": {k_: round(v, 3) for k_, v in times.items()},
        "recon_phase_s": {k_: round(v, 3) for k_, v in
                          sorted(getattr(engine, "timings", {}).items())},
        "engine_log": engine.log,
    }
    progress("done", 1.0, **{"n_points": report["n_points"]})
    return scene, report
