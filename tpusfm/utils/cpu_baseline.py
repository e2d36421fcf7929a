"""Measured CPU reference baseline for bench.py.

The reference (RainbowXXX/3DReconstruction) publishes no numbers and its
C++ stack (OpenMVG + OpenCV + Ceres + OpenMVS) is not buildable in this
image, so the baseline is MEASURED by running an equivalent CPU pipeline on
the same synthetic scenes, stage for stage:

  reference stage                       CPU-baseline stand-in
  -----------------------------------   ----------------------------------
  vlfeat SIFT (detectFeature)           cv2.SIFT_create (same algorithm
                                        family; reference SIFT_describer
                                        defaults: 6 octaves, peak .04,
                                        edge 10 — cv2 defaults match)
  cascade-hash L2 ratio 0.8 (match)     cv2.BFMatcher knn ratio 0.8
                                        (exact L2 — cascade hashing
                                        approximates this FASTER, so BF is
                                        generous to us; both exhaustive)
  F-matrix AC-RANSAC 4px (filter)       cv2.findFundamentalMat RANSAC 4px
  incremental engine (reconstruction)   E-matrix init + solvePnPRansac
                                        (8px, SequentialActuator.h:176) +
                                        cv2.triangulatePoints
  Ceres SPARSE_SCHUR BA 1 thread        numpy/BLAS Schur-eliminated LM:
  (BundleAdjuster.h:167-174)            analytic Jacobians, Huber delta=4
                                        IRLS (BundleAdjuster.h:109), exact
                                        3x3 point elimination + dense
                                        camera-system Cholesky per LM step
                                        — the same per-iteration math
                                        SPARSE_SCHUR does (round 2 used
                                        scipy TRF, which is slower per
                                        iteration than Ceres and
                                        flattered vs_baseline; see
                                        BASELINE.md)

All heavy kernels are C/C++ (OpenCV, scipy) — this is a real CPU pipeline,
not interpreted Python.  Used by bench.py to produce a *measured*
vs_baseline; the result is recorded in BASELINE_MEASURED.json.
"""

from __future__ import annotations

import time

import numpy as np


def _so3_exp_np(aa: np.ndarray) -> np.ndarray:
    """Batched axis-angle -> rotation matrices (Rodrigues), numpy."""
    th = np.linalg.norm(aa, axis=-1, keepdims=True)
    th = np.maximum(th, 1e-12)
    k = aa / th
    K = np.zeros(aa.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    th = th[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _so3_right_jacobian_np(aa: np.ndarray) -> np.ndarray:
    """Batched SO(3) right Jacobian J_r(aa), numpy."""
    th = np.linalg.norm(aa, axis=-1)
    K = np.zeros(aa.shape[:-1] + (3, 3))
    k = aa / np.maximum(th, 1e-12)[..., None]
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    th_ = np.maximum(th, 1e-6)[..., None, None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    # Jr = I - (1-cos)/th * K + (th-sin)/th * K^2  (K = [k]x, unit axis)
    Jr = eye - (1 - np.cos(th_)) / th_ * K + (th_ - np.sin(th_)) / th_ * (K @ K)
    small = (th < 1e-6)[..., None, None]
    return np.where(small, eye - 0.5 * K * th_, Jr)


def _project_np(intr, Xc, model: str):
    """Camera-frame points (O, 3) -> pixels (O, 2) in float64 under the
    named camera model (the numpy twin of core.camera.camera_to_pixel):
    "radial3" [fx fy cx cy k1 k2 k3], "brown" [.. k1 k2 k3 t1 t2] or
    "fisheye" [fx fy cx cy k1..k4]."""
    z = Xc[:, 2:3]
    xn = Xc[:, :2] / np.where(np.abs(z) < 1e-8, 1e-8, z)
    r2 = np.sum(xn * xn, axis=1, keepdims=True)
    if model == "fisheye":
        k1, k2, k3, k4 = (intr[:, 4 + i, None] for i in range(4))
        r = np.sqrt(np.maximum(r2, 1e-18))
        th = np.arctan(r)
        t2 = th * th
        xd = xn * (th * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) / r)
    else:
        k1, k2, k3 = (intr[:, 4 + i, None] for i in range(3))
        xd = xn * (1 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        if model == "brown":
            t1, t2 = intr[:, 7:8], intr[:, 8:9]
            x, y = xn[:, 0:1], xn[:, 1:2]
            xd = xd + np.concatenate([2 * t1 * x * y + t2 * (r2 + 2 * x * x),
                                      t1 * (r2 + 2 * y * y) + 2 * t2 * x * y],
                                     axis=1)
    return xd * intr[:, 0:2] + intr[:, 2:4]


def ba_cost_np(intr, cam_rot, cam_t, points, obs_cam, obs_pt, obs_uv,
               obs_mask, huber: float = 4.0, model: str = "radial3") -> float:
    """Huber reprojection cost of a BA problem in float64 numpy — the
    reference the device solver's reported cost is checked against.
    intr (C, E) per camera; masked observations contribute nothing."""
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    ocam = np.asarray(obs_cam)
    opt = np.asarray(obs_pt)
    R = _so3_exp_np(f64(cam_rot))[ocam]
    Xc = np.einsum("oij,oj->oi", R, f64(points)[opt]) + f64(cam_t)[ocam]
    r = _project_np(f64(intr)[ocam], Xc, model) - f64(obs_uv)
    n = np.linalg.norm(r, axis=-1)
    c = np.where(n <= huber, 0.5 * n * n, huber * (n - 0.5 * huber))
    return float(np.sum(c * np.asarray(obs_mask, np.float64)))


def _schur_lm_ba(cam0, X0, ocam, opt, ouv, K, huber=4.0, max_iters=25,
                 rtol=3e-6):
    """Ceres-SPARSE_SCHUR-equivalent CPU bundle adjustment in numpy/BLAS:
    analytic Jacobians, Huber IRLS, exact 3x3 point-block elimination, dense
    reduced camera system solved by Cholesky, Marquardt damping with
    accept/reject.  Gauge: camera 0 fixed (BundleAdjuster.h:105)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    cams = cam0.copy()
    pts = X0.copy()
    nC, nP, nO = len(cams), len(pts), len(ocam)
    lam = 1e-4
    lin_cp = opt.astype(np.int64) * nC + ocam

    def robust_cost(r):
        n = np.linalg.norm(r, axis=-1)
        return float(np.sum(np.where(n <= huber, 0.5 * n * n,
                                     huber * (n - 0.5 * huber))))

    def seg_sum(idx, vals, n):
        """Segment sum via bincount (much faster than np.add.at)."""
        w = vals.shape[1]
        flat = (idx[:, None].astype(np.int64) * w
                + np.arange(w)[None, :]).ravel()
        return np.bincount(flat, weights=vals.ravel(),
                           minlength=n * w).reshape(n, w)

    def linearize(cams, pts):
        R = _so3_exp_np(cams[:, :3])
        Jr = _so3_right_jacobian_np(cams[:, :3])
        Ro = R[ocam]
        Xo = pts[opt]
        Xc = np.einsum("oij,oj->oi", Ro, Xo) + cams[ocam, 3:]
        z = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        x = Xc[:, 0] / z
        y = Xc[:, 1] / z
        r = np.stack([fx * x + cx - ouv[:, 0], fy * y + cy - ouv[:, 1]], 1)
        # d r / d Xc
        L = np.zeros((nO, 2, 3))
        L[:, 0, 0] = fx / z
        L[:, 0, 2] = -fx * x / z
        L[:, 1, 1] = fy / z
        L[:, 1, 2] = -fy * y / z
        # dXc/daa = -R [X]x Jr ; dXc/dt = I ; dXc/dX = R
        Xx = np.zeros((nO, 3, 3))
        Xx[:, 0, 1], Xx[:, 0, 2] = -Xo[:, 2], Xo[:, 1]
        Xx[:, 1, 0], Xx[:, 1, 2] = Xo[:, 2], -Xo[:, 0]
        Xx[:, 2, 0], Xx[:, 2, 1] = -Xo[:, 1], Xo[:, 0]
        N = -np.einsum("oij,ojk,okl->oil", Ro, Xx, Jr[ocam])
        Jc = np.concatenate([np.einsum("oij,ojk->oik", L, N),
                             L], axis=2)  # (O, 2, 6)
        Jp = np.einsum("oij,ojk->oik", L, Ro)  # (O, 2, 3)
        # Huber IRLS weights
        n = np.linalg.norm(r, axis=-1)
        w = np.sqrt(np.minimum(1.0, huber / np.maximum(n, 1e-12)))[:, None]
        return robust_cost(r), r * w, Jc * w[..., None], Jp * w[..., None]

    cost, r, Jc, Jp = linearize(cams, pts)
    init_cost = cost
    it_done = 0
    for _ in range(max_iters):
        Hcc = seg_sum(ocam, np.einsum("oki,okj->oij", Jc, Jc).reshape(nO, 36),
                      nC).reshape(nC, 6, 6)
        Hpp = seg_sum(opt, np.einsum("oki,okj->oij", Jp, Jp).reshape(nO, 9),
                      nP).reshape(nP, 3, 3)
        gc = seg_sum(ocam, np.einsum("oki,ok->oi", Jc, r), nC)
        gp = seg_sum(opt, np.einsum("oki,ok->oi", Jp, r), nP)
        W = np.einsum("oki,okj->oij", Jc, Jp)  # (O, 6, 3)
        # Marquardt damping.
        di = np.arange(6)
        Hcc_d = Hcc.copy()
        Hcc_d[:, di, di] += lam * np.maximum(Hcc[:, di, di], 1e-6)
        dp3 = np.arange(3)
        Hpp_d = Hpp.copy()
        Hpp_d[:, dp3, dp3] += lam * np.maximum(Hpp[:, dp3, dp3], 1e-6)
        Hpp_inv = np.linalg.inv(Hpp_d + 1e-12 * np.eye(3))
        # Dense coupling table (P, C, 6, 3) and Schur complement.
        Wcp = seg_sum(lin_cp, W.reshape(nO, 18),
                      nP * nC).reshape(nP, nC, 6, 3)
        A = np.einsum("pcdk,pkl->pcdl", Wcp, Hpp_inv)
        S = -np.einsum("pcdl,pejl->cdej", A, Wcp).reshape(nC * 6, nC * 6)
        for c in range(nC):
            S[c * 6:(c + 1) * 6, c * 6:(c + 1) * 6] += Hcc_d[c]
        rhs = (-gc + np.einsum("pcdl,pl->cd",
                               Wcp, np.einsum("pkl,pl->pk", Hpp_inv, gp))
               ).reshape(-1)
        # Gauge: freeze camera 0.
        upd = np.ones(nC * 6)
        upd[:6] = 0.0
        S = S * np.outer(upd, upd) + np.diag(1.0 - upd)
        rhs = rhs * upd
        try:
            from scipy.linalg import cho_factor, cho_solve
            dc = cho_solve(cho_factor(S), rhs).reshape(nC, 6)
        except Exception:
            dc = np.linalg.solve(S, rhs).reshape(nC, 6)
        Wtd = np.einsum("pcdl,cd->pl", Wcp, dc)
        dpt = -np.einsum("pkl,pl->pk", Hpp_inv, gp + Wtd)
        cams_new = cams + dc
        pts_new = pts + dpt
        new_cost, r_new, Jc_new, Jp_new = linearize(cams_new, pts_new)
        it_done += 1
        if new_cost < cost:
            rel = (cost - new_cost) / max(cost, 1e-12)
            cams, pts = cams_new, pts_new
            cost, r, Jc, Jp = new_cost, r_new, Jc_new, Jp_new
            lam = max(lam * 0.5, 1e-10)
            if rel < rtol:
                break
        else:
            lam = min(lam * 4.0, 1e8)
    return cams, pts, init_cost, cost, it_done


def run_cpu_baseline(images: np.ndarray, intr: np.ndarray, ba: bool = True,
                     log=lambda *a: None, pair_window: int = 0) -> dict:
    """Run the CPU reference pipeline on (V, H, W) grayscale float images in
    [0, 1].  intr: (7,) [fx, fy, cx, cy, k1, k2, k3] shared.
    pair_window > 0 matches only |i-j| <= window pairs (the reference's
    PAIR_CONTIGUOUS mode, sparseBuilder.cpp:784-797) — used for the
    200-view medium-rung baseline where exhaustive O(V^2) BF matching
    would dominate the measurement.
    Returns {'fps', 'total_s', 'times_s': {...}, 'n_registered', 'centers'}."""
    import cv2

    V = images.shape[0]
    u8 = (np.clip(np.asarray(images), 0, 1) * 255).astype(np.uint8)
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]],
                 np.float64)
    times = {}
    t_all = time.time()

    # --- features (detectFeature parity) -----------------------------------
    t0 = time.time()
    sift = cv2.SIFT_create()
    kps, descs = [], []
    for v in range(V):
        kp, de = sift.detectAndCompute(u8[v], None)
        kps.append(np.asarray([k.pt for k in kp], np.float64).reshape(-1, 2))
        descs.append(de if de is not None else np.zeros((0, 128), np.float32))
    times["features"] = time.time() - t0
    log(f"cpu-baseline: SIFT {sum(len(k) for k in kps)} kps in {times['features']:.2f}s")

    # --- exhaustive ratio matching (match parity) ---------------------------
    t0 = time.time()
    bf = cv2.BFMatcher(cv2.NORM_L2)
    pair_matches = {}
    for i in range(V):
        for j in range(i + 1, V):
            if pair_window and j - i > pair_window:
                continue
            if len(descs[i]) < 8 or len(descs[j]) < 8:
                continue
            knn = bf.knnMatch(descs[i], descs[j], k=2)
            good = [m for m, n in (p for p in knn if len(p) == 2)
                    if m.distance < 0.8 * n.distance]
            if len(good) >= 8:
                pair_matches[(i, j)] = np.asarray(
                    [(m.queryIdx, m.trainIdx) for m in good], np.int32)
    times["matching"] = time.time() - t0

    # --- geometric filter (filter parity: F-RANSAC 4px, >=50 kept) ----------
    t0 = time.time()
    filtered = {}
    for (i, j), m in pair_matches.items():
        p0 = kps[i][m[:, 0]]
        p1 = kps[j][m[:, 1]]
        F, inl = cv2.findFundamentalMat(p0, p1, cv2.FM_RANSAC, 4.0, 0.99)
        if F is None or inl is None:
            continue
        inl = inl.ravel().astype(bool)
        if inl.sum() >= 50:  # sparseBuilder.cpp:1204
            filtered[(i, j)] = m[inl]
    times["filtering"] = time.time() - t0
    log(f"cpu-baseline: {len(filtered)} pairs survive filtering")

    # --- incremental reconstruction (SequentialActuator parity) -------------
    t0 = time.time()
    # Union-find tracks over filtered matches.
    parent = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (i, j), m in filtered.items():
        for a, b in m:
            ra, rb = find((i, int(a))), find((j, int(b)))
            if ra != rb:
                parent[ra] = rb
    track_of = {}
    tracks = {}
    for key in list(parent):
        r = find(key)
        tid = track_of.setdefault(r, len(track_of))
        tracks.setdefault(tid, []).append(key)

    # Init pair: most filtered matches.
    if not filtered:
        return dict(fps=0.0, total_s=time.time() - t_all, times_s=times,
                    n_registered=0, centers=np.zeros((0, 3)))
    (i0, j0), m0 = max(filtered.items(), key=lambda kv: len(kv[1]))
    p0 = kps[i0][m0[:, 0]]
    p1 = kps[j0][m0[:, 1]]
    E, inl = cv2.findEssentialMat(p0, p1, K, cv2.RANSAC, 0.999, 4.0)
    inl = inl.ravel().astype(bool)
    _, R1, t1, _ = cv2.recoverPose(E, p0[inl], p1[inl], K)
    poses = {i0: (np.eye(3), np.zeros(3)), j0: (R1, t1.ravel())}

    def triangulate(i, j, pi, pj):
        Ri, ti = poses[i]
        Rj, tj = poses[j]
        Pi = K @ np.hstack([Ri, ti.reshape(3, 1)])
        Pj = K @ np.hstack([Rj, tj.reshape(3, 1)])
        X = cv2.triangulatePoints(Pi, Pj, pi.T, pj.T)
        return (X[:3] / np.where(np.abs(X[3]) < 1e-12, 1e-12, X[3])).T

    # World points per track id.
    world = {}
    obs = {}  # track -> list[(view, uv)]
    for (i, j), m in filtered.items():
        for a, b in m:
            tid = track_of.get(find((i, int(a))))
            if tid is None:
                continue
            obs.setdefault(tid, {})[i] = kps[i][a]
            obs[tid][j] = kps[j][b]
    X01 = triangulate(i0, j0, p0[inl], p1[inl])
    k_in = np.nonzero(inl)[0]
    for row, X in zip(k_in, X01):
        tid = track_of.get(find((i0, int(m0[row, 0]))))
        if tid is not None and X[2] > 0:
            world[tid] = X

    # Register remaining views by PnP (solvePnPRansac, 8px, like
    # SequentialActuator.h:175-196 with the <30-inlier frame drop).
    remaining = [v for v in range(V) if v not in poses]
    progressed = True
    while progressed and remaining:
        progressed = False
        for v in list(remaining):
            pts3, pts2 = [], []
            for tid, X in world.items():
                uv = obs.get(tid, {}).get(v)
                if uv is not None:
                    pts3.append(X)
                    pts2.append(uv)
            if len(pts3) < 6:
                continue
            ok, rvec, tvec, inliers = cv2.solvePnPRansac(
                np.asarray(pts3), np.asarray(pts2), K, None,
                reprojectionError=8.0, iterationsCount=100, confidence=0.99)
            if not ok or inliers is None or len(inliers) < 30:
                continue
            R, _ = cv2.Rodrigues(rvec)
            poses[v] = (R, tvec.ravel())
            remaining.remove(v)
            progressed = True
            # Triangulate new tracks seen by this view + a registered one.
            for tid, vs in obs.items():
                if tid in world or v not in vs:
                    continue
                for u in vs:
                    if u in poses and u != v:
                        X = triangulate(u, v, vs[u].reshape(1, 2),
                                        vs[v].reshape(1, 2))[0]
                        if X[2] > 0:
                            world[tid] = X
                        break
    times["reconstruction"] = time.time() - t0
    log(f"cpu-baseline: registered {len(poses)}/{V} views, {len(world)} points")

    # --- bundle adjustment (Ceres SPARSE_SCHUR stand-in) --------------------
    if ba and len(world) > 10:
        t0 = time.time()
        view_ids = sorted(poses)
        vidx = {v: k for k, v in enumerate(view_ids)}
        tids = sorted(world)
        tidx = {t_: k for k, t_ in enumerate(tids)}
        rows = []
        for tid in tids:
            for v, uv in obs[tid].items():
                if v in vidx:
                    rows.append((vidx[v], tidx[tid], uv))
        cam0 = np.zeros((len(view_ids), 6))
        for v, k in vidx.items():
            rv, _ = __import__("cv2").Rodrigues(poses[v][0])
            cam0[k, :3] = rv.ravel()
            cam0[k, 3:] = poses[v][1]
        X0 = np.asarray([world[t_] for t_ in tids])
        nC = len(view_ids)
        ocam = np.asarray([r[0] for r in rows])
        opt = np.asarray([r[1] for r in rows])
        ouv = np.asarray([r[2] for r in rows])

        _, _, ba_ic, ba_fc, ba_it = _schur_lm_ba(
            cam0, X0, ocam, opt, ouv, K, huber=4.0, max_iters=25)
        log(f"cpu-baseline BA: cost {ba_ic:.1f} -> {ba_fc:.1f} in {ba_it} it")
        times["ba"] = time.time() - t0

    total = time.time() - t_all
    centers = np.asarray([-(R.T @ t) for R, t in
                          (poses[v] for v in sorted(poses))])
    return dict(fps=V / total, total_s=total, times_s={k: round(v, 3) for k, v in times.items()},
                n_registered=len(poses), centers=centers,
                registered_ids=sorted(poses))


def run_cpu_dense_baseline(images: np.ndarray, K: np.ndarray,
                           R_all: np.ndarray, t_all: np.ndarray,
                           views: list, src_lists: list,
                           depth_ranges: list, n_planes: int = 64,
                           window: int = 5, best_k: int = 2,
                           log=lambda *a: None) -> dict:
    """CPU dense-stage stand-in: cv2/numpy plane-sweep NCC depth maps at
    matched output density (one depth per pixel, same plane count / source
    count / NCC window as the device sweep).

    Stand-in rationale: the reference's dense stage is the OpenMVS
    ``DensifyPointCloud`` binary (PatchMatch MVS, spawned at
    src/main.cpp:161) which is not buildable in this image; a plane sweep
    with the same sampling volume is the standard CPU-comparable kernel
    (all heavy ops are OpenCV C++: warpPerspective bilinear sampling +
    boxFilter NCC).  bench.py compares it against OUR sweep-only config so
    algorithm and output density match exactly; the PatchMatch-refined
    numbers are reported separately (slanted-plane refinement has no cheap
    CPU stand-in — on the reference it IS the expensive part).

    images: (V, H, W) float [0, 1]; K: (3, 3) shared; R_all/t_all: (V, 3, 3)
    and (V, 3) world->cam; views: reference view ids; src_lists[i]: source
    view ids for views[i]; depth_ranges[i]: (lo, hi) metric depth."""
    import cv2

    V, H, W = images.shape
    imgs = np.ascontiguousarray(images.astype(np.float32))

    def local_norm(im):
        m = cv2.boxFilter(im, -1, (window, window))
        m2 = cv2.boxFilter(im * im, -1, (window, window))
        v = np.maximum(m2 - m * m, 1e-6)
        return (im - m) / np.sqrt(v)

    norm = np.stack([local_norm(imgs[v]) for v in range(V)])
    Kinv = np.linalg.inv(K)
    t0 = time.time()
    depths = {}
    for ref, srcs, (lo, hi) in zip(views, src_lists, depth_ranges):
        inv_ds = np.linspace(1.0 / hi, 1.0 / lo, n_planes)
        ref_n = norm[ref]
        best_cost = np.full((H, W), np.inf, np.float32)
        best_inv = np.zeros((H, W), np.float32)
        R_rel = [R_all[s] @ R_all[ref].T for s in srcs]
        t_rel = [t_all[s] - R_all[s] @ R_all[ref].T @ t_all[ref] for s in srcs]
        for inv_d in inv_ds:
            costs = []
            for Rr, tr, s in zip(R_rel, t_rel, srcs):
                Hmat = K @ (Rr + np.outer(tr, [0, 0, inv_d])) @ Kinv
                # warp SOURCE into the reference frame through the plane
                warp = cv2.warpPerspective(
                    norm[s], Hmat.astype(np.float64), (W, H),
                    flags=cv2.WARP_INVERSE_MAP | cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
                ncc = cv2.boxFilter(warp * ref_n, -1, (window, window))
                costs.append(1.0 - ncc)
            cs = np.sort(np.stack(costs), axis=0)[:best_k]
            agg = cs.mean(axis=0)
            take = agg < best_cost
            best_cost[take] = agg[take]
            best_inv[take] = inv_d
        depths[ref] = 1.0 / np.maximum(best_inv, 1e-9)
    dt = time.time() - t0
    return dict(views=len(views), seconds=round(dt, 2),
                views_per_s=round(len(views) / dt, 4),
                n_planes=n_planes, depths=depths,
                pipeline="cv2 warpPerspective + boxFilter NCC plane sweep")
