"""File-staged, resumable pipeline workspace.

Parity with the reference's artifact contract (SURVEY.md §5 'Checkpoint /
resume'): every stage persists its output and later stages reload it, so
re-running a stage resumes from the last artifact.  Reference staging:
sfm_data.json -> .feat/.desc -> matches.putative.bin -> matches.f.bin ->
sfm_data.bin + cloud_and_poses.ply -> colorized.ply (sparseBuilder.h:25-29).
Here the equivalents are array-native npz files plus the same PLY outputs:

  workspace/
    images/                  uploaded/source images
    views.json               image records + focal priors (~ sfm_data.json)
    config.json              pipeline config dump
    features.npz             (~ .feat/.desc)
    matches_putative.npz     (~ matches.putative.bin)
    matches_geometric.npz    (~ matches.f.bin)
    scene.npz                (~ sfm_data.bin)
    cloud_and_poses.ply      sparse cloud + camera markers
    colorized.ply            colorized sparse cloud
    report.json              reconstruction report (~ HTML report)
    dense.ply / mesh.ply     dense stage outputs
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from ..features import sift
from ..io import images as im_io
from ..io import ply
from ..sfm import scene as scene_mod
from ..utils.events import EventBus
from .config import PipelineConfig
from . import sparse as sp


class StagedPipeline:
    """Workspace-backed pipeline with stage skip-if-done semantics
    (the reference's ``!bForce && is_regular_file`` pattern,
    sparseBuilder.cpp:700)."""

    def __init__(self, workspace: str | Path, cfg: PipelineConfig = PipelineConfig(),
                 bus: EventBus | None = None, force: bool = False):
        self.ws = Path(workspace)
        self.ws.mkdir(parents=True, exist_ok=True)
        (self.ws / "images").mkdir(exist_ok=True)
        self.cfg = cfg
        self.bus = bus or EventBus()
        self.force = force
        self.progress = self.bus.progress_fn()
        (self.ws / "config.json").write_text(cfg.to_json())

    # -- helpers -----------------------------------------------------------

    def _done(self, name: str) -> bool:
        return not self.force and (self.ws / name).exists()

    def image_dir(self) -> Path:
        return self.ws / "images"

    # -- stage 1: preprocessing (ingest + features) ------------------------

    def preprocess(self, focal_prior_px: float | None = None):
        """~ preload(): readImagesCluster + detectFeature (main.cpp:120-129)."""
        self.progress("preprocessing", 0.0)
        paths = im_io.list_images(self.image_dir())
        if not paths:
            raise FileNotFoundError(f"no images in {self.image_dir()}")
        records = [
            im_io.read_image_record(
                p, focal_prior_px=focal_prior_px or self.cfg.focal_prior_px
            )
            for p in paths
        ]
        (self.ws / "views.json").write_text(json.dumps(
            [dataclasses.asdict(r) for r in records], indent=2
        ))
        self.progress("preprocessing", 0.5)

        if self._done("features.npz"):
            self.progress("preprocessing", 1.0)
            return records
        images = im_io.load_images_gray(paths)
        # Optional feature masks (parity: sparseBuilder.cpp:706-739):
        # a global mask.png applies to every view; a per-image
        # <stem>_mask.png overrides it.
        masks = None
        global_mask = self.image_dir() / "mask.png"
        per_image = [p.with_name(p.stem + "_mask.png") for p in paths]
        if global_mask.exists() or any(m.exists() for m in per_image):
            H, W = images.shape[1:3]
            gm = None
            if global_mask.exists():
                gm = im_io.load_images_gray([global_mask])[0]
            masks = np.ones((len(paths), H, W), np.float32)
            for k, m in enumerate(per_image):
                if m.exists():
                    masks[k] = im_io.load_images_gray([m])[0]
                elif gm is not None:
                    masks[k] = gm
        feats = sp.detect_features(images, self.cfg, self.progress, masks=masks)
        np.savez_compressed(
            self.ws / "features.npz",
            kp=np.asarray(feats.kp), desc=np.asarray(feats.desc),
            score=np.asarray(feats.score), mask=np.asarray(feats.mask),
        )
        self.progress("preprocessing", 1.0)
        return records

    def _load_features(self) -> sift.Features:
        d = np.load(self.ws / "features.npz")
        return sift.Features(
            kp=jnp.asarray(d["kp"]), desc=jnp.asarray(d["desc"]),
            score=jnp.asarray(d["score"]), mask=jnp.asarray(d["mask"]),
        )

    def _load_views(self):
        return json.loads((self.ws / "views.json").read_text())

    def _intrinsics(self) -> np.ndarray:
        views = self._load_views()
        intr = []
        for v in views:
            intr.append([v["focal_px"], v["focal_px"], v["width"] / 2, v["height"] / 2, 0, 0, 0])
        return np.asarray(intr, np.float32)

    def _intrinsic_groups(self) -> np.ndarray:
        """Shared-intrinsics group id per view (GroupSharedIntrinsics
        parity, sparseBuilder.cpp:554-556): views from the same physical
        camera — same EXIF make/model, dimensions, and focal prior — share
        one self-calibrating BA intrinsic block.  Distortion starts at zero
        and is REFINED by BA (RADIAL3 ADJUST_ALL, sparseBuilder.cpp:480-502,
        1292-1293), so the real-image path no longer assumes a perfect
        pinhole."""
        views = self._load_views()
        keys = {}
        groups = []
        for v in views:
            key = (v.get("camera_model"), v["width"], v["height"],
                   round(float(v["focal_px"]), 1))
            groups.append(keys.setdefault(key, len(keys)))
        return np.asarray(groups, np.int32)

    # -- stage 2: sparse ---------------------------------------------------

    def sparse(self, key=None):
        """~ sparseWork(): matchPair + match + filter + reconstruction +
        colorize (main.cpp:131-146)."""
        t0 = time.time()
        if not (self.ws / "features.npz").exists():
            self.preprocess()
        feats = self._load_features()
        intr = self._intrinsics()
        V = intr.shape[0]
        key = jax.random.PRNGKey(0) if key is None else key
        mesh = sp.get_mesh(self.cfg)

        # matchPair + match (putative)
        from ..io import reports

        if self._done("matches_putative.npz"):
            d = np.load(self.ws / "matches_putative.npz")
            pair_list, mi, mv = d["pairs"], d["idx"], d["valid"]
        else:
            pair_list = sp.generate_pairs(V, self.cfg, feats=feats)
            mi, mv = sp.match_pairs(feats, pair_list, self.cfg, self.progress,
                                    mesh=mesh)
            np.savez_compressed(self.ws / "matches_putative.npz",
                                pairs=pair_list, idx=mi, valid=mv)
            # Diagnostics parity (.cpp:1010-1019): adjacency SVG + stats.
            counts = mv.sum(axis=1)
            reports.write_adjacency_svg(self.ws / "putative_matches.svg", V, pair_list, counts)
            (self.ws / "putative_graph_stats.json").write_text(
                json.dumps(reports.graph_stats(V, pair_list, counts))
            )
        # filter (geometric)
        if self._done("matches_geometric.npz"):
            d = np.load(self.ws / "matches_geometric.npz")
            pair_list, mi, mv, pair_ok = d["pairs"], d["idx"], d["valid"], d["pair_ok"]
        else:
            key, k = jax.random.split(key)
            mi, mv, pair_ok = sp.filter_pairs(feats, pair_list, mi, mv, self.cfg, k, self.progress, intr=intr)
            np.savez_compressed(self.ws / "matches_geometric.npz",
                                pairs=pair_list, idx=mi, valid=mv, pair_ok=pair_ok)
            # Diagnostics parity (.cpp:1249-1269).
            counts = mv.sum(axis=1)
            reports.write_adjacency_svg(self.ws / "geometric_matches.svg", V, pair_list, counts)
            reports.write_graphviz(self.ws / "geometric_matches.dot", pair_list, counts)
            (self.ws / "geometric_graph_stats.json").write_text(
                json.dumps(reports.graph_stats(V, pair_list, counts))
            )

        # reconstruction (with EXIF-identity shared-intrinsic groups so BA
        # self-calibrates RADIAL3 end-to-end when cfg.self_calibrate).
        # A previous scene.npz seeds the engine (EXISTING_POSES initializer
        # parity, sparseBuilder.cpp:188-193): only unregistered views are
        # resected on a re-run.
        init_scene = None
        if not self.force and (self.ws / "scene.npz").exists():
            try:
                prev = scene_mod.load_scene_npz(str(self.ws / "scene.npz"))
                if int(np.asarray(prev.cam_mask).sum()) >= 2:
                    init_scene = prev
            except Exception:
                init_scene = None
        key, k = jax.random.split(key)
        scene, engine = sp.reconstruct(
            feats, intr, pair_list[pair_ok], mi[pair_ok], mv[pair_ok],
            self.cfg, k, self.progress, cam_group=self._intrinsic_groups(),
            mesh=mesh, init_scene=init_scene,
        )
        # colorize (~ colorize(), sparseBuilder.cpp:1601)
        paths = im_io.list_images(self.image_dir())
        rgb = im_io.load_images_rgb(paths)
        scene = engine.colorize(scene, rgb)

        # GPS geo-registration (parity: getGPS pose priors,
        # sparseBuilder.cpp:112-171): with >= 3 GPS-tagged registered
        # views, similarity-align the reconstruction into the local ENU
        # metric frame before writing artifacts.
        geo_info = None
        gps_list = [tuple(v["gps"]) if v.get("gps") else None
                    for v in self._load_views()]
        if sum(g is not None for g in gps_list) >= 3:
            from ..utils import geo

            try:
                scene, geo_info = geo.georegister_scene(scene, gps_list)
                # GPS priors DURING BA (ViewPriors parity,
                # sparseBuilder.cpp:506-533): re-optimize with soft
                # camera-center priors at the fixes — bounds drift instead
                # of only rotating/scaling it away.
                scene, prior_info = geo.gps_prior_ba(scene, gps_list)
                if prior_info is not None:
                    geo_info = {**geo_info, "prior_ba": prior_info}
                self.progress("sparse", 0.95, geo_rms_m=geo_info["rms_m"])
            except ValueError as e:
                self.progress("sparse", 0.95, warning=f"geo-registration: {e}")

        scene_mod.save_scene_npz(str(self.ws / "scene.npz"), scene)
        # External-tool interchange (~ DenseBuilder::save -> .mvs,
        # DenseBuilder.h:54-146): COLMAP text model, the portable format the
        # OpenMVS toolchain ingests (InterfaceCOLMAP).
        from ..io import colmap

        try:
            sizes = np.array([[im.shape[1], im.shape[0]] for im in rgb]) \
                if len(rgb) == scene.max_cams else None
            colmap.export_colmap(self.ws / "colmap", scene,
                                 [p.name for p in paths], image_sizes=sizes)
        except Exception as e:  # interchange is auxiliary — never fail sparse
            self.progress("sparse", 1.0, warning=f"colmap export failed: {e}")
        reg = np.asarray(scene.cam_mask)
        pm = np.asarray(scene.point_mask)
        centers = np.asarray(scene.camera_centers())[reg]
        ply.write_ply_points(
            self.ws / "cloud_and_poses.ply",
            np.asarray(scene.points)[pm], camera_centers=centers,
        )
        ply.write_ply_points(
            self.ws / "colorized.ply",
            np.asarray(scene.points)[pm], np.asarray(scene.colors)[pm],
        )
        ply.write_pcd_points(
            self.ws / "colorized.pcd",
            np.asarray(scene.points)[pm], np.asarray(scene.colors)[pm],
        )
        report = {
            "n_views": int(V),
            "n_registered": int(reg.sum()),
            "n_points": int(pm.sum()),
            "n_obs": int(np.asarray(scene.obs_mask).sum()),
            "mean_reproj_px": float(
                np.asarray(scene.reprojection_errors())[np.asarray(scene.obs_mask)].mean()
            ) if np.asarray(scene.obs_mask).any() else None,
            "elapsed_s": round(time.time() - t0, 2),
            "engine_log": engine.log,
            "geo": geo_info,
        }
        # Interactive inspection artifact (parity: WorldStructure::show,
        # src/world/WorldStructure.h:108-155) — self-contained WebGL page,
        # opens offline and is served at /files/viewer.html.
        from ..io import viewer as viewer_mod

        try:
            viewer_mod.write_scene_viewer(self.ws / "viewer.html", scene)
        except Exception as e:
            self.progress("sparse", 1.0, warning=f"viewer write failed: {e}")
        (self.ws / "report.json").write_text(json.dumps(report, indent=2))
        reports.write_html_report(
            self.ws / "report.html", report,
            [str(self.ws / "putative_matches.svg"), str(self.ws / "geometric_matches.svg")],
        )
        self.progress("done", 1.0, n_points=report["n_points"])
        return scene, report

    def load_scene(self):
        return scene_mod.load_scene_npz(str(self.ws / "scene.npz"))

    # -- stage 3/4: dense + mesh -------------------------------------------

    def dense(self):
        """~ denseWork() (main.cpp:148-166): depth maps + fused cloud."""
        from ..dense import depth as dense_depth

        scene = self.load_scene()
        paths = im_io.list_images(self.image_dir())
        images = im_io.load_images_gray(paths)
        rgb = im_io.load_images_rgb(paths)
        # Undistort to ideal pinhole before MVS, like the reference's
        # `openMVG2openMVS -d undistorted_images` export (main.cpp:157-158).
        intr_np = np.asarray(scene.intr)
        if np.abs(intr_np[:, 4:7]).max() > 1e-12:
            import jax.numpy as jnp

            from ..ops.image import undistort_image

            und_dir = self.ws / "undistorted_images"
            und_dir.mkdir(exist_ok=True)
            und = jax.jit(undistort_image)
            g_list, c_list = [], []
            for i in range(len(images)):
                it = jnp.asarray(intr_np[min(i, len(intr_np) - 1)])
                g_list.append(np.asarray(und(jnp.asarray(images[i]), it)))
                cu = np.asarray(und(jnp.asarray(rgb[i], jnp.float32), it))
                c_list.append(np.clip(cu, 0, 255).astype(np.uint8))
                # Written as PNG whatever the input format, so no image
                # library is needed.
                im_io.write_png(und_dir / (paths[i].stem + ".png"), c_list[-1])
            images = np.stack(g_list)
            rgb = np.stack(c_list)
            intr_np = intr_np.copy()
            intr_np[:, 4:7] = 0.0
            scene = scene.replace(intr=jnp.asarray(intr_np))
        pts, cols, maps = dense_depth.dense_reconstruct(
            scene, images, rgb, cfg=self.cfg.dense, progress=self.progress,
            return_maps=True, mesh=sp.get_mesh(self.cfg),
        )
        ply.write_ply_points(self.ws / "dense.ply", pts, cols)
        np.savez_compressed(self.ws / "depth_maps.npz", **maps)
        # Refresh the viewer with the dense cloud.
        from ..io import viewer as viewer_mod
        from ..core import lie as lie_mod

        try:
            reg_m = np.asarray(scene.cam_mask)
            viewer_mod.write_viewer_html(
                self.ws / "viewer.html", pts, cols,
                cam_rotations=np.asarray(lie_mod.so3_exp(scene.cam_rot))[reg_m],
                cam_centers=np.asarray(scene.camera_centers())[reg_m],
                title="tpusfm dense reconstruction")
        except Exception as e:
            self.progress("dense", 1.0, warning=f"viewer write failed: {e}")
        self.progress("dense", 1.0, n_points=int(len(pts)))
        return pts, cols

    def mesh(self):
        """~ meshWork() (main.cpp:168-193): TSDF + marching tetrahedra from
        the dense stage's depth maps (falls back to the point cloud)."""
        from ..dense import meshing

        paths = im_io.list_images(self.image_dir())
        rgb = im_io.load_images_rgb(paths)
        maps_path = self.ws / "depth_maps.npz"
        if maps_path.exists():
            d = np.load(maps_path)
            verts, faces, vcols = meshing.mesh_from_depths(
                d["depths"], d["valid"], d["K"], d["R"], d["t"],
                rgb_images=rgb, progress=self.progress,
            )
            if len(faces):
                # ~ RefineMesh (main.cpp:184-185): depth-fit + Laplacian,
                # then PHOTOMETRIC refinement against the images (the
                # photo-consistency pass OpenMVS RefineMesh performs —
                # vertices line-searched along their normals on multi-view
                # tangent-patch NCC, dense/meshing.refine_mesh_photometric).
                verts = meshing.refine_mesh(
                    verts, faces, d["depths"], d["valid"], d["K"], d["R"], d["t"]
                )
                gray = np.asarray(rgb, np.float32).mean(axis=-1) / 255.0
                verts = meshing.refine_mesh_photometric(
                    verts, faces, gray, d["K"], d["R"], d["t"],
                    d["depths"], d["valid"],
                )
            if len(faces):
                # ~ TextureMesh (main.cpp:188-189): OBJ + MTL + atlas PNG.
                from ..dense import texturing

                texturing.texture_mesh(
                    self.ws, verts, faces, d["depths"], d["valid"],
                    d["K"], d["R"], d["t"], rgb, progress=self.progress,
                )
        else:
            xyz, pc_rgb = ply.read_ply_points(self.ws / "dense.ply")
            verts, faces, vcols = meshing.reconstruct_mesh(
                xyz, pc_rgb, progress=self.progress
            )
        ply.write_ply_mesh(self.ws / "mesh.ply", verts, faces, vcols)
        self.progress("mesh", 1.0, n_faces=int(len(faces)))
        return verts, faces
