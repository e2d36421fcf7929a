"""Mesh texturing: per-face view assignment + texture atlas + OBJ export.

Capability parity with the reference's ``TextureMesh`` stage (OpenMVS,
spawned at src/main.cpp:188-189).  Pipeline:

1. For every face, pick the best source view: visible (depth-consistent at
   the face centroid), most fronto-parallel (normal . view-ray), largest
   projected area.
2. Pack each face's projected triangle into a texture atlas (simple
   shelf packing of per-face axis-aligned patches, padded).
3. Sample the source image into the atlas and emit OBJ + MTL + PNG —
   the standard textured-mesh artifact triple.

Runs host-side (mesh sizes are small next to the image work; the dense
stages that feed it are the device programs)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def face_view_assignment(verts, faces, depths, valid, K, R, t, tol=0.05):
    """Best view per face: visible + most aligned. Returns (V_of_face (F,)
    int32, -1 when no view sees the face)."""
    V = depths.shape[0]
    K = np.broadcast_to(np.asarray(K), (V, 3, 3))
    V, H, W = depths.shape
    centroids = verts[faces].mean(axis=1)  # (F, 3)
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    normals = np.cross(e1, e2)
    nn = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(nn, 1e-12)

    best_score = np.full(len(faces), -np.inf)
    best_view = np.full(len(faces), -1, np.int32)
    for v in range(V):
        Xc = centroids @ R[v].T + t[v]
        z = Xc[:, 2]
        u = Xc[:, 0] / np.maximum(z, 1e-9) * K[v, 0, 0] + K[v, 0, 2]
        w_ = Xc[:, 1] / np.maximum(z, 1e-9) * K[v, 1, 1] + K[v, 1, 2]
        ui = np.round(u).astype(int)
        vi = np.round(w_).astype(int)
        inb = (z > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        d = np.zeros(len(faces))
        d[inb] = depths[v][vi[inb], ui[inb]]
        visible = inb & (d > 0) & (np.abs(d - z) < tol * np.maximum(z, 1e-9))
        # View ray at the centroid (world frame).
        C = -R[v].T @ t[v]
        ray = centroids - C
        ray = ray / np.maximum(np.linalg.norm(ray, axis=1, keepdims=True), 1e-12)
        align = np.abs((normals * ray).sum(axis=1))
        score = np.where(visible, align / np.maximum(z, 1e-9), -np.inf)
        upd = score > best_score
        best_score[upd] = score[upd]
        best_view[upd] = v
    return best_view


def _project(pts, K, R, t):
    Xc = pts @ R.T + t
    z = np.maximum(Xc[:, 2], 1e-9)
    return np.stack([Xc[:, 0] / z * K[0, 0] + K[0, 2], Xc[:, 1] / z * K[1, 1] + K[1, 2]], 1)


def build_atlas(verts, faces, face_view, images, K, R, t,
                atlas_size: int | None = None, pad: int = 1,
                max_atlas: int = 8192):
    """Shelf-pack per-face image patches into one atlas.

    Returns (atlas (A, A, 3) u8, uv (F, 3, 2) per-corner texcoords in [0,1],
    packed_mask (F,)).  Faces without a view get uv = 0 and a gray patch.
    When atlas_size is None it is auto-sized from the measured patch areas."""
    images = np.asarray(images)
    Hh, Ww = images.shape[1:3]
    K_v = np.broadcast_to(np.asarray(K), (len(R), 3, 3))

    # Pass 1: per-face patch rectangles in the chosen view.
    F = len(faces)
    patch_lo = np.zeros((F, 2), int)
    patch_wh = np.zeros((F, 2), int)
    uv_img_all = np.zeros((F, 3, 2), np.float32)
    usable = np.zeros(F, bool)
    for f in range(F):
        v = face_view[f]
        if v < 0:
            continue
        uv_img = _project(verts[faces[f]], K_v[v], R[v], t[v])
        lo = np.maximum(np.floor(uv_img.min(axis=0)).astype(int) - 1, 0)
        hi = np.minimum(np.ceil(uv_img.max(axis=0)).astype(int) + 1, [Ww - 1, Hh - 1])
        w = int(hi[0] - lo[0] + 1)
        h = int(hi[1] - lo[1] + 1)
        if w <= 0 or h <= 0:
            continue
        patch_lo[f] = lo
        patch_wh[f] = (w, h)
        uv_img_all[f] = uv_img
        usable[f] = True

    if atlas_size is None:
        total = ((patch_wh[usable, 0] + pad) * (patch_wh[usable, 1] + pad)).sum()
        A = 256
        while A * A < 1.35 * total and A < max_atlas:  # shelf waste margin
            A *= 2
    else:
        A = atlas_size
    atlas = np.full((A, A, 3), 128, np.uint8)
    uv_out = np.zeros((F, 3, 2), np.float32)
    ok = np.zeros(F, bool)

    # Pass 2: shelf packing, tallest patches first (classic shelf heuristic).
    order = np.argsort(-patch_wh[:, 1])
    shelf_x, shelf_y, shelf_h = 0, 0, 0
    for f in order:
        if not usable[f]:
            continue
        w, h = int(patch_wh[f, 0]), int(patch_wh[f, 1])
        if w > A or h > A:
            continue
        if shelf_x + w + pad > A:
            shelf_y += shelf_h + pad
            shelf_x, shelf_h = 0, 0
        if shelf_y + h + pad > A:
            continue  # atlas full; face stays untextured
        lo = patch_lo[f]
        v = face_view[f]
        patch = images[v, lo[1] : lo[1] + h, lo[0] : lo[0] + w]
        if patch.ndim == 2:
            patch = np.repeat(patch[..., None], 3, -1)
        atlas[shelf_y : shelf_y + h, shelf_x : shelf_x + w] = patch
        rel = uv_img_all[f] - lo  # (3, 2) in patch pixels
        au = (shelf_x + rel[:, 0]) / A
        av = (shelf_y + rel[:, 1]) / A
        uv_out[f] = np.stack([au, 1.0 - av], axis=1)  # OBJ v-up
        ok[f] = True
        shelf_x += w + pad
        shelf_h = max(shelf_h, h)
    return atlas, uv_out, ok


def write_textured_obj(out_dir, name, verts, faces, uv, atlas):
    """OBJ + MTL + PNG triple."""
    from ..io.images import write_png

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_png(out / f"{name}.png", atlas)
    (out / f"{name}.mtl").write_text(
        f"newmtl textured\nKa 1 1 1\nKd 1 1 1\nmap_Kd {name}.png\n"
    )
    lines = [f"mtllib {name}.mtl", "usemtl textured"]
    for p in verts:
        lines.append(f"v {p[0]} {p[1]} {p[2]}")
    for f_idx, f in enumerate(faces):
        for k in range(3):
            u, v = uv[f_idx, k]
            lines.append(f"vt {u} {v}")
    for f_idx, f in enumerate(faces):
        t0 = 3 * f_idx + 1
        lines.append(
            f"f {f[0]+1}/{t0} {f[1]+1}/{t0+1} {f[2]+1}/{t0+2}"
        )
    (out / f"{name}.obj").write_text("\n".join(lines) + "\n")
    return out / f"{name}.obj"


def texture_mesh(out_dir, verts, faces, depths, valid, K, R, t, rgb_images,
                 atlas_size: int | None = None, name: str = "textured_mesh",
                 progress=None):
    """Full texturing stage -> path of the OBJ."""
    progress = progress or (lambda *a, **k: None)
    depths = np.asarray(depths) * np.asarray(valid)
    fv = face_view_assignment(verts, faces, depths, valid, K, R, t)
    progress("texture", 0.4)
    atlas, uv, ok = build_atlas(verts, faces, fv, rgb_images, K, R, t, atlas_size)
    progress("texture", 0.8)
    path = write_textured_obj(out_dir, name, verts, faces, uv, atlas)
    progress("texture", 1.0, n_textured=int(ok.sum()), n_faces=int(len(faces)))
    return path, ok
