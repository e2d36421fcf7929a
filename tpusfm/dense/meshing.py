"""Surface meshing: TSDF fusion of depth maps + marching tetrahedra.

Capability parity with the reference's mesh stage, which shells out to
OpenMVS ``ReconstructMesh`` / ``RefineMesh`` / ``TextureMesh``
(src/main.cpp:180-189).  The pipeline here fuses the dense stage's
verified depth maps into a truncated signed distance field — a dense
(G, G, G) array program that batches over views — and extracts the
isosurface with marching *tetrahedra* (table-free, vectorizable, no
external geometry dependency), then colors vertices from the images.

Mesh refinement (photometric) is a later-round item; vertex colors stand in
for texturing (the artifact contract keeps mesh.ply in the workspace like
the reference's output_dense_mesh.ply chain).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    grid: int = 128            # voxels per axis
    trunc_voxels: float = 3.0  # truncation distance in voxel units
    min_weight: float = 1.0    # min observations per voxel
    bounds_margin: float = 0.05


# ---------------------------------------------------------------------------
# TSDF fusion (JAX)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("grid",))
def tsdf_fuse(
    depths: jnp.ndarray,   # (V, H, W), 0 = invalid
    K: jnp.ndarray,        # (V, 3, 3) per-view intrinsics, or (3, 3) shared
    R: jnp.ndarray,        # (V, 3, 3) world->cam
    t: jnp.ndarray,        # (V, 3)
    origin: jnp.ndarray,   # (3,) grid origin (world)
    voxel: jnp.ndarray,    # () voxel size
    trunc: jnp.ndarray,    # () truncation distance (world units)
    grid: int = 128,
):
    """Returns (tsdf (G,G,G), weight (G,G,G))."""
    V, H, W = depths.shape
    if K.ndim == 2:
        K = jnp.broadcast_to(K, (V, 3, 3))
    g = jnp.arange(grid, dtype=jnp.float32)
    gx, gy, gz = jnp.meshgrid(g, g, g, indexing="ij")
    pts = origin[None, :] + voxel * jnp.stack([gx, gy, gz], -1).reshape(-1, 3)  # (N,3)

    def per_view(carry, vi):
        tsdf, wsum = carry
        Xc = pts @ R[vi].T + t[vi]
        z = Xc[:, 2]
        uv = Xc @ K[vi].T
        u = uv[:, 0] / jnp.where(jnp.abs(uv[:, 2]) < 1e-6, 1e-6, uv[:, 2])
        v = uv[:, 1] / jnp.where(jnp.abs(uv[:, 2]) < 1e-6, 1e-6, uv[:, 2])
        inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 1e-3)
        ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, W - 1)
        viy = jnp.clip(jnp.round(v).astype(jnp.int32), 0, H - 1)
        d = depths[vi][viy, ui]
        sdf = d - z  # positive in front of the surface
        valid = inb & (d > 0) & (sdf > -trunc)
        tval = jnp.clip(sdf / trunc, -1.0, 1.0)
        w = valid.astype(jnp.float32)
        return (tsdf + w * tval, wsum + w), None

    init = (jnp.zeros(grid ** 3, jnp.float32), jnp.zeros(grid ** 3, jnp.float32))
    (tsdf, wsum), _ = jax.lax.scan(per_view, init, jnp.arange(V))
    tsdf = tsdf / jnp.maximum(wsum, 1e-6)
    return tsdf.reshape(grid, grid, grid), wsum.reshape(grid, grid, grid)


# ---------------------------------------------------------------------------
# Marching tetrahedra (numpy, host-side extraction)
# ---------------------------------------------------------------------------

# Cube corners numbered by coordinate bits; 6-tet decomposition around the
# 0-7 diagonal (consistent, covers the cube).
_CORNERS = np.array([[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)])
_TETS = np.array([
    [0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
    [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7],
])


def _tet_case_table():
    """For each 4-bit inside pattern: list of triangles, each a triple of
    (corner_a, corner_b) edges crossing the surface."""
    table: list[list[tuple]] = []
    for pat in range(16):
        inside = [i for i in range(4) if (pat >> i) & 1]
        outside = [i for i in range(4) if not (pat >> i) & 1]
        tris = []
        if len(inside) == 1:
            i = inside[0]
            e = [(i, j) for j in outside]
            tris = [(e[0], e[1], e[2])]
        elif len(inside) == 3:
            i = outside[0]
            e = [(j, i) for j in inside]
            tris = [(e[0], e[2], e[1])]
        elif len(inside) == 2:
            i, j = inside
            k, l = outside
            e = {(a, b): (a, b) for a, b in [(i, k), (i, l), (j, k), (j, l)]}
            tris = [((i, k), (i, l), (j, k)), ((j, k), (i, l), (j, l))]
        table.append(tris)
    return table


_CASES = _tet_case_table()


def marching_tetrahedra(values: np.ndarray, mask: np.ndarray, origin, voxel, level=0.0):
    """Extract the `level` isosurface of values (G,G,G) where mask is true.
    Returns (verts (N,3) float32, faces (M,3) int32)."""
    G = values.shape[0]
    s = np.asarray(values, np.float32) - level
    ok = np.asarray(mask, bool)

    # Global corner ids for vertex dedup on edges.
    def cid(ix, iy, iz):
        return (ix * G + iy) * G + iz

    base = np.stack(np.meshgrid(np.arange(G - 1), np.arange(G - 1), np.arange(G - 1),
                                indexing="ij"), -1).reshape(-1, 3)  # (C, 3)
    # Cube corner coords (C, 8, 3) and validity.
    cc = base[:, None, :] + _CORNERS[None]
    vals = s[cc[..., 0], cc[..., 1], cc[..., 2]]  # (C, 8)
    okc = ok[cc[..., 0], cc[..., 1], cc[..., 2]].all(axis=1)
    has_cross = (vals.min(1) < 0) & (vals.max(1) > 0) & okc
    cc = cc[has_cross]
    vals = vals[has_cross]
    if len(cc) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    edge_keys = []
    edge_tris = []
    for tet in _TETS:
        tv = vals[:, tet]  # (C, 4)
        tcorn = cc[:, tet]  # (C, 4, 3)
        pattern = ((tv < 0) * (2 ** np.arange(4))[None]).sum(1)  # (C,)
        for pat in range(1, 15):
            rows = np.nonzero(pattern == pat)[0]
            if len(rows) == 0 or not _CASES[pat]:
                continue
            for tri in _CASES[pat]:
                tri_edges = []
                for (a, b) in tri:
                    ca = tcorn[rows, a]  # (R, 3)
                    cb = tcorn[rows, b]
                    va = tv[rows, a]
                    vb = tv[rows, b]
                    frac = np.clip(np.abs(va) / np.maximum(np.abs(va - vb), 1e-12), 0, 1)
                    pos = ca + frac[:, None] * (cb - ca)
                    ida = cid(ca[:, 0], ca[:, 1], ca[:, 2])
                    idb = cid(cb[:, 0], cb[:, 1], cb[:, 2])
                    key = np.minimum(ida, idb) * np.int64(G ** 3) + np.maximum(ida, idb)
                    tri_edges.append((key, pos))
                edge_tris.append(tri_edges)

    # Deduplicate vertices by edge key.
    all_keys = np.concatenate([e[0] for tri in edge_tris for e in tri])
    all_pos = np.concatenate([e[1] for tri in edge_tris for e in tri])
    uniq, inv = np.unique(all_keys, return_inverse=True)
    verts = np.zeros((len(uniq), 3), np.float64)
    verts[inv] = all_pos  # last write wins; positions per edge are identical
    faces = inv.reshape(-1, 3).astype(np.int32)
    # Drop degenerate faces.
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    faces = faces[good]
    verts_world = np.asarray(origin)[None] + np.asarray(voxel) * verts
    return verts_world.astype(np.float32), faces


def color_vertices(verts, rgb_images, depths, K, R, t, tol=0.05):
    """Vertex colors from the nearest depth-consistent view."""
    V, H, W = depths.shape
    K = np.broadcast_to(np.asarray(K), (V, 3, 3))
    colors = np.full((len(verts), 3), 180, np.uint8)
    found = np.zeros(len(verts), bool)
    for v in range(V):
        Xc = verts @ R[v].T + t[v]
        z = Xc[:, 2]
        u = Xc[:, 0] / np.maximum(z, 1e-6) * K[v, 0, 0] + K[v, 0, 2]
        w_ = Xc[:, 1] / np.maximum(z, 1e-6) * K[v, 1, 1] + K[v, 1, 2]
        ui = np.round(u).astype(int)
        vi = np.round(w_).astype(int)
        inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z > 0)
        d = np.zeros(len(verts), np.float32)
        d[inb] = depths[v][vi[inb], ui[inb]]
        vis = inb & (d > 0) & (np.abs(d - z) < tol * np.maximum(z, 1e-6)) & ~found
        colors[vis] = np.asarray(rgb_images)[v, vi[vis], ui[vis]]
        found |= vis
    return colors


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def mesh_from_depths(depths, valid, K, R, t, rgb_images=None,
                     cfg: MeshConfig = MeshConfig(), progress=None):
    """Depth maps (+ validity) -> (verts, faces, vertex_colors)."""
    progress = progress or (lambda *a, **k: None)
    depths = np.asarray(depths) * np.asarray(valid)
    # Bounds from backprojected valid depths (subsampled).
    V, H, W = depths.shape
    K = np.broadcast_to(np.asarray(K), (V, 3, 3))
    pts = []
    Kinv = np.linalg.inv(K)
    for v in range(V):
        ys, xs = np.nonzero(depths[v][::4, ::4] > 0)
        if not len(ys):
            continue
        d = depths[v][ys * 4, xs * 4]
        pix = np.stack([xs * 4, ys * 4, np.ones_like(xs)], 0).astype(np.float64)
        Xc = Kinv[v] @ pix * d[None]
        pts.append((R[v].T @ (Xc - t[v][:, None])).T)
    if not pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), None
    pts = np.concatenate(pts)
    lo = np.percentile(pts, 1, axis=0)
    hi = np.percentile(pts, 99, axis=0)
    span = float((hi - lo).max()) * (1 + cfg.bounds_margin)
    center = (lo + hi) / 2
    origin = center - span / 2
    voxel = span / (cfg.grid - 1)
    trunc = cfg.trunc_voxels * voxel
    progress("mesh", 0.2)

    tsdf, weight = tsdf_fuse(
        jnp.asarray(depths), jnp.asarray(np.asarray(K, np.float32)),
        jnp.asarray(np.asarray(R, np.float32)), jnp.asarray(np.asarray(t, np.float32)),
        jnp.asarray(origin.astype(np.float32)), jnp.float32(voxel), jnp.float32(trunc),
        cfg.grid,
    )
    progress("mesh", 0.5)
    verts, faces = marching_tetrahedra(
        np.asarray(tsdf), np.asarray(weight) >= cfg.min_weight, origin, voxel
    )
    progress("mesh", 0.8)
    colors = None
    if rgb_images is not None and len(verts):
        colors = color_vertices(verts, rgb_images, depths, K, R, t)
    return verts, faces, colors


def refine_mesh(verts, faces, depths, valid, K, R, t, iters: int = 10,
                step: float = 0.5, smooth: float = 0.3, tol: float = 0.08):
    """Mesh refinement against the depth maps (parity-lite with OpenMVS
    ``RefineMesh``, main.cpp:184-185): each iteration pulls every vertex
    along its viewing rays toward the median observed depth in the views
    that see it (depth-consistent only), then applies umbrella Laplacian
    smoothing.  Numpy host-side (meshes are small next to the image work).

    Returns refined verts (V, 3)."""
    verts = np.asarray(verts, np.float64).copy()
    faces = np.asarray(faces)
    depths = np.asarray(depths) * np.asarray(valid)
    Vn, Hh, Ww = depths.shape
    K = np.broadcast_to(np.asarray(K), (Vn, 3, 3))

    # Vertex adjacency (umbrella operator) from face edges.
    nbr_sum_idx = np.concatenate([
        faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]],
        faces[:, [1, 0]], faces[:, [2, 1]], faces[:, [0, 2]],
    ])
    for _ in range(iters):
        # Data term: move toward observed depths.
        target = np.zeros_like(verts)
        weight = np.zeros(len(verts))
        for v in range(Vn):
            C = -R[v].T @ t[v]
            Xc = verts @ R[v].T + t[v]
            z = Xc[:, 2]
            u = Xc[:, 0] / np.maximum(z, 1e-9) * K[v, 0, 0] + K[v, 0, 2]
            w_ = Xc[:, 1] / np.maximum(z, 1e-9) * K[v, 1, 1] + K[v, 1, 2]
            ui = np.round(u).astype(int)
            vi = np.round(w_).astype(int)
            inb = (z > 0) & (ui >= 0) & (ui < Ww) & (vi >= 0) & (vi < Hh)
            d = np.zeros(len(verts))
            d[inb] = depths[v][vi[inb], ui[inb]]
            ok = inb & (d > 0) & (np.abs(d - z) < tol * np.maximum(z, 1e-9))
            # Move along the ray to the observed depth.
            ray = verts - C
            scale = np.ones(len(verts))
            scale[ok] = d[ok] / np.maximum(z[ok], 1e-9)
            tgt = C + ray * scale[:, None]
            target[ok] += tgt[ok]
            weight[ok] += 1.0
        has = weight > 0
        data_pt = np.where(has[:, None], target / np.maximum(weight[:, None], 1), verts)
        verts = verts + step * (data_pt - verts)
        # Smoothness: umbrella Laplacian.
        nb_sum = np.zeros_like(verts)
        nb_cnt = np.zeros(len(verts))
        np.add.at(nb_sum, nbr_sum_idx[:, 0], verts[nbr_sum_idx[:, 1]])
        np.add.at(nb_cnt, nbr_sum_idx[:, 0], 1.0)
        mean_nb = nb_sum / np.maximum(nb_cnt[:, None], 1)
        verts = verts + smooth * (mean_nb - verts) * (nb_cnt > 0)[:, None]
    return verts.astype(np.float32)


@partial(jax.jit, static_argnames=("n_steps",))
def _photo_sweep(X, nrm, tan1, tan2, vidx, vweight, images, Ks, Rs, ts,
                 step_scale, patch_scale, n_steps: int):
    """Photoconsistency line search along vertex normals (jitted core of
    refine_mesh_photometric).

    For each vertex and each of n_steps displacements s along its normal, a
    3x3 tangent-plane patch (world spacing patch_scale) is projected into
    the vertex's M selected views, bilinearly sampled, per-view normalized,
    and scored by mean pairwise NCC.  Returns (best_s (N,), best_cost (N,),
    n_valid_views (N,)) with parabolic sub-step refinement."""
    N = X.shape[0]
    M = vidx.shape[1]
    V, H, W = images.shape
    ab = jnp.asarray([(a, b) for a in (-1.0, 0.0, 1.0) for b in (-1.0, 0.0, 1.0)],
                     jnp.float32)  # (9, 2)
    steps = (jnp.arange(n_steps, dtype=jnp.float32) - (n_steps - 1) / 2) \
        * (2.0 / max(n_steps - 1, 1)) * step_scale  # (S,) in [-h, h]

    Kv = Ks[vidx]      # (N, M, 3, 3)
    Rv = Rs[vidx]      # (N, M, 3, 3)
    tv = ts[vidx]      # (N, M, 3)

    def cost_at(s):
        Xs = X + s * nrm  # (N, 3)
        P = (Xs[:, None, :] + patch_scale
             * (ab[None, :, 0:1] * tan1[:, None, :]
                + ab[None, :, 1:2] * tan2[:, None, :]))  # (N, 9, 3)
        Xc = jnp.einsum("nmij,npj->nmpi", Rv, P) + tv[:, :, None, :]  # (N,M,9,3)
        z = Xc[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        u = Xc[..., 0] / zs * Kv[:, :, None, 0, 0] + Kv[:, :, None, 0, 2]
        v = Xc[..., 1] / zs * Kv[:, :, None, 1, 1] + Kv[:, :, None, 1, 2]
        inb = ((u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
               & (z > 1e-3)).all(axis=2)  # (N, M) whole patch in bounds
        yi = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, H - 2)
        xi = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, W - 2)
        fy = jnp.clip(v - yi, 0.0, 1.0)
        fx = jnp.clip(u - xi, 0.0, 1.0)

        def g(dy, dx):
            return images[vidx[:, :, None], yi + dy, xi + dx]  # (N, M, 9)

        patch = (g(0, 0) * (1 - fy) * (1 - fx) + g(0, 1) * (1 - fy) * fx
                 + g(1, 0) * fy * (1 - fx) + g(1, 1) * fy * fx)  # (N, M, 9)
        ok = inb.astype(jnp.float32) * vweight  # (N, M)
        mu = patch.mean(axis=2, keepdims=True)
        pz = patch - mu
        sig = jnp.sqrt(jnp.maximum((pz * pz).mean(axis=2), 1e-8))
        pn = pz / jnp.maximum(sig[..., None], 1e-4)  # unit-ish patches
        pn = pn * ok[..., None]
        m_eff = jnp.sum(ok, axis=1)  # (N,)
        # Mean pairwise correlation: (|sum_m p|^2 - sum_m |p|^2) / (9 m(m-1))
        ssum = jnp.sum(pn, axis=1)  # (N, 9)
        tot = jnp.sum(ssum * ssum, axis=1)
        per = jnp.sum(pn * pn, axis=(1, 2))
        denom = jnp.maximum(m_eff * (m_eff - 1.0), 1e-6) * 9.0
        ncc = (tot - per) / denom
        valid = m_eff >= 2.0
        return jnp.where(valid, 1.0 - jnp.clip(ncc, -1.0, 1.0), 2.0), m_eff

    costs, m_eff = jax.lax.map(lambda s: cost_at(s), steps)  # (S, N)
    m_eff = m_eff[0]
    best = jnp.argmin(costs, axis=0)
    bm = jnp.clip(best, 1, n_steps - 2)
    c0 = jnp.take_along_axis(costs, (bm - 1)[None], axis=0)[0]
    c1 = jnp.take_along_axis(costs, bm[None], axis=0)[0]
    c2 = jnp.take_along_axis(costs, (bm + 1)[None], axis=0)[0]
    den = c0 - 2 * c1 + c2
    delta = jnp.where(jnp.abs(den) > 1e-9, 0.5 * (c0 - c2) / den, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    ds = steps[1] - steps[0]
    s_star = steps[bm] + delta * ds
    best_cost = jnp.min(costs, axis=0)
    return s_star, best_cost, m_eff


def refine_mesh_photometric(verts, faces, images, K, R, t, depths, valid,
                            iters: int = 4, n_steps: int = 9,
                            step_frac: float = 1.5, patch_frac: float = 2.0,
                            smooth: float = 0.25, tol: float = 0.08,
                            max_cost: float = 0.7, n_views: int = 4):
    """Photometric mesh refinement (OpenMVS ``RefineMesh`` parity — the
    photo-consistency pass the reference spawns at src/main.cpp:184-185,
    which the round-2 depth-fit refiner lacked).

    Each iteration: (1) vertex normals + tangent frames from the faces,
    (2) per-vertex visibility from the depth maps (depth-consistent views
    only, like refine_mesh), (3) a jitted line search along each vertex
    normal maximizing mean pairwise NCC of a 3x3 tangent-plane patch
    across the vertex's views (_photo_sweep), (4) umbrella Laplacian
    smoothing.  Search extent and patch spacing scale with the local mean
    edge length (step_frac / patch_frac edge lengths).

    Returns refined verts (Nv, 3) float32."""
    verts = np.asarray(verts, np.float64).copy()
    faces = np.asarray(faces)
    if len(verts) == 0 or len(faces) == 0:
        return verts.astype(np.float32)
    images = np.asarray(images, np.float32)
    depths = np.asarray(depths) * np.asarray(valid)
    Vn, Hh, Ww = depths.shape
    K = np.broadcast_to(np.asarray(K, np.float32), (Vn, 3, 3))
    R = np.asarray(R, np.float32)
    t = np.asarray(t, np.float32)

    nbr_sum_idx = np.concatenate([
        faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]],
        faces[:, [1, 0]], faces[:, [2, 1]], faces[:, [0, 2]],
    ])
    edge_len = float(np.median(np.linalg.norm(
        verts[faces[:, 0]] - verts[faces[:, 1]], axis=1)))

    for _ in range(iters):
        # Vertex normals (area-weighted face normals).  Marching-tetrahedra
        # windings are UNORIENTED (measured ~50/50 on the synthetic room),
        # so unoriented face normals cancel in the vertex sum and the line
        # search runs along a near-random axis — orient every face normal
        # toward the nearest camera center first.
        fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                      verts[faces[:, 2]] - verts[faces[:, 0]])
        centers_all = -np.einsum("vji,vj->vi", R, t)  # camera centers
        fcen = verts[faces].mean(axis=1)
        d2 = ((fcen[:, None, :] - centers_all[None, :, :]) ** 2).sum(-1)
        near = centers_all[np.argmin(d2, axis=1)]
        flip = np.sum(fn * (near - fcen), axis=1) < 0
        fn[flip] *= -1.0
        vn = np.zeros_like(verts)
        for k in range(3):
            np.add.at(vn, faces[:, k], fn)
        nl = np.linalg.norm(vn, axis=1, keepdims=True)
        vn = vn / np.maximum(nl, 1e-12)
        # Tangent frame.
        ref = np.where(np.abs(vn[:, 2:3]) < 0.9,
                       np.array([0.0, 0, 1]), np.array([1.0, 0, 0]))
        t1 = np.cross(vn, ref)
        t1 /= np.maximum(np.linalg.norm(t1, axis=1, keepdims=True), 1e-12)
        t2 = np.cross(vn, t1)

        # Visibility: depth-consistent views per vertex, strongest n_views.
        vis_w = np.zeros((len(verts), Vn), np.float32)
        for v in range(Vn):
            Xc = verts @ R[v].T + t[v]
            z = Xc[:, 2]
            u = Xc[:, 0] / np.maximum(z, 1e-9) * K[v, 0, 0] + K[v, 0, 2]
            w_ = Xc[:, 1] / np.maximum(z, 1e-9) * K[v, 1, 1] + K[v, 1, 2]
            ui = np.round(u).astype(int)
            vi = np.round(w_).astype(int)
            inb = (z > 0) & (ui >= 0) & (ui < Ww) & (vi >= 0) & (vi < Hh)
            d = np.zeros(len(verts))
            d[inb] = depths[v][vi[inb], ui[inb]]
            ok = inb & (d > 0) & (np.abs(d - z) < tol * np.maximum(z, 1e-9))
            vis_w[ok, v] = 1.0
        order = np.argsort(-vis_w, axis=1)[:, :n_views]
        vidx = order.astype(np.int32)
        vweight = np.take_along_axis(vis_w, order, axis=1)

        s_star, best_cost, m_eff = jax.device_get(_photo_sweep(
            jnp.asarray(verts, jnp.float32), jnp.asarray(vn, jnp.float32),
            jnp.asarray(t1, jnp.float32), jnp.asarray(t2, jnp.float32),
            jnp.asarray(vidx), jnp.asarray(vweight),
            jnp.asarray(images), jnp.asarray(K), jnp.asarray(R),
            jnp.asarray(t), jnp.float32(step_frac * edge_len),
            jnp.float32(patch_frac * edge_len), n_steps))
        move = (m_eff >= 2.0) & (best_cost < max_cost)
        verts = verts + np.where(move[:, None], s_star[:, None] * vn, 0.0)

        # Umbrella Laplacian smoothing.
        nb_sum = np.zeros_like(verts)
        nb_cnt = np.zeros(len(verts))
        np.add.at(nb_sum, nbr_sum_idx[:, 0], verts[nbr_sum_idx[:, 1]])
        np.add.at(nb_cnt, nbr_sum_idx[:, 0], 1.0)
        mean_nb = nb_sum / np.maximum(nb_cnt[:, None], 1)
        verts = verts + smooth * (mean_nb - verts) * (nb_cnt > 0)[:, None]
    return verts.astype(np.float32)


def reconstruct_mesh(xyz, rgb, cfg: MeshConfig = MeshConfig(), progress=None):
    """Fallback meshing straight from a fused point cloud (no depth maps):
    point-splat occupancy -> pseudo-SDF -> marching tetrahedra.  Used when
    only dense.ply is available (the staged pipeline prefers depth maps)."""
    progress = progress or (lambda *a, **k: None)
    xyz = np.asarray(xyz, np.float64)
    if len(xyz) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), None
    lo = np.percentile(xyz, 1, axis=0)
    hi = np.percentile(xyz, 99, axis=0)
    span = float((hi - lo).max()) * (1 + cfg.bounds_margin)
    center = (lo + hi) / 2
    origin = center - span / 2
    G = cfg.grid
    voxel = span / (G - 1)
    idx = np.clip(np.round((xyz - origin) / voxel), 0, G - 1).astype(np.int64)
    occ = np.zeros((G, G, G), np.float32)
    np.add.at(occ, (idx[:, 0], idx[:, 1], idx[:, 2]), 1.0)
    progress("mesh", 0.3)
    # Pseudo-SDF: smoothed occupancy, iso-level at a small density.
    from scipy.ndimage import gaussian_filter

    dens = gaussian_filter(occ, 1.2)
    level = max(float(np.percentile(dens[dens > 0], 55)), 1e-4)
    sdf = level - dens  # negative inside
    progress("mesh", 0.5)
    verts, faces = marching_tetrahedra(sdf, np.ones_like(sdf, bool), origin, voxel)
    progress("mesh", 0.9)
    colors = None
    if rgb is not None and len(verts):
        # Nearest input point's color.
        from scipy.spatial import cKDTree

        _, nn = cKDTree(xyz).query(verts, k=1)
        colors = np.asarray(rgb)[nn]
    return verts, faces, colors
