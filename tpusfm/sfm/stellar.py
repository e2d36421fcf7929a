"""Stellar structure-from-motion: pod-scale fusion of two-view geometries.

Capability parity with the reference's STELLAR engine option
(ESfMEngine::STELLAR wired at src/sparseBuilder/sparseBuilder.cpp:195-200,
1537-1560 — OpenMVG's SfMSceneInitializerStellar + stellar solver, which
groups relative motions into "stellar pods" around each view, makes their
translation scales consistent, then fuses globally).

Batched design: instead of per-pod sequential bundle adjustments, the
scale-consistency structure is a single sparse linear problem solved as an
array program —

1. Two-view relative poses (and their unit-baseline triangulated depths)
   come from the same batched essential-RANSAC kernel the other engines
   use — one vmapped dispatch per pair chunk.
2. **Pod scale links**: for every pod (a view v and its incident edges),
   any two edges (v,i), (v,j) that share tracks give a robust relative
   scale: a track's true depth Z in view v equals z_e * s_e for each
   edge's unit-baseline depth z_e, so  log s_e1 - log s_e2 =
   median(log z2 - log z1).  Every link is one row of a sparse
   difference system.
3. **Global edge-scale solve**: the log-scale consistency system
   (edges = unknowns, pod links = rows, one edge anchored) is solved
   matrix-free with CG over segment-sums — the same gather/psum pattern
   as the distributed BA, so it shards over the mesh unchanged.
4. Rotation averaging identical to the global engine.
5. **Scaled translation registration**: with per-edge baselines known up
   to one global factor, camera centers minimize
   sum_e w_e |C_j - C_i - s_e d_e|^2 — a plain graph Laplacian solved by
   CG, much better conditioned than direction-only cross-product
   averaging (no collapsing-scale null directions beyond the gauge).
6. Structure + BA tail shared with the global engine.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .global_sfm import GlobalEngine, GlobalConfig, rotation_averaging
from .scene import Scene


@partial(jax.jit, static_argnames=("n_edges", "cg_iters"))
def edge_scale_solve(link_a, link_b, rhs, w, n_edges: int, cg_iters: int = 100):
    """Least-squares log-scales: minimize sum_l w_l (s_a - s_b - rhs_l)^2
    with mean(s) = 0 (global scale gauge).  Matrix-free CG via segment sums.
    link_a/b (L,) int32 edge indices, rhs (L,).  Returns log-scales (E,)."""

    # Edges that appear in no link are unconstrained: pin them to log-scale
    # 0 (scale 1) instead of leaving near-null directions that float32 CG
    # amplifies into overflow.
    linked = jnp.zeros((n_edges,), bool).at[link_a].set(True).at[link_b].set(True)
    free = linked.astype(jnp.float32)

    def AtA(s):
        s = s * free
        d = s[link_a] - s[link_b]
        u = w * d
        out = jax.ops.segment_sum(u, link_a, n_edges)
        out -= jax.ops.segment_sum(u, link_b, n_edges)
        # Mean gauge as a soft penalty keeps the system full-rank per
        # connected component; pinned edges get an identity row.
        return (out + 1e-3 * jnp.mean(s) + 1e-5 * s) * free + (1.0 - free) * s

    b = jax.ops.segment_sum(w * rhs, link_a, n_edges)
    b -= jax.ops.segment_sum(w * rhs, link_b, n_edges)
    b = b * free

    x = jnp.zeros((n_edges,))
    r = b - AtA(x)
    p = r
    rs = jnp.sum(r * r)

    def body(carry):
        x, r, p, rs, it = carry
        Ap = AtA(p)
        alpha = rs / jnp.maximum(jnp.sum(p * Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.sum(r * r)
        p = r + (rs_new / jnp.maximum(rs, 1e-20)) * p
        return x, r, p, rs_new, it + 1

    def cond(carry):
        _, _, _, rs, it = carry
        return (it < cg_iters) & (rs > 1e-16)

    x, *_ = jax.lax.while_loop(cond, body, (x, r, p, rs, 0))
    n_linked = jnp.maximum(jnp.sum(free), 1.0)
    return (x - jnp.sum(x * free) / n_linked) * free


@partial(jax.jit, static_argnames=("n_views", "cg_iters"))
def scaled_translation_solve(edge_i, edge_j, tvec, w, n_views: int,
                             cg_iters: int = 100):
    """Camera centers from scaled relative translations:
    minimize sum_e w_e |C_j - C_i - tvec_e|^2, C_0 = 0 gauge.
    Matrix-free CG on the weighted graph Laplacian.  Returns (V, 3)."""
    free = jnp.ones((n_views, 1)).at[0].set(0.0)

    def L(C):
        d = C[edge_j] - C[edge_i]
        u = w[:, None] * d
        out = jax.ops.segment_sum(u, edge_j, n_views)
        out -= jax.ops.segment_sum(u, edge_i, n_views)
        return out

    b = jax.ops.segment_sum(w[:, None] * tvec, edge_j, n_views)
    b -= jax.ops.segment_sum(w[:, None] * tvec, edge_i, n_views)
    b = b * free

    def mv(v):
        return L(v * free) * free + 1e-8 * v * free

    x = jnp.zeros((n_views, 3))
    r = b
    p = r
    rs = jnp.sum(r * r)

    def body(carry):
        x, r, p, rs, it = carry
        Ap = mv(p)
        alpha = rs / jnp.maximum(jnp.sum(p * Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.sum(r * r)
        p = r + (rs_new / jnp.maximum(rs, 1e-20)) * p
        return x, r, p, rs_new, it + 1

    def cond(carry):
        _, _, _, rs, it = carry
        return (it < cg_iters) & (rs > 1e-14)

    x, *_ = jax.lax.while_loop(cond, body, (x, r, p, rs, 0))
    return x


class StellarEngine(GlobalEngine):
    """Stellar pipeline: pod-consistent scales + scaled translation fusion."""

    MAX_POD_DEGREE = 8  # strongest edges per pod considered for scale links

    def run(self, key=None) -> Scene:
        cfg = self.cfg
        key = jax.random.PRNGKey(0) if key is None else key
        edges, key = self.relative_poses(key, keep_structure=True)
        if not edges:
            raise RuntimeError("stellar SfM: no usable pairs")

        # Largest connected component (same policy as the global engine).
        adj: dict[int, set] = {v: set() for v in range(self.V)}
        for e in edges:
            adj[e[0]].add(e[1])
            adj[e[1]].add(e[0])
        seen: set = set()
        comps = []
        for s0 in range(self.V):
            if s0 in seen or not adj[s0]:
                continue
            stack, comp = [s0], set()
            while stack:
                u = stack.pop()
                if u in comp:
                    continue
                comp.add(u)
                stack.extend(adj[u] - comp)
            seen |= comp
            comps.append(comp)
        comp = max(comps, key=len)
        vids = sorted(comp)
        vmap_ = {v: k for k, v in enumerate(vids)}
        E = [e for e in edges if e[0] in comp and e[1] in comp]
        Ne = len(E)
        Vc = len(vids)

        # ---- pod scale links ------------------------------------------------
        # For each view, intersect the inlier track sets of its strongest
        # incident edges pairwise; each intersection yields one robust
        # log-scale difference.
        incident: dict[int, list[int]] = {v: [] for v in comp}
        for eidx, e in enumerate(E):
            incident[e[0]].append(eidx)
            incident[e[1]].append(eidx)
        link_a, link_b, link_rhs, link_w = [], [], [], []
        for v, eidxs in incident.items():
            eidxs = sorted(eidxs, key=lambda k: -E[k][4])
            # Track -> depth-in-view-v map per edge.
            depth_maps = []
            for k in eidxs:
                i, j, _R, _t, _w, (tr, z_i, z_j) = E[k]
                z = z_i if i == v else z_j
                pos = z > 1e-6
                depth_maps.append(dict(zip(tr[pos].tolist(), z[pos].tolist())))
            # All pairs among the strongest MAX_POD_DEGREE edges, plus a
            # star link from every remaining incident edge to the pod's
            # strongest edge: capping alone can disconnect a view's whole
            # edge cluster from the link graph, letting its scale float
            # (observed as a coherent 40% offset of one view's baselines).
            top = min(len(eidxs), self.MAX_POD_DEGREE)
            pairs = [(a, b) for a in range(top) for b in range(a + 1, top)]
            pairs += [(0, b) for b in range(top, len(eidxs))]
            for a, b in pairs:
                da, db = depth_maps[a], depth_maps[b]
                shared = da.keys() & db.keys()
                if len(shared) < 5:
                    continue
                # Z = z_a s_a = z_b s_b  =>  log s_a - log s_b = log z_b - log z_a
                ratios = [np.log(db[t]) - np.log(da[t]) for t in shared]
                link_a.append(eidxs[a])
                link_b.append(eidxs[b])
                link_rhs.append(float(np.median(ratios)))
                link_w.append(float(len(shared)))
        if not link_a:
            # No pod overlap: fall back to the direction-only global path.
            self.log.append("stellar: no pod scale links; falling back to global")
            return super().run(key)
        self.progress("stellar_pods", 1.0)

        log_s = edge_scale_solve(
            jnp.asarray(link_a, jnp.int32), jnp.asarray(link_b, jnp.int32),
            jnp.asarray(np.asarray(link_rhs, np.float32)),
            jnp.asarray(np.asarray(link_w, np.float32)),
            n_edges=Ne, cg_iters=max(Ne, 50),
        )
        scales = np.exp(np.asarray(log_s, np.float64))
        # Guard: scales are positive multiplicative quantities; an edge that
        # never appeared in a link keeps scale 1 (mean gauge) but carries no
        # scale information — down-weight it in the translation solve.
        scales = np.clip(scales, 1e-3, 1e3).astype(np.float32)
        linked_np = np.zeros(Ne, bool)
        linked_np[np.asarray(link_a)] = True
        linked_np[np.asarray(link_b)] = True

        # ---- rotation averaging (shared with global engine) ----------------
        edge_i = jnp.asarray([vmap_[e[0]] for e in E], dtype=jnp.int32)
        edge_j = jnp.asarray([vmap_[e[1]] for e in E], dtype=jnp.int32)
        R_rel = jnp.asarray(np.stack([e[2] for e in E]).astype(np.float32))
        w_np = np.asarray([e[4] for e in E], np.float32)
        w_np = w_np / w_np.max()
        w = jnp.asarray(w_np)

        R_init = np.tile(np.eye(3, dtype=np.float32), (Vc, 1, 1))
        tree_adj: dict[int, list] = {k: [] for k in range(Vc)}
        for eidx, e in enumerate(E):
            tree_adj[vmap_[e[0]]].append((vmap_[e[1]], eidx, +1))
            tree_adj[vmap_[e[1]]].append((vmap_[e[0]], eidx, -1))
        visited = {0}
        stack = [0]
        R_rel_np = np.asarray(R_rel)
        while stack:
            u = stack.pop()
            for (v2, eidx, sgn) in tree_adj[u]:
                if v2 in visited:
                    continue
                visited.add(v2)
                R_init[v2] = (R_rel_np[eidx] @ R_init[u]) if sgn > 0 else (
                    R_rel_np[eidx].T @ R_init[u]
                )
                stack.append(v2)
        R_glob = rotation_averaging(
            edge_i, edge_j, R_rel, w, jnp.asarray(R_init), Vc, cfg.rot_iters
        )
        self.progress("rotation_averaging", 1.0)

        # ---- scaled translation registration --------------------------------
        # World-frame scaled baselines: C_j - C_i = -s_e * R_j^T t_rel.
        Rg = np.asarray(R_glob)
        tvec = -np.einsum(
            "eji,ej->ei", Rg[np.asarray(edge_j)], np.stack([e[3] for e in E])
        )
        nrm = np.linalg.norm(tvec, axis=1, keepdims=True)
        tvec = tvec / np.maximum(nrm, 1e-12) * scales[:, None]
        # Unlinked edges carry no scale information — exclude them from the
        # center solve unless they are needed for connectivity.
        keep = linked_np.copy()
        cov = set()
        for eidx in np.nonzero(keep)[0]:
            cov.add(E[eidx][0])
            cov.add(E[eidx][1])
        for eidx in np.nonzero(~keep)[0]:
            if E[eidx][0] not in cov or E[eidx][1] not in cov:
                keep[eidx] = True
                cov.add(E[eidx][0])
                cov.add(E[eidx][1])
        w_t = jnp.asarray(np.where(keep, w_np, 0.0).astype(np.float32))
        centers = scaled_translation_solve(
            edge_i, edge_j, jnp.asarray(tvec.astype(np.float32)), w_t,
            n_views=Vc, cg_iters=max(3 * Vc, 100),
        )
        self.progress("translation_averaging", 1.0)

        return self._install_and_finish(vids, Rg, np.asarray(centers))
