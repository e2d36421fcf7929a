"""Global structure-from-motion: rotation averaging + translation averaging.

Capability parity with the reference's GLOBAL engine option
(ESfMEngine::GLOBAL wired at src/sparseBuilder/sparseBuilder.cpp:195-200,
1516-1535 — OpenMVG's GlobalSfMReconstructionEngine with rotation/
translation averaging), built as batched array programs:

1. Pairwise relative poses come from the same batched essential-RANSAC
   kernel the incremental bootstrap uses (one vmapped dispatch per pair
   chunk).
2. Rotation averaging is a vectorized Jacobi relaxation: every iteration
   gathers neighbor estimates R_rel^T R_j / R_rel R_i over the edge table,
   segment-sums them per node, and projects back onto SO(3) with batched
   SVD — all nodes update in parallel (no sequential spanning-tree walk
   after initialization).
3. Translation averaging minimizes the cross-product consistency
   || [d_ij]_x (C_j - C_i) ||^2 over camera centers with two anchored
   cameras (gauge + scale), solved matrix-free with CG over the edge
   table — the same gather/segment-sum pattern as the distributed BA.
4. Structure: triangulate every track against the global poses, wash
   outliers, and run one global bundle adjustment.

The pair-relative-pose stage and the averaging iterations are O(edges)
array programs, so the engine shards over the mesh the same way matching
and BA do.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ba import bundle_adjust as ba
from ..core import lie
from . import incremental as inc_mod
from .scene import Scene


@dataclasses.dataclass(frozen=True)
class GlobalConfig:
    ransac_iters: int = 256
    min_pair_inliers: int = 30
    # Pairs whose median inlier parallax is below this carry no usable
    # translation direction (rotation-dominant / planar-far regime).
    min_pair_parallax_deg: float = 0.5
    essential_thresh_px: float = 4.0
    rot_iters: int = 40
    trans_cg_iters: int = 100
    reproj_outlier_px: float = 4.0
    min_tri_angle_deg: float = 1.5
    max_views_per_track: int = 8
    ba_iters: int = 30
    pair_chunk: int = 32


# ---------------------------------------------------------------------------
# Rotation averaging
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_views", "iters"))
def rotation_averaging(edge_i, edge_j, R_rel, w, R_init, n_views: int, iters: int):
    """Jacobi relaxation of sum_e w_e |R_j - R_rel R_i|_F^2.

    edge_i/j (E,) int32, R_rel (E, 3, 3) with R_j ~ R_rel R_i, w (E,),
    R_init (V, 3, 3).  Returns (V, 3, 3)."""

    def body(_, R):
        # Estimate of R_i from each edge: R_rel^T R_j; of R_j: R_rel R_i.
        est_i = jnp.einsum("eji,ejk->eik", R_rel, R[edge_j])  # R_rel^T R_j
        est_j = jnp.einsum("eij,ejk->eik", R_rel, R[edge_i])  # R_rel R_i
        acc = jax.ops.segment_sum(est_i * w[:, None, None], edge_i, n_views)
        acc += jax.ops.segment_sum(est_j * w[:, None, None], edge_j, n_views)
        # Keep inertia for poorly connected nodes.
        acc += 1e-3 * R
        U, _, Vt = jnp.linalg.svd(acc)
        det = jnp.linalg.det(jnp.einsum("vij,vjk->vik", U, Vt))
        D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
        R_new = jnp.einsum("vij,vj,vjk->vik", U, D, Vt)
        return R_new

    R = jax.lax.fori_loop(0, iters, body, R_init)
    # Gauge: express everything relative to view 0 (R_0 = I).
    return jnp.einsum("vij,kj->vik", R, R[0])


# ---------------------------------------------------------------------------
# Translation averaging
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_views", "cg_iters", "irls_iters"))
def translation_averaging(edge_i, edge_j, dirs, w, anchor_j: jnp.ndarray,
                          n_views: int, cg_iters: int, irls_iters: int = 1):
    """Camera centers from pairwise directions d_ij ~ (C_j - C_i)/|.|.

    Minimizes sum_e w_e |[d]_x (C_j - C_i)|^2 with C_0 = 0 (gauge) and
    C_{anchor_j} = d_{0,anchor} (scale), then re-solves with
    cheirality-flipped edges (solved displacement anti-parallel to the
    measured direction — e.g. a wrong-sign E decomposition) removed.
    Soft Cauchy-style IRLS was measured to HURT here: on short-baseline
    chain graphs the direction errors are small but correlated (they come
    from the shared rotation-averaging solution), so down-weighting the
    tail just un-stiffens the chain; only outright flips are worth
    rejecting.  Matrix-free CG per round.  Returns (V, 3)."""
    Dx = lie.hat(dirs)  # (E, 3, 3)
    DtD = jnp.einsum("eji,ejk->eik", Dx, Dx)  # [d]x^T [d]x

    fixed_mask = jnp.zeros((n_views,), bool).at[0].set(True)
    fixed_mask = fixed_mask.at[anchor_j].set(True)
    free = (~fixed_mask).astype(jnp.float32)[:, None]

    C_fixed = jnp.zeros((n_views, 3))
    anchor_dir = jnp.sum(
        jnp.where(((edge_i == 0) & (edge_j == anchor_j))[:, None], dirs, 0.0), axis=0
    )
    C_fixed = C_fixed.at[anchor_j].set(anchor_dir)

    def solve(we, x0):
        wD = (w * we)[:, None, None] * DtD

        def AtA(C):
            diff = C[edge_j] - C[edge_i]  # (E, 3)
            u = jnp.einsum("eij,ej->ei", wD, diff)
            out = jax.ops.segment_sum(u, edge_j, n_views)
            out -= jax.ops.segment_sum(u, edge_i, n_views)
            return out

        b = -(AtA(C_fixed)) * free

        def mv(v):
            return AtA(v * free) * free + 1e-8 * v * free

        x = x0 * free
        r = b - mv(x)
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
            _, r, _, rs, it = carry
            return (it < cg_iters) & (rs > 1e-14)

        x, *_ = jax.lax.while_loop(cond, body, (x, r, p, rs, 0))
        return x

    def flip_round(x, _):
        C = x + C_fixed
        diff = C[edge_j] - C[edge_i]
        nrm = jnp.linalg.norm(diff, axis=1)
        cos_a = jnp.sum(diff * dirs, axis=1) / jnp.maximum(nrm, 1e-9)
        we = (cos_a >= 0.0).astype(jnp.float32)
        return solve(we, x), None

    x0 = solve(jnp.ones_like(w), jnp.zeros((n_views, 3)))
    x, _ = jax.lax.scan(flip_round, x0, None, length=irls_iters)
    return x + C_fixed


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class GlobalEngine:
    """Global pipeline over the same inputs as the incremental engine."""

    def __init__(self, kp, intr, track_ids, n_tracks,
                 cfg: GlobalConfig = GlobalConfig(), progress=None,
                 cam_group=None, inc_cfg=None, mesh=None):
        self.cfg = cfg
        self.kp = np.asarray(kp)[..., :2].astype(np.float32)
        self.intr = np.asarray(intr, np.float32)
        self.track_ids = np.asarray(track_ids)
        self.V, self.N = self.track_ids.shape
        self.T = int(n_tracks)
        self.progress = progress or (lambda *a, **k: None)
        self.log: list[str] = []
        # Reuse the incremental engine's obs-table machinery for tracks
        # (and its BA, which carries the shared intrinsic groups).
        self._inc = inc_mod.IncrementalEngine(
            kp, intr, track_ids, n_tracks,
            inc_cfg or inc_mod.IncrementalConfig(), cam_group=cam_group,
            mesh=mesh)

    def relative_poses(self, key, keep_structure: bool = False):
        """Batched essential RANSAC on every view pair with shared tracks.

        keep_structure=True additionally records, per edge, the inlier
        track ids and their triangulated depths in both views' frames (at
        the pair's unit-baseline scale) — the raw material for stellar
        pod-scale estimation."""
        cfg = self.cfg
        inc = self._inc
        iu = np.triu_indices(self.V, 1)
        sel = inc._pair_counts[iu] >= 8
        cand = list(zip(iu[0][sel].tolist(), iu[1][sel].tolist()))
        edges = []
        ch = cfg.pair_chunk
        for s in range(0, len(cand), ch):
            chunk = cand[s : s + ch]
            x0s, x1s, valids, trs = [], [], [], []
            for (i, j) in chunk:
                uvi, uvj, tr = inc._pair_correspondences(i, j)
                x0, x1, valid = inc._pad_pair(uvi, uvj, i, j)
                x0s.append(x0)
                x1s.append(x1)
                valids.append(valid)
                trs.append(tr)
            while len(x0s) < ch:
                x0s.append(x0s[-1])
                x1s.append(x1s[-1])
                valids.append(jnp.zeros_like(valids[-1]))
            f = float(self.intr[chunk[0][0], 0])
            key, k = jax.random.split(key)
            keys = jax.random.split(k, ch)
            R_b, t_b, X_b, good_b, n_inl_b, ang_b = inc_mod._init_pairs_batched(
                keys, jnp.stack(x0s), jnp.stack(x1s), jnp.stack(valids),
                cfg.ransac_iters, cfg.essential_thresh_px / f,
            )
            good_b = np.asarray(good_b)
            ang_np = np.asarray(ang_b)
            R_np, t_np = np.asarray(R_b), np.asarray(t_b)
            X_np = np.asarray(X_b) if keep_structure else None
            for ci, (i, j) in enumerate(chunk):
                n_good = int(good_b[ci].sum())
                if n_good < cfg.min_pair_inliers:
                    continue
                med_ang = float(np.median(ang_np[ci][good_b[ci]])) if n_good else 0.0
                if med_ang < cfg.min_pair_parallax_deg:
                    continue
                edge = [i, j, R_np[ci], t_np[ci], n_good]
                if keep_structure:
                    tr = trs[ci]
                    good = good_b[ci][: len(tr)]
                    X = X_np[ci][: len(tr)][good]  # frame-i points, |t| = 1
                    z_i = X[:, 2]
                    z_j = (X @ R_np[ci].T + t_np[ci])[:, 2]
                    edge.append((tr[good], z_i.astype(np.float64), z_j.astype(np.float64)))
                edges.append(tuple(edge))
            self.progress("global_pairs", min(1.0, (s + ch) / max(len(cand), 1)))
        return edges, key

    def run(self, key=None) -> Scene:
        cfg = self.cfg
        key = jax.random.PRNGKey(0) if key is None else key
        edges, key = self.relative_poses(key)
        if len(edges) < self.V - 1:
            pass  # sparse graphs may still connect; component check below
        if not edges:
            raise RuntimeError("global SfM: no usable pairs")

        # Largest connected component only.
        adj = {v: set() for v in range(self.V)}
        for i, j, *_ in edges:
            adj[i].add(j)
            adj[j].add(i)
        seen = set()
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
        # Remap to the component; keep absolute view ids via index arrays.
        vids = sorted(comp)
        vmap_ = {v: k for k, v in enumerate(vids)}
        E = [(vmap_[i], vmap_[j], R, t, w) for (i, j, R, t, w) in edges
             if i in comp and j in comp]
        Vc = len(vids)
        edge_i = jnp.asarray([e[0] for e in E], dtype=jnp.int32)
        edge_j = jnp.asarray([e[1] for e in E], dtype=jnp.int32)
        R_rel = jnp.asarray(np.stack([e[2] for e in E]).astype(np.float32))
        w = jnp.asarray(np.asarray([e[4] for e in E], np.float32))
        w = w / jnp.max(w)

        # Spanning-tree init (host BFS composing relative rotations).
        R_init = np.tile(np.eye(3, dtype=np.float32), (Vc, 1, 1))
        tree_adj: dict[int, list[tuple[int, int, int]]] = {k: [] for k in range(Vc)}
        for eidx, (i, j, *_rest) in enumerate(E):
            tree_adj[i].append((j, eidx, +1))
            tree_adj[j].append((i, eidx, -1))
        visited = {0}
        stack = [0]
        R_rel_np = np.asarray(R_rel)
        while stack:
            u = stack.pop()
            for (v, eidx, sgn) in tree_adj[u]:
                if v in visited:
                    continue
                visited.add(v)
                if sgn > 0:  # edge (u -> v): R_v = R_rel R_u
                    R_init[v] = R_rel_np[eidx] @ R_init[u]
                else:  # edge (v -> u): R_u = R_rel R_v
                    R_init[v] = R_rel_np[eidx].T @ R_init[u]
                stack.append(v)
        self.progress("rotation_averaging", 0.5)

        R_glob = rotation_averaging(
            edge_i, edge_j, R_rel, w, jnp.asarray(R_init), Vc, cfg.rot_iters
        )
        self.progress("rotation_averaging", 1.0)

        # Directions in world frame: C_j - C_i = -R_j^T t_rel.
        Rg = np.asarray(R_glob)
        dirs = -np.einsum("eji,ej->ei", Rg[np.asarray(edge_j)],
                          np.stack([e[3] for e in E]))
        nrm = np.linalg.norm(dirs, axis=1, keepdims=True)
        dirs = dirs / np.maximum(nrm, 1e-12)
        # Scale anchor: the strongest edge incident to node 0.
        e0 = [k for k, e in enumerate(E) if e[0] == 0]
        anchor = E[e0[int(np.argmax([E[k][4] for k in e0]))]][1] if e0 else int(edge_j[0])
        centers = translation_averaging(
            edge_i, edge_j, jnp.asarray(dirs.astype(np.float32)), w,
            jnp.asarray(anchor), Vc, cfg.trans_cg_iters,
        )
        self.progress("translation_averaging", 1.0)

        return self._install_and_finish(vids, Rg, np.asarray(centers))

    def _install_and_finish(self, vids, Rg, C_np) -> Scene:
        """Install global poses into the shared obs-table machinery and
        build structure exactly like the incremental engine's tail."""
        cfg = self.cfg
        inc = self._inc
        for k, v in enumerate(vids):
            inc.aa[v] = np.asarray(lie.so3_log(jnp.asarray(Rg[k])))
            inc.t[v] = -Rg[k] @ C_np[k]
            inc.registered[v] = True
            inc._reg_order.append(int(v))
        inc.n_registered = len(vids)
        inc.gauge_cam = vids[0]
        inc.cfg = dataclasses.replace(
            inc.cfg,
            reproj_outlier_px=cfg.reproj_outlier_px,
            min_tri_angle_deg=cfg.min_tri_angle_deg,
            max_views_per_track=cfg.max_views_per_track,
        )
        # Alternate triangulation and global BA: the averaged-translation
        # init on weakly conditioned (chain-like) graphs can be off enough
        # that a single triangulation pass only admits the best-placed
        # tracks; each BA round tightens the centers and lets the next
        # triangulation admit more structure (measured 138 -> ~300 points
        # on a contiguous-window chain).
        for _ in range(3):
            # Re-mark every installed view: the incremental engine's
            # triangulation is dirty-gated, and each BA round here can turn
            # previously gate-failed tracks valid.
            for v in vids:
                inc._mark_dirty_view(int(v))
            inc.triangulate_new()
            inc.wash_outliers()
            inc.run_ba(cfg.ba_iters)
            inc.wash_outliers()
        for v in vids:
            inc._mark_dirty_view(int(v))
        inc.triangulate_new()
        inc.wash_outliers()
        inc.run_ba(max(cfg.ba_iters // 3, 5))
        self.progress("reconstruction", 1.0)
        self.log = inc.log
        return inc.to_scene()

    def colorize(self, scene, images):
        return self._inc.colorize(scene, images)
