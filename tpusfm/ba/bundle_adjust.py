"""Huber-robust bundle adjustment: Levenberg-Marquardt with a matrix-free
Schur-complement solve and shared self-calibrating intrinsics.

Capability parity with the reference BA:
- residual = reproject(angle-axis, t, intrinsics, X) - uv, 2 per observation
  (ReprojectCost::operator(), src/adjuster/BundleAdjuster.h:40-68)
- Huber loss delta = 4 px (BundleAdjuster.h:109)
- gauge: first camera pose held constant (BundleAdjuster.h:105)
- intrinsics: the production engine's default camera model is
  PINHOLE_CAMERA_RADIAL3 (src/sparseBuilder/sparseBuilder.cpp:480-502) with
  one intrinsic block SHARED by all views from the same physical camera
  (GroupSharedIntrinsics, sparseBuilder.cpp:554-556) and BA refining
  focal + principal point + k1/k2/k3 (ADJUST_ALL, sparseBuilder.cpp:1292-1293).
  Here that is a separate (G, 7) parameter table [fx,fy,cx,cy,k1,k2,k3] with
  a per-camera group id; cfg.refine_params picks the refined subset
  ("focal" | "focal_pp" | "all" — OpenMVG's Intrinsic_Parameter_Type).
- solver: the reference uses Ceres SPARSE_SCHUR + JACOBI + EIGEN_SPARSE on
  one thread (BundleAdjuster.h:167-174).  A sparse Cholesky does not batch
  on an accelerator; the equivalent here (SURVEY.md §7 hard part 3)
  eliminates points exactly (3x3 block inverses, embarrassingly parallel)
  and solves the reduced [pose | intrinsic-group] system with block-Jacobi
  preconditioned CG where every operation is a segment-sum / gather over
  the observation table — no sparse matrix is ever materialized, and every
  step is an O(obs) dense-batched kernel.
- damping: Marquardt-scaled (lam * diag(H), Ceres' default) — scale
  invariant across focal (~1e6) / rotation (~1) diagonal entries and keeps
  the reduced system conditioned along the scene's scale-gauge null
  direction (additive lam*I leaves that eigenvalue at ~lam and amplifies
  fp32 reduction noise into gauge drift between differently-sharded runs).

Parameter blocks: pose 6 (aa + t) per camera, intrinsics 7 per GROUP
(shared by every camera with the same group id), point 3.  The whole solve
is one jit-able function of fixed-capacity arrays; masked slots contribute
zeros.  This same structure shards over a device mesh by partitioning the
observation table (tpusfm.parallel.dist_ba): all obs-table reductions are
psum-hooked, and anything quadratic in per-shard partials (the dense-Schur
coupling tables) is psum-reduced BEFORE contraction.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core import camera as cam
from ..core import lie

POSE_DIM = 6
INTR_DIM = 7

_REFINE_MASKS = {
    "focal": (1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    "focal_pp": (1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0),
    "all": (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
}


@dataclasses.dataclass(frozen=True)
class BAConfig:
    max_iters: int = 20            # LM outer iterations
    huber_delta: float = 4.0       # px (BundleAdjuster.h:109)
    refine_intrinsics: bool = False  # refine the shared intrinsic blocks
    refine_params: str = "all"     # which intrinsics refine when enabled:
                                   # "focal" | "focal_pp" | "all" (ADJUST_ALL
                                   # parity, sparseBuilder.cpp:1292-1293)
    cg_iters: int = 50
    cg_tol: float = 1e-2       # inexact Newton: CG only needs a descent
                               # direction — LM's accept/reject guards
                               # quality, and each saved CG iteration is a
                               # full gather/scatter pass over the obs table
    lambda_init: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    lambda_min: float = 1e-10
    lambda_max: float = 1e8
    converge_rtol: float = 3e-6    # accepted-step relative improvement below
                                   # this = converged.  Must sit above fp32
                                   # cost resolution (ulp/cost ~ 6e-8..1e-7,
                                   # and the summed cost carries reduction-
                                   # order noise ~10x that): a tighter value
                                   # makes the LM loop wander the flat
                                   # post-convergence valley on noise-driven
                                   # marginal accepts, so single-device and
                                   # sharded solves (different reduction
                                   # orders) would diverge after convergence.
    fix_first_cam: bool = True     # gauge (BundleAdjuster.h:105): pose only —
                                   # intrinsic groups refine independently
    obs_chunk: int = 65536         # obs per assembly chunk: assembly scans
                                   # chunks instead of materializing the
                                   # per-obs (O, D, D) Jacobian products
    axis_name: str | None = None   # mesh axis the observation table is
                                   # sharded over (distributed BA: partial
                                   # segment-sums are psum-reduced, SURVEY.md
                                   # §2.3 item 4); None = single device
    # Direct dense-Schur solve for small reduced systems: when the reduced
    # system is at most this many scalars wide (C*6 + refined G*7), assemble
    # S densely and solve by Cholesky instead of running PCG.  A 20-camera
    # step-BA's S is 120x120 — one small factorization beats 50 CG sweeps
    # over the observation table (each a gather+segment-sum pass).  PCG
    # remains the at-scale path (500 cams -> S is 3000x3000 and the (P, C)
    # scatter table would not fit).
    dense_schur_max_dim: int = 384
    dense_schur_max_bytes: int = 256 * 1024 * 1024  # cap on peak coupling-
                                   # table residency (~2x the (P, C, 6, 3)
                                   # [+ (P, G, 7, 3)] tables: W plus the
                                   # intermediate A = W @ Hpp_inv)

    # Camera model for the reprojection residual (intrinsic factory parity,
    # src/sparseBuilder/sparseBuilder.cpp:484-497): "auto" dispatches on the
    # intrinsic width (7 = RADIAL3, 9 = Brown-T2); "fisheye" / "spherical"
    # must be named.
    camera_model: str = "auto"

    def refine_mask(self, e: int = INTR_DIM) -> tuple[float, ...]:
        if not self.refine_intrinsics:
            return (0.0,) * e
        if self.refine_params in ("focal", "focal_pp"):
            n = 2 if self.refine_params == "focal" else 4
            return tuple(1.0 if i < n else 0.0 for i in range(e))
        # "all": every lane the model actually uses.
        if self.camera_model == "fisheye":
            return tuple(1.0 if i < 8 else 0.0 for i in range(e))
        if self.camera_model == "spherical":
            return tuple(1.0 if i < 4 else 0.0 for i in range(e))
        return (1.0,) * e


# ---------------------------------------------------------------------------
# Residuals and Jacobians
# ---------------------------------------------------------------------------

def _residual_one(pose, intr, X, uv, model: str = "auto"):
    """Reprojection residual for one observation: pose = [aa(3), t(3)],
    intr = the RADIAL3 7-vector or Brown-T2 9-vector (or fisheye/spherical
    with an explicit model) — distortion is live in the projection, so
    refining the distortion lanes is just a wider Jacobian."""
    Xc = lie.rotate_aa(pose[:3], X) + pose[3:6]
    return cam.camera_to_pixel(intr, Xc, model=model) - uv


def _obs_jacobians(pose_o, intr_o, X_o, uv_o, refine: bool,
                   model: str = "auto"):
    """Per-observation residual + Jacobians, vmapped over the obs table.
    Returns r (O, 2), Jc (O, 2, 6), Jg (O, 2, E) | None, Jp (O, 2, 3)."""
    def per_obs(ps, gi, X, uv):
        r = _residual_one(ps, gi, X, uv, model)
        Jc = jax.jacfwd(lambda p: _residual_one(p, gi, X, uv, model))(ps)
        Jp = jax.jacfwd(lambda x: _residual_one(ps, gi, x, uv, model))(X)
        if refine:
            Jg = jax.jacfwd(lambda g: _residual_one(ps, g, X, uv, model))(gi)
        else:
            Jg = jnp.zeros((2, intr_o.shape[-1]), ps.dtype)
        return r, Jc, Jg, Jp

    r, Jc, Jg, Jp = jax.vmap(per_obs)(pose_o, intr_o, X_o, uv_o)
    return r, Jc, (Jg if refine else None), Jp


def _prior_terms(ps, prior_pos, prior_w):
    """Soft camera-center prior residuals r_c = sqrt(w_c) (C(pose_c) - p_c)
    (GPS pose priors: the reference attaches ViewPriors to views before SfM,
    src/sparseBuilder/sparseBuilder.cpp:112-171, 506-533; here they enter the
    BA normal equations directly).  Returns additive (dHcc (C,6,6),
    dgc (C,6), dcost) — camera-side only, so the Schur structure is
    untouched.  prior_w (C,) is the per-camera weight (1/sigma^2 from the
    EXIF accuracy); 0 disables a camera's prior."""
    aa = ps[:, :3]
    t = ps[:, 3:6]
    R = lie.so3_exp(aa)
    Jr = lie.so3_right_jacobian(aa)
    Cc = -jnp.einsum("cji,cj->ci", R, t)  # camera centers
    r = Cc - prior_pos
    # dC/daa = [C]x Jr  (right-Jacobian convention, see core/lie.py);
    # dC/dt = -R^T.
    J = jnp.concatenate(
        [jnp.einsum("cij,cjk->cik", lie.hat(Cc), Jr),
         -jnp.transpose(R, (0, 2, 1))], axis=2)  # (C, 3, 6)
    w = prior_w[:, None, None]
    dH = w * jnp.einsum("cki,ckj->cij", J, J)
    dg = prior_w[:, None] * jnp.einsum("cki,ck->ci", J, r)
    dcost = 0.5 * jnp.sum(prior_w * jnp.sum(r * r, axis=-1))
    return dH, dg, dcost


def _huber_weight(r: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS weight sqrt(rho'(s)) for the Huber loss on the residual norm:
    w = 1 inside delta, delta/||r|| outside. (O,)"""
    nrm = jnp.linalg.norm(r, axis=-1)
    return jnp.sqrt(jnp.minimum(1.0, delta / jnp.maximum(nrm, 1e-12)))


def robust_cost(r: jnp.ndarray, mask: jnp.ndarray, delta: float) -> jnp.ndarray:
    """Total Huber cost over masked observations."""
    s = jnp.sum(r * r, axis=-1)
    nrm = jnp.sqrt(s + 1e-20)
    quad = 0.5 * s
    lin = delta * (nrm - 0.5 * delta)
    return jnp.sum(jnp.where(nrm <= delta, quad, lin) * mask)


# ---------------------------------------------------------------------------
# Small linear-algebra helpers
# ---------------------------------------------------------------------------

def _maybe_psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name else x


def _chunk_obs(arrs, n_chunks: int):
    """Reshape leading obs axis to (n_chunks, chunk, ...); O must divide."""
    return [a.reshape(n_chunks, a.shape[0] // n_chunks, *a.shape[1:]) for a in arrs]


def _damp_blocks(H, lam):
    """Marquardt-scaled LM damping: H + lam * diag(H) (Ceres' default
    scaling).  Scale-invariant — focal entries (~1e6) and rotation entries
    (~1) are damped proportionally — and it keeps the reduced camera system
    well-conditioned along the scene's scale-gauge null direction even at
    tiny lam (additive lam*I leaves that eigenvalue at ~lam, amplifying
    fp32 reduction-order noise by 1/lam into gauge drift; with diag scaling
    the floor is lam * typical-diagonal instead).  Diagonal entries of
    masked/empty blocks are floored so the blocks stay invertible."""
    n = H.shape[-1]
    idx = jnp.arange(n)
    d = jnp.maximum(H[..., idx, idx], 1e-6)
    return H.at[..., idx, idx].add(lam * d)


def _inv3(M):
    """Batched closed-form (adjugate) 3x3 inverse with ridge for masked or
    empty blocks — pure elementwise math that fuses into one kernel instead
    of a batched LU call."""
    M = M + 1e-12 * jnp.eye(3, dtype=M.dtype)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack([
        jnp.stack([A, B, C], -1),
        jnp.stack([D, E, F], -1),
        jnp.stack([G, H, I], -1),
    ], -2)
    return adj / det[..., None, None]


def _invD(M):
    D = M.shape[-1]
    M = M + 1e-12 * jnp.eye(D, dtype=M.dtype)
    return jnp.linalg.inv(M)


def _tree_vdot(a, b):
    return sum(jnp.vdot(x, y) for x, y in zip(jax.tree_util.tree_leaves(a),
                                              jax.tree_util.tree_leaves(b)))


def _pcg(matvec, b, apply_M, iters: int, tol: float):
    """Block-Jacobi preconditioned conjugate gradients over a pytree of
    per-block unknowns (pose blocks, and intrinsic-group blocks when
    refining).  Returns (x, number of CG iterations run)."""
    x0 = jax.tree_util.tree_map(jnp.zeros_like, b)
    r0 = b
    z0 = apply_M(r0)
    p0 = z0
    rz0 = _tree_vdot(r0, z0)
    b2 = _tree_vdot(b, b)

    def body(carry):
        x, r, p, rz, it = carry
        Ap = matvec(p)
        pAp = _tree_vdot(p, Ap)
        alpha = rz / jnp.where(jnp.abs(pAp) < 1e-30, 1e-30, pAp)
        x = jax.tree_util.tree_map(lambda x_, p_: x_ + alpha * p_, x, p)
        r = jax.tree_util.tree_map(lambda r_, a_: r_ - alpha * a_, r, Ap)
        z = apply_M(r)
        rz_new = _tree_vdot(r, z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        p = jax.tree_util.tree_map(lambda z_, p_: z_ + beta * p_, z, p)
        return x, r, p, rz_new, it + 1

    def cond(carry):
        _, r, _, _, it = carry
        return (it < iters) & (_tree_vdot(r, r) > tol * tol * jnp.maximum(b2, 1e-30))

    x, _, _, _, n_it = jax.lax.while_loop(cond, body,
                                          (x0, r0, p0, rz0, jnp.int32(0)))
    return x, n_it


# ---------------------------------------------------------------------------
# Normal-equation assembly (XLA path: chunked scan over the obs table)
# ---------------------------------------------------------------------------

def _build_system(pose, gintr, points, refine_m, obs_cam, obs_grp, obs_pt,
                  obs_uv, obs_w, C, G, cfg: BAConfig):
    """Assemble the segment-summed normal-equation pieces.

    Assembly runs as a lax.scan over observation chunks, materializing only
    (chunk, D, D) per-observation blocks at a time; the coupling blocks
    persist flattened as (O, D*3)."""
    P = points.shape[0]
    D, E = POSE_DIM, gintr.shape[-1]
    O = obs_cam.shape[0]
    refine = cfg.refine_intrinsics
    ax = cfg.axis_name
    n_chunks = max(1, O // max(cfg.obs_chunk, 1))
    while O % n_chunks:
        n_chunks -= 1
    ocam_c, ogrp_c, opt_c, ouv_c, ow_c = _chunk_obs(
        [obs_cam, obs_grp, obs_pt, obs_uv, obs_w], n_chunks)

    def chunk_body(carry, inp):
        ocam, ogrp, opt, ouv, ow = inp
        pose_o = pose[ocam]
        intr_o = gintr[ogrp]
        X_o = points[opt]
        r, Jc, Jg, Jp = _obs_jacobians(pose_o, intr_o, X_o, ouv, refine,
                                       cfg.camera_model)
        w = (_huber_weight(r, cfg.huber_delta) * ow)[:, None]
        cost = robust_cost(r, ow, cfg.huber_delta)
        r = r * w
        Jc = Jc * w[..., None]
        Jp = Jp * w[..., None]
        out = {}
        acc = dict(carry)
        acc["cost"] = acc["cost"] + cost
        acc["Hcc"] = acc["Hcc"] + jax.ops.segment_sum(
            jnp.einsum("oki,okj->oij", Jc, Jc), ocam, C)
        acc["Hpp"] = acc["Hpp"] + jax.ops.segment_sum(
            jnp.einsum("oki,okj->oij", Jp, Jp), opt, P)
        acc["gc"] = acc["gc"] + jax.ops.segment_sum(
            jnp.einsum("oki,ok->oi", Jc, r), ocam, C)
        acc["gp"] = acc["gp"] + jax.ops.segment_sum(
            jnp.einsum("oki,ok->oi", Jp, r), opt, P)
        out["Wc"] = jnp.einsum("oki,okj->oij", Jc, Jp).reshape(-1, D * 3)
        if refine:
            Jg = Jg * (w[..., None] * refine_m[None, None, :])
            acc["Hgg"] = acc["Hgg"] + jax.ops.segment_sum(
                jnp.einsum("oki,okj->oij", Jg, Jg), ogrp, G)
            acc["Hcg"] = acc["Hcg"] + jax.ops.segment_sum(
                jnp.einsum("oki,okj->oij", Jc, Jg), ocam, C)
            acc["gg"] = acc["gg"] + jax.ops.segment_sum(
                jnp.einsum("oki,ok->oi", Jg, r), ogrp, G)
            out["Wg"] = jnp.einsum("oki,okj->oij", Jg, Jp).reshape(-1, E * 3)
        return acc, out

    init = {
        "Hcc": jnp.zeros((C, D, D)), "Hpp": jnp.zeros((P, 3, 3)),
        "gc": jnp.zeros((C, D)), "gp": jnp.zeros((P, 3)),
        "cost": jnp.zeros(()),
    }
    if refine:
        init.update({
            "Hgg": jnp.zeros((G, E, E)), "Hcg": jnp.zeros((C, D, E)),
            "gg": jnp.zeros((G, E)),
        })
    if ax:
        # Under shard_map the accumulators are device-varying; mark the
        # zero init accordingly or the scan carry types disagree.
        init = jax.tree_util.tree_map(
            lambda z: jax.lax.pcast(z, ax, to='varying'), init)
    acc, outs = jax.lax.scan(
        chunk_body, init, (ocam_c, ogrp_c, opt_c, ouv_c, ow_c))
    acc = jax.tree_util.tree_map(lambda x: _maybe_psum(x, ax), acc)
    Wc = outs["Wc"].reshape(O, D * 3)
    Wg = outs["Wg"].reshape(O, E * 3) if refine else None
    return acc, Wc, Wg


# ---------------------------------------------------------------------------
# Reduced-system solves
# ---------------------------------------------------------------------------

def _dense_schur_solve(Hcc_d, Hgg_d, Hcg, Hpp_inv, Wc3, Wg3,
                       obs_cam, obs_grp, obs_pt, rhs, upd_c, upd_g,
                       cam_group, C, G, refine: bool, axis_name=None):
    """Assemble the reduced [pose | intrinsic-group] system densely and
    solve by Cholesky.  Exact (no CG truncation) and a single small
    factorization — the fast path for step-BAs with few cameras.

    Per-point coupling is gathered into (P, C, 6, 3) / (P, G, E, 3) tables
    with one segment-sum over linearized (point, block) ids; the
    off-diagonal Schur blocks are then batched einsum contractions.

    Sharded correctness: the coupling tables must be psum-reduced BEFORE
    the quadratic contraction — a per-shard table would drop every
    cross-shard coupling term W_p* Hpp^-1 W_p*^T where two observations of
    point p live on different devices (S is quadratic in W, so psum-ing
    the contracted blocks after would be wrong)."""
    D = POSE_DIM
    E = Hgg_d.shape[-1] if refine else INTR_DIM
    P = Hpp_inv.shape[0]
    lin_c = obs_pt * C + obs_cam
    Wcp = jax.ops.segment_sum(Wc3.reshape(-1, D * 3), lin_c, P * C)
    Wcp = _maybe_psum(Wcp, axis_name).reshape(P, C, D, 3)
    Acp = jnp.einsum("pcdk,pkl->pcdl", Wcp, Hpp_inv)
    idxC = jnp.arange(C)
    Scc = -jnp.einsum("pcdl,pejl->cdej", Acp, Wcp)
    Scc = Scc.at[idxC, :, idxC, :].add(Hcc_d)

    if refine:
        lin_g = obs_pt * G + obs_grp
        Wgp = jax.ops.segment_sum(Wg3.reshape(-1, E * 3), lin_g, P * G)
        Wgp = _maybe_psum(Wgp, axis_name).reshape(P, G, E, 3)
        Scg = -jnp.einsum("pcdl,pgel->cdge", Acp, Wgp)
        Scg = Scg.at[idxC, :, cam_group, :].add(Hcg)
        Agp = jnp.einsum("pgek,pkl->pgel", Wgp, Hpp_inv)
        idxG = jnp.arange(G)
        Sgg = -jnp.einsum("pgel,phfl->gehf", Agp, Wgp)
        Sgg = Sgg.at[idxG, :, idxG, :].add(Hgg_d)
        N = C * D + G * E
        S = jnp.zeros((N, N), Hcc_d.dtype)
        S = S.at[: C * D, : C * D].set(Scc.reshape(C * D, C * D))
        cg = Scg.reshape(C * D, G * E)
        S = S.at[: C * D, C * D:].set(cg)
        S = S.at[C * D:, : C * D].set(cg.T)
        S = S.at[C * D:, C * D:].set(Sgg.reshape(G * E, G * E))
        u = jnp.concatenate([jnp.broadcast_to(upd_c, (C, D)).reshape(-1),
                             jnp.broadcast_to(upd_g, (G, E)).reshape(-1)])
    else:
        N = C * D
        S = Scc.reshape(N, N)
        u = jnp.broadcast_to(upd_c, (C, D)).reshape(-1)

    # Freeze fixed rows: zero their rows/cols, identity diagonal (keeps
    # S symmetric positive definite; their rhs is already zero).
    S = S * (u[:, None] * u[None, :]) + jnp.diag(1.0 - u)
    L = jnp.linalg.cholesky(S)
    from jax.scipy.linalg import solve_triangular

    y = solve_triangular(L, rhs * u, lower=True)
    d = solve_triangular(L.T, y, lower=False)
    # A failed factorization (non-PD from extreme conditioning) falls back
    # to the zero step — LM rejects it and raises lambda.
    d = jnp.where(jnp.all(jnp.isfinite(d)), d, 0.0) * u
    dc = d[: C * D].reshape(C, D)
    dg = d[C * D:].reshape(G, E) if refine else None
    return dc, dg


def _dense_eligible(C, G, P, cfg: BAConfig) -> bool:
    # Peak residency is ~2x the coupling tables: the intermediate
    # A = einsum(W, Hpp_inv) materializes a second table of identical size.
    dim = C * POSE_DIM + (G * INTR_DIM if cfg.refine_intrinsics else 0)
    tables = P * C * POSE_DIM * 3
    if cfg.refine_intrinsics:
        tables += P * G * INTR_DIM * 3
    return dim <= cfg.dense_schur_max_dim and 2 * tables * 4 <= cfg.dense_schur_max_bytes


def _schur_diag_pose(Hcc_d, Hpp_inv, Wc, obs_cam, obs_pt, C, cfg, axis_name=None):
    """Exact pose-diagonal blocks of S for the block-Jacobi preconditioner
    (the analog of Ceres' SCHUR_JACOBI).  Exact because each (cam,
    point) pair has at most one observation.  Chunked like _build_system to
    avoid a resident (O, D, D) tensor."""
    D = Hcc_d.shape[-1]
    O = obs_cam.shape[0]
    n_chunks = max(1, O // max(cfg.obs_chunk, 1))
    while O % n_chunks:
        n_chunks -= 1
    Wc_c, ocam_c, opt_c = _chunk_obs([Wc, obs_cam, obs_pt], n_chunks)

    def body(acc, inp):
        Wf, ocam, opt = inp
        W3 = Wf.reshape(-1, D, 3)
        contrib = jnp.einsum("oij,ojk,olk->oil", W3, Hpp_inv[opt], W3)
        return acc + jax.ops.segment_sum(contrib, ocam, C), None

    acc0 = jnp.zeros((C, D, D))
    if axis_name:
        acc0 = jax.lax.pcast(acc0, axis_name, to="varying")
    acc, _ = jax.lax.scan(body, acc0, (Wc_c, ocam_c, opt_c))
    return Hcc_d - _maybe_psum(acc, axis_name)


# ---------------------------------------------------------------------------
# LM driver
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "n_groups"))
def bundle_adjust(
    intr: jnp.ndarray,       # (C, 7) per-camera intrinsics; must already be
                             # consistent within each shared group
    cam_rot: jnp.ndarray,    # (C, 3) axis-angle
    cam_t: jnp.ndarray,      # (C, 3)
    cam_mask: jnp.ndarray,   # (C,)
    points: jnp.ndarray,     # (P, 3)
    point_mask: jnp.ndarray, # (P,)
    obs_cam: jnp.ndarray,    # (O,)
    obs_pt: jnp.ndarray,     # (O,)
    obs_uv: jnp.ndarray,     # (O, 2)
    obs_mask: jnp.ndarray,   # (O,)
    cfg: BAConfig = BAConfig(),
    cam_free_mask: jnp.ndarray | None = None,  # (C,) — False freezes a camera
                                               # pose (local-BA support)
    cam_group: jnp.ndarray | None = None,  # (C,) int32 intrinsic-group id per
                                           # camera (GroupSharedIntrinsics,
                                           # sparseBuilder.cpp:554-556);
                                           # None = one group per camera
    n_groups: int | None = None,           # static group count; None = C
    prior_pos: jnp.ndarray | None = None,  # (C, 3) soft camera-center priors
                                           # (GPS, reconstruction frame —
                                           # ViewPriors parity,
                                           # sparseBuilder.cpp:506-533)
    prior_weight: jnp.ndarray | None = None,  # (C,) weights (1/sigma^2);
                                              # 0/None disables
    max_iters=None,          # RUNTIME iteration cap overriding
                             # cfg.max_iters: step-BA and final-BA calls at
                             # different budgets share ONE compiled program
                             # (the warm-up's 3rd bundle_adjust trace was
                             # exactly this cfg difference)
):
    """Run LM bundle adjustment. Returns (intr, cam_rot, cam_t, points, info)
    where info = {'initial_cost', 'final_cost', 'iterations',
    'cg_iterations', 'lambda', 'n_obs'}
    (the reference prints initial/final RMSE + time, BundleAdjuster.h:134-139).
    The returned intr is per-camera, gathered from the refined group table.
    """
    C = intr.shape[0]
    P = points.shape[0]
    refine = cfg.refine_intrinsics
    if cam_group is None:
        cam_group = jnp.arange(C, dtype=jnp.int32)
        G = C
    else:
        cam_group = cam_group.astype(jnp.int32)
        G = int(n_groups) if n_groups is not None else C
    # Group intrinsic table: scatter per-camera rows (all rows of a group are
    # required identical, so last-write-wins is exact).
    E_in = intr.shape[-1]
    gintr = jnp.zeros((G, E_in), intr.dtype).at[cam_group].set(intr)
    refine_m = jnp.asarray(cfg.refine_mask(E_in), intr.dtype)

    # Pad the obs table so the assembly chunk size divides it exactly
    # (padded rows have zero weight — harmless everywhere).
    O = obs_cam.shape[0]
    if O > cfg.obs_chunk and O % cfg.obs_chunk:
        pad = cfg.obs_chunk - (O % cfg.obs_chunk)
        obs_cam = jnp.concatenate([obs_cam, jnp.zeros(pad, obs_cam.dtype)])
        obs_pt = jnp.concatenate([obs_pt, jnp.zeros(pad, obs_pt.dtype)])
        obs_uv = jnp.concatenate([obs_uv, jnp.zeros((pad, 2), obs_uv.dtype)])
        obs_mask = jnp.concatenate([obs_mask, jnp.zeros(pad, obs_mask.dtype)])
    obs_w = obs_mask.astype(jnp.float32)
    obs_grp = cam_group[obs_cam]

    # Gauge: freeze camera 0's pose block (first registered camera, pose
    # only — its intrinsic group still refines).
    free = cam_mask if cam_free_mask is None else (cam_mask & cam_free_mask)
    upd_c = free.astype(jnp.float32)[:, None]
    if cfg.fix_first_cam:
        upd_c = upd_c.at[0].set(0.0)
    pt_upd = point_mask.astype(jnp.float32)[:, None]
    # Group update mask: refined parameter subset x groups that have any
    # observation weight (empty groups stay frozen).
    grp_w = _maybe_psum(jax.ops.segment_sum(obs_w, obs_grp, G), cfg.axis_name)
    upd_g = (grp_w > 0).astype(jnp.float32)[:, None] * refine_m[None, :]

    prior_w = None
    if prior_pos is not None:
        prior_w = (jnp.ones(C) if prior_weight is None
                   else prior_weight) * cam_mask.astype(jnp.float32)

    pose0 = jnp.concatenate([cam_rot, cam_t], axis=-1)
    D, E = POSE_DIM, E_in

    dense_ok = _dense_eligible(C, G, P, cfg)

    def linearize(ps, gi, pts):
        """One chunked pass over the obs table -> (system dict incl. the W
        coupling tables, robust cost) — the cost rides along so the LM
        driver reuses the candidate's linearization as its accept test
        (two-pass accept)."""
        acc, Wc, Wg = _build_system(
            ps, gi, pts, refine_m, obs_cam, obs_grp, obs_pt, obs_uv, obs_w,
            C, G, cfg
        )
        cost = acc.pop("cost")  # psum-reduced inside _build_system
        acc["Wc"] = Wc
        if refine:
            acc["Wg"] = Wg
        if prior_pos is not None:
            # Replicated, added AFTER the psum — identical on every shard.
            dH, dg, dcost = _prior_terms(ps, prior_pos, prior_w)
            acc["Hcc"] = acc["Hcc"] + dH
            acc["gc"] = acc["gc"] + dg
            cost = cost + dcost
        return acc, cost

    def solve(sys, lam):
        """Damped Schur solve -> (dc, dg, dp, CG iterations run)."""
        Wc3 = sys["Wc"].reshape(-1, D, 3)
        Wg3 = sys["Wg"].reshape(-1, E, 3) if refine else None
        # Marquardt-scaled LM damping on the diagonal blocks.
        Hcc_d = _damp_blocks(sys["Hcc"], lam)
        Hpp_inv = _inv3(_damp_blocks(sys["Hpp"], lam))
        Hgg_d = _damp_blocks(sys["Hgg"], lam) if refine else None
        Hcg = sys["Hcg"] if refine else None

        # Reduced system rhs: -g + W Hpp^-1 gp (per block type).
        z = jnp.einsum("pij,pj->pi", Hpp_inv, sys["gp"])
        z_o = z[obs_pt]
        rhs_c = -sys["gc"] + _maybe_psum(jax.ops.segment_sum(
            jnp.einsum("oij,oj->oi", Wc3, z_o), obs_cam, C), cfg.axis_name)
        rhs_c = rhs_c * upd_c
        if refine:
            rhs_g = -sys["gg"] + _maybe_psum(jax.ops.segment_sum(
                jnp.einsum("oij,oj->oi", Wg3, z_o), obs_grp, G), cfg.axis_name)
            rhs_g = rhs_g * upd_g

        if dense_ok:
            rhs_flat = (jnp.concatenate([rhs_c.reshape(-1), rhs_g.reshape(-1)])
                        if refine else rhs_c.reshape(-1))
            dc, dg = _dense_schur_solve(
                Hcc_d, Hgg_d, Hcg, Hpp_inv, Wc3, Wg3, obs_cam, obs_grp,
                obs_pt, rhs_flat, upd_c, upd_g, cam_group, C, G, refine,
                cfg.axis_name)
            n_cg = jnp.int32(0)
        else:
            S_diag = _schur_diag_pose(Hcc_d, Hpp_inv, sys["Wc"], obs_cam,
                                      obs_pt, C, cfg, cfg.axis_name)
            M_inv_c = _invD(S_diag)
            M_inv_g = _invD(Hgg_d) if refine else None

            def apply_M(v):
                out = {"c": jnp.einsum("cij,cj->ci", M_inv_c, v["c"])}
                if refine:
                    out["g"] = jnp.einsum("gij,gj->gi", M_inv_g, v["g"])
                return out

            def mv(v):
                vc = v["c"] * upd_c
                u = jnp.einsum("oij,oi->oj", Wc3, vc[obs_cam])
                if refine:
                    vg = v["g"] * upd_g
                    u = u + jnp.einsum("oij,oi->oj", Wg3, vg[obs_grp])
                y = _maybe_psum(jax.ops.segment_sum(u, obs_pt, P), cfg.axis_name)
                zz = jnp.einsum("pij,pj->pi", Hpp_inv, y)
                zz_o = zz[obs_pt]
                bc = _maybe_psum(jax.ops.segment_sum(
                    jnp.einsum("oij,oj->oi", Wc3, zz_o), obs_cam, C),
                    cfg.axis_name)
                Hvc = jnp.einsum("cij,cj->ci", Hcc_d, vc)
                if refine:
                    Hvc = Hvc + jnp.einsum("cde,ce->cd", Hcg, vg[cam_group])
                    bg = _maybe_psum(jax.ops.segment_sum(
                        jnp.einsum("oij,oj->oi", Wg3, zz_o), obs_grp, G),
                        cfg.axis_name)
                    Hvg = jnp.einsum("gef,gf->ge", Hgg_d, vg) + jax.ops.segment_sum(
                        jnp.einsum("cde,cd->ce", Hcg, vc), cam_group, G)
                    return {"c": (Hvc - bc) * upd_c, "g": (Hvg - bg) * upd_g}
                return {"c": (Hvc - bc) * upd_c}

            rhs = {"c": rhs_c, "g": rhs_g} if refine else {"c": rhs_c}
            d, n_cg = _pcg(mv, rhs, apply_M, cfg.cg_iters, cfg.cg_tol)
            dc = d["c"] * upd_c
            dg = d["g"] * upd_g if refine else None

        # Back-substitute points: dp = -Hpp^-1 (gp + W^T d)
        u = jnp.einsum("oij,oi->oj", Wc3, dc[obs_cam])
        if refine:
            u = u + jnp.einsum("oij,oi->oj", Wg3, dg[obs_grp])
        Wtd = _maybe_psum(jax.ops.segment_sum(u, obs_pt, P), cfg.axis_name)
        dp = -jnp.einsum("pij,pj->pi", Hpp_inv, sys["gp"] + Wtd) * pt_upd
        return dc, dg, dp, n_cg

    def lm_step(carry):
        # Two-pass accept: solve the carried system, linearize the candidate
        # (cost comes from the same pass), keep the winner's linearization.
        ps, gi, pts, sys, lam, cost, done, it, cg_total = carry
        dc, dg, dp, n_cg = solve(sys, lam)
        ps_new = ps + dc
        gi_new = gi + dg if refine else gi
        pts_new = pts + dp
        sys_new, new_cost = linearize(ps_new, gi_new, pts_new)
        accept = (new_cost < cost) & ~done

        def sel(new, old):
            return jnp.where(accept, new, old)

        ps = sel(ps_new, ps)
        gi = sel(gi_new, gi) if refine else gi
        pts = sel(pts_new, pts)
        sys = jax.tree_util.tree_map(sel, sys_new, sys)
        cost_out = jnp.where(accept, new_cost, cost)
        lam = jnp.where(
            accept,
            jnp.maximum(lam * cfg.lambda_down, cfg.lambda_min),
            jnp.minimum(lam * cfg.lambda_up, cfg.lambda_max),
        )
        # Converged when an accepted step barely improves the cost.
        rel = jnp.abs(cost - cost_out) / jnp.maximum(cost, 1e-12)
        done = done | (accept & (rel < cfg.converge_rtol))
        return ps, gi, pts, sys, lam, cost_out, done, it + 1, cg_total + n_cg

    mi = jnp.int32(cfg.max_iters) if max_iters is None \
        else jnp.asarray(max_iters, jnp.int32)
    sys0, init_cost = linearize(pose0, gintr, points)
    # A real while_loop (not scan): converged solves stop paying for the
    # remaining LM iterations on device — mid-reconstruction step-BAs
    # typically accept 2-4 steps and exit.
    (ps, gi, pts, _, lam, final_cost, _, n_it, n_cg) = jax.lax.while_loop(
        lambda c: (c[7] < mi) & ~c[6],
        lm_step,
        (pose0, gintr, points, sys0, jnp.float32(cfg.lambda_init), init_cost,
         jnp.bool_(False), jnp.int32(0), jnp.int32(0)),
    )
    intr_out = gi[cam_group]
    info = {
        "initial_cost": init_cost,
        "final_cost": final_cost,
        "lambda": lam,
        "iterations": n_it,
        "cg_iterations": n_cg,  # summed over LM steps; 0 on the dense path
        "n_obs": _maybe_psum(jnp.sum(obs_mask), cfg.axis_name),
    }
    return intr_out, ps[:, :3], ps[:, 3:6], pts, info


def bundle_adjust_scene(scene, cfg: BAConfig = BAConfig(), cam_group=None,
                        n_groups=None):
    """Convenience wrapper over a tpusfm.sfm.scene.Scene."""
    intr, rot, t, pts, info = bundle_adjust(
        scene.intr, scene.cam_rot, scene.cam_t, scene.cam_mask,
        scene.points, scene.point_mask,
        scene.obs_cam, scene.obs_pt, scene.obs_uv, scene.obs_mask,
        cfg, cam_group=cam_group, n_groups=n_groups,
    )
    return scene.replace(intr=intr, cam_rot=rot, cam_t=t, points=pts), info
