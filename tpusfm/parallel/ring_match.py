"""Ring all-pairs matching: descriptors sharded by view, rotated over the
mesh with ppermute.

SURVEY.md §5 'long-context' analog: the reference bounds the O(N^2) pair
problem with windowed CONTIGUOUS pairs (sparseBuilder.cpp:784-797); at pod
scale tpusfm instead keeps ALL pairs but never gathers all descriptors to
one device — each device holds a view shard, and D ring steps rotate a
copy of the shards around the mesh (lax.ppermute) while every
device matches its resident views against the visiting shard.  Per-device
memory stays O(V/D * N * 128) regardless of collection size.

Matching inside a step is the same ratio-test matcher as the local path,
vmapped over the (resident x visiting) view grid; the caller filters the
resulting (V, V) table to i < j pairs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..matching import match as match_mod


def ring_match_all_pairs(
    mesh: Mesh,
    desc: jnp.ndarray,   # (V, N, D) descriptors, V divisible by mesh size
    mask: jnp.ndarray,   # (V, N)
    ratio: float = 0.8,
    axis: str = "shard",
):
    """Returns (idx (V, V, N) int32, ok (V, V, N) bool): for every ordered
    view pair (a, b), view a's features matched into view b.  The caller
    uses rows with a < b (the table is computed for all ordered pairs).

    Cross-checking is implicit: ok[a, b] uses a->b's ratio test only; run
    the symmetric consistency on the host if needed (the pipeline's
    geometric filter subsumes it)."""
    n_dev = mesh.shape[axis]
    V, N, D = desc.shape
    assert V % n_dev == 0, f"V={V} must divide the mesh axis {n_dev}"
    Vl = V // n_dev

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    )
    def _run(d_local, m_local):
        # d_local: (Vl, N, D) resident shard.  The visiting buffer starts as
        # a copy of the resident shard and rotates each step.
        me = jax.lax.axis_index(axis)

        def match_block(visiting_d, visiting_m):
            """Match every resident view against every visiting view."""
            def one_a(da, ma):
                return jax.vmap(
                    lambda db, mb: match_mod.match_descriptors(
                        da, db, ma, mb, ratio=ratio, cross_check=False
                    )
                )(visiting_d, visiting_m)

            return jax.vmap(one_a)(d_local, m_local)  # (Vl, Vl, N) x2

        def step(carry, k):
            vis_d, vis_m = carry
            idx_k, ok_k = match_block(vis_d, vis_m)
            # Which global view block is visiting at step k: the shard that
            # started at device (me - k) mod n_dev.
            src = jnp.mod(me - k, n_dev)
            # Rotate the visiting buffer to the next device.
            perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            vis_d = jax.lax.ppermute(vis_d, axis, perm)
            vis_m = jax.lax.ppermute(vis_m, axis, perm)
            return (vis_d, vis_m), (idx_k, ok_k, src)

        (_, _), (idx_steps, ok_steps, srcs) = jax.lax.scan(
            step, (d_local, m_local), jnp.arange(n_dev)
        )
        # idx_steps: (n_dev, Vl, Vl, N) — reorder steps into global view
        # order: step k holds columns for view block srcs[k].
        order = jnp.argsort(srcs)
        idx_full = idx_steps[order].transpose(1, 0, 2, 3).reshape(Vl, V, N)
        ok_full = ok_steps[order].transpose(1, 0, 2, 3).reshape(Vl, V, N)
        return idx_full, ok_full

    return _run(desc, mask)


def pairs_from_ring_table(idx, ok, min_matches: int = 1):
    """Host helper: ordered-pair table -> (pair_list (P, 2), match_idx
    (P, N), match_valid (P, N)) for i < j pairs (build_tracks input)."""
    idx = np.asarray(idx)
    ok = np.asarray(ok)
    V = idx.shape[0]
    # Vectorized upper-triangle selection (a Python double loop here is
    # O(V^2) interpreter work — minutes at 1000 views).
    iu, ju = np.triu_indices(V, 1)
    keep = ok[iu, ju].sum(axis=-1) >= min_matches
    iu, ju = iu[keep], ju[keep]
    if len(iu) == 0:
        n = idx.shape[-1]
        return (np.zeros((0, 2), np.int32), np.zeros((0, n), np.int32),
                np.zeros((0, n), bool))
    pl = np.stack([iu, ju], axis=1).astype(np.int32)
    return pl, idx[iu, ju], ok[iu, ju]
