"""Sharded pairwise matching: DP over the view-pair list.

SURVEY.md §2.3 item 3: the O(N^2) pair list is sharded across the mesh; each
device computes its pairs' descriptor distance matrices as local matmuls —
no collectives on the hot path (embarrassingly data parallel, like the
reference's OpenMP loop over pairs but across devices)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..matching import match


def match_pairs_sharded(
    mesh: Mesh,
    desc_a: jnp.ndarray,  # (Pr, N, D) descriptors of pair lhs views
    desc_b: jnp.ndarray,  # (Pr, N, D) rhs
    mask_a: jnp.ndarray,  # (Pr, N)
    mask_b: jnp.ndarray,
    ratio: float = 0.8,
    cross_check: bool = True,
    quantized: bool = False,
    axis: str = "shard",
):
    """Pr must be divisible by the mesh axis size (pad with pairs.pad_pairs).
    Each device runs the platform's batched matcher (match.match_batch) on
    its pairs.  Returns (idx (Pr, N) int32, valid (Pr, N) bool)."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
        # The GPU matcher is a pallas_call, whose outputs carry no
        # varying-manual-axes annotation; every output is per-shard here.
        check_vma=False,
    )
    def _run(da, db, ma, mb):
        return match.match_batch(da, db, ma, mb, ratio=ratio,
                                 cross_check=cross_check, quantized=quantized)

    return jax.jit(_run)(desc_a, desc_b, mask_a, mask_b)
