"""View-pair generation.

Parity with the reference's ``matchPair`` stage
(src/sparseBuilder/sparseBuilder.cpp:758-807): EXHAUSTIVE all-pairs (the
default, .cpp:786) and CONTIGUOUS windowed pairs (.cpp:784-797) which is the
reference's scale lever for long sequences (SURVEY.md §5 long-context analog).

``retrieval_pairs`` adds the capability the reference reaches through its
exhaustive default + scalable matcher methods (cascade hashing / HNSW,
sparseBuilder.cpp:909-944): at collection sizes where exhaustive pairing is
off the table and contiguous pairing is pure odometry, a coarse global
descriptor per view (pooled SIFT, one matmul for all-pairs similarity)
proposes top-k revisit candidates — loop closure enters through the pair
list, and the downstream ratio-test + geometric filter verify each
candidate as usual.

Pair lists are host-side numpy (they parameterize sharding and batching,
not device compute); the retrieval similarity + top-k runs on device and
fetches only (V, k) indices.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("top_k", "exclude", "pool_k"))
def _retrieval_topk(desc, mask, top_k: int, exclude: int, pool_k: int):
    """Per-view top-k most-similar other views by pooled-descriptor cosine.
    desc (V, N, D) score-sorted descriptors, mask (V, N).  Views within
    `exclude` of the query are suppressed (the contiguous window already
    covers them)."""
    d = desc[:, :pool_k].astype(jnp.float32)
    m = mask[:, :pool_k].astype(jnp.float32)[..., None]
    g = jnp.sum(d * m, axis=1)
    g = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-8)
    s = g @ g.T
    v = s.shape[0]
    i = jnp.arange(v)
    near = jnp.abs(i[:, None] - i[None, :]) <= exclude
    s = jnp.where(near, -1.0, s)
    vals, idx = jax.lax.top_k(s, top_k)
    return vals, idx


def retrieval_pairs(desc, mask, exclude: int, top_k: int = 3,
                    min_sim: float = 0.5) -> np.ndarray:
    """Loop-closure / revisit candidate pairs from pooled-descriptor
    retrieval.  Returns (K, 2) int32 with i < j, deduplicated.  Candidates
    are *proposals*: full matching and the geometric filter downstream
    reject non-overlapping ones (the min_matches / inlier-ratio gates), so
    precision here only costs compute, never correctness."""
    import jax

    vals, idx = jax.device_get(_retrieval_topk(
        desc, mask, top_k=int(top_k), exclude=int(exclude),
        pool_k=min(256, desc.shape[1])))
    v = vals.shape[0]
    qi = np.repeat(np.arange(v), top_k)
    qj = idx.reshape(-1)
    keep = vals.reshape(-1) >= min_sim
    a = np.minimum(qi, qj)[keep]
    b = np.maximum(qi, qj)[keep]
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    pairs = pairs[pairs[:, 1] - pairs[:, 0] > exclude]
    return pairs.astype(np.int32).reshape(-1, 2)


def exhaustive_pairs(n_views: int) -> np.ndarray:
    """All (i, j) with i < j — O(N^2) (exhaustivePairs, .cpp:786)."""
    i, j = np.triu_indices(n_views, k=1)
    return np.stack([i, j], axis=1).astype(np.int32)


def contiguous_pairs(n_views: int, window: int = 5) -> np.ndarray:
    """(i, j) with 0 < j - i <= window (contiguousWithOverlap, .cpp:793-797)."""
    out = []
    for i in range(n_views):
        for j in range(i + 1, min(i + 1 + window, n_views)):
            out.append((i, j))
    return np.asarray(out, dtype=np.int32).reshape(-1, 2)


def shard_pairs(pairs: np.ndarray, n_shards: int) -> list[np.ndarray]:
    """Split a pair list into near-equal shards (device-parallel matching,
    SURVEY.md §2.3 item 3).  Round-robin keeps per-shard work balanced when
    contiguous pairs cluster by view."""
    return [pairs[s::n_shards] for s in range(n_shards)]


def pad_pairs(pairs: np.ndarray, multiple: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the pair list to a multiple (static shapes for jit); returns
    (padded_pairs, valid_mask).  Padding repeats pair 0 and is masked out."""
    n = len(pairs)
    if n == 0:
        padded = np.zeros((multiple, 2), np.int32)
        return padded, np.zeros((multiple,), bool)
    m = ((n + multiple - 1) // multiple) * multiple
    pad = np.repeat(pairs[:1], m - n, axis=0)
    return np.concatenate([pairs, pad]), np.arange(m) < n
