"""Descriptor matching: brute-force L2 top-2 with Lowe ratio test.

The reference delegates to OpenMVG collection matchers (cascade hashing L2 /
HNSW, src/sparseBuilder/sparseBuilder.cpp:909-963, ratio 0.8 at .cpp:812).
Here the exact descriptor distance is a (Na x 128) @ (128 x Nb) matrix
product batched over pairs, and exactness removes the recall loss of
hashing (SURVEY.md §7 design stance (d)).

All functions are jit-able with fixed capacities; invalid feature slots are
masked to +inf distance.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

INF = jnp.float32(3.4e38)


def distance_matrix(da: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """Squared-L2 distance matrix via the matmul identity
    |a-b|^2 = |a|^2 + |b|^2 - 2 a.b.  (..., Na, D) x (..., Nb, D)
    -> (..., Na, Nb)."""
    a2 = jnp.sum(da * da, axis=-1, keepdims=True)
    b2 = jnp.sum(db * db, axis=-1, keepdims=True)
    ab = jnp.einsum("...nd,...md->...nm", da, db, preferred_element_type=jnp.float32)
    return jnp.maximum(a2 + jnp.swapaxes(b2, -1, -2) - 2.0 * ab, 0.0)


def _top2_min(d: jnp.ndarray):
    """Smallest and second smallest along the last axis, plus argmin."""
    d1 = jnp.min(d, axis=-1)
    i1 = jnp.argmin(d, axis=-1)
    d_wo = jnp.where(jax.nn.one_hot(i1, d.shape[-1], dtype=bool), INF, d)
    d2 = jnp.min(d_wo, axis=-1)
    return d1, d2, i1


@partial(jax.jit, static_argnames=("ratio", "cross_check"))
def match_descriptors(
    da: jnp.ndarray,
    db: jnp.ndarray,
    mask_a: jnp.ndarray,
    mask_b: jnp.ndarray,
    ratio: float = 0.8,
    cross_check: bool = True,
):
    """Ratio-test matching for one (or a batch of) descriptor pair(s).

    da (..., Na, D), db (..., Nb, D), masks (..., Na)/(..., Nb).
    Returns (idx_b (..., Na) int32, valid (..., Na) bool): for each valid
    feature in A, its match in B passing the Lowe ratio test
    (d1 < ratio^2 * d2 on squared distances — OpenMVG's NN-dist-ratio 0.8,
    sparseBuilder.cpp:812) and optionally mutual-NN cross-checking.
    """
    d = distance_matrix(da, db)
    d = jnp.where(mask_b[..., None, :], d, INF)
    d1, d2, i1 = _top2_min(d)
    ok = mask_a & (d1 < (ratio * ratio) * d2) & (d1 < INF)
    if cross_check:
        d_t = jnp.where(mask_a[..., :, None], d, INF)
        j1 = jnp.argmin(d_t, axis=-2)  # best A for each B
        mutual = jnp.take_along_axis(j1, i1, axis=-1) == jnp.arange(da.shape[-2])
        ok = ok & mutual
    return i1.astype(jnp.int32), ok


def _match_descriptors_xla(da, db, mask_a, mask_b, ratio, cross_check,
                           quantized):
    del quantized  # exact at any precision the CPU runs
    return match_descriptors(da, db, mask_a, mask_b, ratio=ratio,
                             cross_check=cross_check)


def matcher_for(platform: str):
    """The batched matcher that runs on `platform`: the fused Pallas kernel
    on GPUs (ops/pallas_match.py), which never writes the (Na, Nb) distance
    matrix to device memory, and the XLA reduction of match_descriptors on
    the CPU.  This is the one place the choice is made."""
    if platform == "gpu":
        from ..ops import pallas_match

        return pallas_match.match_descriptors_fused
    if platform == "cpu":
        return _match_descriptors_xla
    raise ValueError(f"no descriptor matcher for platform {platform!r}")


def match_batch(da, db, mask_a, mask_b, ratio: float = 0.8,
                cross_check: bool = True, quantized: bool = False):
    """match_descriptors over a batch of pairs (P, Na, D) x (P, Nb, D) on
    the default backend's matcher.  quantized=True declares u8-grid
    descriptors (SIFT), which the GPU kernel multiplies exactly in bf16."""
    return matcher_for(jax.default_backend())(
        da, db, mask_a, mask_b, ratio=ratio, cross_check=cross_check,
        quantized=quantized)


def match_counts(idx: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Number of accepted matches per pair: (..., Na) -> (...,)."""
    del idx
    return jnp.sum(valid.astype(jnp.int32), axis=-1)


def gather_matched_points(kp_a, kp_b, idx_b, valid):
    """kp_a (..., Na, K), kp_b (..., Nb, K), idx_b (..., Na) -> matched
    coordinate arrays (x0, x1) of shape (..., Na, 2) with `valid` masking."""
    x0 = kp_a[..., :2]
    x1 = jnp.take_along_axis(kp_b[..., :2], idx_b[..., None], axis=-2)
    return x0, x1, valid
