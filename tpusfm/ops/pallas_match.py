"""Fused descriptor distance + running top-2 matcher, a Pallas kernel on the
Triton route for NVIDIA GPUs.

The matching hot loop (SURVEY.md §3.2 'match', the reference's cascade
hashing / HNSW at sparseBuilder.cpp:909-963) reduces to: for every
descriptor in A, the two smallest squared-L2 distances to B and the argmin.
The plain XLA path (matching.match) writes the full (Na, Nb) float32
distance matrix to device memory and reads it back to reduce it: at D = 128
that is ~2*Na*Nb*128 FLOP against ~8*Na*Nb bytes, far below the tensor
cores' FLOP/byte ridge, and at 8,192 features a pair's matrix alone is
268 MB.  Here each program owns a block of A rows, streams B tiles through
an in-kernel loop (Triton pipelines the tile loads over `num_stages`), and
keeps a running (m1, m2, argmin) per row in registers: the (Na, Nb) matrix
never exists.

Cross-checking needs the column-wise argmin as well.  The same pass emits,
per A block, the minimum over its rows for every B column and the row that
attains it; a small XLA reduction over the (Na / BM, Nb) block minima
finishes it.  On an H100 that single pass beat a second pass with A and B
swapped at 1,024, 2,048 and 8,192 features (PERF.md).  Block sizes were
chosen on the same card: 64 x 64 tiles, 4 warps and 3 stages.

`quantized=True` runs the products in bf16 with float32 accumulation: SIFT
descriptors lie on the u8 grid (integers 0..255, features/sift.py RootSIFT
x512), which bf16 represents exactly, and every partial sum of products
stays below 2^24, so the result is bit-identical to float32 on that grid.
Float descriptors (`quantized=False`) run the product in IEEE float32
(`Precision.HIGHEST`), never TF32.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_INF = 3.4e38
INF = jnp.float32(_INF)
BM = 64    # A rows per program
BN = 64    # B columns per loop step
NUM_WARPS = 4
NUM_STAGES = 3


def _match_kernel(a_ref, b_ref, b2m_ref, a2m_ref,
                  m1_ref, m2_ref, i1_ref, *col_refs, precision):
    """One program: a block of BM rows of A against all of B.

    a_ref (BM, D); b_ref (Nb, D); b2m_ref (Nb,) = |b|^2, +inf at masked
    columns; a2m_ref (BM,) = |a|^2, +inf at masked rows.  Outputs per A row:
    m1, m2 (smallest and second smallest |b|^2 - 2 a.b) and i1 (argmin
    column); per B column: cm (min over this block's rows of
    |a|^2 - 2 a.b) and ci (the block-local row attaining it)."""
    a = a_ref[...]
    a2m = a2m_ref[...]
    bm = a.shape[0]
    nt = b_ref.shape[0] // BN

    def body(t, carry):
        m1, m2, i1 = carry
        cols = pl.ds(t * BN, BN)
        ab = pl.dot(a, b_ref[cols, :], trans_b=True, precision=precision)
        s = b2m_ref[cols][None, :] - 2.0 * ab                 # (BM, BN)
        tm1 = jnp.min(s, axis=1)
        tc = jnp.argmin(s, axis=1).astype(jnp.int32)
        col = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
        tm2 = jnp.min(jnp.where(col == tc[:, None], _INF, s), axis=1)
        m2 = jnp.minimum(jnp.maximum(m1, tm1), jnp.minimum(m2, tm2))
        # Strict <: an earlier tile keeps a tie, as argmin keeps the first.
        i1 = jnp.where(tm1 < m1, t * BN + tc, i1)
        m1 = jnp.minimum(m1, tm1)
        if col_refs:
            cm_ref, ci_ref = col_refs
            sc = a2m[:, None] - 2.0 * ab
            cm_ref[cols] = jnp.min(sc, axis=0)
            ci_ref[cols] = jnp.argmin(sc, axis=0).astype(jnp.int32)
        return m1, m2, i1

    init = (jnp.full((bm,), _INF, jnp.float32),
            jnp.full((bm,), _INF, jnp.float32),
            jnp.zeros((bm,), jnp.int32))
    m1, m2, i1 = jax.lax.fori_loop(0, nt, body, init)
    m1_ref[...] = m1
    m2_ref[...] = m2
    i1_ref[...] = i1


def _pad_axis(x, n, axis, value=0):
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=value)


@partial(jax.jit, static_argnames=("quantized", "interpret", "columns"))
def match_top2(da, db, mask_a, mask_b, quantized: bool = False,
               interpret: bool = False, columns: bool = True):
    """Fused top-2 for a batch of pairs.  da (P, Na, D), db (P, Nb, D),
    masks (P, Na) / (P, Nb); D must be a power of two.

    Returns d1, d2 (P, Na) squared L2 distances to the nearest and second
    nearest valid B row (+inf where none), i1 (P, Na) the nearest row, and
    j1 (P, Nb) the nearest valid A row of every B row (None unless
    `columns`)."""
    n_pairs, na, dim = da.shape
    nb = db.shape[1]
    if dim & (dim - 1):
        raise ValueError(f"descriptor width {dim} is not a power of two")
    na_p = pl.cdiv(na, BM) * BM
    nb_p = pl.cdiv(nb, BN) * BN
    n_blk = na_p // BM
    af = _pad_axis(da.astype(jnp.float32), na_p, 1)
    bf = _pad_axis(db.astype(jnp.float32), nb_p, 1)
    ma = _pad_axis(mask_a, na_p, 1, False)
    mb = _pad_axis(mask_b, nb_p, 1, False)
    a2 = jnp.sum(af * af, axis=-1)
    b2 = jnp.sum(bf * bf, axis=-1)
    a2m = jnp.where(ma, a2, INF)
    b2m = jnp.where(mb, b2, INF)
    cdt = jnp.bfloat16 if quantized else jnp.float32
    precision = None if quantized else jax.lax.Precision.HIGHEST

    row_spec = pl.BlockSpec((None, BM), lambda p, i: (p, i))
    col_spec = pl.BlockSpec((None, None, nb_p), lambda p, i: (p, i, 0))
    col_shapes = [jax.ShapeDtypeStruct((n_pairs, n_blk, nb_p), jnp.float32),
                  jax.ShapeDtypeStruct((n_pairs, n_blk, nb_p), jnp.int32)]
    outs = pl.pallas_call(
        partial(_match_kernel, precision=precision),
        grid=(n_pairs, n_blk),
        in_specs=[
            pl.BlockSpec((None, BM, dim), lambda p, i: (p, i, 0)),
            pl.BlockSpec((None, nb_p, dim), lambda p, i: (p, 0, 0)),
            pl.BlockSpec((None, nb_p), lambda p, i: (p, 0)),
            row_spec,
        ],
        out_specs=[row_spec, row_spec, row_spec]
        + ([col_spec, col_spec] if columns else []),
        out_shape=[
            jax.ShapeDtypeStruct((n_pairs, na_p), jnp.float32),
            jax.ShapeDtypeStruct((n_pairs, na_p), jnp.float32),
            jax.ShapeDtypeStruct((n_pairs, na_p), jnp.int32),
        ] + (col_shapes if columns else []),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="match_top2",
    )(af.astype(cdt), bf.astype(cdt), b2m, a2m)
    m1, m2, i1 = outs[:3]
    a2 = a2[:, :na]
    d1 = jnp.where(m1[:, :na] < INF, jnp.maximum(m1[:, :na] + a2, 0.0), INF)
    d2 = jnp.where(m2[:, :na] < INF, jnp.maximum(m2[:, :na] + a2, 0.0), INF)
    if not columns:
        return d1, d2, i1[:, :na], None
    # Column argmin: the first block holding the minimum, then its row.
    cm, ci = outs[3:]
    blk = jnp.argmin(cm, axis=1)                                 # (P, Nb_p)
    row = jnp.take_along_axis(ci, blk[:, None, :], axis=1)[:, 0]
    j1 = (blk * BM + row)[:, :nb].astype(jnp.int32)
    return d1, d2, i1[:, :na], j1


@partial(jax.jit, static_argnames=("ratio", "cross_check", "quantized",
                                   "interpret"))
def match_descriptors_fused(da, db, mask_a, mask_b, ratio: float = 0.8,
                            cross_check: bool = True, quantized: bool = False,
                            interpret: bool = False):
    """Batched drop-in for matching.match.match_descriptors on the fused
    kernel: (P, Na, D) x (P, Nb, D) -> (idx_b (P, Na) int32, valid (P, Na))."""
    d1, d2, i1, j1 = match_top2(da, db, mask_a, mask_b, quantized=quantized,
                                interpret=interpret, columns=cross_check)
    ok = mask_a & (d1 < (ratio * ratio) * d2) & (d1 < INF)
    if cross_check:
        mutual = jnp.take_along_axis(j1, i1, axis=-1) == jnp.arange(
            da.shape[-2], dtype=jnp.int32)
        ok = ok & mutual
    return i1, ok
