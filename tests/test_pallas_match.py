"""Fused top-2 matcher (ops/pallas_match.py) against a numpy brute force and
the XLA matcher: interpret mode on the CPU, the compiled kernel on a GPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpusfm.matching import match
from tpusfm.ops import pallas_match

rng = np.random.default_rng(5)


def planted_pairs(n_pairs=2, na=300, nb=460, n_planted=200, u8=False):
    """B holds noisy copies of n_planted A rows plus unrelated rows."""
    if u8:
        da = rng.integers(0, 256, (n_pairs, na, 128)).astype(np.float32)
        close = np.clip(da[:, :n_planted]
                        + rng.integers(-4, 5, (n_pairs, n_planted, 128)), 0, 255)
        rest = rng.integers(0, 256, (n_pairs, nb - n_planted, 128))
    else:
        da = rng.normal(size=(n_pairs, na, 128)).astype(np.float32) * 20
        close = da[:, :n_planted] + rng.normal(size=(n_pairs, n_planted, 128)) * 0.3
        rest = rng.normal(size=(n_pairs, nb - n_planted, 128)) * 20
    db = np.concatenate([close, rest], axis=1).astype(np.float32)
    db = db[:, rng.permutation(nb)]
    return da, db


def brute_force(da, db, ma, mb):
    """float64 d1, d2, i1 per A row over valid B rows, and the nearest
    valid A row of every B row."""
    d = ((da[:, :, None, :].astype(np.float64)
          - db[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    d = np.where(mb[:, None, :], d, np.inf)
    order = np.argsort(d, axis=-1, kind="stable")
    d1 = np.take_along_axis(d, order[..., :1], -1)[..., 0]
    d2 = np.take_along_axis(d, order[..., 1:2], -1)[..., 0]
    j1 = np.argmin(np.where(ma[:, :, None], d, np.inf), axis=1)
    return d1, d2, order[..., 0], j1


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("na,nb", [(130, 200), (64, 64), (1, 70), (200, 97)])
def test_top2_matches_brute_force(na, nb, quantized):
    """Shapes off the 64-row block, random masks on both sides."""
    da, db = planted_pairs(2, na, nb, min(na, nb) // 2, u8=quantized)
    ma = rng.random((2, na)) > 0.15
    mb = rng.random((2, nb)) > 0.15
    d1, d2, i1, j1 = (np.asarray(x) for x in pallas_match.match_top2(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
        quantized=quantized, interpret=True))
    r1, r2, ri, rj = brute_force(da, db, ma, mb)
    fin = np.isfinite(r1)
    if quantized:  # exact integer arithmetic on the u8 grid
        np.testing.assert_array_equal(d1[fin], r1[fin])
        np.testing.assert_array_equal(d2[np.isfinite(r2)], r2[np.isfinite(r2)])
    else:  # float32 cancellation error scales with |a|^2 + |b|^2
        scale = 2.0 * (da.astype(np.float64) ** 2).sum(-1) + 2.0 * r1
        np.testing.assert_array_less(np.abs(d1 - r1)[fin] / scale[fin], 1e-5)
    np.testing.assert_array_equal(i1[fin], ri[fin])
    assert np.all(d1[~fin] >= 1e38)
    valid_b = mb & ma.any(axis=1, keepdims=True)
    np.testing.assert_array_equal(j1[valid_b], rj[valid_b])


def test_pallas_matches_xla_exactly():
    da, db = planted_pairs(1, u8=True)
    ma = np.ones((1, 300), bool)
    mb = np.ones((1, 460), bool)
    mb[0, 100:120] = False
    i_x, ok_x = match.match_descriptors(*map(jnp.asarray, (da, db, ma, mb)))
    i_p, ok_p = pallas_match.match_descriptors_fused(
        *map(jnp.asarray, (da, db, ma, mb)), quantized=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(ok_x), np.asarray(ok_p))
    both = np.asarray(ok_x)
    np.testing.assert_array_equal(np.asarray(i_x)[both], np.asarray(i_p)[both])
    assert both.sum() > 150


def test_pallas_nonmultiple_shapes_and_masks():
    """Fully masked B gives no match at all; padding rows never match."""
    da, db = planted_pairs(1, na=130, nb=200, n_planted=130)
    ma = jnp.ones((1, 130), bool)
    d1, _, _, _ = pallas_match.match_top2(
        jnp.asarray(da), jnp.asarray(db), ma, jnp.zeros((1, 200), bool),
        interpret=True)
    assert np.all(np.asarray(d1) >= 1e38)
    i1, ok = pallas_match.match_descriptors_fused(
        jnp.asarray(da), jnp.asarray(db), ma, jnp.ones((1, 200), bool),
        interpret=True)
    assert np.asarray(ok).sum() > 100
    assert np.asarray(i1).max() < 200


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("quantized", [True, False])
def test_fused_equals_xla_matcher(cross_check, quantized):
    da, db = planted_pairs(3, na=150, nb=190, n_planted=120, u8=quantized)
    ma = rng.random((3, 150)) > 0.1
    mb = rng.random((3, 190)) > 0.1
    args = [jnp.asarray(x) for x in (da, db, ma, mb)]
    i_x, ok_x = match.match_descriptors(*args, cross_check=cross_check)
    i_p, ok_p = pallas_match.match_descriptors_fused(
        *args, cross_check=cross_check, quantized=quantized, interpret=True)
    ok_x = np.asarray(ok_x)
    np.testing.assert_array_equal(ok_x, np.asarray(ok_p))
    np.testing.assert_array_equal(np.asarray(i_x)[ok_x], np.asarray(i_p)[ok_x])
    assert ok_x.sum() > 150


@pytest.mark.parametrize("platform,expected", [
    ("gpu", pallas_match.match_descriptors_fused),
    ("cpu", match._match_descriptors_xla),
])
def test_matcher_for_platform(platform, expected):
    assert match.matcher_for(platform) is expected


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_matcher_for_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match=platform):
        match.matcher_for(platform)


def test_match_batch_runs_the_cpu_matcher_here():
    da, db = planted_pairs(2, na=40, nb=50, n_planted=30, u8=True)
    m = jnp.ones((2, 40), bool), jnp.ones((2, 50), bool)
    i_b, ok_b = match.match_batch(jnp.asarray(da), jnp.asarray(db), *m,
                                  quantized=True)
    i_x, ok_x = match.match_descriptors(jnp.asarray(da), jnp.asarray(db), *m)
    np.testing.assert_array_equal(np.asarray(ok_b), np.asarray(ok_x))
    np.testing.assert_array_equal(np.asarray(i_b), np.asarray(i_x))


@pytest.mark.gpu
def test_compiled_kernel_matches_reference_on_gpu(gpu):
    """The Triton-compiled kernel at the bench width: bit-identical d1/d2 on
    the u8 grid, the same argmin except at exact ties."""
    da, db = planted_pairs(8, na=1024, nb=1024, n_planted=600, u8=True)
    ma = rng.random((8, 1024)) > 0.1
    mb = rng.random((8, 1024)) > 0.1
    args = [jax.device_put(jnp.asarray(x), gpu) for x in (da, db, ma, mb)]
    d1, d2, i1, _ = (np.asarray(x) for x in
                     pallas_match.match_top2(*args, quantized=True))
    with jax.default_matmul_precision("highest"):
        d = match.distance_matrix(args[0], args[1])
        d = jnp.where(args[3][:, None, :], d, match.INF)
        r1, r2, ri = match._top2_min(d)
        ties = np.asarray(jnp.sum(d == r1[..., None], -1))
    r1, r2, ri = np.asarray(r1), np.asarray(r2), np.asarray(ri)
    fin = r1 < 1e38
    np.testing.assert_array_equal(d1[fin], r1[fin])
    np.testing.assert_array_equal(d2[r2 < 1e38], r2[r2 < 1e38])
    assert not ((i1 != ri) & fin & (ties == 1)).any()
