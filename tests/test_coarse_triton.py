"""The folded coarse pass as a Pallas-Triton kernel (ops/coarse_triton.py)
against its plain XLA reference.  Here the kernel runs in the Pallas
interpreter; the ``gpu`` test compiles it for the card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from doppelspeller.ops.coarse_triton import (
    WINDOW,
    coarse_topk,
    coarse_window_max,
)
from doppelspeller.ops.jaccard import topk_over_blocks, unpack_bits, window_max


def _inputs(qb, ntp, C, folds, nt, seed=0):
    """Random folded bits and bf16-exact sparse weights shaped like one
    query block of the folded engine."""
    rng = np.random.default_rng(seed)
    mc = rng.integers(0, 256, (folds * C, ntp // 8), dtype=np.uint8)
    mc &= rng.integers(0, 256, mc.shape, dtype=np.uint8)     # sparser bits
    sums = rng.uniform(5, 40, ntp).astype(np.float32)
    w = rng.uniform(0, 8, (qb, folds * C)) * (rng.random((qb, folds * C)) < 0.05)
    w = jnp.asarray(w, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32)
    maxint = w[:, :C].sum(axis=1) + 2.0
    return (jnp.asarray(mc), jnp.asarray(sums), w, maxint, jnp.int32(nt))


def _plain_scores(mc, sums, w, maxint, nt, folds):
    h = mc.shape[0] // folds
    num = None
    for f in range(folds):
        s = jnp.dot(w[:, f * h:(f + 1) * h],
                    unpack_bits(mc[f * h:(f + 1) * h]).astype(jnp.float32),
                    precision=jax.lax.Precision.HIGHEST)
        num = s if num is None else jnp.minimum(num, s)
    jacc = num / jnp.maximum(sums[None, :] + maxint[:, None] - num, 1e-9)
    return np.asarray(jnp.where(jnp.arange(jacc.shape[1]) < nt, jacc, -1.0))


@pytest.mark.parametrize("qb,ntp,C,folds,nt", [
    (8, 1024, 64, 1, 1000),      # query block padded to one 16-row tile
    (16, 2048, 32, 2, 2048),     # two hashes, every title real
    (70, 1024, 64, 2, 777),      # 70 queries → two 64-row tiles, padded
])
def test_window_maxima_match_plain_scores(qb, ntp, C, folds, nt):
    args = _inputs(qb, ntp, C, folds, nt, seed=qb)
    wmax, warg = coarse_window_max(*args, folds=folds, interpret=True)
    assert wmax.shape == warg.shape == (qb, ntp // WINDOW)
    jacc = _plain_scores(*args, folds)
    ref_max, _ = window_max(jnp.asarray(jacc), WINDOW)
    np.testing.assert_allclose(np.asarray(wmax), np.asarray(ref_max),
                               rtol=1e-5, atol=1e-6)
    # the reported offset holds the window's max (ties may pick another)
    warg = np.asarray(warg)
    assert ((warg >= 0) & (warg < WINDOW)).all()
    b = np.arange(ntp // WINDOW)[None, :]
    picked = jacc[np.arange(qb)[:, None], b * WINDOW + warg]
    np.testing.assert_allclose(picked, np.asarray(ref_max), rtol=1e-5, atol=1e-6)
    # windows past the last real title score -1
    assert (np.asarray(wmax)[:, -(-nt // WINDOW):] == -1).all()


def test_coarse_topk_matches_windowed_plain_scorer():
    """coarse_topk (kernel windows + blocked exact top-k) returns the same
    top-k' values as the plain scorer's windowed select."""
    qb, ntp, C, folds, k = 16, 4096, 64, 2, 24
    args = _inputs(qb, ntp, C, folds, nt=4000, seed=5)
    v, p = coarse_topk(*args, k=k, folds=folds, merge=128, interpret=True)
    vx, px = topk_over_blocks(args[0], args[1], args[2], args[3], jnp.int32(0),
                              args[4], k=k, title_block=1024,
                              score_dtype="bfloat16", folds=folds, window=WINDOW)
    np.testing.assert_allclose(np.asarray(v), np.asarray(vx), rtol=1e-5,
                               atol=1e-6)
    # every returned position carries its returned score
    jacc = _plain_scores(*args, folds)
    np.testing.assert_allclose(jacc[np.arange(qb)[:, None], np.asarray(p)],
                               np.asarray(v), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ntp,C", [(1000, 64), (1024, 40)])
def test_rejects_shapes_the_kernel_cannot_tile(ntp, C):
    args = _inputs(8, ntp - ntp % 8, C, 1, 10)
    with pytest.raises(ValueError, match="coarse kernel needs"):
        coarse_window_max(*args, folds=1, interpret=True)


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_scores_on_gpu(gpu):
    """Compiled for the card at a real width: 128 queries × 2 × 512 folds
    × 131,072 titles."""
    with jax.default_device(gpu):
        args = _inputs(128, 131072, 512, 2, 131000, seed=1)
        wmax, _ = coarse_window_max(*args, folds=2)
        ref_max, _ = window_max(jnp.asarray(_plain_scores(*args, 2)), WINDOW)
    np.testing.assert_allclose(np.asarray(wmax), np.asarray(ref_max),
                               rtol=1e-5, atol=1e-6)
