"""Folded two-stage retrieval (ops/fold.py) vs the exact scorer.

Strategy: with fold_dim >= the number of observed trigrams the fold map is
injective on observed ids, so the coarse stage IS the exact computation and
the whole folded path must reproduce the exact scorer bit-for-bit (same
float32 config on both sides).  With a lossy fold the coarse scores must
remain an upper bound of the exact ones and the exact-rescore stage must
return exact scores for every retained candidate; retrieval loss is
measured on score CURVES (position sets are tie-dominated on small worlds).
Reference capability: match_maker.py:16-50.
"""

import numpy as np
import pytest

from doppelspeller.ops.fold import build_fold_map, plan_id_blocks
from doppelspeller.ops.jaccard import JaccardScorer
from doppelspeller.ops.ngram_index import build_truth_index


@pytest.fixture(scope="module")
def world():
    from bench import make_synthetic_world

    cfg, truth, queries, _ = make_synthetic_world(1500, 300)
    cfg = cfg.with_(title_block=2048, dispatch_blocks=4, query_block=64,
                    score_dtype="float32", retrieval_window_select=False)
    index = build_truth_index(truth, cfg)
    exact = JaccardScorer(index, cfg)
    vs, ps = exact.topk(queries, k=25)
    return cfg, truth, queries, index, vs, ps


def test_fold_map_balanced_and_injective_when_wide():
    df = np.zeros(50653, dtype=np.int32)
    rng = np.random.default_rng(0)
    obs = rng.choice(50653, size=600, replace=False)
    df[obs] = rng.integers(1, 1000, size=600)
    fold = build_fold_map(df, 1024)
    assert fold.shape == (50654,)
    assert fold[50653] == 1024
    # injective on observed ids when C >= observed count
    assert len(np.unique(fold[obs])) == 600
    # balanced loads with a lossy fold
    fold2 = build_fold_map(df, 64)
    loads = np.zeros(64, np.int64)
    np.add.at(loads, fold2[obs], df[obs].astype(np.int64))
    assert loads.max() <= loads.min() + df[obs].max()


def test_injective_fold_equals_exact(world):
    cfg, truth, queries, index, vs_e, ps_e = world
    observed = int((index.df > 0).sum())
    assert observed <= 8192, "world too big for the injective test"
    cfgf = cfg.with_(retrieval_mode="folded", fold_dim=8192, rescore_depth=32)
    folded = JaccardScorer(index, cfgf, truth=truth)
    vs_f, ps_f = folded.topk(queries, k=25)
    np.testing.assert_allclose(vs_e, vs_f, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ps_e, ps_f)


def test_lossy_fold_head_and_exact_scores(world):
    """A lossy fold may drop tail junk (whose collision upper bounds outrank
    near-zero exact scores), but the HEAD of every query's ranking — what
    the fuzzy/model stages actually consume — must survive, and every
    retained candidate must carry its exact score."""
    cfg, truth, queries, index, vs_e, ps_e = world
    cfgf = cfg.with_(retrieval_mode="folded", fold_dim=512, rescore_depth=128)
    folded = JaccardScorer(index, cfgf, truth=truth)
    vs_f, ps_f = folded.topk(queries, k=25)
    # strong candidates are never lost: a real match's coarse upper bound
    # can only be buried below rescore_depth by > depth junk collision
    # bounds, which cluster well under 0.15 (only near-zero junk-tail
    # candidates may be displaced — the exact 5th-best of a small world is
    # often junk itself, so the gate is score-conditioned, not positional)
    strong = vs_e >= 0.15
    head_loss = np.where(strong, vs_e - vs_f, 0.0).max()
    assert float(head_loss) < 1e-5
    assert strong.any()
    # retained candidates carry the exact score
    score_e = {
        (i, int(ps_e[i, j])): vs_e[i, j]
        for i in range(ps_e.shape[0]) for j in range(ps_e.shape[1])
    }
    checked = 0
    for i in range(ps_f.shape[0]):
        for j in range(ps_f.shape[1]):
            key = (i, int(ps_f[i, j]))
            if key in score_e:
                assert abs(vs_f[i, j] - score_e[key]) < 1e-5
                checked += 1
    assert checked > 0


def test_coarse_is_upper_bound(world):
    """rescore_depth=0 returns raw coarse scores; they must dominate the
    exact scores of the same (query, title) pairs."""
    cfg, truth, queries, index, vs_e, ps_e = world
    cfgc = cfg.with_(retrieval_mode="folded", fold_dim=256, rescore_depth=0)
    coarse = JaccardScorer(index, cfgc, truth=truth)
    vs_c, ps_c = coarse.topk(queries, k=25)
    lookup = {
        (i, int(ps_c[i, j])): vs_c[i, j]
        for i in range(ps_c.shape[0]) for j in range(ps_c.shape[1])
    }
    hits = 0
    for i in range(ps_e.shape[0]):
        for j in range(ps_e.shape[1]):
            key = (i, int(ps_e[i, j]))
            if key in lookup:
                assert lookup[key] >= vs_e[i, j] - 1e-5
                hits += 1
    assert hits > 0


def test_plan_id_blocks_shapes(world):
    cfg, truth, queries, *_ = world
    plans = plan_id_blocks(queries, cfg)
    assert sum(p.n_valid for p in plans) == len(queries)
    for p in plans:
        assert p.ids.shape[0] == cfg.query_block
        assert p.ids.dtype == np.int32
        assert p.ids.max() <= 50653        # invalid slots hold the sentinel
    rows = np.concatenate([p.query_rows for p in plans])
    np.testing.assert_array_equal(np.sort(rows), np.arange(len(queries)))


def test_fold_query_block_results_invariant(world):
    """fold_query_block only re-tiles the folded dispatch — results are
    identical to the default (query_block-sized) folded blocks."""
    cfg, truth, queries, index, *_ = world
    base = dict(retrieval_mode="folded", fold_dim=512, rescore_depth=64)
    s_small = JaccardScorer(index, cfg.with_(**base), truth=truth)
    s_big = JaccardScorer(
        index, cfg.with_(fold_query_block=256, **base), truth=truth
    )
    plans_big = plan_id_blocks(queries, cfg.with_(fold_query_block=256))
    assert plans_big[0].ids.shape[0] == 256
    v1, p1 = s_small.topk(queries, k=25)
    v2, p2 = s_big.topk(queries, k=25)
    np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(p1, p2)


def test_folded_triton_interpret_matches_xla(world):
    """The production coarse route (bf16, two hashes, windowed select) runs
    as the Pallas-Triton kernel on the GPU; in interpret mode it must give
    the plain XLA folded path's results.  Coarse bf16 scores are upper
    bounds, so the comparison is after the exact f32 rescore: same scores,
    and the same positions wherever a score is not tied."""
    cfg, truth, queries, index, *_ = world
    base = dict(retrieval_mode="folded", fold_dim=512, rescore_depth=32,
                fold_hashes=2, score_dtype="bfloat16",
                retrieval_window_select=True)
    sub_rows = np.arange(64)
    s_x = JaccardScorer(index, cfg.with_(retrieval_impl="xla", **base),
                        truth=truth)
    s_t = JaccardScorer(index, cfg.with_(retrieval_impl="triton", **base),
                        truth=truth)
    assert (s_x.folded.route, s_t.folded.route) == ("xla", "triton")
    s_t.folded.route = "triton_interpret"
    vx, px = s_x.topk(queries, k=10, rows=sub_rows)
    vt, pt = s_t.topk(queries, k=10, rows=sub_rows)
    np.testing.assert_allclose(vx, vt, rtol=1e-5, atol=1e-6)
    untied = np.ones_like(vx, bool)
    untied[:, 1:] &= vx[:, 1:] < vx[:, :-1]
    untied[:, :-1] &= vx[:, :-1] > vx[:, 1:]
    assert untied.any()
    np.testing.assert_array_equal(px[untied], pt[untied])


def test_two_hash_injective_equals_exact(world):
    """fold_hashes=2 with injective folds: both per-hash numerators are the
    exact intersection, their min is too — the whole two-hash plain XLA
    path must reproduce the exact scorer bit-for-bit."""
    cfg, truth, queries, index, vs_e, ps_e = world
    cfgf = cfg.with_(retrieval_mode="folded", fold_dim=8192, rescore_depth=32,
                     fold_hashes=2)
    folded = JaccardScorer(index, cfgf, truth=truth)
    assert folded.folded.folds == 2
    assert folded.folded.mc_d.shape[0] == 2 * 8192
    vs_f, ps_f = folded.topk(queries, k=25)
    np.testing.assert_allclose(vs_e, vs_f, rtol=1e-5, atol=1e-6)
    # positions: exact wherever the score is NOT tied with a neighbour (the
    # second hash's different f32 accumulation order legitimately permutes
    # equal-score ties; the single-hash test keeps the bitwise gate)
    tied_lo = np.concatenate(
        [np.zeros((vs_e.shape[0], 1), bool), vs_e[:, 1:] >= vs_e[:, :-1] - 1e-7],
        axis=1)
    tied_hi = np.concatenate(
        [vs_e[:, :-1] <= vs_e[:, 1:] + 1e-7, np.zeros((vs_e.shape[0], 1), bool)],
        axis=1)
    untied = ~(tied_lo | tied_hi)
    assert untied.any()
    np.testing.assert_array_equal(ps_e[untied], ps_f[untied])


def test_two_hash_coarse_is_tighter_upper_bound(world):
    """Lossy fold_hashes=2 raw coarse scores (rescore_depth=0) still
    dominate the exact scores of the same pairs, and are pointwise <= the
    single-hash (first hash) coarse bound."""
    cfg, truth, queries, index, vs_e, ps_e = world
    base = dict(retrieval_mode="folded", fold_dim=256, rescore_depth=0)
    c2 = JaccardScorer(index, cfg.with_(fold_hashes=2, **base), truth=truth)
    vs_c, ps_c = c2.topk(queries, k=25)
    lookup = {
        (i, int(ps_c[i, j])): vs_c[i, j]
        for i in range(ps_c.shape[0]) for j in range(ps_c.shape[1])
    }
    hits = 0
    for i in range(ps_e.shape[0]):
        for j in range(ps_e.shape[1]):
            key = (i, int(ps_e[i, j]))
            if key in lookup:
                assert lookup[key] >= vs_e[i, j] - 1e-5
                hits += 1
    assert hits > 0
    # tighter than (or equal to) the single-hash bound on shared pairs
    c1 = JaccardScorer(index, cfg.with_(fold_hashes=1, **base), truth=truth)
    vs_1, ps_1 = c1.topk(queries, k=25)
    one = {
        (i, int(ps_1[i, j])): vs_1[i, j]
        for i in range(ps_1.shape[0]) for j in range(ps_1.shape[1])
    }
    shared = 0
    for key, v2 in lookup.items():
        if key in one:
            assert v2 <= one[key] + 1e-5
            shared += 1
    assert shared > 0


def test_two_hash_lossy_head_and_exact_scores(world):
    """fold_hashes=2 production-style config: the strong head survives and
    every retained candidate carries its exact score (same gates as the
    single-hash test)."""
    cfg, truth, queries, index, vs_e, ps_e = world
    cfgf = cfg.with_(retrieval_mode="folded", fold_dim=512, rescore_depth=128,
                     fold_hashes=2)
    folded = JaccardScorer(index, cfgf, truth=truth)
    vs_f, ps_f = folded.topk(queries, k=25)
    strong = vs_e >= 0.15
    head_loss = np.where(strong, vs_e - vs_f, 0.0).max()
    assert float(head_loss) < 1e-5
    assert strong.any()
    score_e = {
        (i, int(ps_e[i, j])): vs_e[i, j]
        for i in range(ps_e.shape[0]) for j in range(ps_e.shape[1])
    }
    checked = 0
    for i in range(ps_f.shape[0]):
        for j in range(ps_f.shape[1]):
            key = (i, int(ps_f[i, j]))
            if key in score_e:
                assert abs(vs_f[i, j] - score_e[key]) < 1e-5
                checked += 1
    assert checked > 0
