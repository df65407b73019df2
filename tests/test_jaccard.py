"""Retrieval parity tests: packed-index scorer vs brute-force set-math oracle.

Oracle reimplements the reference semantics from scratch (match_maker.py:16-50):
weighted-Jaccard = Σ idf(common n-grams) / (Σ idf(truth n-grams) +
max_intersection − Σ idf(common n-grams)).
"""

import math
import random
import string

import numpy as np
import pytest

from doppelspeller.config import Config
from doppelspeller.ops.jaccard import JaccardScorer
from doppelspeller.ops.ngram_index import TruthIndex, build_truth_index, plan_query_blocks
from doppelspeller.utils import text as T
from doppelspeller.utils.io import TitleSet


def _random_titles(n, rng, min_len=3, max_len=40):
    alphabet = string.ascii_lowercase + "  0123456789"
    out = []
    for _ in range(n):
        ln = rng.randint(min_len, max_len)
        t = "".join(rng.choice(alphabet) for _ in range(ln))
        out.append(t)
    return out


def _oracle_scores(query_title, truth_titles, idf_map, max_idf, n_truth):
    """Brute-force weighted Jaccard for one query against all truth titles."""
    q_grams = T.get_n_grams(query_title, 3)
    max_int = sum(idf_map.get(g, max_idf) for g in q_grams)
    scores = []
    for t in truth_titles:
        t_grams = T.get_n_grams(t, 3)
        common = q_grams & t_grams
        num = sum(idf_map[g] for g in common)
        sums_t = sum(idf_map[g] for g in t_grams)
        scores.append(num / (sums_t + max_int - num))
    return np.array(scores, dtype=np.float64)


@pytest.fixture(scope="module")
def small_world():
    rng = random.Random(42)
    truth_titles = _random_titles(300, rng)
    query_titles = _random_titles(37, rng)
    # include exact and near matches
    query_titles += [truth_titles[5], truth_titles[10][:-1] + "x"]
    cfg = Config(data_path="/tmp/x", title_block=128, query_block=8, score_dtype="float32")
    truth = TitleSet.from_titles(truth_titles, config=cfg)
    queries = TitleSet.from_titles(query_titles, config=cfg)
    index = build_truth_index(truth, cfg)

    # idf map over transformed truth titles
    from collections import Counter

    gram_counter = Counter()
    for t in truth.transformed:
        gram_counter.update(T.get_n_grams(t, 3))
    n_truth = len(truth_titles)
    idf_map = {g: math.log(n_truth / c) for g, c in gram_counter.items()}
    max_idf = max(idf_map.values())
    return cfg, truth, queries, index, idf_map, max_idf


def test_index_build_consistency(small_world):
    cfg, truth, queries, index, idf_map, max_idf = small_world
    assert index.num_titles == len(truth)
    assert index.padded_titles % cfg.title_block == 0
    # per-title sums must equal set-math sums
    for t_i in [0, 7, 123]:
        grams = T.get_n_grams(truth.transformed[t_i], 3)
        expected = sum(idf_map[g] for g in grams)
        assert np.isclose(index.sums[t_i], expected, rtol=1e-5)
    assert np.isclose(index.max_idf, max_idf, rtol=1e-6)
    # padding columns must be zero
    assert index.sums[index.num_titles:].sum() == 0.0


def test_planner_covers_all_queries(small_world):
    cfg, truth, queries, index, idf_map, max_idf = small_world
    plans = plan_query_blocks(queries, index, cfg)
    covered = np.concatenate([p.query_rows for p in plans])
    np.testing.assert_array_equal(np.sort(covered), np.arange(len(queries)))
    for p in plans:
        # unions are padded to the smallest static bucket that holds them
        assert p.weights.shape[0] == cfg.query_block
        assert p.weights.shape[1] in cfg.union_buckets
        assert p.n_valid == len(p.query_rows)


def test_scores_match_oracle(small_world):
    cfg, truth, queries, index, idf_map, max_idf = small_world
    scorer = JaccardScorer(index, cfg)
    k = 20
    scores, pos = scorer.topk(queries, k=k)
    assert scores.shape == (len(queries), k)
    for qi in range(len(queries)):
        oracle = _oracle_scores(
            queries.transformed[qi], truth.transformed, idf_map, max_idf, len(truth)
        )
        order = np.argsort(-oracle, kind="stable")
        top_oracle = oracle[order[:k]]
        # top-k *scores* must match the oracle's top-k scores (tie-agnostic)
        np.testing.assert_allclose(scores[qi], top_oracle, rtol=2e-4, atol=1e-6)
        # returned positions must actually achieve those scores
        np.testing.assert_allclose(oracle[pos[qi]], scores[qi], rtol=2e-4, atol=1e-6)


def test_exact_match_scores_highest(small_world):
    cfg, truth, queries, index, idf_map, max_idf = small_world
    scorer = JaccardScorer(index, cfg)
    scores, pos = scorer.topk(queries, k=5)
    # query 37 is truth title 5 verbatim
    qi = 37
    assert pos[qi, 0] == 5
    assert scores[qi, 0] == pytest.approx(1.0, rel=1e-5)


def test_topk_subset_rows(small_world):
    cfg, truth, queries, index, idf_map, max_idf = small_world
    scorer = JaccardScorer(index, cfg)
    all_scores, all_pos = scorer.topk(queries, k=10)
    subset = np.array([3, 17, 38])
    s, p = scorer.topk(queries, k=10, rows=subset)
    np.testing.assert_allclose(s, all_scores[subset], rtol=1e-6)


def test_bfloat16_recall_matches_float32(small_world):
    """The fast bf16 scoring path must preserve top-k candidate recall."""
    cfg, truth, queries, index, idf_map, max_idf = small_world
    f32 = JaccardScorer(index, cfg)
    bf16 = JaccardScorer(index, cfg.with_(score_dtype="bfloat16"))
    k = 10
    s1, p1 = f32.topk(queries, k=k)
    s2, p2 = bf16.topk(queries, k=k)
    np.testing.assert_allclose(s1, s2, rtol=8e-3, atol=1e-3)
    # recall of the top-10 candidate sets (ties may reorder)
    recall = np.mean([
        len(set(p1[i]) & set(p2[i])) / k for i in range(len(queries))
    ])
    assert recall > 0.97


def test_index_save_load_roundtrip(small_world, tmp_path):
    cfg, truth, queries, index, idf_map, max_idf = small_world
    path = str(tmp_path / "index.npz")
    index.save(path)
    loaded = TruthIndex.load(path)
    np.testing.assert_array_equal(loaded.packed, index.packed)
    np.testing.assert_array_equal(loaded.title_ids, index.title_ids)
    assert loaded.num_titles == index.num_titles
    assert loaded.max_idf == index.max_idf


def test_device_index_build_matches_host(small_world):
    """On-device index construction (ops/index_device.py) must be
    bit-for-bit equal to the host builder: packed bytes, df, idf, sums."""
    import numpy as np

    from doppelspeller.ops.index_device import build_truth_index_device
    from doppelspeller.ops.ngram_index import build_truth_index

    cfg, truth, queries, host, idf_map, max_idf = small_world
    dev = build_truth_index_device(truth, cfg, block=64)
    np.testing.assert_array_equal(np.asarray(dev.packed), host.packed)
    np.testing.assert_array_equal(dev.df, host.df)
    np.testing.assert_allclose(dev.idf, host.idf, rtol=1e-6)
    np.testing.assert_allclose(dev.sums, host.sums, rtol=1e-5, atol=1e-5)
    assert dev.num_titles == host.num_titles
    assert dev.padded_titles == host.padded_titles
    assert dev.content_hash == host.content_hash
