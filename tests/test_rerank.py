"""Fused rerank engine parity vs the separate features+predict path (CPU)."""

import random

import numpy as np
import pytest

from doppelspeller.config import Config
from doppelspeller.models.gbt import GBTParams, train_gbt
from doppelspeller.models.trainer import WordCounts
from doppelspeller.ops.features import (
    construct_features,
    remove_spaces_host,
    split_words_host,
)
from doppelspeller.ops.rerank import RerankEngine
from doppelspeller.utils.io import TitleSet


def _titles(n, rng):
    words = ["alpha", "beta", "gamma", "delta", "omega", "sigma", "kappa"]
    return [
        " ".join(rng.choice(words) for _ in range(rng.randint(1, 4)))
        + f" {rng.randint(0, 99)}"
        for _ in range(n)
    ]


@pytest.fixture(scope="module")
def world():
    rng = random.Random(2)
    cfg = Config(data_path="/tmp/x", pair_block=64, score_dtype="float32")
    truth = TitleSet.from_titles(_titles(120, rng), config=cfg)
    queries = TitleSet.from_titles(_titles(25, rng), config=cfg)

    # tiny model on random features
    nprng = np.random.RandomState(0)
    X = nprng.randn(800, 66).astype(np.float32)
    X[nprng.rand(800, 66) < 0.2] = np.nan
    y = (np.nan_to_num(X[:, 4]) > 0).astype(np.float32)
    model = train_gbt(X, y, X[:200], y[:200],
                      GBTParams(num_boost_round=8, early_stopping_rounds=8, depth=4),
                      verbose_every=0)
    return cfg, truth, queries, model


def test_fused_rerank_matches_reference_path(world):
    cfg, truth, queries, model = world
    rng = np.random.RandomState(1)
    word_counts = WordCounts(truth)
    counts_matrix = word_counts.matrix(truth.transformed)
    truth_words = split_words_host(truth.encoded, truth.lengths)
    engine = RerankEngine(
        truth.encoded, truth.lengths, truth_words, counts_matrix,
        model, len(truth), cfg,
    )

    n_pairs = 300
    pair_q = rng.randint(0, len(queries), n_pairs).astype(np.int64)
    pair_t = rng.randint(0, len(truth), n_pairs).astype(np.int64)
    q_wo, q_wo_len = remove_spaces_host(queries.encoded, queries.lengths)

    fused = engine.score(
        queries.encoded, queries.lengths.astype(np.int32),
        q_wo, q_wo_len, pair_q, pair_t, truth.lengths,
    )

    # reference path: explicit feature matrix then model.predict
    X = construct_features(
        queries.encoded[pair_q], queries.lengths[pair_q].astype(np.int32),
        truth.encoded[pair_t], truth.lengths[pair_t].astype(np.int32),
        counts_matrix[pair_t], len(truth), cfg,
    )
    want = model.predict(X)
    np.testing.assert_allclose(fused, want, rtol=1e-5, atol=1e-6)
