"""One-dispatch fused small-batch cascade (ops/serve_fused.py) vs the
classic staged path — results must be identical (the fused program composes
the SAME stage kernels; only the dispatch structure changes)."""

import random

import numpy as np
import pytest

from doppelspeller.pipeline import Matcher
from doppelspeller.utils.io import TitleSet, single_title_set
from doppelspeller.utils.misspell import generate_misspelled_name


@pytest.fixture(scope="module")
def matchers(world, trained):
    cfg, truth, train, test, actuals = world
    model, _ = trained
    m_fused = Matcher(cfg, truth=truth, model=model)
    m_classic = Matcher(cfg.with_(serve_fused="off"), truth=truth, model=model)
    return cfg, truth, test, m_fused, m_classic


def _assert_same(r1, r2):
    np.testing.assert_array_equal(r1.match_title_id, r2.match_title_id)
    np.testing.assert_array_equal(r1.stage, r2.stage)
    np.testing.assert_allclose(r1.prediction, r2.prediction, rtol=1e-5,
                               atol=1e-6)


def test_fused_single_title_matches_classic(matchers):
    cfg, truth, test, m_fused, m_classic = matchers
    rng = random.Random(3)
    qs = [
        truth.titles[5],                                   # exact
        generate_misspelled_name(truth.transformed[9], rng),   # fuzzy/model
        generate_misspelled_name(truth.transformed[30], rng),
        "zzqq vvkk nn",                                    # not in truth
    ]
    for q in qs:
        r1 = m_fused.predict(single_title_set(q, cfg), single=True)
        r2 = m_classic.predict(single_title_set(q, cfg), single=True)
        _assert_same(r1, r2)
        # single-title semantics: argmax regardless of threshold — a
        # non-exact query still returns SOME candidate
        if r1.stage[0] != 1:
            assert r1.match_title_id[0] != -1


def test_fused_small_batch_matches_classic(matchers):
    """Batch semantics (thresholds, −1 not-found, tie drops) through the
    fused program must equal the classic staged run."""
    cfg, truth, test, m_fused, m_classic = matchers
    batch = TitleSet.from_titles(
        list(test.titles[:8]), ids=np.arange(8, dtype=np.int64), config=cfg
    )
    r1 = m_fused.predict(batch)
    r2 = m_classic.predict(batch)
    _assert_same(r1, r2)
    assert r1.stage_counts == r2.stage_counts


def test_fused_bucket_fallback_is_exact(world, trained, caplog):
    """Rows whose candidates exceed the compiled rerank bucket must be
    re-decided by the classic host stages with identical results.  A short
    query (tlr stays at the forced 32-bucket) retrieving a crafted
    60+-char truth title trips the probe gate deterministically."""
    import logging

    cfg, truth, train, test, actuals = world
    model, _ = trained
    long_title = "aaxq bbxq ccxq ddxq eexq ffxq ggxq hhxq iixq jjxq kkxq"
    truth2 = TitleSet.from_titles(
        list(truth.titles) + [long_title],
        ids=np.append(truth.ids, [9009]), config=cfg,
    )
    m_fused = Matcher(cfg, truth=truth2, model=model)
    m_classic = Matcher(cfg.with_(serve_fused="off"), truth=truth2,
                        model=model)
    eng = m_fused._fused_engine()
    eng.tlr_default = 32          # candidates probe at 54 chars > bucket 32
    qs = ["aaxq bbxq ccxq"] + list(test.titles[30:35])   # query len 14 < 32
    batch = TitleSet.from_titles(qs, ids=np.arange(len(qs), dtype=np.int64),
                                 config=cfg)
    with caplog.at_level(logging.INFO, logger="doppelspeller.ops.serve_fused"):
        r1 = m_fused.predict(batch)
    assert any("classic host redo" in rec.message for rec in caplog.records), (
        "probe-gated fallback did not fire — test is vacuous"
    )
    r2 = m_classic.predict(batch)
    _assert_same(r1, r2)
    assert r1.stage_counts == r2.stage_counts


@pytest.mark.heavy
def test_fused_folded_retrieval_matches_classic(world, trained):
    """The fused program's folded-retrieval branch (injective fold ⇒ exact
    candidates) must agree with the classic folded path."""
    cfg, truth, train, test, actuals = world
    model, _ = trained
    cfgf = cfg.with_(retrieval_mode="folded", fold_dim=8192, rescore_depth=16,
                     retrieval_window_select=False)
    m_fused = Matcher(cfgf, truth=truth, model=model)
    m_classic = Matcher(cfgf.with_(serve_fused="off"), truth=truth,
                        model=model)
    assert m_fused.scorer.folded is not None
    batch = TitleSet.from_titles(
        list(test.titles[10:16]), ids=np.arange(6, dtype=np.int64), config=cfg
    )
    r1 = m_fused.predict(batch)
    r2 = m_classic.predict(batch)
    _assert_same(r1, r2)
    rng = random.Random(5)
    q = generate_misspelled_name(truth.transformed[40], rng)
    r1 = m_fused.predict(single_title_set(q, cfgf), single=True)
    r2 = m_classic.predict(single_title_set(q, cfgf), single=True)
    _assert_same(r1, r2)
