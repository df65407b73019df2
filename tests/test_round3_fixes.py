"""Regression tests for the round-3 ADVICE.md findings."""

import numpy as np
import pytest

from doppelspeller.pipeline import Matcher, STAGE_EXACT, STAGE_FUZZY
from doppelspeller.utils.io import TitleSet

# reuse the trained tiny-world fixtures


@pytest.mark.heavy
def test_long_word_title_bucket_clamp(world, trained):  # noqa: F811
    """ADVICE r2 (medium): a stage-3 row whose candidate has a 33+ char
    spaceless word used to fall in the (title-bucket < word-bucket) dispatch
    hole and be silently skipped.  The clamp must route it to a processed
    cell (the cascade now asserts full coverage) and the device path must
    equal the host path."""
    cfg, truth, train, test, actuals = world
    model, _ = trained

    long_title = "aaaabbbbccccddddeeeeffffgggghhhhiiiijjjj"  # 40 chars, 1 word
    assert len(long_title) == 40 and " " not in long_title
    truth2 = TitleSet.from_titles(
        list(truth.titles) + [long_title],
        ids=np.append(truth.ids, 9999),
        config=cfg,
    )
    # 4 substitutions: levenshtein ratio = round((80-8)/80*100) = 90 <= 94,
    # so the row passes fuzzy unmatched and MUST be dispatched to stage 3
    q_long = "aaaabbbbccccddddeeeeffffgggghhhhiiiixxxx"
    q_titles = [q_long] + [t for t in test.titles[:40]]
    queries = TitleSet.from_titles(
        q_titles, ids=np.arange(len(q_titles)), config=cfg
    )

    m_dev = Matcher(cfg.with_(cascade_impl="device"), truth=truth2, model=model)
    m_host = Matcher(cfg.with_(cascade_impl="host"), truth=truth2, model=model)
    r_dev = m_dev.predict(queries)   # raises AssertionError without the clamp
    r_host = m_host.predict(queries)

    # the crafted row must have reached stage 3 (not exact/fuzzy)
    assert r_dev.stage[0] not in (STAGE_EXACT, STAGE_FUZZY)
    np.testing.assert_array_equal(r_host.match_title_id, r_dev.match_title_id)
    np.testing.assert_array_equal(r_host.stage, r_dev.stage)


@pytest.mark.heavy
def test_adaptive_model_depth_parity(world, trained):  # noqa: F811
    """Adaptive candidate depth (wave A over the top-k head, widen on
    probability) must reproduce the full-depth device cascade exactly."""
    cfg, truth, train, test, actuals = world
    model, _ = trained
    base = cfg.with_(cascade_impl="device")
    m_full = Matcher(base.with_(model_depth_initial=0), truth=truth, model=model)
    m_adpt = Matcher(base.with_(model_depth_initial=8), truth=truth, model=model)
    r_full = m_full.predict(test)
    r_adpt = m_adpt.predict(test)
    np.testing.assert_array_equal(r_full.match_title_id, r_adpt.match_title_id)
    np.testing.assert_array_equal(r_full.stage, r_adpt.stage)
    np.testing.assert_allclose(r_full.prediction, r_adpt.prediction, rtol=1e-5)


def test_gbt_extreme_negative_feature_not_missing():
    """ADVICE r2 (low): a legitimate feature value below -1e20 must NOT be
    routed down the missing-value branch (features are clipped to ±1e18
    before the sentinel test)."""
    import jax.numpy as jnp

    from doppelspeller.models.gbt import predict_forest_margin

    # one tree, one internal node: f0 <= 0.5 -> left leaf 1.0, else right 2.0;
    # missing goes RIGHT
    feat = jnp.array([[0, -1, -1]], jnp.int32)
    thr = jnp.array([[0.5, 0.0, 0.0]], jnp.float32)
    ml = jnp.array([[False, False, False]])
    value = jnp.array([[0.0, 1.0, 2.0]], jnp.float32)
    is_leaf = jnp.array([[False, True, True]])

    X = jnp.array([[-1e25], [np.nan], [0.2], [0.9]], jnp.float32)
    m = predict_forest_margin(X, feat, thr, ml, value, is_leaf, 1, 0.0)
    # -1e25 is a real (left) value; NaN is missing (right)
    np.testing.assert_allclose(np.asarray(m), [1.0, 2.0, 1.0, 2.0])
