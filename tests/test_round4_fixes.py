"""Regression tests for the round-4 VERDICT/ADVICE findings."""

import logging

import numpy as np

from doppelspeller.pipeline import Matcher
from doppelspeller.utils.io import TitleSet

# reuse the trained tiny-world fixtures


def test_fuzzy_tile_cap_overflow_host_redo(world, trained, caplog):  # noqa: F811
    """VERDICT r3 weak #3: the fuzzy device-overflow host-redo path
    (pipeline.py over-rows branch) must actually execute and agree with the
    host path.  ``fuzzy_tile_cap`` bounds the device DP tile, so rows whose
    length-prefilter-considered pairs exceed the tile overflow to an exact
    host redo."""
    cfg, truth, train, test, actuals = world
    model, _ = trained

    # long truth titles (> 32-char tile) with close-length queries so the
    # pairs pass the length prefilter AND exceed the capped tile
    long_truth = [
        "aaaa bbbb cccc dddd eeee ffff gggg hhh",   # 38 chars
        "mmmm nnnn oooo pppp qqqq rrrr ssss ttt",
    ]
    truth2 = TitleSet.from_titles(
        list(truth.titles) + long_truth,
        ids=np.append(truth.ids, [9001, 9002]),
        config=cfg,
    )
    q_titles = [
        "aaaa bbbb cccc dddd eeee ffff gggg hht",   # 1 sub: ratio 97 > 94
        "mmmm nnnn oooo pppp qqqq rrrr ssss tta",
    ] + list(test.titles[:30])
    queries = TitleSet.from_titles(
        q_titles, ids=np.arange(len(q_titles)), config=cfg
    )

    capped = cfg.with_(cascade_impl="device", fuzzy_tile_cap=32)
    m_cap = Matcher(capped, truth=truth2, model=model)
    with caplog.at_level(logging.WARNING, logger="doppelspeller.pipeline"):
        r_cap = m_cap.predict(queries)
    # the overflow branch must have fired (otherwise this test is vacuous)
    assert any("fuzzy device overflow" in rec.message for rec in caplog.records)

    m_host = Matcher(cfg.with_(cascade_impl="host"), truth=truth2, model=model)
    r_host = m_host.predict(queries)
    # the crafted rows must land in the fuzzy stage via the host redo
    assert r_cap.match_title_id[0] == 9001
    assert r_cap.match_title_id[1] == 9002
    np.testing.assert_array_equal(r_cap.match_title_id, r_host.match_title_id)
    np.testing.assert_array_equal(r_cap.stage, r_host.stage)

    # stage counts stay consistent: every query is accounted for exactly once
    matched = int((r_cap.stage > 0).sum())
    assert sum(r_cap.stage_counts.values()) == matched
    for stage in ("exact", "fuzzy", "model"):
        assert r_cap.stage_counts.get(stage, 0) == r_host.stage_counts.get(stage, 0)
