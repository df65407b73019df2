"""Regression tests for the round-5 fixes (VERDICT r4 asks + ADVICE r4).

Covers: the Matcher's encoding-width guard (ADVICE r4: a TitleSet built at a
narrower ``max_characters`` than the Matcher's config silently truncated
fuzzy-stage encodings), the bench synthetic-world cache hygiene (ADVICE r4:
bare-/tmp keying was poisonable and stale-able), and the wave-B calibration
dump hook (scripts/calibrate_trust.py depends on its layout).
"""

import os

import numpy as np
import pytest

from doppelspeller.pipeline import Matcher
from doppelspeller.utils.io import TitleSet


def test_predict_rejects_width_mismatch(world, trained):
    cfg, truth, train, test, actuals = world
    model, _ = trained
    narrow_cfg = cfg.with_(max_characters=64)
    narrow_queries = TitleSet.from_titles(
        list(test.titles), ids=test.ids, config=narrow_cfg
    )
    assert narrow_queries.encoded.shape[1] == 64
    matcher = Matcher(cfg, truth=truth, model=model)
    with pytest.raises(ValueError, match="width"):
        matcher.predict(narrow_queries)


def test_bench_world_cache_is_repo_owned_and_versioned():
    import bench

    path = bench._world_cache_path(123, 45, 7)
    repo_root = os.path.dirname(os.path.abspath(bench.__file__))
    # inside the repo's .cache dir, never bare /tmp
    assert path.startswith(os.path.join(repo_root, ".cache") + os.sep)
    # keyed on the generator version so bumping it invalidates old worlds
    assert f"v{bench.WORLD_GEN_VERSION}_" in os.path.basename(path)
    bumped = path.replace(
        f"v{bench.WORLD_GEN_VERSION}_", f"v{bench.WORLD_GEN_VERSION + 1}_"
    )
    assert bumped != path


def test_wave_dump_hook_layout(world, trained, tmp_path, monkeypatch):
    """DOPPEL_DUMP_WAVES writes per-widened-row stats for both waves with
    consistent shapes (consumed offline by scripts/calibrate_trust.py)."""
    cfg, truth, train, test, actuals = world
    model, _ = trained
    dump = str(tmp_path / "waves.npz")
    monkeypatch.setenv("DOPPEL_DUMP_WAVES", dump)
    # force the device cascade with every stage-3 row widened into wave B
    cfg2 = cfg.with_(
        cascade_impl="device",
        model_depth_initial=4,
        model_widen_threshold=-1.0,
        model_trust_threshold=2.0,
    )
    matcher = Matcher(cfg2, truth=truth, model=model)
    matcher.predict(test)
    assert os.path.exists(dump), "no stage-3 rows reached wave B"
    z = np.load(dump)
    keys = {"widen", "mx_a", "mx_b", "pos_a", "pos_b", "cnt_a", "cnt_b"}
    assert keys <= set(z.files)
    n = len(z["widen"])
    assert n > 0
    for k in keys:
        assert len(z[k]) == n
    # wave maxima are probabilities (or -inf for never-scored pad rows)
    finite = np.isfinite(z["mx_a"])
    assert ((z["mx_a"][finite] >= 0) & (z["mx_a"][finite] <= 1)).all()
