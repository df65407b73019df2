"""End-to-end pipeline tests on a tiny synthetic world (CPU)."""

import random
import string

import numpy as np

from doppelspeller import constants as c
from doppelspeller.models.trainer import (
    assemble_training_pairs,
    evaluation_indexes,
)
from doppelspeller.ops.jaccard import JaccardScorer
from doppelspeller.ops.ngram_index import build_truth_index
from doppelspeller.pipeline import Matcher, accuracy_report
from doppelspeller.utils.io import single_title_set
from doppelspeller.utils.misspell import generate_misspelled_name


def _word(rng, n):
    return "".join(rng.choice(string.ascii_lowercase) for _ in range(n))


# `world` and `trained` are session-scoped fixtures in conftest.py (shared
# with test_round3_fixes / test_round4_fixes so the ~19 s setup runs once).


def test_assemble_training_pairs(world):
    cfg, truth, train, test, actuals = world
    scorer = JaccardScorer(build_truth_index(truth, cfg), cfg)
    pairs = assemble_training_pairs(train, truth, scorer, cfg, random.Random(0))
    kinds = pairs.kind
    n_neg = int((kinds == c.TRAINING_KIND_NEGATIVE).sum())
    n_pos = int((kinds == c.TRAINING_KIND_POSITIVE).sum())
    n_gen = int((kinds == c.TRAINING_KIND_GENERATED).sum())
    assert n_neg == 30 * cfg.top_n_training
    assert n_pos == 60 * cfg.top_n_training
    assert n_gen == sum(len(t) > 9 for t in truth.transformed)
    # every positive row-group contains its label exactly once with target 1
    pos_targets = pairs.target[kinds == c.TRAINING_KIND_POSITIVE]
    per_row = pos_targets.reshape(60, cfg.top_n_training)
    assert (per_row.sum(axis=1) == 1).all()


def test_evaluation_split_fractions(world):
    cfg, truth, train, test, actuals = world
    kind = np.array(
        [c.TRAINING_KIND_GENERATED] * 500
        + [c.TRAINING_KIND_NEGATIVE] * 300
        + [c.TRAINING_KIND_POSITIVE] * 200,
        dtype=np.uint8,
    )
    idx = evaluation_indexes(kind, cfg)
    total = 1000
    # sizes are fractions of the TOTAL (reference quirk)
    n_gen = (kind[idx] == c.TRAINING_KIND_GENERATED).sum()
    n_neg = (kind[idx] == c.TRAINING_KIND_NEGATIVE).sum()
    n_pos = (kind[idx] == c.TRAINING_KIND_POSITIVE).sum()
    assert n_gen == int(total * cfg.evaluation_fraction_generated)
    assert n_neg == int(total * cfg.evaluation_fraction_negative)
    assert n_pos == int(total * cfg.evaluation_fraction_positive)


def test_training_report(trained):
    model, report = trained
    em = report["error_matrix"]
    total = sum(em.values())
    assert total > 0
    # the model must actually separate: mostly true cells
    assert (em["tp"] + em["tn"]) / total > 0.9
    assert report["feature_importance"].shape == (66,)


def test_end_to_end_accuracy(world, trained, tmp_path):
    cfg, truth, train, test, actuals = world
    model, _ = trained
    matcher = Matcher(cfg, truth=truth, model=model)
    result = matcher.predict(test)

    # exact matches must all hit via stage 1
    assert result.stage_counts["exact"] >= 28  # duplicate titles may differ
    out_path = str(tmp_path / "out.csv")
    result.save_csv(out_path, cfg.delimiter)

    # score
    import pandas as pd

    actual_df = pd.DataFrame({"test_index": test.ids, "company_id": actuals})
    actuals_path = str(tmp_path / "actuals.csv")
    actual_df.to_csv(actuals_path, index=False, sep=cfg.delimiter)
    report = accuracy_report(actuals_path, out_path, cfg.delimiter)

    n = len(actuals)
    accuracy = (report["correctly_matched"] + report["correctly_not_found"]) / n
    assert accuracy > 0.75, report
    # exact queries must all be correct
    assert report["correctly_matched"] >= 28


def test_single_title_search(world, trained):
    cfg, truth, train, test, actuals = world
    model, _ = trained
    matcher = Matcher(cfg, truth=truth, model=model)
    # exact title
    res = matcher.predict(single_title_set(truth.titles[3], cfg), single=True)
    d = res.single_result()
    assert d["match_title_id"] == int(truth.ids[3])
    assert d["prediction"] == 1.0
    # misspelled title returns SOME candidate (argmax, no threshold)
    rng = random.Random(77)
    q = generate_misspelled_name(truth.transformed[7], rng)
    if q != truth.transformed[7]:
        res = matcher.predict(single_title_set(q, cfg), single=True)
        d = res.single_result()
        assert d["match_title_id"] != -1


def test_output_csv_format(world, trained, tmp_path):
    cfg, truth, train, test, actuals = world
    model, _ = trained
    matcher = Matcher(cfg, truth=truth, model=model)
    result = matcher.predict(test)
    path = str(tmp_path / "final_output.csv")
    result.save_csv(path, cfg.delimiter)
    with open(path) as f:
        header = f.readline().strip()
    assert header == "title_id|test_index"
    import pandas as pd

    df = pd.read_csv(path, sep="|")
    assert (df["test_index"].values == np.sort(test.ids)).all()


def test_device_cascade_matches_host(world, trained):
    """The on-device cascade (device-resident candidates, scan-batched fuzzy
    and model decisions) must produce the host path's exact output."""
    cfg, truth, train, test, actuals = world
    model, _ = trained
    m_host = Matcher(cfg.with_(cascade_impl="host"), truth=truth, model=model)
    m_dev = Matcher(cfg.with_(cascade_impl="device"), truth=truth, model=model)
    r_host = m_host.predict(test)
    r_dev = m_dev.predict(test)
    np.testing.assert_array_equal(r_host.match_title_id, r_dev.match_title_id)
    np.testing.assert_array_equal(r_host.stage, r_dev.stage)
    np.testing.assert_allclose(r_host.prediction, r_dev.prediction, rtol=1e-5)
    assert r_host.stage_counts == r_dev.stage_counts
