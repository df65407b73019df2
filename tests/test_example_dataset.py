"""Integration tests on the reference's shipped example dataset (CPU,
subsetted for speed).  Skipped when the dataset is unavailable."""

import os

import numpy as np
import pytest

pd = pytest.importorskip("pandas")      # test-side convenience only

from doppelspeller.config import Config
from doppelspeller.ops.jaccard import JaccardScorer
from doppelspeller.ops.ngram_index import build_truth_index
from doppelspeller.utils import text as T
from doppelspeller.utils.io import TitleSet


@pytest.fixture(scope="module")
def example(example_data_dir):
    cfg = Config(
        data_path=str(example_data_dir),
        title_block=1024,
        query_block=16,
        score_dtype="float32",
    )
    truth_df = pd.read_csv(example_data_dir / "example_truth.csv", sep="|")
    test_df = pd.read_csv(example_data_dir / "example_test_with_actuals.csv", sep="|")
    return cfg, truth_df, test_df


def test_known_transforms(example):
    cfg, truth_df, test_df = example
    # rows eyeballed from the shipped files
    assert T.transform_title("Great Expectations Ministries") == (
        "great expectations ministries"
    )
    assert T.transform_title("DMG Events (UK) Limited") == "dmg events uk limited"


def test_retrieval_recall_on_example_subset(example):
    cfg, truth_df, test_df = example
    truth_sub = truth_df.iloc[:4000]
    truth = TitleSet.from_titles(
        [str(x) for x in truth_sub["name"]],
        ids=truth_sub["company_id"].to_numpy(np.int64),
        config=cfg,
    )
    id_set = set(truth.ids.tolist())
    # queries whose actual truth id is inside the subset
    mask = test_df["company_id"].isin(id_set)
    q_df = test_df[mask].iloc[:80]
    assert len(q_df) >= 40
    queries = TitleSet.from_titles(
        [str(x) for x in q_df["name"]],
        ids=q_df["test_index"].to_numpy(np.int64),
        config=cfg,
    )
    index = build_truth_index(truth, cfg)
    scorer = JaccardScorer(index, cfg)
    _, cand_ids = scorer.topk_title_ids(queries, k=20)
    actual = q_df["company_id"].to_numpy(np.int64)
    recall = np.mean([actual[i] in cand_ids[i] for i in range(len(q_df))])
    # the reference funnels these same queries through its own top-n; real
    # misspellings of in-subset titles must essentially always be retrieved
    assert recall >= 0.95, recall
    # and the top-1 should usually be the right one
    top1 = np.mean(cand_ids[:, 0] == actual)
    assert top1 >= 0.80, top1


def test_exact_example_titles_score_one(example):
    cfg, truth_df, test_df = example
    truth_sub = truth_df.iloc[:2000]
    truth = TitleSet.from_titles(
        [str(x) for x in truth_sub["name"]],
        ids=truth_sub["company_id"].to_numpy(np.int64),
        config=cfg,
    )
    queries = TitleSet.from_titles(truth.titles[:25], config=cfg)
    scorer = JaccardScorer(build_truth_index(truth, cfg), cfg)
    scores, ids = scorer.topk_title_ids(queries, k=3)
    np.testing.assert_allclose(scores[:, 0], 1.0, rtol=1e-5)
    np.testing.assert_array_equal(ids[:, 0], truth.ids[:25])


@pytest.mark.slow
def test_full_example_parity(tmp_path, example_data_dir):
    """Full train -> predict -> accuracy on the 30k/10k example set; pins the
    README parity claim (custom error <= 700 vs reference 633).  ~minutes on
    CPU — run explicitly: pytest -m slow tests/test_example_dataset.py."""
    import subprocess
    import sys

    out = tmp_path / "parity.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "scripts/example_parity.py", "--out", str(out),
         "--data-dir", str(example_data_dir)],
        cwd=repo, capture_output=True, text=True, timeout=3600, env=env,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    import json

    parity = json.loads(out.read_text())
    assert parity["ok"], parity
    assert parity["ours"]["custom_error"] <= 700


@pytest.mark.slow
def test_cascade_stages_on_real_data(example):
    """Fuzzy + model stages on REAL example-dataset text (not synthetic):
    misspelled test titles against a 4000-title truth subset, with a small
    GBT trained on real pairs.  Asserts both stages produce matches, most
    matches are correct, and the device cascade equals the host path on this
    messier distribution (round-1 review: stages 2-3 were only exercised on
    synthetic worlds)."""
    from doppelspeller.models.gbt import GBTParams
    from doppelspeller.models.trainer import train_model
    from doppelspeller.pipeline import Matcher

    cfg, truth_df, test_df = example
    truth_sub = truth_df.iloc[:800]
    truth = TitleSet.from_titles(
        [str(x) for x in truth_sub["name"]],
        ids=truth_sub["company_id"].to_numpy(np.int64),
        config=cfg,
    )
    tids = set(truth.ids.tolist())
    # test rows whose actual is inside the truth subset + not-found rows
    inside = test_df[test_df["company_id"].isin(tids)].iloc[:120]
    notfound = test_df[test_df["company_id"] == -1].iloc[:40]
    rows = pd.concat([inside, notfound])
    queries = TitleSet.from_titles(
        [str(x) for x in rows["name"]],
        ids=rows["test_index"].to_numpy(np.int64),
        config=cfg,
    )
    actual = rows["company_id"].to_numpy(np.int64)

    # small-but-real model trained on real truth titles (misspelled pairs)
    train_rows = inside.iloc[:50]
    train = TitleSet.from_titles(
        [str(x) for x in train_rows["name"]],
        ids=np.arange(len(train_rows)),
        labels=train_rows["company_id"].to_numpy(np.int64),
        config=cfg,
    )
    params = GBTParams.from_config(cfg)
    params.num_boost_round = 30
    params.early_stopping_rounds = 30
    model, _ = train_model(
        config=cfg, train=train, truth=truth, params=params, save=False
    )

    # exact-adaptive config: every stage-3 row runs the full two-wave
    # cascade (wave A head + wave B tail, merged), which is exactly equal
    # to full-depth scoring for ANY model — this test gates the cascade
    # MACHINERY (buckets, gathers, wave merge) against the host path.  The
    # default band heuristics (skip below widen floor / trust a unique head
    # max >= 0.995) assume jaccard-sorted candidates put the argmax in the
    # head; that is measured exact on real models (0/10000 diffs on the
    # full example set, re-gated every bench run by the oracle anchor) but
    # not on this deliberately tiny 30-round model whose probabilities
    # cluster
    exact_cfg = cfg.with_(model_widen_threshold=-1.0, model_trust_threshold=2.0)
    res = {}
    for impl in ("host", "device"):
        m = Matcher(
            exact_cfg.with_(cascade_impl=impl), truth=truth, model=model,
            use_index_checkpoint=False,
        )
        res[impl] = m.predict(queries)

    h, d = res["host"], res["device"]
    np.testing.assert_array_equal(h.match_title_id, d.match_title_id)
    np.testing.assert_array_equal(h.stage, d.stage)
    assert h.stage_counts == d.stage_counts

    assert h.stage_counts["fuzzy"] > 15, h.stage_counts
    assert h.stage_counts["model"] > 5, h.stage_counts
    matched = h.match_title_id != -1
    precision = (h.match_title_id[matched] == actual[matched]).mean()
    assert precision > 0.9, (precision, h.stage_counts)
