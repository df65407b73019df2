"""Training pipeline: assemble pairs → features → boosted trees.

Reference flow parity (train.py:85-137 + feature_engineering.py:172-378 +
feature_engineering_prepare.py:25-57):

* GENERATED pairs: every truth title with a transformed length > 9 is
  misspelled once → target 1 (feature_engineering.py:207-225);
* candidate retrieval: top-100 weighted-Jaccard candidates per train row,
  10 sampled at random (feature_engineering_prepare.py:30,43);
* NEGATIVE pairs: rows labelled −1 → 10 candidates, target 0;
* POSITIVE pairs: labelled rows → 10 candidates with the true label forced
  into the set (replacing the weakest), target = (candidate == label);
* evaluation split: per-kind random subsets whose sizes are the configured
  fractions of the *total* row count (reference quirk, feature_engineering.py:276-296);
* training with the custom weighted objective + custom-error early stopping.

Deviations (documented): candidates for labelled rows are keyed per *row*
rather than per title_id (the reference dict silently collapses duplicate
title_ids, feature_engineering_prepare.py:49); all randomness is seeded.
"""

from __future__ import annotations

import logging
import random
from collections import Counter
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from doppelspeller import constants as c
from doppelspeller.config import Config, get_config
from doppelspeller.models.gbt import GBTModel, GBTParams, custom_error, train_gbt
from doppelspeller.ops.features import features_for_pairs
from doppelspeller.ops.jaccard import JaccardScorer
from doppelspeller.ops.ngram_index import build_truth_index
from doppelspeller.utils import text as T
from doppelspeller.utils.io import TitleSet, load_ground_truth, load_train_data
from doppelspeller.utils.misspell import generate_misspelled_name

LOGGER = logging.getLogger(__name__)


class WordCounts:
    """Truth-DB word document counts → uint32[*, 15] gathers
    (reference feature_engineering.py:309-319)."""

    def __init__(self, truth: TitleSet, w_slots: int = 15):
        self.counter: Counter = T.get_words_counter(truth.words)
        self.w_slots = w_slots

    def for_title(self, transformed: str) -> np.ndarray:
        out = np.zeros(self.w_slots, dtype=np.uint32)
        for k, w in enumerate(transformed.split()[: self.w_slots]):
            out[k] = self.counter[w]
        return out

    def for_titles(self, titles: List[str]) -> np.ndarray:
        return np.stack([self.for_title(t) for t in titles])

    def matrix(self, titles: List[str]) -> np.ndarray:
        """uint32[len(titles), 15] — computed once, gathered per pair."""
        return self.for_titles(titles)


@dataclass
class TrainingPairs:
    kind: np.ndarray          # uint8[M] TRAINING_KIND_*
    target: np.ndarray        # float32[M]
    pair_q: np.ndarray        # int32[M] indices into q_titles
    t_pos: np.ndarray         # int32[M] truth row positions
    q_titles: List[str]       # UNIQUE transformed query-side titles


def assemble_training_pairs(
    train: TitleSet,
    truth: TitleSet,
    scorer: JaccardScorer,
    config: Optional[Config] = None,
    rng: Optional[random.Random] = None,
) -> TrainingPairs:
    cfg = config or get_config()
    rng = rng or random.Random(cfg.seed)

    # the truth side of every pair is a truth ROW — candidates come back as
    # positions, labels map through id→position (1:1, ids are unique), and
    # generated pairs misspell row p itself.  The feature builder gathers
    # truth-side tensors on device by position (features_for_pairs), so no
    # per-pair truth strings are ever materialized.
    pos_of_id = {int(i): p for p, i in enumerate(truth.ids)}

    kinds: List[int] = []
    targets: List[float] = []
    pair_q: List[int] = []
    t_pos: List[int] = []
    q_titles: List[str] = []
    q_index: dict = {}

    def q_id(title: str) -> int:
        j = q_index.get(title)
        if j is None:
            j = len(q_titles)
            q_index[title] = j
            q_titles.append(title)
        return j

    # --- NEGATIVE + POSITIVE: retrieval candidates for every train row ---
    LOGGER.info("Retrieving top-%d candidates for %d train rows",
                cfg.top_n_predicting, len(train))
    _, cand_pos = scorer.topk(train, k=cfg.top_n_predicting)

    n_sample = cfg.top_n_training
    for row in range(len(train)):
        label = int(train.labels[row])
        # rng parity note: sample() draws by list position, so sampling
        # positions yields exactly the candidates the id-based form would
        cands = rng.sample(list(cand_pos[row]), n_sample)
        qi = q_id(train.transformed[row])
        if label == cfg.train_not_found_value:
            for cp in cands:
                kinds.append(c.TRAINING_KIND_NEGATIVE)
                targets.append(0.0)
                pair_q.append(qi)
                t_pos.append(int(cp))
        else:
            label_pos = pos_of_id[label]
            if label_pos not in [int(x) for x in cands]:
                if len(cands) == n_sample:
                    cands.pop()
                cands.append(label_pos)
            for cp in cands:
                kinds.append(c.TRAINING_KIND_POSITIVE)
                targets.append(1.0 if int(cp) == label_pos else 0.0)
                pair_q.append(qi)
                t_pos.append(int(cp))

    # --- GENERATED: misspell every truth title longer than 9 chars ---
    LOGGER.info("Generating misspelled training data")
    for p, t in enumerate(truth.transformed):
        if len(t) > 9:
            kinds.append(c.TRAINING_KIND_GENERATED)
            targets.append(1.0)
            pair_q.append(q_id(generate_misspelled_name(t, rng)))
            t_pos.append(p)

    return TrainingPairs(
        kind=np.asarray(kinds, dtype=np.uint8),
        target=np.asarray(targets, dtype=np.float32),
        pair_q=np.asarray(pair_q, dtype=np.int32),
        t_pos=np.asarray(t_pos, dtype=np.int32),
        q_titles=q_titles,
    )


def evaluation_indexes(
    kind: np.ndarray, config: Optional[Config] = None, seed: Optional[int] = None
) -> np.ndarray:
    """Reference-quirk split: per-kind sample sizes are fractions of the
    TOTAL row count (feature_engineering.py:276-296), clipped to the kind
    size (the reference would raise instead)."""
    cfg = config or get_config()
    rs = np.random.RandomState(cfg.seed if seed is None else seed)
    total = len(kind)
    picks = []
    for k, frac in (
        (c.TRAINING_KIND_GENERATED, cfg.evaluation_fraction_generated),
        (c.TRAINING_KIND_NEGATIVE, cfg.evaluation_fraction_negative),
        (c.TRAINING_KIND_POSITIVE, cfg.evaluation_fraction_positive),
    ):
        cand = np.flatnonzero(kind == k)
        size = min(int(total * frac), len(cand))
        if size > 0:
            picks.append(rs.choice(cand, size=size, replace=False))
    if not picks:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(picks))


def build_feature_matrix(
    pairs: TrainingPairs, word_counts: WordCounts, truth: TitleSet,
    config: Optional[Config] = None,
) -> np.ndarray:
    """Feature matrix via the resident-gather path: the unique query
    encodings and the truth-side tables go to the device once, then each
    chunk ships only (q row, truth row) index pairs (features_for_pairs)."""
    cfg = config or get_config()
    q_enc = T.encode_titles(pairs.q_titles, cfg.max_characters)
    q_len = np.array([min(len(t), cfg.max_characters) for t in pairs.q_titles], np.int32)
    counts = word_counts.matrix(truth.transformed)
    LOGGER.info("Constructing features for %d pairs (%d unique queries)",
                len(pairs.kind), len(pairs.q_titles))
    return features_for_pairs(
        pairs.pair_q, pairs.t_pos, q_enc, q_len,
        truth.encoded, np.minimum(truth.lengths, cfg.max_characters).astype(np.int32),
        counts, cfg,
    )


def error_matrix(pred: np.ndarray, target: np.ndarray, threshold: float):
    """(TP, TN, FP, FN) at the probability threshold (train.py:63-82)."""
    pos = pred > threshold
    tp = int(((target == 1) & pos).sum())
    tn = int(((target == 0) & ~pos).sum())
    fp = int(((target == 0) & pos).sum())
    fn = int(((target == 1) & ~pos).sum())
    return tp, tn, fp, fn


def train_model(
    config: Optional[Config] = None,
    train: Optional[TitleSet] = None,
    truth: Optional[TitleSet] = None,
    scorer: Optional[JaccardScorer] = None,
    params: Optional[GBTParams] = None,
    save: bool = True,
    mesh=None,
) -> Tuple[GBTModel, dict]:
    """End-to-end training (reference train.py:85-137).  Returns the model
    and a report dict (error matrix, feature importance, history, timings).

    ``mesh``: optional 1-D jax.sharding.Mesh — candidate retrieval runs over
    the title-sharded index and boosting runs data-parallel over the sample
    axis with psum-ed histograms (see gbt.train_gbt)."""
    import time as _time

    cfg = config or get_config()
    timings = {}
    t0 = _time.time()
    truth = truth or load_ground_truth(cfg)
    train = train or load_train_data(cfg)
    if scorer is None:
        index = build_truth_index(truth, cfg)
        if mesh is not None:
            from doppelspeller.parallel.sharded import ShardedJaccardScorer

            scorer = ShardedJaccardScorer(index, mesh, cfg)
        else:
            scorer = JaccardScorer(index, cfg)
    timings["setup_seconds"] = _time.time() - t0

    rng = random.Random(cfg.seed)
    t0 = _time.time()
    pairs = assemble_training_pairs(train, truth, scorer, cfg, rng)
    timings["candidates_seconds"] = _time.time() - t0
    LOGGER.info(
        "Assembled %d pairs (generated %d / negative %d / positive %d)",
        len(pairs.kind),
        int((pairs.kind == c.TRAINING_KIND_GENERATED).sum()),
        int((pairs.kind == c.TRAINING_KIND_NEGATIVE).sum()),
        int((pairs.kind == c.TRAINING_KIND_POSITIVE).sum()),
    )

    word_counts = WordCounts(truth)
    t0 = _time.time()
    X = build_feature_matrix(pairs, word_counts, truth, cfg)
    timings["features_seconds"] = _time.time() - t0
    y = pairs.target

    eval_idx = evaluation_indexes(pairs.kind, cfg)
    train_mask = np.ones(len(y), dtype=bool)
    train_mask[eval_idx] = False
    X_train, y_train = X[train_mask], y[train_mask]
    X_eval, y_eval = X[eval_idx], y[eval_idx]
    LOGGER.info("Train %d rows / eval %d rows", len(y_train), len(y_eval))

    params = params or GBTParams.from_config(cfg)
    t0 = _time.time()
    model = train_gbt(X_train, y_train, X_eval, y_eval, params, mesh=mesh)
    timings["boosting_seconds"] = _time.time() - t0
    LOGGER.info(
        "train timings: setup %.1fs | candidates %.1fs | features %.1fs | "
        "boosting %.1fs",
        timings["setup_seconds"], timings["candidates_seconds"],
        timings["features_seconds"], timings["boosting_seconds"],
    )

    pred_eval = model.predict(X_eval)
    tp, tn, fp, fn = error_matrix(pred_eval, y_eval, cfg.prediction_probability_threshold)
    LOGGER.info(
        "\n\nEvaluation Data Error Matrix:\n"
        "    True Positives     %d\n"
        "    True Negatives     %d\n"
        "    False Positives    %d\n"
        "    False Negatives    %d\n",
        tp, tn, fp, fn,
    )
    report = {
        "error_matrix": {"tp": tp, "tn": tn, "fp": fp, "fn": fn},
        "eval_custom_error": custom_error(
            pred_eval, y_eval, cfg.false_positive_penalty_factor,
            cfg.prediction_probability_threshold,
        ),
        "feature_importance": model.feature_importance(),
        "history": model.history,
        "n_pairs": len(y),
        "timings": timings,
    }
    if save:
        model.save(cfg.model_path)
        LOGGER.info("Model saved to %s", cfg.model_path)
    return model, report
