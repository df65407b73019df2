"""Calibrate ``model_trust_threshold`` from ONE full-depth bench-scale run.

The model stage's wave B re-scores every row whose wave-A head max lands in
[model_widen_threshold, model_trust_threshold).  Trusting is only wrong when the tail
holds a strictly higher-probability candidate (identity change) or an exact
tie with the head max (tie-drop) AND the row would actually match
(merged p > prediction_probability_threshold).  This script runs the full
bench world once with trusting disabled and every row widened
(``DOPPEL_DUMP_WAVES`` captures per-row wave-A/B stats, pipeline.py), then
evaluates ANY candidate threshold offline: for each t, how many rows would
be trusted (wave-B work saved) and how many of those rows' FINAL OUTCOMES
(matched position at p > 0.9, or unmatched) differ from the full-depth
truth.

Usage: python scripts/calibrate_trust.py [n_titles] [n_queries]
Writes .cache/trust_calibration.json in the checkout.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache")
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (repo-root bench.py: world gen + quick trainer)

n_titles = int(sys.argv[1]) if len(sys.argv) > 1 else 500_000
n_queries = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000

from doppelspeller.ops.ngram_index import build_truth_index  # noqa: E402
from doppelspeller.pipeline import Matcher  # noqa: E402
from doppelspeller.utils.io import TitleSet  # noqa: E402

cfg, truth, queries, actual = bench.make_synthetic_world(n_titles, n_queries)

t0 = time.time()
model = bench.quick_train_model(cfg, truth, int(os.environ.get("BENCH_TRAIN_ROUNDS", 60)))
print(f"# train {time.time()-t0:.0f}s", file=sys.stderr)
t0 = time.time()
index = build_truth_index(truth, cfg)
print(f"# index {time.time()-t0:.0f}s", file=sys.stderr)

# full-depth config: every post-fuzzy row widens, nothing is trusted
full_cfg = cfg.with_(model_widen_threshold=-1.0, model_trust_threshold=2.0)
matcher = Matcher(full_cfg, truth=truth, index=index, model=model)

# small warmup so the measured predict is steady (programs cached on disk)
stride = max(len(queries.titles) // 24576, 1)
warm = TitleSet.from_titles(queries.titles[::stride][:24576], config=full_cfg)
t0 = time.time()
matcher.predict(warm)
print(f"# warmup {time.time()-t0:.0f}s", file=sys.stderr)

os.makedirs(CACHE, exist_ok=True)
dump = os.path.join(CACHE, "waves_full.npz")
os.environ["DOPPEL_DUMP_WAVES"] = dump
t0 = time.time()
res = matcher.predict(queries)
dt_full = time.time() - t0
del os.environ["DOPPEL_DUMP_WAVES"]
print(f"# full-depth predict {dt_full:.1f}s "
      f"(model stage {res.stage_seconds['model']:.2f}s)", file=sys.stderr)

z = np.load(dump)
mx_a, mx_b = z["mx_a"], z["mx_b"]
cnt_a, cnt_b = z["cnt_a"], z["cnt_b"]
pos_a, pos_b = z["pos_a"], z["pos_b"]
thr = cfg.prediction_probability_threshold

# merged (full-depth) outcome per widened row — mirrors pipeline merge
a_wins = mx_a >= mx_b
tie = mx_a == mx_b
mx_m = np.where(a_wins, mx_a, mx_b)
pos_m = np.where(a_wins, pos_a, pos_b)
cnt_m = np.where(tie, cnt_a + cnt_b, np.where(a_wins, cnt_a, cnt_b))
match_m = (cnt_m == 1) & (mx_m > thr)          # full-depth: matches at pos_m
match_h = (cnt_a == 1) & (mx_a > thr)          # head-only: matches at pos_a

grid = [0.9, 0.95, 0.98, 0.99, 0.995, 0.999]
out = {
    "n_titles": n_titles, "n_queries": n_queries,
    "widened_rows": int(len(mx_a)),
    "full_depth_seconds": round(dt_full, 2),
    "model_stage_seconds_full_depth": round(res.stage_seconds["model"], 2),
    "thresholds": {},
}
for t in grid:
    trusted = mx_a >= t
    # outcome diff: matched-vs-not flips, or both match but at different pos
    diff = trusted & (
        (match_h != match_m) | (match_h & match_m & (pos_a != pos_m))
    )
    out["thresholds"][str(t)] = {
        "rows_trusted": int(trusted.sum()),
        "waveB_rows_remaining": int((~trusted).sum()),
        "outcome_diffs": int(diff.sum()),
        "tail_won_above_t": int((trusted & ~a_wins).sum()),
        "new_tail_tie_above_t": int((trusted & tie & (cnt_b > 0)).sum()),
    }
    print(f"t={t}: trusted {trusted.sum()}, outcome diffs {diff.sum()}, "
          f"tail wins {int((trusted & ~a_wins).sum())}", file=sys.stderr)

with open(os.path.join(CACHE, "trust_calibration.json"), "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps(out["thresholds"], indent=1))
