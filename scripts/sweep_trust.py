"""Accuracy + model-stage-time sweep over ``model_trust_threshold``.

Companion to calibrate_trust.py: that script showed trusting diverges from
full-depth on 0.7 % of trusted rows at bench scale (153/22,343 at the 0.995
default — the example-set 0/10000 measurement does not transfer to the
synthetic world's 60-tree model, whose head-max distribution clusters at
0.99+).  Divergence is not loss: this script measures what each threshold
does to END accuracy (vs the synthetic world's ground truth) and to the
model stage's wall time, on the same matcher in one process.

Usage: python scripts/sweep_trust.py [n_titles] [n_queries]
Writes .cache/trust_sweep.json in the checkout.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

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

matcher = Matcher(cfg, truth=truth, index=index, model=model)

# warm every program shape the sweep will hit (full-depth wave B included)
stride = max(len(queries.titles) // 24576, 1)
warm = TitleSet.from_titles(queries.titles[::stride][:24576], config=cfg)
t0 = time.time()
matcher.cfg = cfg.with_(model_widen_threshold=-1.0, model_trust_threshold=2.0)
matcher.predict(warm)
matcher.cfg = cfg
matcher.predict(queries)  # steady-state full-scale warm pass
print(f"# warmup {time.time()-t0:.0f}s", file=sys.stderr)

grid = [2.0, 0.995, 0.99, 0.98, 0.95, 0.9]
out = {"n_titles": n_titles, "n_queries": n_queries, "train_rounds":
       int(os.environ.get("BENCH_TRAIN_ROUNDS", 60)), "thresholds": {}}
base_ids = None
for t in grid:
    matcher.cfg = cfg.with_(model_trust_threshold=t)
    # 2 reps, keep the faster; accuracy identical across reps
    best = None
    for _ in range(2):
        tt = time.time()
        res = matcher.predict(queries)
        dt = time.time() - tt
        if best is None or dt < best[0]:
            best = (dt, res)
    dt, res = best
    acc = float((res.match_title_id == actual).mean())
    if base_ids is None:
        base_ids = res.match_title_id.copy()      # t=2.0 full-depth baseline
    diffs = int((res.match_title_id != base_ids).sum())
    out["thresholds"][str(t)] = {
        "elapsed_seconds": round(dt, 2),
        "model_stage_seconds": round(res.stage_seconds["model"], 2),
        "accuracy": round(acc, 5),
        "output_diffs_vs_full_depth": diffs,
        "model_matches": res.stage_counts["model"],
    }
    print(f"t={t}: {dt:.2f}s (model {res.stage_seconds['model']:.2f}s) "
          f"acc={acc:.5f} diffs={diffs}", file=sys.stderr)
matcher.cfg = cfg

os.makedirs(os.path.join(ROOT, ".cache"), exist_ok=True)
with open(os.path.join(ROOT, ".cache", "trust_sweep.json"), "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps(out["thresholds"], indent=1))
