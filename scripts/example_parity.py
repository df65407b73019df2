"""Reproducible example-dataset parity: full train → predict → accuracy.

Runs the complete pipeline on the reference's shipped example dataset
(30k truth / 10k train / 10k test; /root/reference/example_dataset) and
checks the accuracy table against the reference README's published numbers
(reference README.md:43-68; BASELINE.md):

    correctly matched   ~5929    incorrectly matched   ~114
    correctly not-found ~3894    incorrectly not-found  ~63
    custom error = incorrectly_not_found + 5*incorrectly_matched  (~633)

The reference seeds nothing (SURVEY.md §7.3), so parity is statistical:
the gate is custom_error <= PARITY_MAX_ERROR (default 700) and each cell
within 5% of the reference total.  Prints a JSON summary and, with
``--out``, writes the full record there.

Usage:  python scripts/example_parity.py [--source DIR] [--out FILE]
"""

import argparse
import glob
import gzip
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REFERENCE_TABLE = {
    "correctly_matched": 5929,
    "incorrectly_matched": 114,
    "correctly_not_found": 3894,
    "incorrectly_not_found": 63,
}
REFERENCE_ERROR = 633  # 63 + 5*114


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default="/root/reference/example_dataset")
    ap.add_argument("--out", default=None, help="write the full record here")
    ap.add_argument("--max-error", type=float,
                    default=float(os.environ.get("PARITY_MAX_ERROR", 700)))
    ap.add_argument("--data-dir", default=None,
                    help="reuse a staged dataset dir instead of staging one "
                         "under the checkout's data/parity/")
    args = ap.parse_args()

    data_dir = args.data_dir or os.path.join(ROOT, "data", "parity")
    if not args.data_dir:
        os.makedirs(data_dir, exist_ok=True)
        for gz in glob.glob(os.path.join(args.source, "*.csv.gz")):
            dest = os.path.join(data_dir, os.path.basename(gz)[:-3])
            with gzip.open(gz, "rb") as f_in, open(dest, "wb") as f_out:
                shutil.copyfileobj(f_in, f_out)
    os.environ["PROJECT_DATA_PATH"] = data_dir

    from doppelspeller.config import Config, set_config
    from doppelspeller.models.trainer import train_model
    from doppelspeller.pipeline import Matcher, accuracy_report
    from doppelspeller.utils.io import load_test_data

    cfg = Config(data_path=data_dir)
    set_config(cfg)

    t0 = time.time()
    model, report = train_model(config=cfg)
    t_train = time.time() - t0
    print(f"# train: {t_train:.1f}s trees={model.num_trees} "
          f"best={model.best_ntree_limit} "
          f"eval-error={report['eval_custom_error']:.0f}", file=sys.stderr)

    t0 = time.time()
    matcher = Matcher(cfg, model=model, use_index_checkpoint=False)
    result = matcher.predict(load_test_data(cfg))
    t_predict = time.time() - t0
    result.save_csv(cfg.final_output_path, cfg.delimiter)
    print(f"# predict: {t_predict:.1f}s stages={result.stage_counts}",
          file=sys.stderr)

    # warm predict: same process, all programs compiled — separates one-time
    # compile/cache cost from the steady per-run cost in the artifact
    t0 = time.time()
    result_w = matcher.predict(load_test_data(cfg))
    t_predict_warm = time.time() - t0
    assert list(result_w.match_title_id) == list(result.match_title_id)
    print(f"# predict warm: {t_predict_warm:.1f}s", file=sys.stderr)

    acc = accuracy_report(cfg.test_with_actuals_path, cfg.final_output_path,
                          cfg.delimiter)

    total = sum(REFERENCE_TABLE.values())
    checks = {
        "custom_error_leq_max": acc["custom_error"] <= args.max_error,
    }
    for key, ref in REFERENCE_TABLE.items():
        checks[f"{key}_within_5pct_of_total"] = abs(acc[key] - ref) <= 0.05 * total
    ok = all(checks.values())

    parity = {
        "dataset": "reference example_dataset (30k truth / 10k train / 10k test)",
        "reference_table": REFERENCE_TABLE,
        "reference_custom_error": REFERENCE_ERROR,
        "ours": acc,
        "train_eval_custom_error": report["eval_custom_error"],
        "train_error_matrix": report["error_matrix"],
        "train_seconds": round(t_train, 1),
        "train_timings": {k: round(v, 1) for k, v in
                          report.get("timings", {}).items()},
        "predict_seconds": round(t_predict, 1),
        "predict_warm_seconds": round(t_predict_warm, 1),
        "predict_warm_stage_seconds": {k: round(v, 2) for k, v in
                                       result_w.stage_seconds.items()},
        "predict_stage_seconds": {k: round(v, 2) for k, v in
                                  result.stage_seconds.items()},
        "stage_counts": result.stage_counts,
        "checks": checks,
        "ok": ok,
        "max_error_gate": args.max_error,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(parity, f, indent=2)
    print(json.dumps({"parity_ok": ok, "custom_error": acc["custom_error"],
                      "reference_custom_error": REFERENCE_ERROR}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
