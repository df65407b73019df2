"""Summarize a jax.profiler trace directory (BENCH_TRACE_DIR) into the
top time consumers — used to attribute rep-to-rep variance in bench runs.

Usage: python scripts/trace_summary.py TRACE_DIR
"""

import glob
import gzip
import json
import sys
from collections import defaultdict


def main(trace_dir: str) -> None:
    files = glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True)
    if not files:
        print(f"no trace files under {trace_dir}")
        return
    path = max(files)  # latest
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    by_name = defaultdict(float)
    by_cat = defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        dur = e.get("dur", 0) / 1e6  # us -> s
        by_name[e.get("name", "?")] += dur
        by_cat[e.get("cat", e.get("pid", "?"))] += dur
    print(f"# {path}: {len(events)} events")
    print("\n== top 25 by total duration ==")
    for name, dur in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"{dur:10.3f}s  {name[:110]}")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
