"""Retrieval recall of each scoring variant against exact float32 scoring.

Measures recall@100 against the exact f32 path, top-1 agreement, and
true-match retention (is a misspelled query's true title among its top-100
candidates?) for bf16 exact scoring and for folded retrieval over a grid of
fold widths, rescore depths and hash counts, on a synthetic registry.
Prints one JSON object.

Usage: python scripts/recall_ab.py [n_titles] [n_queries]
"""

import json
import os
import random
import string
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

n_titles = int(sys.argv[1]) if len(sys.argv) > 1 else 500_000
n_queries = int(sys.argv[2]) if len(sys.argv) > 2 else 4_096

from doppelspeller.config import Config
from doppelspeller.ops.jaccard import JaccardScorer
from doppelspeller.ops.ngram_index import build_truth_index
from doppelspeller.utils.io import TitleSet
from doppelspeller.utils.misspell import generate_misspelled_name

rng = random.Random(7)
common = ["limited", "holdings", "group", "services", "international", "systems"]
stems = ["".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(4, 10)))
         for _ in range(max(n_titles // 12, 1000))]


def make_title():
    words = [rng.choice(stems) for _ in range(rng.randint(1, 3))]
    if rng.random() < 0.75:
        words.append(rng.choice(common))
    return " ".join(words)


base = Config(data_path=os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data"))
truth = TitleSet.from_titles([make_title() for _ in range(n_titles)], config=base)
# realistic query mix: misspelled truth titles + unseen
q_titles = []
q_truth_row = []      # truth row of misspelled queries, -1 for unseen
for i in range(n_queries):
    if i % 3 == 2:
        q_titles.append(make_title())
        q_truth_row.append(-1)
    else:
        j = rng.randrange(n_titles)
        q_titles.append(generate_misspelled_name(truth.transformed[j], rng))
        q_truth_row.append(j)
q_truth_row = np.asarray(q_truth_row)
index = build_truth_index(truth, base)
print(f"# index built ({index.packed_nbytes/1e9:.2f} GB)", file=sys.stderr)

K = 100
results = {}
pos_by_variant = {}
# Folded variants: the engine at >= folded_min_titles is the two-stage
# folded path, on a C/depth/hash grid and with the coarse pass's windowed
# select on/off.  All folded variants run the production bf16 default.
fold = dict(retrieval_mode="folded")
for name, cfg in [
    ("exact_f32", base.with_(score_dtype="float32", retrieval_mode="exact")),
    ("exact_bf16", base.with_(score_dtype="bfloat16", retrieval_mode="exact")),
    ("folded_c512_d128_h1", base.with_(fold_dim=512, rescore_depth=128,
                                       fold_hashes=1, **fold)),
    ("folded_c512_d128_h2", base.with_(fold_dim=512, rescore_depth=128,
                                       fold_hashes=2, **fold)),
    ("folded_c512_d64_h2", base.with_(fold_dim=512, rescore_depth=64,
                                      fold_hashes=2, **fold)),
    ("folded_c256_d128_h2", base.with_(fold_dim=256, rescore_depth=128,
                                       fold_hashes=2, **fold)),
    ("folded_c1024_d128_h1", base.with_(fold_dim=1024, rescore_depth=128,
                                        fold_hashes=1, **fold)),
    ("folded_c512_d128_h2_nowsel", base.with_(fold_dim=512, rescore_depth=128,
                                              fold_hashes=2,
                                              retrieval_window_select=False,
                                              **fold)),
]:
    queries = TitleSet.from_titles(q_titles, config=cfg)
    scorer = JaccardScorer(index, cfg, truth=truth)
    t0 = time.time()
    s, p = scorer.topk(queries, k=K)
    dt = time.time() - t0
    pos_by_variant[name] = p
    results[name] = {"seconds": round(dt, 2), "qps": round(n_queries / dt, 1)}
    print(f"# {name}: {dt:.2f}s", file=sys.stderr)

ref = pos_by_variant["exact_f32"]
for name, p in pos_by_variant.items():
    inter = np.fromiter(
        (len(np.intersect1d(ref[i], p[i], assume_unique=False))
         for i in range(n_queries)),
        dtype=np.int64, count=n_queries,
    )
    recall = inter / K
    known = q_truth_row >= 0
    retained = (p[known] == q_truth_row[known, None]).any(axis=1)
    results[name].update({
        "recall_at_100_vs_exact_f32_mean": round(float(recall.mean()), 5),
        "recall_at_100_vs_exact_f32_p01": round(float(np.percentile(recall, 1)), 5),
        "top1_agreement": round(float((ref[:, 0] == p[:, 0]).mean()), 5),
        # the metric the cascade actually depends on: is the TRUE title of a
        # misspelled query still among its top-100 candidates?
        "true_match_retained": round(float(retained.mean()), 5),
    })

out = {
    "n_titles": n_titles, "n_queries": n_queries, "k": K,
    "variants": results,
}
print(json.dumps(out))
