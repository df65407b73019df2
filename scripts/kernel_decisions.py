"""Time each hand-written kernel against the plain XLA version it replaces,
on the GPU, at the production shapes (500k truth titles, 10k queries).

    python scripts/kernel_decisions.py [--out chiprun_out/kernel_decisions.json]

Measures, in one process:

* the retrieval stage of ``Matcher.predict`` with the folded coarse pass on
  the Pallas-Triton kernel and on plain XLA (runs in the order xla, triton,
  triton, xla after a warm-up of each), and the same two coarse passes in
  isolation over one 128-query block;
* ``lax.top_k`` at the coarse pass's widths;
* the bit-parallel window match against the DP scan it replaced, at
  model-stage bucket shapes.

Every time is host wall clock around work that ends in
``jax.block_until_ready``: the median of the repetitions.  The card's name
and power limit are printed beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timed(fn, *args, reps: int = 20):
    """Median seconds of ``fn(*args)`` over ``reps`` calls after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "kernel_decisions.json"))
    p.add_argument("--titles", type=int, default=500_000)
    p.add_argument("--queries", type=int, default=10_000)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    import bench
    from chip_smoke import card_line
    from doppelspeller.ops.coarse_triton import WINDOW
    from doppelspeller.ops.features import (
        _window_best_bitparallel,
        _window_best_xla,
    )
    from doppelspeller.ops.fold import (
        coarse_candidates,
        fold_group_weights,
        plan_id_blocks,
    )
    from doppelspeller.ops.ngram_index import build_truth_index
    from doppelspeller.pipeline import Matcher

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"kernel_decisions: needs a CUDA GPU, found {dev.platform}",
              file=sys.stderr)
        return 2
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "card": card_line()}
    print(f"# card: {out['card']}", flush=True)

    cfg, truth, queries, actual = bench.make_synthetic_world(args.titles,
                                                             args.queries)
    model = bench.quick_train_model(cfg, truth, 60)
    index = build_truth_index(truth, cfg)
    matchers = {
        route: Matcher(cfg.with_(retrieval_impl=route), truth=truth,
                       index=index, model=model, use_index_checkpoint=False)
        for route in ("xla", "triton")
    }
    for route, m in matchers.items():
        assert m.scorer.folded.route == route
        m.predict(queries)                               # compile + warm

    # ---- end to end: Matcher.predict stage times, alternating routes ----
    runs = []
    for route in ("xla", "triton", "triton", "xla"):
        t0 = time.perf_counter()
        r = matchers[route].predict(queries)
        runs.append({
            "route": route, "seconds": time.perf_counter() - t0,
            "stage_seconds": dict(r.stage_seconds),
            "accuracy": float((r.match_title_id == actual).mean()),
        })
        print(f"# predict[{route}]: {runs[-1]['seconds']:.3f}s "
              f"stages {runs[-1]['stage_seconds']} acc {runs[-1]['accuracy']:.4f}",
              flush=True)
    out["predict_runs"] = runs

    # ---- the coarse pass alone, one 128-query block over every title ----
    st = matchers["triton"].scorer.folded
    plan = plan_id_blocks(queries, cfg, rows=np.arange(cfg.query_block))[0]
    wfold, _, maxint = (x[0] for x in fold_group_weights(
        jnp.asarray(plan.ids)[None], st.idf_ext_d, st.fb_ext_d, st.fold_ext_d,
        C=st.C, folds=st.folds, dtype=jnp.bfloat16))
    kp = max(st.kprime, cfg.top_n_predicting)
    coarse = {}
    for route in ("xla", "triton"):
        fn = jax.jit(lambda mc, s, w, m, nt, route=route: coarse_candidates(
            mc, s, w, m, nt, kprime=kp, folds=st.folds,
            title_block=cfg.title_block, score_dtype="bfloat16", route=route,
            window=WINDOW))
        coarse[route] = timed(fn, st.mc_d, st.sums_d, wfold, maxint, st.nt_d)
        print(f"# coarse pass [{route}] per 128-query block: "
              f"{coarse[route] * 1e3:.3f} ms", flush=True)
    out["coarse_block_seconds"] = coarse
    out["coarse_shapes"] = {"weights": list(wfold.shape),
                            "folded_bits": list(st.mc_d.shape)}

    # ---- exact top-k at the coarse widths ----
    sel = {}
    rng = np.random.default_rng(0)
    for width in (st.mc_d.shape[1], index.padded_titles):
        x = jnp.asarray(rng.random((cfg.query_block, width), np.float32))
        sel[width] = timed(jax.jit(lambda v: jax.lax.top_k(v, kp)), x)
        print(f"# top_k k={kp} of (128, {width}): {sel[width]}", flush=True)
    out["select_seconds"] = {str(k): v for k, v in sel.items()}

    # ---- the window match: bit-parallel against the DP scan ----
    win = {}
    for B, TL, WL in ((12800, 32, 16), (4096, 64, 32)):
        q_wo = jnp.asarray(rng.integers(2, 38, (B, TL)), jnp.uint8)
        q_len = jnp.asarray(rng.integers(1, TL + 1, B), jnp.int32)
        wlen = rng.integers(0, 9, (B, 15)).astype(np.int32)
        wch = jnp.asarray(rng.integers(2, 38, (B, 15, WL))
                          * (np.arange(WL) < wlen[:, :, None]), jnp.uint8)
        a = (wch, jnp.asarray(wlen), q_wo, q_len)
        win[f"{B}x{TL}x{WL}"] = {
            "bitparallel": timed(jax.jit(_window_best_bitparallel), *a, reps=10),
            "dp_scan": timed(jax.jit(_window_best_xla), *a, reps=10),
        }
        print(f"# window match B={B} TL={TL} WL={WL}: {win[f'{B}x{TL}x{WL}']}",
              flush=True)
    out["window_seconds"] = win

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
