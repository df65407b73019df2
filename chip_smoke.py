"""Smoke run of the matcher's main path on one CUDA GPU.

    python chip_smoke.py                 # one GPU: the whole main path
    python chip_smoke.py --four-cards    # four GPUs: the mesh path only
    python chip_smoke.py --cpu-rehearsal [--titles N --queries N]

One process drives every phase through the entry points a user calls:

1. device   — the default device must be a CUDA GPU; prints its kind and
               ``nvidia-smi``'s name and power limit.
2. world    — bench.make_synthetic_world: 500,000 company-like truth titles
               and 10,000 queries (~10% exact, ~60% misspelled, ~30% absent).
3. train    — bench.quick_train_model: the GBT reranker trained on the
               device (50k-title subset, 60 rounds).
4. predict  — build_truth_index (device build, checked bit-equal to the host
               build on a 100k-title prefix), Matcher over all titles,
               predict on every query: accuracy floor, the exact-oracle
               anchor on a 2,000-query sample, and true-match retention of
               the folded top-100 against the exact top-100.
5. serve    — 8 single-title requests and one 8-title batch through the
               ``serve`` command's handler (cli.Server, the fused cascade);
               every answer must equal Matcher.predict's.
6. kernels  — each hand-written kernel (ops/coarse_triton.py) against its
               plain XLA reference at the predict phase's shapes, plus the
               bit-parallel window match against the DP scan.

``--four-cards`` runs only the mesh comparison: a 2,000,000-title registry
sharded over four GPUs (exact and folded engines) against the same registry
on one GPU, and data-parallel GBT training on four GPUs against one.

Every phase prints its checks and seconds; a failed check exits non-zero.
The last line of a successful run is the JSON object
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
``--cpu-rehearsal`` runs the same code on the CPU at the given sizes, with
the Triton kernel in the Pallas interpreter, reports failed checks without
stopping, and always exits non-zero: it is not a GPU run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

ACCURACY_FLOOR = 0.81       # bench floor on the 500k x 10k world
ORACLE_DELTA = 0.01         # |fast - exact oracle| accuracy on the sample
RETENTION_DELTA = 0.005     # exact - folded true-match retention in top-100
RTOL_F32 = 1e-5             # f32 scores: only summation order differs


class CheckFailed(Exception):
    pass


class Run:
    """Phase timing and checks; in rehearsal a failed check is reported
    and the run goes on."""

    def __init__(self, rehearsal: bool):
        self.rehearsal = rehearsal
        self.failed = []

    def phase(self, name: str):
        run = self

        class _Phase:
            def __enter__(self):
                self.t0 = time.time()
                print(f"# phase {name}: start", flush=True)

            def __exit__(self, typ, exc, tb):
                dt = time.time() - self.t0
                status = "ok" if typ is None else f"FAILED ({typ.__name__}: {exc})"
                print(f"# phase {name}: {status} in {dt:.1f}s", flush=True)
                if typ is not None:
                    run.failed.append(name)
                return False

        return _Phase()

    def check(self, ok: bool, what: str) -> None:
        print(f"#   check {'pass' if ok else 'FAIL'}: {what}", flush=True)
        if not ok:
            self.failed.append(what)
            if not self.rehearsal:
                raise CheckFailed(what)


def card_line() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "n/a"
    except (OSError, subprocess.SubprocessError):
        return "n/a"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="Run only the four-GPU mesh comparison.")
    p.add_argument("--cpu-rehearsal", action="store_true",
                   help="Run on the CPU at small sizes; never reports success.")
    p.add_argument("--titles", type=int, default=None)
    p.add_argument("--queries", type=int, default=None)
    return p.parse_args(argv)


# ------------------------------------------------------------------ phases

def phase_world(n_titles: int, n_queries: int):
    import bench

    cfg, truth, queries, actual = bench.make_synthetic_world(n_titles, n_queries)
    print(f"#   {len(truth)} titles, {len(queries)} queries, "
          f"{int((actual == -1).sum())} absent", flush=True)
    return cfg, truth, queries, actual


def phase_train(run, cfg, truth):
    import bench

    model = bench.quick_train_model(cfg, truth, 60)
    print(f"#   {model.num_trees} trees, best {model.best_ntree_limit}", flush=True)
    run.check(model.num_trees == 60, "60 boosting rounds trained")
    return model


def phase_predict(run, cfg, truth, queries, actual, model, sample_n):
    import jax

    from doppelspeller.ops.ngram_index import build_truth_index
    from doppelspeller.pipeline import Matcher
    from doppelspeller.utils.io import TitleSet

    t0 = time.time()
    index = build_truth_index(truth, cfg)
    jax.block_until_ready(index.packed)
    print(f"#   index build {time.time() - t0:.1f}s: {index.num_titles} titles, "
          f"padded {index.padded_titles}, packed {index.vocab_size} x "
          f"{index.padded_titles // 8} B", flush=True)

    # the device build's byte scatter-add runs as atomics on the GPU; its
    # distinct bits never carry, so it must equal the host build bit for bit
    n_sub = min(100_000, len(truth))
    sub = TitleSet.from_titles(truth.titles[:n_sub], ids=truth.ids[:n_sub],
                               config=cfg)
    dev = build_truth_index(sub, cfg.with_(index_build_impl="device"))
    host = build_truth_index(sub, cfg.with_(index_build_impl="host"))
    run.check(np.array_equal(np.asarray(dev.packed), host.packed)
              and np.array_equal(dev.df, host.df),
              f"device-built index == host-built index ({n_sub} titles)")
    del dev, host

    matcher = Matcher(cfg, truth=truth, index=index, model=model,
                      use_index_checkpoint=False)
    folded = matcher.scorer.folded
    print(f"#   retrieval: {'folded' if folded is not None else 'exact'}"
          + (f", coarse route {folded.route}, {folded.folds} hashes"
             if folded is not None else ""), flush=True)
    t0 = time.time()
    res = matcher.predict(queries)
    t_first = time.time() - t0
    t0 = time.time()
    res = matcher.predict(queries)
    t_warm = time.time() - t0
    acc = float((res.match_title_id == actual).mean())
    stages = {k: round(v, 3) for k, v in res.stage_seconds.items()}
    print(f"#   predict {len(queries)} queries: first {t_first:.1f}s (with "
          f"compiles), warm {t_warm:.2f}s = {len(queries) / t_warm:.0f} q/s; "
          f"stages {stages}; counts {res.stage_counts}", flush=True)
    run.check(acc >= ACCURACY_FLOOR, f"accuracy {acc:.4f} >= {ACCURACY_FLOOR}")

    # oracle anchor: float32 scoring, exact retrieval, full model depth
    stride = max(len(queries) // sample_n, 1)
    idx = np.arange(0, len(queries), stride)[:sample_n]
    sample = TitleSet.from_titles([queries.titles[i] for i in idx],
                                  ids=queries.ids[idx], config=cfg)
    cfg_exact = cfg.with_(score_dtype="float32", model_depth_initial=0,
                          retrieval_window_select=False, retrieval_mode="exact")
    t0 = time.time()
    m_exact = Matcher(cfg_exact, truth=truth, index=index, model=model,
                      use_index_checkpoint=False)
    r_o = m_exact.predict(sample)
    acc_o = float((r_o.match_title_id == actual[idx]).mean())
    acc_f = float((res.match_title_id[idx] == actual[idx]).mean())
    print(f"#   oracle anchor on {len(idx)} queries ({time.time() - t0:.1f}s): "
          f"exact {acc_o:.4f}, fast {acc_f:.4f}", flush=True)
    run.check(abs(acc_f - acc_o) <= ORACLE_DELTA,
              f"|fast - oracle| = {abs(acc_f - acc_o):.4f} <= {ORACLE_DELTA}")

    # true-match retention of the candidate lists the cascade consumes
    k = cfg.top_n_predicting
    present = actual[idx] != -1
    rows = np.flatnonzero(present)
    ret = {}
    for name, scorer in (("fast", matcher.scorer), ("exact", m_exact.scorer)):
        _, pos = scorer.topk(sample, k=k, rows=rows)
        hit = (index.title_ids[pos] == actual[idx][rows][:, None]).any(axis=1)
        ret[name] = float(hit.mean())
    print(f"#   true-match retention in top-{k} over {len(rows)} in-registry "
          f"queries: fast {ret['fast']:.4f}, exact {ret['exact']:.4f}", flush=True)
    run.check(ret["exact"] - ret["fast"] <= RETENTION_DELTA,
              f"retention gap {ret['exact'] - ret['fast']:.4f} <= {RETENTION_DELTA}")
    del m_exact
    return index, matcher, res


def phase_serve(run, cfg, truth, queries, index, model, matcher, res):
    from doppelspeller.cli import Server, serve_config
    from doppelspeller.pipeline import STAGE_EXACT, Matcher
    from doppelspeller.utils.io import TitleSet, single_title_set

    server = Server(Matcher(serve_config(cfg, "latency"), truth=truth,
                            index=index, model=model,
                            use_index_checkpoint=False))
    t0 = time.time()
    server.warmup()
    print(f"#   serve warmup {time.time() - t0:.1f}s", flush=True)
    # requests that reach retrieval (exact hits never touch the device)
    pick = [i for i in np.flatnonzero(res.stage != STAGE_EXACT)][:16]
    singles = [queries.titles[i] for i in pick[:8]]
    batch = [queries.titles[i] for i in pick[8:16]]
    # reference answers: the same Matcher.predict over the staged cascade
    ref_cfg = matcher.cfg
    matcher.cfg = ref_cfg.with_(serve_fused="off")
    try:
        want_single = [matcher.predict(single_title_set(t, cfg), single=True)
                       for t in singles]
        want_batch = matcher.predict(TitleSet.from_titles(
            batch, ids=np.arange(len(batch), dtype=np.int64), config=cfg))
    finally:
        matcher.cfg = ref_cfg
    lat = []
    same = True
    for t, want in zip(singles, want_single):
        got = server.handle(json.dumps({"title": t}))
        lat.append(got["latency_ms"])
        same &= (got["match_title_id"] == int(want.match_title_id[0])
                 and abs(got["prediction"] - float(want.prediction[0])) <= 1e-5)
    got_b = server.handle(json.dumps({"titles": batch}))
    ids_b = [r["match_title_id"] for r in got_b["results"]]
    preds_b = np.asarray([r["prediction"] for r in got_b["results"]])
    same_b = (ids_b == [int(x) for x in want_batch.match_title_id]
              and np.allclose(preds_b, want_batch.prediction, atol=1e-5))
    print(f"#   serve single latency p50 {np.median(lat):.1f} ms "
          f"(min {min(lat):.1f}, max {max(lat):.1f}); batch-8 "
          f"{got_b['latency_ms']:.1f} ms", flush=True)
    run.check(bool(same), "8 single-title answers == Matcher.predict")
    run.check(bool(same_b), "8-title batch answers == Matcher.predict")


def phase_kernels(run, cfg, queries, matcher, interpret: bool):
    """Each hand-written kernel against its plain XLA reference at the
    predict phase's shapes (one 128-query block over every title)."""
    import jax
    import jax.numpy as jnp

    from doppelspeller.ops.coarse_triton import WINDOW, coarse_window_max
    from doppelspeller.ops.features import (
        _window_best_bitparallel,
        _window_best_xla,
    )
    from doppelspeller.ops.fold import (
        _rescore_exact,
        coarse_candidates,
        fold_group_weights,
        plan_id_blocks,
    )
    from doppelspeller.ops.jaccard import unpack_bits, window_max

    st = matcher.scorer.folded
    if st is None:
        run.check(False, "folded engine engaged (kernel shapes)")
        return
    plan = plan_id_blocks(queries, cfg, rows=np.arange(min(cfg.query_block,
                                                           len(queries))))[0]
    ids = jnp.asarray(plan.ids)
    wfold, w_val, maxint = (x[0] for x in fold_group_weights(
        ids[None], st.idf_ext_d, st.fb_ext_d, st.fold_ext_d, C=st.C,
        folds=st.folds, dtype=jnp.bfloat16))
    mc, sums, nt = st.mc_d, st.sums_d, st.nt_d
    print(f"#   coarse shapes: weights {tuple(wfold.shape)}, folded bits "
          f"{tuple(mc.shape)} u8 ({mc.nbytes / 1e6:.1f} MB)", flush=True)

    wmax, warg = coarse_window_max(mc, sums, wfold, maxint, nt,
                                   folds=st.folds, interpret=interpret)

    @jax.jit
    def plain_scores(mc, sums, wfold, maxint, nt):
        # the plain reference: every title's two-hash bound, in f32 sums of
        # exact bf16 products
        h = mc.shape[0] // st.folds
        num = None
        for f in range(st.folds):
            s = jax.lax.dot_general(
                wfold[:, f * st.C:(f + 1) * st.C],
                unpack_bits(mc[f * h:(f + 1) * h]).astype(jnp.bfloat16),
                (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
            num = s if num is None else jnp.minimum(num, s)
        jacc = num / jnp.maximum(sums[None, :] + maxint[:, None] - num, 1e-9)
        t = jnp.arange(jacc.shape[1])[None, :]
        return jnp.where(t < nt, jacc, -1.0)

    jacc = plain_scores(mc, sums, wfold, maxint, nt)
    ref_max, _ = window_max(jacc, WINDOW)
    wmax, warg, jacc, ref_max = (np.asarray(x) for x in (wmax, warg, jacc, ref_max))
    run.check(np.allclose(wmax, ref_max, rtol=RTOL_F32, atol=1e-6),
              f"coarse window maxima == plain XLA (rtol {RTOL_F32}); max abs "
              f"diff {np.abs(wmax - ref_max).max():.2e}")
    # ties may pick another title of the window: its score must be the max
    q = np.arange(wmax.shape[0])[:, None]
    b = np.arange(wmax.shape[1])[None, :]
    picked = jacc[q, b * WINDOW + warg]
    run.check(np.allclose(picked, ref_max, rtol=RTOL_F32, atol=1e-6),
              "coarse window argmax holds the window's max score")

    # coarse top-k' through each route, then the exact f32 rescore
    kp = max(st.kprime, cfg.top_n_predicting)
    out = {}
    for route in ("triton_interpret" if interpret else "triton", "xla"):
        vc, pc = coarse_candidates(
            mc, sums, wfold, maxint, nt, kprime=kp, folds=st.folds,
            title_block=cfg.title_block, score_dtype="bfloat16", route=route,
            window=WINDOW)
        v, p = _rescore_exact(st.tl_d, sums, ids, w_val, maxint, vc, pc, nt,
                              cfg.top_n_predicting)
        out[route.split("_")[0]] = (np.asarray(v), np.asarray(p))
    (vt, pt), (vx, px) = out["triton"], out["xla"]
    untied = np.ones_like(vx, bool)
    untied[:, 1:] &= vx[:, 1:] < vx[:, :-1]
    untied[:, :-1] &= vx[:, :-1] > vx[:, 1:]
    run.check(np.allclose(vt, vx, rtol=RTOL_F32, atol=1e-6)
              and np.array_equal(pt[untied], px[untied]),
              "rescored top-k of the kernel's candidates == plain XLA's "
              "(positions compared where scores are untied)")

    # the bit-parallel window match against the DP scan at model-stage shapes
    rng = np.random.default_rng(0)
    for TL, WL in ((32, 16), (64, 32)):
        B = 4096
        q_wo = rng.integers(2, 38, (B, TL)).astype(np.uint8)
        q_len = rng.integers(1, TL + 1, B).astype(np.int32)
        wlen = rng.integers(0, WL + 1, (B, 15)).astype(np.int32)
        wch = (rng.integers(2, 38, (B, 15, WL))
               * (np.arange(WL) < wlen[:, :, None])).astype(np.uint8)
        args = [jnp.asarray(x) for x in (wch, wlen, q_wo, q_len)]
        rb, pb = jax.jit(_window_best_bitparallel)(*args)
        rx, px_ = jax.jit(_window_best_xla)(*args)
        run.check(np.array_equal(np.asarray(rb), np.asarray(rx))
                  and np.array_equal(np.asarray(pb), np.asarray(px_)),
                  f"bit-parallel window match == DP scan (B={B}, TL={TL}, WL={WL})")


def check_folded_mesh(run, s1, p1, s4, p4, title_ids, actual):
    """Folded top-k on four shards against one device, after the exact f32
    rescore.  Each shard rescores its own coarse top-k', and their union
    holds the single device's coarse top-k', so the mesh ranks can only
    score higher: rank by rank the mesh dominates, except where coarse
    scores tie at the k' boundary (their f32 weights come from a
    scatter-add whose order varies).  A title in both lists carries the
    same exact score, and the mesh keeps every true match the single
    device keeps."""
    below = (s4 < s1 - 1e-6).any(axis=1)
    higher = (s4 > s1 + 1e-6).any(axis=1)
    shared = mism = 0
    for i in range(len(p1)):
        got = dict(zip(p4[i].tolist(), s4[i].tolist()))
        for p, v in zip(p1[i].tolist(), s1[i].tolist()):
            if p in got:
                shared += 1
                mism += abs(got[p] - v) > RTOL_F32 * abs(v) + 1e-6
    known = actual != -1

    def kept(p):
        return float((title_ids[p[known]] == actual[known][:, None]).any(1).mean())

    print(f"#   folded: {int(higher.sum())} queries score higher on 4 cards, "
          f"{int(below.sum())} lower; {shared} shared titles, {mism} with "
          f"another score; true-match retention 1 card {kept(p1):.4f}, "
          f"4 cards {kept(p4):.4f}", flush=True)
    run.check(below.mean() <= 0.01,
              "folded: 4 cards rank-wise >= 1 card on >= 99% of queries")
    run.check(mism == 0, "folded: shared titles carry the same exact score "
              f"(rtol {RTOL_F32})")
    run.check(kept(p4) >= kept(p1), "folded: 4-card retention >= 1-card")


def phase_four_cards(run, n_titles: int, n_queries: int, devices):
    """The mesh path on four devices against device 0 alone."""
    import jax

    import bench
    from doppelspeller.models.gbt import GBTParams, train_gbt
    from doppelspeller.ops.jaccard import JaccardScorer
    from doppelspeller.ops.ngram_index import build_truth_index
    from doppelspeller.parallel.sharded import build_sharded_index, make_mesh

    cfg, truth, queries, actual = bench.make_synthetic_world(n_titles, n_queries)
    mesh = make_mesh(4, axis=cfg.mesh_axis, platform=devices[0].platform)
    k = cfg.top_n_predicting
    with jax.default_device(devices[0]):
        index = build_truth_index(truth, cfg)
    for mode in ("exact", "auto"):
        c = cfg.with_(retrieval_mode=mode,
                      **({"score_dtype": "float32"} if mode == "exact" else {}))
        t0 = time.time()
        sharded = build_sharded_index(truth, mesh, c)
        t_build = time.time() - t0
        single = JaccardScorer(index, c, device=devices[0], truth=truth)
        name = "folded" if sharded.folded is not None else "exact"
        if mode == "auto":
            run.check(name == "folded", "mesh engages the folded engine at "
                      f"{n_titles} titles")
        t0 = time.time()
        s4, p4 = sharded.topk(queries, k=k)
        t4 = time.time() - t0
        t0 = time.time()
        s1, p1 = single.topk(queries, k=k)
        t1 = time.time() - t0
        print(f"#   {name}: mesh build {t_build:.1f}s, score {len(queries)} "
              f"queries 4 cards {t4:.1f}s / 1 card {t1:.1f}s (incl. compile)",
              flush=True)
        if name == "exact":
            untied = np.ones_like(s1, bool)
            untied[:, 1:] &= s1[:, 1:] < s1[:, :-1]
            untied[:, :-1] &= s1[:, :-1] > s1[:, 1:]
            run.check(np.allclose(s4, s1, rtol=RTOL_F32, atol=1e-6)
                      and np.array_equal(p4[untied], p1[untied]),
                      "exact f32 top-k: 4 cards == 1 card (positions where "
                      "untied)")
            shards = sharded.packed_d.addressable_shards
        else:
            check_folded_mesh(run, s1, p1, s4, p4, index.title_ids, actual)
            shards = sharded.folded.mc_d.addressable_shards
        devs = {s.device for s in shards}
        run.check(len(devs) == 4, f"{name} shards on {len(devs)} distinct devices")
        if name == "exact":
            share = shards[0].data.nbytes
            per_dev = [(d.memory_stats() or {}).get("bytes_in_use", 0)
                       for d in mesh.devices.flat]
            print(f"#   bytes in use per card {per_dev}; exact shard {share}",
                  flush=True)
            run.check(all(b >= share for b in per_dev),
                      "each card's memory holds its exact-index shard")
        del sharded, single
    del index

    # data-parallel GBT: 4 cards against 1
    rng = np.random.default_rng(3)
    N, F = 200_000, 66
    X = rng.standard_normal((N, F)).astype(np.float32)
    X[rng.random((N, F)) < 0.05] = np.nan
    y = ((np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 5])
          + 0.3 * rng.standard_normal(N)) > 0).astype(np.float32)
    Xe, ye = X[:20_000].copy(), y[:20_000].copy()
    params = GBTParams(depth=5, num_boost_round=40, early_stopping_rounds=40)
    t0 = time.time()
    with jax.default_device(devices[0]):
        m1 = train_gbt(X, y, Xe, ye, params, verbose_every=0)
    t1 = time.time() - t0
    t0 = time.time()
    m4 = train_gbt(X, y, Xe, ye, params, verbose_every=0,
                   mesh=make_mesh(4, axis="data", platform=devices[0].platform))
    t4 = time.time() - t0
    print(f"#   GBT {N} x {F}, 40 rounds: 1 card {t1:.1f}s, 4 cards {t4:.1f}s "
          f"(incl. compile)", flush=True)
    run.check(np.array_equal(m1.feat[0], m4.feat[0])
              and np.array_equal(m1.split_bin[0], m4.split_bin[0]),
              "first tree: same splits on 4 cards as on 1")

    def margin(m, X):
        p = np.clip(m.predict(X, ntree_limit=1).astype(np.float64), 1e-12,
                    1 - 1e-12)
        return np.log(p / (1 - p))

    d = np.abs(margin(m1, Xe) - margin(m4, Xe)).max()
    run.check(d <= 1e-4, f"first-tree margins within 1e-4 (max {d:.2e})")
    same = float((m1.feat == m4.feat).mean())
    print(f"#   40-round forests: {same:.4f} of split features equal", flush=True)


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    args = parse_args(argv)
    if args.cpu_rehearsal:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                       + " --xla_force_host_platform_device_count=4")
    import jax

    devices = jax.devices()
    dev = devices[0]
    want = 4 if args.four_cards else 1
    if not args.cpu_rehearsal and dev.platform != "gpu":
        print(f"chip_smoke: needs a CUDA GPU, JAX found {dev.platform!r} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    if len(devices) < want:
        print(f"chip_smoke: needs {want} devices, JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    print(f"# device: {dev.platform} {dev.device_kind} x {len(devices)}",
          flush=True)
    print(card_line(), flush=True)        # name, power limit as nvidia-smi gives them

    sys.path.insert(0, HERE)
    import doppelspeller  # noqa: F401  (enables the compile cache)

    run = Run(args.cpu_rehearsal)
    t_all = time.time()
    try:
        if args.four_cards:
            with run.phase("four-cards"):
                phase_four_cards(run, args.titles or 2_000_000,
                                 args.queries or 4096, devices[:4])
        else:
            n_titles = args.titles or 500_000
            n_queries = args.queries or 10_000
            with run.phase("world"):
                cfg, truth, queries, actual = phase_world(n_titles, n_queries)
                if args.cpu_rehearsal:
                    # engage the folded engine at rehearsal sizes
                    cfg = cfg.with_(folded_min_titles=min(n_titles, 200_000))
            with run.phase("train"):
                model = phase_train(run, cfg, truth)
            with run.phase("predict"):
                index, matcher, res = phase_predict(
                    run, cfg, truth, queries, actual, model,
                    sample_n=min(2000, n_queries))
            with run.phase("serve"):
                phase_serve(run, cfg, truth, queries, index, model, matcher, res)
            with run.phase("kernels"):
                phase_kernels(run, cfg, queries, matcher,
                              interpret=args.cpu_rehearsal)
    except Exception as exc:  # a failed phase ends the run
        print(f"chip_smoke: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(f"# total {time.time() - t_all:.1f}s", flush=True)
    if args.cpu_rehearsal:
        print(f"chip_smoke: CPU rehearsal, {len(run.failed)} failed check(s): "
              f"{run.failed}; not a GPU run", file=sys.stderr)
        return 3
    if run.failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
