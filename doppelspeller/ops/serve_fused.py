"""Fused small-batch cascade: retrieval → fuzzy → model in ONE device program.

The classic cascade makes three dispatch-and-fetch rounds per predict call
(retrieval, fuzzy decide, rerank decide), so a single-title request pays
three host↔device synchronisations however fast the kernels are.  This
module composes the SAME traced stage kernels — the folded/exact retrieval
step, the fuzzy dual-ratio decide body, and the fused feature+GBT rerank —
into one jitted program over a fixed QB-query block: per request the host
ships one small id/encoding bundle and fetches one packed stats matrix plus
the candidate block (~4 KB).

Semantics are bit-identical to the classic stages:

* fuzzy: length-delta prefilter → plain ratio, token-sort fallback, keep
  > threshold, per-row unique max (reference predict.py:140-183);
* model: GBT probability over all top-k candidates, unique argmax
  > threshold for batch requests; raw argmax regardless of threshold for
  single-title requests (reference predict.py:239-242, 316-317).

The model stage compiles at a static (title-length, word-length) bucket
covering ≥99.9 % of the truth DB; the program also returns the per-row
probe (max candidate title/word length), and any row exceeding the compiled
bucket is re-decided EXACTLY by the classic host path using the fetched
candidates (no extra retrieval) — rare by construction, never wrong.
"""

from __future__ import annotations

import logging
from functools import partial


import numpy as np

from doppelspeller.config import Config

LOGGER = logging.getLogger(__name__)


def _fused_cascade_impl(
    # retrieval state (folded: mc / exact: packed)
    ret0, sums, tl_mat, idf_t, fb_t, fold_t,
    buf,                                # i32: folded (qb·lq,) ids
    #                                      exact (u + qb·lq,) union+positions
    nt_i,
    # fuzzy resident state
    f_t_enc, f_t_len, f_t_ts, f_t_ts_len,
    # rerank resident state
    r_t_enc, r_t_len, r_t_wchars, r_t_start, r_t_wlen, r_t_nwords, r_t_counts,
    m_feat, m_thr, m_ml, m_val, m_leaf, n_truth_f, base_margin,
    # probe tables (per-truth-title max lengths)
    p_tl, p_wl,
    # per-request query arrays
    q_enc, q_len, q_ts, q_ts_len, q_wo, q_wo_len,
    *, mode, u, qb, lq, k, C, kprime, score_dtype, route, title_block,
    window, folds, tlf, tlr, wl, depth, thr_ratio,
):
    import jax.numpy as jnp

    from doppelspeller.ops.jaccard import (
        densify_weights, topk_over_blocks, union_weights,
    )
    from doppelspeller.ops.levenshtein import lcs_kernel
    from doppelspeller.ops.rerank import _score_gathered_pairs, _word_chars

    dtype = jnp.dtype(score_dtype)

    # ---- stage: retrieval -------------------------------------------------
    if mode == "folded":
        from doppelspeller.ops.fold import (
            _rescore_exact, coarse_candidates, fold_group_weights,
        )

        ids = buf.reshape(qb, lq)
        wfold, w_val, maxint = (x[0] for x in fold_group_weights(
            ids[None], idf_t, fb_t, fold_t, C=C, folds=folds, dtype=dtype,
        ))
        vals_c, pos_c = coarse_candidates(
            ret0, sums, wfold, maxint, nt_i, kprime=kprime, folds=folds,
            title_block=title_block, score_dtype=score_dtype, route=route,
            window=window,
        )
        if tl_mat is not None:
            _, cd = _rescore_exact(
                tl_mat, sums, ids, w_val, maxint, vals_c, pos_c, nt_i, k
            )
        else:
            cd = pos_c[:, :k]
    else:
        union_ids = buf[:u]
        w_val, maxint, wp_c = union_weights(
            idf_t, fb_t, union_ids, buf[u:].reshape(qb, lq), u)
        w = densify_weights(wp_c, w_val, u, dtype)
        _, cd = topk_over_blocks(
            ret0[union_ids], sums, w, maxint, jnp.int32(0), nt_i,
            k=k, title_block=title_block, score_dtype=score_dtype,
        )

    flat = cd.reshape(-1)                                 # (qb·k,)

    # ---- probe: max candidate title/word length per row --------------------
    probe_tl = p_tl[cd].max(axis=1)                       # (qb,)
    probe_wl = p_wl[cd].max(axis=1)

    # ---- stage: fuzzy (the _fuzzy_decide_kernel step body, C=qb) ----------
    te = f_t_enc[flat][:, :tlf]
    tle = f_t_len[flat]
    tts = f_t_ts[flat][:, :tlf]
    ttsl = f_t_ts_len[flat]
    ql_r = jnp.repeat(q_len, k)
    tot = ql_r + tle
    delta = jnp.abs(ql_r - tle)
    del_ratio = (tot - delta).astype(jnp.float32) / jnp.maximum(tot, 1) * 100.0
    consider = del_ratio >= thr_ratio

    def rounded_ratio(a, la, b, lb):
        lcs = lcs_kernel(a, la, b, lb)
        total = jnp.maximum(la + lb, 1).astype(jnp.float32)
        return jnp.round(200.0 * lcs.astype(jnp.float32) / total).astype(jnp.int32)

    r1 = rounded_ratio(jnp.repeat(q_enc, k, axis=0)[:, :tlf], ql_r, te, tle)
    r2 = rounded_ratio(
        jnp.repeat(q_ts, k, axis=0)[:, :tlf], jnp.repeat(q_ts_len, k),
        tts, ttsl,
    )
    ratio = jnp.where(r1 > thr_ratio, r1, r2)
    ratio = jnp.where(consider, ratio, 0).reshape(qb, k)
    keep = ratio > thr_ratio
    masked = jnp.where(keep, ratio, -1)
    fz_mx = masked.max(axis=1)
    fz_cnt = (masked == fz_mx[:, None]).sum(axis=1)
    fz_matched = (fz_mx > -1) & (fz_cnt == 1)
    fz_col = jnp.argmax(masked, axis=1).astype(jnp.int32)
    fz_pos = jnp.take_along_axis(cd, fz_col[:, None], axis=1)[:, 0]

    # ---- stage: model (the _rerank_decide_kernel step body, one chunk) ----
    rep = lambda x: jnp.repeat(x, k, axis=0)  # noqa: E731
    chars = _word_chars(r_t_wchars, r_t_start, r_t_wlen, r_t_enc, flat, wl)
    preds = _score_gathered_pairs(
        rep(q_enc)[:, :tlr], ql_r,
        rep(q_wo)[:, :tlr], jnp.maximum(jnp.repeat(q_wo_len, k), 1),
        r_t_enc[flat], jnp.maximum(r_t_len[flat], 1),
        chars, r_t_wlen[flat],
        jnp.maximum(r_t_nwords[flat], 1),
        r_t_counts[flat].astype(jnp.float32),
        m_feat, m_thr, m_ml, m_val, m_leaf, n_truth_f, base_margin,
        tl=tlr, wl=wl, depth=depth,
    ).reshape(qb, k)
    md_mx = preds.max(axis=1)
    md_cnt = (preds == md_mx[:, None]).sum(axis=1).astype(jnp.int32)
    md_col = jnp.argmax(preds, axis=1).astype(jnp.int32)
    md_pos = jnp.take_along_axis(cd, md_col[:, None], axis=1)[:, 0]

    # ---- one packed result (positions < 2^24 are exact in f32) ------------
    stats = jnp.stack([
        fz_matched.astype(jnp.float32),
        fz_pos.astype(jnp.float32),
        fz_mx.astype(jnp.float32),
        md_cnt.astype(jnp.float32),
        md_pos.astype(jnp.float32),
        md_mx,
        probe_tl.astype(jnp.float32),
        probe_wl.astype(jnp.float32),
    ])                                                    # (8, qb)
    return stats, cd


_fused_cascade = None


def fused_cascade(*args, **kwargs):
    """jit wrapper (deferred so importing this module never initializes jax)."""
    global _fused_cascade
    if _fused_cascade is None:
        import jax

        _fused_cascade = partial(
            jax.jit, static_argnames=(
                "mode", "u", "qb", "lq", "k", "C", "kprime", "score_dtype",
                "route", "title_block", "window", "folds", "tlf", "tlr",
                "wl", "depth", "thr_ratio",
            ),
        )(_fused_cascade_impl)
    return _fused_cascade(*args, **kwargs)


class FusedServe:
    """One-dispatch small-batch matcher over a Matcher's resident engines.

    Built lazily by the pipeline for batches of ≤ one retrieval query block
    on a single device; reuses the scorer/fuzzy/rerank device state, so
    construction only precomputes host-side bucket defaults."""

    def __init__(self, matcher):
        self.m = matcher
        cfg: Config = matcher.cfg
        self.cfg = cfg
        self.scorer = matcher.scorer
        self.fuzzy = matcher._fuzzy_engine()
        self.rerank = matcher._rerank_engine()
        self.k = cfg.top_n_predicting
        self.mode = "folded" if self.scorer.folded is not None else "exact"
        self.qb = (cfg.fold_query_block or cfg.query_block
                   if self.mode == "folded" else cfg.query_block)
        # static rerank buckets covering >=99.9% of the truth DB — rows whose
        # candidates exceed them fall back to the classic path (probe-gated)
        buckets = [b for b in cfg.length_buckets if b < cfg.max_characters]
        buckets.append(cfg.max_characters)
        self._buckets = np.asarray(buckets)
        w_buckets = [b for b in (16, 32, 64) if b < cfg.max_characters]
        w_buckets.append(cfg.max_characters)
        self._w_buckets = np.asarray(w_buckets)
        tl999 = int(np.quantile(matcher.truth.lengths, 0.999))
        wl999 = int(np.quantile(np.maximum(self.rerank._wlen_max, 1), 0.999))
        self.tlr_default = int(self._buckets[np.searchsorted(self._buckets,
                                                             min(tl999, cfg.max_characters))])
        self.wl_default = int(self._w_buckets[np.searchsorted(self._w_buckets,
                                                              min(wl999, cfg.max_characters))])
        self._probe = matcher._probe_tables()
        LOGGER.info(
            "[FusedServe] mode=%s qb=%d k=%d rerank bucket (%d, %d)",
            self.mode, self.qb, self.k, self.tlr_default, self.wl_default,
        )

    # ---------------------------------------------------------- dispatch

    def _retrieval_args(self, queries, rows):
        """(state arrays..., buf, statics dict) for the request's rows."""
        cfg = self.cfg
        sc = self.scorer
        if self.mode == "folded":
            from doppelspeller.ops.fold import plan_id_blocks

            st = sc.folded
            plans = plan_id_blocks(queries, cfg, rows=rows)
            assert len(plans) == 1, "fused path is one query block"
            p = plans[0]
            qb, lq = p.ids.shape
            state = (st.mc_d, st.sums_d, st.tl_d,
                     st.idf_ext_d, st.fb_ext_d, st.fold_ext_d)
            buf = p.ids.reshape(-1).astype(np.int32)
            statics = dict(mode="folded", u=0, qb=qb, lq=lq,
                           **st.statics(self.k))
            return state, buf, statics, p
        from doppelspeller.ops.ngram_index import plan_query_blocks

        plans = plan_query_blocks(queries, sc.index, cfg, rows=rows)
        assert len(plans) == 1, "fused path is one query block"
        p = plans[0]
        qb, lq = p.w_pos.shape
        u = p.union_ids.shape[0]
        state = (sc.packed_d, sc.sums_d, None, sc.idf_d, sc.fb_d, sc.idf_d)
        buf = np.concatenate([p.union_ids, p.w_pos.reshape(-1)]).astype(np.int32)
        statics = dict(
            mode="exact", u=u, qb=qb, lq=lq, C=0, k=self.k, kprime=self.k,
            score_dtype=cfg.score_dtype, route="xla",
            title_block=cfg.title_block, window=1, folds=1,
        )
        return state, buf, statics, p

    def dispatch(self, queries, rows: np.ndarray):
        """One fused device program for ≤ qb rows.  Returns
        (plan, stats (8, qb) f32, cand (qb, k) i32) — DEVICE arrays."""
        import jax.numpy as jnp

        cfg = self.cfg
        state, buf, statics, plan = self._retrieval_args(queries, rows)
        qb = statics["qb"]
        rws = plan.query_rows

        # fuzzy tile: the length-delta prefilter bounds every considered
        # candidate by |q|·(200−thr)/thr, so the tile follows from the
        # request's query lengths alone (same formula as the batch cascade)
        thr = int(cfg.levenshtein_ratio_threshold)
        q_len = queries.lengths[rws].astype(np.int64)
        need = int(np.minimum(
            (q_len * (200 - thr) + thr - 1) // thr, cfg.max_characters
        ).max(initial=1))
        tlf = int(self._buckets[np.searchsorted(
            self._buckets, min(max(need, int(q_len.max(initial=1))),
                               cfg.max_characters))])
        # rerank tile: the static ≥99.9 % bucket, widened to hold the query
        tlr = int(self._buckets[np.searchsorted(
            self._buckets,
            min(max(self.tlr_default, int(q_len.max(initial=1))),
                cfg.max_characters))])
        tlq = max(tlf, tlr)

        n = len(rws)
        q_enc = np.zeros((qb, tlq), np.uint8)
        q_len_a = np.zeros(qb, np.int32)
        q_ts = np.zeros((qb, tlq), np.uint8)
        q_ts_len = np.zeros(qb, np.int32)
        q_wo = np.zeros((qb, tlq), np.uint8)
        q_wo_len = np.zeros(qb, np.int32)
        q_enc[:n] = queries.encoded[rws][:, :tlq]
        q_len_a[:n] = queries.lengths[rws].astype(np.int32)
        ts_all, ts_len_all = queries.encoded_token_sorted
        q_ts[:n] = ts_all[rws][:, :tlq]
        q_ts_len[:n] = np.minimum(ts_len_all[rws], tlq)
        wo_all, wo_len_all = queries.encoded_wo
        q_wo[:n] = wo_all[rws][:, :tlq]
        q_wo_len[:n] = np.minimum(wo_len_all[rws], tlq)

        rk = self.rerank
        out = fused_cascade(
            *state, jnp.asarray(buf), self.scorer.nt_d,
            self.fuzzy.t_enc, self.fuzzy.t_len, self.fuzzy.t_ts,
            self.fuzzy.t_ts_len,
            rk.t_enc, rk.t_len, rk.t_wchars, rk.t_start, rk.t_wlen,
            rk.t_nwords, rk.t_counts,
            *rk.m, rk.n_truth, rk._put(np.float32(rk.base_margin)),
            *self._probe,
            jnp.asarray(q_enc), jnp.asarray(q_len_a),
            jnp.asarray(q_ts), jnp.asarray(q_ts_len),
            jnp.asarray(q_wo), jnp.asarray(q_wo_len),
            tlf=tlf, tlr=tlr, wl=self.wl_default, depth=rk.depth,
            thr_ratio=thr, **statics,
        )
        return plan, out[0], out[1], tlr

    def match(self, queries, rem: np.ndarray, res, single: bool) -> None:
        """Run the fused cascade for ``rem`` (≤ qb rows) and fill ``res``.
        Rows whose candidates exceed the compiled rerank bucket are
        re-decided exactly by the classic host stages (no extra retrieval)."""
        import time as _t

        import jax

        t0 = _t.time()
        plan, stats_d, cand_d, tlr = self.dispatch(queries, rem)
        stats, cand = jax.device_get((stats_d, cand_d))   # ONE fetch barrier
        res.stage_seconds["retrieval"] = _t.time() - t0
        (fz_matched, fz_pos, _fz_ratio, md_cnt, md_pos, md_pred,
         probe_tl, probe_wl) = stats
        cfg = self.cfg
        truth = self.m.truth
        index = self.m.index
        thr_p = cfg.prediction_probability_threshold
        fallback = []
        n_fz = n_md = 0
        from doppelspeller.pipeline import STAGE_FUZZY, STAGE_MODEL

        for j, qi in enumerate(plan.query_rows):
            if probe_tl[j] > tlr or probe_wl[j] > self.wl_default:
                fallback.append((j, qi))
                continue
            if fz_matched[j] > 0:
                pos = int(fz_pos[j])
                res.match_title_id[qi] = int(index.title_ids[pos])
                res.prediction[qi] = 1.0
                res.stage[qi] = STAGE_FUZZY
                res.match_transformed[qi] = truth.transformed[pos]
                n_fz += 1
                continue
            if single or (md_cnt[j] == 1 and md_pred[j] > thr_p):
                # single-title: raw argmax regardless of threshold
                # (reference predict.py:316-317)
                pos = int(md_pos[j])
                res.match_title_id[qi] = int(index.title_ids[pos])
                res.prediction[qi] = float(md_pred[j])
                res.stage[qi] = STAGE_MODEL
                res.match_transformed[qi] = truth.transformed[pos]
                n_md += 1
        res.stage_counts["fuzzy"] = n_fz
        res.stage_counts["model"] = n_md
        if fallback:
            LOGGER.info(
                "[FusedServe] %d rows exceed the (%d, %d) rerank bucket; "
                "classic host redo", len(fallback), tlr, self.wl_default,
            )
            js = np.asarray([j for j, _ in fallback])
            qs = np.asarray([qi for _, qi in fallback], dtype=np.int64)
            cand_sub = cand[js]
            self.m._stage_fuzzy(queries, qs, cand_sub, res)
            res.stage_counts["fuzzy"] = n_fz + res.stage_counts["fuzzy"]
            still = res.stage[qs] == 0
            if still.any():
                self.m._stage_model(
                    queries, qs[still], cand_sub[still], res, single
                )
                res.stage_counts["model"] = n_md + res.stage_counts["model"]
            else:
                res.stage_counts["model"] = n_md
        res.stage_seconds["fuzzy"] = 0.0
        res.stage_seconds["model"] = 0.0
