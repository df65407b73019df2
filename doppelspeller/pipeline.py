"""The prediction cascade: exact → Jaccard top-n → fuzzy Levenshtein → model.

Reference parity: predict.py:17-321.  Stage semantics:

1. **Exact** (predict.py:97-113): transformed-title hash lookup (on duplicate
   truth titles the last title_id wins, as with the reference's dict
   reversal, predict.py:75), prediction = 1.0.
2. **Fuzzy** (predict.py:140-183): for each remaining query, its top-100
   weighted-Jaccard candidates are filtered by the length-delta "deletion
   ratio" (≥ threshold), scored with the rounded Levenshtein ratio, falling
   back to the token-sort ratio when ≤ threshold; matches with ratio >
   threshold are grouped per query, max taken, and queries with tied
   distinct max rows are dropped to the next stage.
3. **Model** (predict.py:185-254): all 100 candidates of still-unmatched
   queries are scored by the GBT reranker over the 66-dim features;
   per-query argmax kept if prediction > 0.9 (unless single-title mode,
   which returns the argmax unconditionally, predict.py:239-242).

Everything is batched: no 10k-row chunk loop (the reference's chunking,
predict.py:294-314, is a memory workaround with no semantic effect), no
per-row candidate loops.
"""

from __future__ import annotations

import csv
import logging
import os
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from doppelspeller.config import Config, get_config
from doppelspeller.models.gbt import GBTModel
from doppelspeller.models.trainer import WordCounts
from doppelspeller.ops.jaccard import JaccardScorer
from doppelspeller.ops.ngram_index import TruthIndex, build_truth_index
from doppelspeller.utils import text as T
from doppelspeller.utils.io import TitleSet, load_ground_truth

LOGGER = logging.getLogger(__name__)

STAGE_NONE = 0
STAGE_EXACT = 1
STAGE_FUZZY = 2
STAGE_MODEL = 3


@dataclass
class PredictionResult:
    test_index: np.ndarray        # int64[N]
    match_title_id: np.ndarray    # int64[N]  (−1 = not found)
    prediction: np.ndarray        # float32[N]
    stage: np.ndarray             # uint8[N]  (STAGE_*)
    transformed: List[str]
    match_transformed: List[Optional[str]]
    stage_counts: Dict[str, int] = field(default_factory=dict)
    stage_seconds: Dict[str, float] = field(default_factory=dict)

    def save_csv(self, path: str, delimiter: str = "|") -> None:
        """``title_id<d>test_index`` rows sorted by test_index (reference
        output file, predict.py:319-321)."""
        order = np.argsort(self.test_index, kind="stable")
        with open(path, "w", newline="") as f:
            w = csv.writer(f, delimiter=delimiter, lineterminator="\n")
            w.writerow(["title_id", "test_index"])
            w.writerows(zip(self.match_title_id[order].tolist(),
                            self.test_index[order].tolist()))

    def single_result(self) -> dict:
        """Reference single-title dict (predict.py:35-41,316-317)."""
        return {
            "test_index": int(self.test_index[0]),
            "transformed_title": self.transformed[0],
            "match_transformed_title": self.match_transformed[0],
            "match_title_id": int(self.match_title_id[0]),
            "prediction": float(self.prediction[0]),
        }


def _jit_helpers():
    """Tiny jitted device helpers for the fixed-shape cascade (module-level
    so their compile caches are shared across Matcher instances).  All are
    trivial data-movement programs — the heavy decide kernels never see a
    query-count-dependent shape, so no heavy program compiles mid-run."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def reshape_cand(pos):
        return pos.reshape(-1, pos.shape[-1])

    from functools import partial as _partial

    @_partial(jax.jit, static_argnames=("n",))
    def pack_fuzzy(matched, best_pos, best_ratio, over, ptl, pwl, *, n):
        # row order consumed by the cascade's barrier-1 reader:
        # probe_tl, probe_wl, matched, best_pos, best_ratio, over
        return jnp.stack([
            ptl[:n].astype(jnp.int32), pwl[:n].astype(jnp.int32),
            matched[:n].astype(jnp.int32), best_pos[:n].astype(jnp.int32),
            best_ratio[:n].astype(jnp.int32), over[:n].astype(jnp.int32),
        ])

    @_partial(jax.jit, static_argnames=("n",))
    def pack_model(n_at_max, best_pos, pred, *, n):
        return jnp.stack([
            n_at_max[:n].astype(jnp.float32),   # tie count <= K: exact in f32
            best_pos[:n].astype(jnp.float32),   # positions < 2^24: exact in f32
            pred[:n],
        ])

    @jax.jit
    def concat_rows(*xs):
        return jnp.concatenate(xs, axis=0)

    @jax.jit
    def gather_rows(arr, idx):
        return arr[idx]

    return reshape_cand, pack_fuzzy, pack_model, concat_rows, gather_rows


_HELPERS = None


def _helpers():
    global _HELPERS
    if _HELPERS is None:
        _HELPERS = _jit_helpers()
    return _HELPERS


def _groupby_max_unique(q_idx: np.ndarray, values: np.ndarray, n_queries: int):
    """For rows (q_idx, value): per-query max and whether it is achieved by
    exactly one row.  Returns (max_val[nq], best_row[nq], unique[nq])."""
    max_val = np.full(n_queries, -np.inf, dtype=np.float64)
    np.maximum.at(max_val, q_idx, values.astype(np.float64))
    is_max = values.astype(np.float64) == max_val[q_idx]
    count_max = np.zeros(n_queries, dtype=np.int64)
    np.add.at(count_max, q_idx[is_max], 1)
    best_row = np.full(n_queries, -1, dtype=np.int64)
    rows = np.flatnonzero(is_max)
    best_row[q_idx[rows][::-1]] = rows[::-1]  # keep FIRST max row
    return max_val, best_row, count_max == 1


class Matcher:
    """End-to-end matcher over a truth database (reference Prediction class)."""

    def __init__(
        self,
        config: Optional[Config] = None,
        truth: Optional[TitleSet] = None,
        index: Optional[TruthIndex] = None,
        model: Optional[GBTModel] = None,
        use_index_checkpoint: bool = True,
        mesh=None,
    ):
        """``mesh``: a 1-D jax.sharding.Mesh — the truth index is sharded over
        the title axis for retrieval (per-shard scoring + all-gather merge)
        and the fuzzy/model stages run data-parallel over the query
        rows.  Multi-chip capability per SURVEY.md §2.4 (the reference is
        single-node; README.md:79-80 frames distribution as future work)."""
        self.cfg = config or get_config()
        self.mesh = mesh
        self.truth = truth or load_ground_truth(self.cfg)
        if len(self.truth) >= 2 ** 24:
            # the device cascade packs truth positions through float32
            # (_jit_helpers.pack_model), exact only below 2^24 — fail loudly
            # rather than silently corrupt matched positions
            raise ValueError(
                f"truth set has {len(self.truth)} titles >= 2^24; the device "
                "cascade's float32 position packing would lose exactness "
                "(shard the index across a mesh instead)"
            )
        if (mesh is not None and index is None and use_index_checkpoint
                and os.path.exists(self.cfg.index_path)):
            # mesh path: load the checkpoint shard-by-shard onto the mesh
            # (host peak ≈ one shard) instead of materializing a full host
            # matrix first — covers both sharded- and single-chip-format
            # checkpoints (parallel/sharded.ShardedJaccardScorer.load)
            from doppelspeller.parallel.sharded import ShardedJaccardScorer

            if ShardedJaccardScorer.checkpoint_matches(
                self.cfg.index_path, self.truth
            ):
                LOGGER.info(
                    "loading index checkpoint %s onto the mesh",
                    self.cfg.index_path,
                )
                self.scorer = ShardedJaccardScorer.load(
                    self.cfg.index_path, mesh, self.cfg, truth=self.truth
                )
                self.index = self.scorer.index
                self._finish_init(model)
                return
            LOGGER.warning(
                "index checkpoint at %s does not match the truth data; "
                "rebuilding on the mesh", self.cfg.index_path,
            )
        if index is None and use_index_checkpoint and os.path.exists(self.cfg.index_path):
            # resume from the checkpointed index (cli.py build-index) — the
            # reference rebuilds its MatchMaker from CSV on every run
            from doppelspeller.ops.ngram_index import title_content_hash

            try:
                loaded = TruthIndex.load(self.cfg.index_path)
            except Exception as exc:  # stale/old-format checkpoint
                LOGGER.warning(
                    "index checkpoint at %s unreadable (%s); rebuilding",
                    self.cfg.index_path, exc,
                )
                loaded = None
            if (
                loaded is not None
                and loaded.num_titles == len(self.truth)
                and np.array_equal(loaded.title_ids, self.truth.ids)
                and loaded.content_hash
                == title_content_hash(self.truth.encoded, self.truth.lengths)
            ):
                LOGGER.info("loaded index checkpoint from %s", self.cfg.index_path)
                index = loaded
            else:
                LOGGER.warning(
                    "index checkpoint at %s does not match the truth data; rebuilding",
                    self.cfg.index_path,
                )
        if mesh is not None and index is None:
            # build the index directly on the mesh: each device constructs
            # its own title-column shard from its slice of the encodings —
            # no full packed matrix on the host or any single device
            from doppelspeller.parallel.sharded import build_sharded_index

            self.scorer = build_sharded_index(self.truth, mesh, self.cfg)
            self.index = self.scorer.index
        elif mesh is not None:
            from doppelspeller.parallel.sharded import ShardedJaccardScorer

            self.index = index
            self.scorer = ShardedJaccardScorer(
                self.index, mesh, self.cfg, truth=self.truth
            )
        else:
            self.index = index or build_truth_index(self.truth, self.cfg)
            self.scorer = JaccardScorer(self.index, self.cfg, truth=self.truth)
        self._finish_init(model)

    def _finish_init(self, model: Optional[GBTModel]) -> None:
        self.model = model
        self.word_counts = WordCounts(self.truth)
        # exact-match hash: duplicate transformed titles → last id wins
        self.reverse: Dict[str, int] = {
            t: int(i) for t, i in zip(self.truth.transformed, self.truth.ids)
        }
        # per-truth-title caches, computed once and gathered per pair
        self._counts_matrix: Optional[np.ndarray] = None
        self._truth_words = None          # (start, wlen, n_words)
        self._ts_truth = None             # token-sorted (enc, len)
        self._rerank = None               # fused stage-3 device engine
        self._fuzzy = None                # fused stage-2 device engine
        self._fused_serve = None          # one-dispatch small-batch cascade

    @property
    def counts_matrix(self) -> np.ndarray:
        if self._counts_matrix is None:
            self._counts_matrix = self.word_counts.matrix(self.truth.transformed)
        return self._counts_matrix

    @property
    def truth_words(self):
        if self._truth_words is None:
            from doppelspeller.ops.features import split_words_host

            self._truth_words = split_words_host(
                self.truth.encoded, self.truth.lengths
            )
        return self._truth_words

    @property
    def ts_truth(self):
        if self._ts_truth is None:
            ts = [self._token_sort(t) for t in self.truth.transformed]
            enc = T.encode_titles(ts, self.cfg.max_characters)
            lens = np.array([min(len(s), self.cfg.max_characters) for s in ts], np.int32)
            self._ts_truth = (enc, lens)
        return self._ts_truth

    def _load_model(self) -> GBTModel:
        if self.model is None:
            self.model = GBTModel.load(self.cfg.model_path)
        return self.model

    def _fuzzy_engine(self):
        if self._fuzzy is None:
            from doppelspeller.ops.fuzzy import FuzzyEngine

            ts_enc, ts_len = self.ts_truth
            _, wlen, _ = self.truth_words
            self._fuzzy = FuzzyEngine(
                self.truth.encoded, self.truth.lengths, ts_enc, ts_len, self.cfg,
                mesh=self.mesh,
                truth_wlen_max=wlen.max(axis=1).astype(np.int32),
            )
        return self._fuzzy

    def _rerank_engine(self):
        if self._rerank is None:
            from doppelspeller.ops.rerank import RerankEngine

            self._rerank = RerankEngine(
                self.truth.encoded, self.truth.lengths, self.truth_words,
                self.counts_matrix, self._load_model(), len(self.truth), self.cfg,
                mesh=self.mesh,
            )
        return self._rerank

    def _use_fused(self, rem: np.ndarray, impl: str) -> bool:
        """Engage the one-dispatch fused cascade for small batches: single
        chip only, one retrieval query block, device execution not opted
        out.  serve_fused='off' disables (the classic 3-round-trip host path
        remains available for debugging/parity)."""
        if self.cfg.serve_fused == "off":
            return False
        if self.mesh is not None or impl == "host":
            return False
        qb = ((int(getattr(self.cfg, "fold_query_block", 0))
               or self.cfg.query_block)
              if getattr(self.scorer, "folded", None) is not None
              else self.cfg.query_block)
        return len(rem) <= qb and self.index.num_titles >= self.cfg.top_n_predicting

    def _fused_engine(self):
        if self._fused_serve is None:
            from doppelspeller.ops.serve_fused import FusedServe

            self._fused_serve = FusedServe(self)
        return self._fused_serve

    def _token_sort(self, title: str) -> str:
        return " ".join(sorted(title.split()))

    # ------------------------------------------------------------- stages

    def _stage_exact(self, queries: TitleSet, res: PredictionResult) -> None:
        hits = 0
        for i, t in enumerate(queries.transformed):
            tid = self.reverse.get(t)
            if tid is not None:
                res.match_title_id[i] = tid
                res.prediction[i] = 1.0
                res.stage[i] = STAGE_EXACT
                res.match_transformed[i] = t
                hits += 1
        res.stage_counts["exact"] = hits
        LOGGER.info("Matched %d titles so far (exact)", hits)

    def _stage_fuzzy(
        self, queries: TitleSet, rem: np.ndarray, cand_pos: np.ndarray,
        res: PredictionResult,
    ) -> None:
        cfg = self.cfg
        R, K = cand_pos.shape
        thr = cfg.levenshtein_ratio_threshold
        q_len = queries.lengths[rem].astype(np.int64)
        t_len = self.truth.lengths[cand_pos.reshape(-1)].reshape(R, K).astype(np.int64)

        tot = q_len[:, None] + t_len
        delta = np.abs(q_len[:, None] - t_len)
        del_ratio = (tot - delta) / np.maximum(tot, 1) * 100.0
        consider = del_ratio >= thr                       # predict.py:150

        ratio = np.zeros((R, K), dtype=np.int32)
        rows, cols = np.nonzero(consider)
        if len(rows):
            # token-sorted query encodings (cached per TitleSet) for rem
            ts_all, ts_len_all = queries.encoded_token_sorted
            ts_q_enc = ts_all[rem][:, : cfg.max_characters]
            ts_q_len = np.minimum(ts_len_all[rem], cfg.max_characters)
            ts_t_enc, ts_t_len = self.ts_truth
            engine = self._fuzzy_engine()
            ratio[rows, cols] = engine.ratios(
                queries.encoded[rem], queries.lengths[rem].astype(np.int32),
                ts_q_enc, ts_q_len,
                rows, cand_pos[rows, cols],
                self.truth.lengths, ts_t_len,
            )

        keep = ratio > thr                                # predict.py:172
        kr, kc = np.nonzero(keep)
        hits = 0
        if len(kr):
            max_val, best_row, unique = _groupby_max_unique(
                kr, ratio[kr, kc].astype(np.float64), R
            )
            # queries with tied max on distinct rows are dropped to stage 3
            for r in np.flatnonzero((best_row >= 0) & unique):
                row_global = best_row[r]
                col = kc[row_global]
                qi = rem[r]
                pos = cand_pos[r, col]
                res.match_title_id[qi] = int(self.index.title_ids[pos])
                res.prediction[qi] = 1.0
                res.stage[qi] = STAGE_FUZZY
                res.match_transformed[qi] = self.truth.transformed[pos]
                hits += 1
        res.stage_counts["fuzzy"] = hits
        LOGGER.info("Matched %d titles so far (fuzzy)", hits)

    def _stage_model(
        self, queries: TitleSet, rem: np.ndarray, cand_pos: np.ndarray,
        res: PredictionResult, single: bool,
    ) -> None:
        cfg = self.cfg
        R, K = cand_pos.shape
        if R == 0:
            res.stage_counts["model"] = 0
            return
        from doppelspeller.ops.features import remove_spaces_host

        engine = self._rerank_engine()
        flat_pos = cand_pos.reshape(-1).astype(np.int64)
        q_idx = np.repeat(np.arange(R), K)
        q_wo_u, q_wo_len_u = remove_spaces_host(
            queries.encoded[rem], queries.lengths[rem]
        )
        pred = engine.score(
            queries.encoded[rem], queries.lengths[rem].astype(np.int32),
            q_wo_u, q_wo_len_u,
            q_idx, flat_pos,
            self.truth.lengths,
        )

        hits = 0
        if single:
            best = int(np.argmax(pred))
            qi = rem[q_idx[best]]
            pos = flat_pos[best]
            res.match_title_id[qi] = int(self.index.title_ids[pos])
            res.prediction[qi] = float(pred[best])
            res.stage[qi] = STAGE_MODEL
            res.match_transformed[qi] = self.truth.transformed[pos]
            hits = 1
        else:
            max_val, best_row, unique = _groupby_max_unique(q_idx, pred, R)
            for r in np.flatnonzero(best_row >= 0):
                if not unique[r]:
                    continue
                row = best_row[r]
                if pred[row] <= cfg.prediction_probability_threshold:
                    continue
                qi = rem[r]
                pos = flat_pos[row]
                res.match_title_id[qi] = int(self.index.title_ids[pos])
                res.prediction[qi] = float(pred[row])
                res.stage[qi] = STAGE_MODEL
                res.match_transformed[qi] = self.truth.transformed[pos]
                hits += 1
        res.stage_counts["model"] = hits
        LOGGER.info("Matched %d titles (model stage)", hits)

    # ------------------------------------------------- device-cascade stages
    #
    # Fixed-shape orchestration: every heavy device program (retrieval
    # scoring, fuzzy decide, rerank decide) sees only shapes determined by
    # static config buckets — never by the query count.  The per-query-count
    # work is confined to trivial data-movement programs (_jit_helpers) and
    # host numpy.  Results come back as one small packed fetch per dispatch
    # group/slab, pipelined behind compute.

    def _probe_tables(self):
        """Device-resident per-truth-title (length, max word length) tables
        for the fused retrieval probe."""
        if getattr(self, "_probe_d", None) is None:
            import jax
            import jax.numpy as jnp

            _, wlen, _ = self.truth_words
            wlm = wlen.max(axis=1).astype(np.int32)
            tl = self.truth.lengths.astype(np.int32)
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                rep = NamedSharding(self.mesh, P())
                self._probe_d = (jax.device_put(tl, rep), jax.device_put(wlm, rep))
            else:
                self._probe_d = (jnp.asarray(tl), jnp.asarray(wlm))
        return self._probe_d

    def _put_rep(self, x):
        import jax
        import jax.numpy as jnp

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            return jax.device_put(x, NamedSharding(self.mesh, P()))
        return jnp.asarray(x)

    def _cascade_device(self, queries: TitleSet, rem: np.ndarray,
                        res: PredictionResult) -> None:
        """Stages 2+3 on device against device-resident candidates.

        Dispatch plan (all async; two fetch barriers total):
          1. retrieval groups → (G, QB, k) pos per group
          2. fuzzy decide per group (stage-3 bucket probe fused here)
          3. fetch packed probe+fuzzy results (one per group)
          4. rerank decide on still-unmatched rows in fixed-size slabs
          5. fetch packed model results (one per slab)
        """
        import jax

        cfg = self.cfg
        k = cfg.top_n_predicting
        reshape_cand, pack_fuzzy, pack_model, concat_rows, gather_rows = _helpers()
        engine_f = self._fuzzy_engine()

        # sort rows (fuzzy length bucket major, transformed title minor):
        # title order shrinks per-block trigram unions (less retrieval work),
        # bucket order makes the per-group fuzzy tile tight
        buckets = [b for b in cfg.length_buckets if b < cfg.max_characters]
        buckets.append(cfg.max_characters)
        buckets_arr = np.asarray(buckets)
        q_len_all = queries.lengths.astype(np.int64)
        # a fuzzy-considered candidate satisfies the length-delta prefilter
        # (tot−Δ)/tot·100 ≥ thr  ⇒  |t| ≤ ⌈|q|·(200−thr)/thr⌉ (predict.py:150;
        # at thr=94 this is the familiar |q|·106/94), and token-sorting
        # preserves lengths — so the fuzzy DP tile only needs
        # max(|q|, ⌈|q|·(200−thr)/thr⌉) regardless of the candidates
        thr_i = int(cfg.levenshtein_ratio_threshold)
        need_all = np.minimum(
            (q_len_all * (200 - thr_i) + thr_i - 1) // thr_i, cfg.max_characters
        ).astype(np.int64)
        titles = np.array(queries.transformed, dtype=object)
        fzb = np.searchsorted(buckets_arr, need_all[rem])
        rem = rem[np.lexsort((titles[rem], fzb))]

        t0 = _time.time()
        # the stage-3 bucket probe rides the FUZZY decide, which gathers
        # every candidate's length anyway
        pending, _plans = self.scorer.topk_device(queries, k=k, rows=rem)

        # fuzzy host prep AFTER the retrieval dispatch so the single
        # host thread works while the device scores (~1 s for 100k titles
        # on first use; cached on the TitleSet for repeat predicts)
        ts_enc_all, ts_len_all = queries.encoded_token_sorted
        ts_enc_rem = ts_enc_all[rem][:, : cfg.max_characters]
        ts_len_rem = np.minimum(ts_len_all[rem], cfg.max_characters).astype(
            np.int32
        )
        pos_of_rem = {int(r): j for j, r in enumerate(rem)}

        # slot bookkeeping: slot = group offset + block slot · QB + row index
        slot_rows = []          # per group: int64[G·QB] rem-row ids (−1 pad)
        for chunk, vals, pos in pending:
            G, QB, _ = pos.shape
            rows_g = np.full(G * QB, -1, dtype=np.int64)
            for s, plan in enumerate(chunk):
                rows_g[s * QB : s * QB + plan.n_valid] = plan.query_rows
            slot_rows.append(rows_g)

        # wait for the last group's scores so the stage log attributes
        # retrieval time (device execution is in order).  Skipped for tiny
        # batches, where the serving path would only add a synchronisation
        if len(rem) > 256:
            jax.block_until_ready(pending[-1][1])
        t_retr = _time.time()
        res.stage_seconds["retrieval"] = t_retr - t0

        fuzzy_pend = []
        for (chunk, vals, pos), rows_g in zip(pending, slot_rows):
            n = len(rows_g)
            valid = rows_g >= 0
            tl_g = int(need_all[rows_g[valid]].max(initial=1))
            cap = cfg.fuzzy_tile_cap
            if cap:
                # capped tile: long rows overflow to the exact host redo
                tl_g = min(tl_g, max(
                    [b for b in buckets if b <= cap] or [buckets[0]]
                ))
            TL = int(buckets_arr[np.searchsorted(buckets_arr, tl_g)])
            q_enc_g = np.zeros((n, TL), np.uint8)
            q_len_g = np.zeros(n, np.int32)
            ts_enc_g = np.zeros((n, TL), np.uint8)
            ts_len_g = np.zeros(n, np.int32)
            vi = np.flatnonzero(valid)
            src = rows_g[vi]
            ri = np.fromiter((pos_of_rem[int(r)] for r in src), np.int64,
                             count=len(src))
            q_enc_g[vi] = queries.encoded[src][:, :TL]
            q_len_g[vi] = queries.lengths[src].astype(np.int32)
            ts_enc_g[vi] = ts_enc_rem[ri][:, :TL]
            ts_len_g[vi] = ts_len_rem[ri]
            cand_g = reshape_cand(pos)
            out = engine_f.decide_device(
                q_enc_g, q_len_g, ts_enc_g, ts_len_g,
                cand_g, np.arange(n, dtype=np.int64), TL,
            )
            fuzzy_pend.append((rows_g, cand_g, pack_fuzzy(*out, n=n)))

        # ---- fetch barrier 1: probe + fuzzy results -----------------------
        # ONE batched fetch for all groups: device_get starts every
        # device→host copy asynchronously before blocking, so the groups'
        # transfers overlap instead of paying one synchronisation each
        hits = 0
        over_slots = []          # (group_idx, slot) pairs for host redo
        tl_probe = {}
        wl_probe = {}
        fetched1 = jax.device_get([p for _, _, p in fuzzy_pend])
        for gi, (rows_g, cand_g, _packed) in enumerate(fuzzy_pend):
            arr = fetched1[gi]                           # (6, n)
            tl_probe[gi] = arr[0]
            wl_probe[gi] = arr[1]
            matched, best_pos, _ratio, over = arr[2] > 0, arr[3], arr[4], arr[5] > 0
            valid = rows_g >= 0
            ov = over & valid
            if ov.any():
                over_slots.append((gi, np.flatnonzero(ov)))
                matched = matched & ~ov
            for j in np.flatnonzero(matched & valid):
                qi = rows_g[j]
                pos = int(best_pos[j])
                res.match_title_id[qi] = int(self.index.title_ids[pos])
                res.prediction[qi] = 1.0
                res.stage[qi] = STAGE_FUZZY
                res.match_transformed[qi] = self.truth.transformed[pos]
                hits += 1
        res.stage_counts["fuzzy"] = hits
        if over_slots:
            n_over = sum(len(s) for _, s in over_slots)
            LOGGER.warning("fuzzy device overflow on %d rows; host redo", n_over)
            for gi, slots in over_slots:
                rows_g, cand_g, _ = fuzzy_pend[gi]
                cand_sub = np.asarray(gather_rows(cand_g, self._put_rep(slots)))
                before = res.stage_counts["fuzzy"]
                self._stage_fuzzy(queries, rows_g[slots], cand_sub, res)
                res.stage_counts["fuzzy"] = before + res.stage_counts["fuzzy"]
        LOGGER.info("Matched %d titles so far (fuzzy)", res.stage_counts["fuzzy"])
        t1 = _time.time()
        res.stage_seconds["fuzzy"] = t1 - t_retr

        # ---- stage 3 (model) on still-unmatched rows, fixed-size slabs ----
        slab = cfg.model_slab
        todo_parts = []          # (global_slot, rem_row, tl_need, wl_need)
        for gi, rows_g in enumerate(slot_rows):
            base = gi * len(rows_g)
            valid = rows_g >= 0
            unm = valid & (res.stage[np.maximum(rows_g, 0)] == STAGE_NONE)
            js = np.flatnonzero(unm)
            if len(js):
                todo_parts.append(np.stack([
                    base + js, rows_g[js],
                    tl_probe[gi][js].astype(np.int64),
                    wl_probe[gi][js].astype(np.int64),
                ], axis=1))
        if not todo_parts:
            res.stage_counts["model"] = 0
            return
        todo = np.concatenate(todo_parts, axis=0)        # (M, 4)
        gq = todo[:, 1]
        tl_need = np.maximum(queries.lengths[gq].astype(np.int64), todo[:, 2])
        wl_need = np.maximum(todo[:, 3], 1)
        # the 64 entry matters: without it a 33-64 char candidate word would
        # clamp its row all the way to the (max, max) bucket, whose XLA
        # window-DP state is ~60x the (64, 64) cell's
        w_buckets = [b for b in (16, 32, 64) if b < cfg.max_characters]
        w_buckets.append(cfg.max_characters)
        w_arr = np.asarray(w_buckets)
        tbi = np.searchsorted(buckets_arr, np.minimum(tl_need, cfg.max_characters))
        wbi = np.searchsorted(w_arr, np.minimum(wl_need, cfg.max_characters))
        # a row whose word bucket exceeds its title bucket (e.g. a spaceless
        # 40-char candidate word against a short query) must be clamped UP to
        # the first title bucket that holds the word bucket — the dispatch
        # loop below only visits (TL, WL) cells with WL <= TL
        ti_min_for_w = np.searchsorted(buckets_arr, w_arr)
        tbi = np.maximum(tbi, ti_min_for_w[wbi])

        from doppelspeller.ops.features import remove_spaces_host

        t_prep0 = _time.time()
        engine_m = self._rerank_engine()
        t_prep1 = _time.time()
        cand_all = concat_rows(*[reshape_cand(p[2]) for p in pending])
        t_prep2 = _time.time()
        q_enc_m = queries.encoded[gq]
        q_len_m = queries.lengths[gq].astype(np.int32)
        wo_enc, wo_len = queries.encoded_wo
        q_wo_m, q_wo_len_m = wo_enc[gq], wo_len[gq]
        t_prep3 = _time.time()

        from collections import Counter as _Counter

        LOGGER.info(
            "model: %d rows, buckets %s | prep: engine %.2fs, cand concat "
            "%.2fs, q-slices %.2fs (todo assembly %.2fs)", len(todo),
            dict(_Counter(
                (int(buckets_arr[min(t, len(buckets_arr) - 1)]),
                 int(w_arr[min(w, len(w_arr) - 1)]))
                for t, w in zip(tbi, wbi)
            )),
            t_prep1 - t_prep0, t_prep2 - t_prep1, t_prep3 - t_prep2,
            t_prep0 - t1,
        )
        small = max(slab // 8, 64)

        def dispatch_wave(rows_t: np.ndarray, narrow: int, col_lo: int = 0):
            """Dispatch decide slabs for ``rows_t`` (indices into todo).
            Returns [(sl, m, packed_device)] with sl indexing todo."""
            pend = []
            for ti, TL in enumerate(buckets):
                for wi, WL in enumerate(w_buckets):
                    if WL > TL:
                        continue
                    sub = rows_t[(tbi[rows_t] == ti) & (wbi[rows_t] == wi)]
                    # full-size slabs, then the remainder in small slabs —
                    # the padding of a 2048-row slab would dominate tiny
                    # runs (two fixed shapes per bucket, not one per count)
                    slabs = []
                    s = 0
                    while len(sub) - s >= slab:
                        slabs.append((s, slab))
                        s += slab
                    while s < len(sub):
                        slabs.append((s, small))
                        s += small
                    for s, width in slabs:
                        t_sl = _time.time()
                        sl = sub[s : s + width]
                        m = len(sl)
                        idx = np.zeros(width, np.int32)
                        idx[:m] = todo[sl, 0]
                        qe = np.zeros((width, TL), np.uint8)
                        ql = np.zeros(width, np.int32)
                        qw = np.zeros((width, TL), np.uint8)
                        qwl = np.zeros(width, np.int32)
                        qe[:m] = q_enc_m[sl][:, :TL]
                        ql[:m] = q_len_m[sl]
                        qw[:m] = q_wo_m[sl][:, :TL]
                        qwl[:m] = q_wo_len_m[sl]
                        cand_slab = gather_rows(cand_all, self._put_rep(idx))
                        out = engine_m.decide_device(
                            qe, ql, qw, qwl, cand_slab,
                            np.arange(width, dtype=np.int64), TL, WL,
                            narrow=narrow, col_lo=col_lo,
                        )
                        pend.append((sl, m, pack_model(*out, n=width)))
                        dt_sl = _time.time() - t_sl
                        if dt_sl > 0.5:
                            # dispatch is async — a slow call is a trace +
                            # (remote) compile; log the cache key parts
                            LOGGER.info(
                                "slow slab dispatch %.2fs: TL=%d WL=%d "
                                "width=%d narrow=%d col_lo=%d",
                                dt_sl, TL, WL, width, narrow, col_lo,
                            )
            n_disp = sum(m for _, m, _ in pend)
            if n_disp != len(rows_t):
                raise AssertionError(
                    f"stage-3 bucket dispatch covered {n_disp}/{len(rows_t)} rows"
                )
            return pend

        def fetch_wave(pend, cnt, pos, mx):
            """Fetch a wave's packed stats into per-todo-row arrays with ONE
            batched device_get (async copies overlap; a wave has ~25-50
            slabs, and a serial per-slab fetch synchronises once each)."""
            arrs = jax.device_get([p for _, _, p in pend])
            for arr, (sl, m, _p) in zip(arrs, pend):     # arr: (3, slab) f32
                cnt[sl] = arr[0][:m].astype(np.int64)
                pos[sl] = arr[1][:m].astype(np.int64)
                mx[sl] = arr[2][:m]

        def apply_decisions(rows_t, cnt, pos, mx) -> int:
            thr = cfg.prediction_probability_threshold
            hits = 0
            for j in rows_t[(cnt[rows_t] == 1) & (mx[rows_t] > thr)]:
                qi = todo[j, 1]
                p = int(pos[j])
                res.match_title_id[qi] = int(self.index.title_ids[p])
                res.prediction[qi] = float(mx[j])
                res.stage[qi] = STAGE_MODEL
                res.match_transformed[qi] = self.truth.transformed[p]
                hits += 1
            return hits

        # Adaptive candidate depth: wave A scores the top model_depth_initial
        # jaccard candidates of every row; rows whose wave-A max probability
        # lands in the ambiguous band [widen, trust) get their REMAINING
        # columns scored in wave B, and the two waves merge exactly
        # (per-pair predictions are batching-independent, so
        # max/argmax/tie-count compose) — widened rows cost exactly the
        # same pairs as a full-depth pass, never more.  Rows outside the
        # band skip the tail: below the widen floor a model match needs
        # p > threshold >> widen, and at/above the trust ceiling the head
        # argmax is accepted as global (on jaccard-sorted candidates the
        # argmax sits in the head essentially always; exact-equality parity
        # tests + the bench oracle anchor gate both).
        k1 = cfg.model_depth_initial
        adaptive = 0 < k1 < k
        nt_rows = len(todo)
        all_rows = np.arange(nt_rows, dtype=np.int64)
        cnt_a = np.zeros(nt_rows, np.int64)
        pos_a = np.zeros(nt_rows, np.int64)
        mx_a = np.full(nt_rows, -np.inf, np.float32)
        t_wa0 = _time.time()
        wave_a = dispatch_wave(all_rows, k1 if adaptive else 0)
        t_wa1 = _time.time()

        # ---- fetch barrier 2: model results -------------------------------
        fetch_wave(wave_a, cnt_a, pos_a, mx_a)
        LOGGER.info("model wave A: %d slabs dispatched %.2fs, fetched %.2fs",
                    len(wave_a), t_wa1 - t_wa0, _time.time() - t_wa1)
        if not adaptive:
            hits = apply_decisions(all_rows, cnt_a, pos_a, mx_a)
        else:
            widen_thr = cfg.model_widen_threshold
            trust_thr = cfg.model_trust_threshold
            band = (mx_a >= widen_thr) & (mx_a < trust_thr)
            # a trusted row whose head max is TIED (cnt > 1) must widen
            # anyway: accepting the head stats would tie-drop the row, but
            # the tail could hold a strictly higher unique max (observed
            # with weak models whose probabilities cluster) — trusting is
            # only safe for a unique head argmax
            band |= (mx_a >= trust_thr) & (cnt_a > 1)
            widen = all_rows[band]
            if LOGGER.isEnabledFor(logging.INFO) and nt_rows:
                qs = np.percentile(mx_a, [10, 25, 50, 75, 90])
                LOGGER.info(
                    "model wave A max-prob p10/p25/p50/p75/p90: "
                    "%.3f/%.3f/%.3f/%.3f/%.3f | %d rows below %.2f, "
                    "%d trusted at >= %.3f",
                    *qs, int((mx_a < widen_thr).sum()), widen_thr,
                    int((mx_a >= trust_thr).sum()), trust_thr,
                )
            # below the widen floor: can never clear the match threshold;
            # at/above the trust ceiling: head argmax accepted as global
            hits = apply_decisions(all_rows[~band], cnt_a, pos_a, mx_a)
            if len(widen):
                LOGGER.info(
                    "model wave B: %d/%d rows widened by %d tail candidates",
                    len(widen), nt_rows, k - k1,
                )
                cnt_b = np.zeros(nt_rows, np.int64)
                pos_b = np.zeros(nt_rows, np.int64)
                mx_b = np.full(nt_rows, -np.inf, np.float32)
                t_wb0 = _time.time()
                wave_b = dispatch_wave(widen, 0, col_lo=k1)
                t_wb1 = _time.time()
                # ---- fetch barrier 3: tail stats, exact merge -------------
                fetch_wave(wave_b, cnt_b, pos_b, mx_b)
                LOGGER.info(
                    "model wave B: %d slabs dispatched %.2fs, fetched %.2fs",
                    len(wave_b), t_wb1 - t_wb0, _time.time() - t_wb1,
                )
                a_wins = mx_a[widen] >= mx_b[widen]   # ties keep A (first col)
                tie = mx_a[widen] == mx_b[widen]
                LOGGER.info(
                    "model wave B: tail won %d/%d widened rows, %d head=tail "
                    "ties", int((~a_wins).sum()), len(widen), int(tie.sum()),
                )
                dump = os.environ.get("DOPPEL_DUMP_WAVES")
                if dump:
                    # offline trust-threshold calibration: per widened row,
                    # both waves' (max, argpos, tie-count) — lets any
                    # candidate model_trust_threshold be evaluated from one
                    # full-depth run (see config.model_trust_threshold)
                    np.savez(dump, widen=widen, mx_a=mx_a[widen],
                             mx_b=mx_b[widen], pos_a=pos_a[widen],
                             pos_b=pos_b[widen], cnt_a=cnt_a[widen],
                             cnt_b=cnt_b[widen])
                mx_a[widen] = np.where(a_wins, mx_a[widen], mx_b[widen])
                pos_a[widen] = np.where(a_wins, pos_a[widen], pos_b[widen])
                cnt_a[widen] = np.where(
                    tie, cnt_a[widen] + cnt_b[widen],
                    np.where(a_wins, cnt_a[widen], cnt_b[widen]),
                )
                hits += apply_decisions(widen, cnt_a, pos_a, mx_a)
        res.stage_counts["model"] = hits
        LOGGER.info("Matched %d titles (model stage)", hits)
        res.stage_seconds["model"] = _time.time() - t1

    # -------------------------------------------------------------- entry

    def predict(self, queries: TitleSet, single: bool = False) -> PredictionResult:
        cfg = self.cfg
        if single and len(queries) != 1:
            raise ValueError("single prediction requires exactly one query")
        if queries.encoded.shape[1] != cfg.max_characters:
            # the cached derived encodings (encoded_wo / encoded_token_sorted)
            # are built at the TitleSet's construction width; mixing widths
            # would silently truncate fuzzy-stage encodings
            raise ValueError(
                f"queries were encoded at width {queries.encoded.shape[1]} "
                f"but this Matcher's config.max_characters is "
                f"{cfg.max_characters}; build the TitleSet with the same "
                "config as the Matcher"
            )
        n = len(queries)
        res = PredictionResult(
            test_index=queries.ids.copy(),
            match_title_id=np.full(n, cfg.train_not_found_value, dtype=np.int64),
            prediction=np.zeros(n, dtype=np.float32),
            stage=np.zeros(n, dtype=np.uint8),
            transformed=list(queries.transformed),
            match_transformed=[None] * n,
        )

        t0 = _time.time()
        self._stage_exact(queries, res)
        t1 = _time.time()
        res.stage_seconds = {"exact": t1 - t0, "retrieval": 0.0,
                             "fuzzy": 0.0, "model": 0.0}

        rem = np.flatnonzero(res.stage == STAGE_NONE)
        impl = cfg.cascade_impl
        use_device = not single and len(rem) > 0 and (
            impl == "device" or (impl == "auto" and len(rem) >= 2048)
        )
        if len(rem) and not use_device and self._use_fused(rem, impl):
            # one-dispatch small-batch cascade (ops/serve_fused.py): the
            # whole retrieval→fuzzy→model decision runs as ONE device
            # program with ONE fetch — a single-title request synchronises
            # with the device once instead of three times
            self._fused_engine().match(queries, rem, res, single)
        elif use_device:
            self._cascade_device(queries, rem, res)
        elif len(rem):
            _, cand_pos = self.scorer.topk(queries, k=cfg.top_n_predicting, rows=rem)
            t2 = _time.time()
            self._stage_fuzzy(queries, rem, cand_pos, res)
            t3 = _time.time()
            still = res.stage[rem] == STAGE_NONE
            rem2 = rem[still]
            if len(rem2) and (not single or res.stage[0] == STAGE_NONE):
                self._stage_model(queries, rem2, cand_pos[still], res, single)
            res.stage_seconds.update(
                retrieval=t2 - t1, fuzzy=t3 - t2, model=_time.time() - t3
            )
        ss = res.stage_seconds
        LOGGER.info(
            "stage timing: exact %.2fs | retrieval %.2fs | fuzzy %.2fs | model %.2fs",
            ss["exact"], ss["retrieval"], ss["fuzzy"], ss["model"],
        )

        LOGGER.info(
            "Matched %d/%d titles (exact %d, fuzzy %d, model %d)",
            int((res.stage != STAGE_NONE).sum()), n,
            res.stage_counts.get("exact", 0),
            res.stage_counts.get("fuzzy", 0),
            res.stage_counts.get("model", 0),
        )
        return res


def accuracy_report(actuals_path: str, output_path: str, delimiter: str = "|") -> dict:
    """Scoring harness (reference cli.py:86-132)."""
    from doppelspeller.utils.io import read_csv_columns

    actual = read_csv_columns(actuals_path, delimiter, ("test_index", "company_id"))
    predictions = read_csv_columns(output_path, delimiter, ("test_index", "title_id"))
    actual_map = dict(zip(map(int, actual["test_index"]),
                          map(int, actual["company_id"])))
    pred_map = dict(zip(map(int, predictions["test_index"]),
                        map(int, predictions["title_id"])))

    cm_e = cm_ne = im_e = im_ne = 0
    for key, actual_value in actual_map.items():
        p = pred_map[key]
        if p == -1:
            if actual_value == p:
                cm_ne += 1
            else:
                im_ne += 1
        else:
            if actual_value == p:
                cm_e += 1
            else:
                im_e += 1
    report = {
        "correctly_matched": cm_e,
        "incorrectly_matched": im_e,
        "correctly_not_found": cm_ne,
        "incorrectly_not_found": im_ne,
        "custom_error": im_ne + im_e * 5,
    }
    LOGGER.info(
        "\n\n    Correctly matched titles            %(correctly_matched)d\n"
        "    Incorrectly matched titles          %(incorrectly_matched)d\n"
        "    Correctly marked as not-found       %(correctly_not_found)d\n"
        "    Incorrectly marked as not-found     %(incorrectly_not_found)d\n\n"
        "    Custom Error                        %(custom_error)d\n",
        report,
    )
    return report
