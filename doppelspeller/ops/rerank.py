"""Fused stage-3 reranking: gather → 66-dim features → GBT inference,
all in one device program.

The naive pipeline (reference predict.py:185-254) materializes the feature
matrix on the host between feature construction and model.predict (~260 MB
per 500K pairs).  Here the truth-side tensors (encodings, word boundaries,
word counts) and the tree arrays live in device memory; per chunk only two
int32 index vectors go up and one float32 prediction vector comes down
(8 B/pair instead of ~550 B/pair).
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from doppelspeller.config import Config, get_config
from doppelspeller.models.gbt import GBTModel
from doppelspeller.ops.features import _features_kernel, pair_bytes

LOGGER = logging.getLogger(__name__)


def _score_gathered_pairs(
    qe, ql, qw, qwl,                  # (B, tl) / (B,) pair-gathered query side
    te, tl_len, chars, wlen, nwords, counts,   # pair-gathered truth side
    m_feat, m_thr, m_ml, m_val, m_leaf,
    n_truth, base_margin,
    *, tl: int, wl: int, depth: int,
):
    """66-dim features + forest margin → probability, for B gathered pairs.

    ``chars`` is the pre-gathered (B, W, wl) word-character tensor — sliced
    from the engine's resident (n_truth, W, 32) table by a row gather rather
    than a per-element window gather against te."""
    feats = _features_kernel(
        qe, ql, te[:, :tl], tl_len, chars, wlen, nwords, qw, qwl, counts, n_truth,
    )

    # GBT inference: level-synchronous across all trees at once
    from doppelspeller.models.gbt import predict_forest_margin

    margins = predict_forest_margin(
        feats, m_feat, m_thr, m_ml, m_val, m_leaf, depth, base_margin
    )
    return jax.nn.sigmoid(margins)


def _word_chars(t_wchars, t_start, t_wlen, t_enc, pair_t, wl: int):
    """(B, W, wl) word chars for the gathered pairs (zeroed past word_len).

    wl ≤ 32: slice of the resident pre-gathered (n_truth, W, 32) table (one
    row gather).  wl > 32 (words longer than the bit-parallel capacity;
    vanishingly rare): per-element window gather from the encodings."""
    if wl <= t_wchars.shape[2]:
        return t_wchars[pair_t][:, :, :wl]
    te = t_enc[pair_t]
    start = t_start[pair_t]
    wlen = t_wlen[pair_t]
    B, W = start.shape
    j = jnp.arange(wl, dtype=jnp.int32)
    idx = jnp.clip(start[:, :, None] + j[None, None, :], 0, te.shape[1] - 1)
    chars = jnp.take_along_axis(
        te[:, None, :], idx.reshape(B, W * wl)[:, None, :], axis=2
    ).reshape(B, W, wl)
    return chars * (j[None, None, :] < wlen[:, :, None]).astype(chars.dtype)


@partial(jax.jit, static_argnames=("tl", "wl", "depth"))
def _fused_rerank_kernel(
    # query-side device arrays (per predict call)
    q_enc, q_len, q_wo, q_wo_len,
    # truth-side device arrays (resident)
    t_enc, t_len, t_wchars, t_start, t_wlen, t_nwords, t_counts,
    # model arrays (resident)
    m_feat, m_thr, m_ml, m_val, m_leaf,
    # per-chunk pair indices: ONE (2, B) buffer = one host→device transfer
    pairs,
    n_truth,
    base_margin,
    *, tl: int, wl: int, depth: int,
):
    pair_q = pairs[0]
    pair_t = pairs[1]
    chars = _word_chars(t_wchars, t_start, t_wlen, t_enc, pair_t, wl)
    return _score_gathered_pairs(
        q_enc[pair_q][:, :tl], q_len[pair_q],
        q_wo[pair_q][:, :tl], jnp.maximum(q_wo_len[pair_q], 1),
        t_enc[pair_t], jnp.maximum(t_len[pair_t], 1),
        chars, t_wlen[pair_t],
        jnp.maximum(t_nwords[pair_t], 1), t_counts[pair_t].astype(jnp.float32),
        m_feat, m_thr, m_ml, m_val, m_leaf, n_truth, base_margin,
        tl=tl, wl=wl, depth=depth,
    )


@partial(jax.jit, static_argnames=("tl", "wl", "depth", "chunk",
                                   "threshold", "narrow", "col_lo"))
def _rerank_decide_kernel(
    q_enc, q_len, q_wo, q_wo_len,      # (R, TL) bucket-sliced query arrays
    t_enc, t_len, t_wchars, t_start, t_wlen, t_nwords, t_counts,   # resident
    m_feat, m_thr, m_ml, m_val, m_leaf,                  # resident
    cand,                              # (R_all, K) int32 device-resident top-k
    rows,                              # (R,) int32 rows of ``cand`` to process
    n_truth, base_margin,
    *, tl: int, wl: int, depth: int, chunk: int,
    threshold: float, narrow: int = 0, col_lo: int = 0,
):
    """Stage-3 decision for a bucket of query rows entirely on device.

    Per row: GBT probability for candidate columns
    [col_lo, col_lo + narrow) (the whole tail from col_lo when narrow=0);
    the final match rule — unique max and > threshold, predict.py:243-252 —
    is applied by the caller from the returned statistics, so partial-column
    waves of the adaptive-depth cascade can be merged EXACTLY (per-pair
    predictions are independent of batching, hence bitwise identical
    across waves).  Returns (n_at_max int32[R], best_pos int32[R] — truth
    position of the first argmax candidate, best_pred float32[R]).
    """
    K = narrow if narrow else cand.shape[1] - col_lo
    R = rows.shape[0]
    del threshold  # decision applied by the caller (kept in the signature
    #                so cache keys stay explicit about the config)

    def step(_, sl):
        qe, ql, qw, qwl, rws = sl                   # (C, ...) slice
        C = qe.shape[0]
        cd = cand[rws][:, col_lo : col_lo + K]      # (C, K)
        pair_t = cd.reshape(-1)
        rep = lambda x: jnp.repeat(x, K, axis=0)
        chars = _word_chars(t_wchars, t_start, t_wlen, t_enc, pair_t, wl)
        preds = _score_gathered_pairs(
            rep(qe)[:, :tl], jnp.repeat(ql, K),
            rep(qw)[:, :tl], jnp.maximum(jnp.repeat(qwl, K), 1),
            t_enc[pair_t], jnp.maximum(t_len[pair_t], 1),
            chars, t_wlen[pair_t],
            jnp.maximum(t_nwords[pair_t], 1),
            t_counts[pair_t].astype(jnp.float32),
            m_feat, m_thr, m_ml, m_val, m_leaf, n_truth, base_margin,
            tl=tl, wl=wl, depth=depth,
        ).reshape(C, K)
        mx = preds.max(axis=1)
        cnt = (preds == mx[:, None]).sum(axis=1).astype(jnp.int32)
        best_col = jnp.argmax(preds, axis=1).astype(jnp.int32)
        best_pos = jnp.take_along_axis(cd, best_col[:, None], axis=1)[:, 0]
        return None, (cnt, best_pos, mx)

    n_chunks = R // chunk
    xs = tuple(
        x.reshape((n_chunks, chunk) + x.shape[1:])
        for x in (q_enc, q_len, q_wo, q_wo_len, rows)
    )
    _, (cnt, best_pos, best_pred) = jax.lax.scan(step, None, xs)
    return cnt.reshape(-1), best_pos.reshape(-1), best_pred.reshape(-1)


class RerankEngine:
    """Device-resident stage-3 scorer over a fixed truth set + model."""

    def __init__(
        self,
        truth_enc: np.ndarray, truth_len: np.ndarray,
        truth_words: Tuple[np.ndarray, np.ndarray, np.ndarray],
        counts_matrix: np.ndarray,
        model: GBTModel,
        n_truth: int,
        config: Optional[Config] = None,
        mesh=None,
    ):
        self.cfg = config or get_config()
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            put = lambda x: jax.device_put(  # noqa: E731
                np.asarray(x), NamedSharding(mesh, P())
            )
        else:
            put = jnp.asarray
        self._put = put
        self.n_truth = put(np.float32(n_truth))
        self.t_enc = put(truth_enc)
        self.t_len = put(truth_len.astype(np.int32))
        start, wlen, nwords = truth_words
        self.t_start = put(start)
        self.t_wlen = put(wlen)
        self.t_nwords = put(nwords)
        self.t_counts = put(counts_matrix.astype(np.float32))
        # pre-gathered word chars (n_truth, W, 32): the rerank kernels fetch
        # a pair's word tensor with one row gather instead of a per-element
        # take_along_axis window gather
        from doppelspeller.ops.features import gather_word_chars

        self.t_wchars = put(gather_word_chars(truth_enc, start, wlen, 32))
        self._wlen_max = wlen.max(axis=1)  # host copy for bucketing
        nt = model.best_ntree_limit or model.num_trees
        # pad the forest to a 64-tree multiple with zero-value single-leaf
        # trees (root is_leaf, value 0 — margin contribution exactly 0):
        # every jitted rerank program is otherwise keyed on the exact
        # trained tree count, so re-training recompiles the whole stage-3
        # cascade
        T_pad = max(((nt + 63) // 64) * 64 - nt, 0)

        def _pad_tree(a, leaf_like: bool):
            a = a[:nt]
            if T_pad == 0:
                return a
            pad = np.zeros((T_pad,) + a.shape[1:], a.dtype)
            if leaf_like:
                pad[:, 0] = 1
            return np.concatenate([a, pad])

        self.m = tuple(
            put(_pad_tree(np.asarray(a), leaf_like=(i == 4)))
            for i, a in enumerate((model.feat, model.threshold,
                                   model.missing_left, model.value,
                                   model.is_leaf))
        )
        self.depth = model.depth
        self.base_margin = float(np.log(model.base_score / (1 - model.base_score)))

    def decide(
        self,
        q_enc: np.ndarray, q_len: np.ndarray,       # (R, L) bucket-sliced host
        q_wo: np.ndarray, q_wo_len: np.ndarray,
        cand_d,                                     # (R_all, K) device-resident
        rows: np.ndarray,                           # (R,) rows of cand_d
        tl: int, wl: int,
    ):
        """Device decisions for a bucket of rows (see _rerank_decide_kernel).
        Returns host (matched, best_pos, best_pred) trimmed to R."""
        R = len(rows)
        cnt, best_pos, best_pred = self.decide_device(
            q_enc, q_len, q_wo, q_wo_len, cand_d, rows, tl, wl
        )
        cnt = np.asarray(cnt)[:R]
        best_pred = np.asarray(best_pred)[:R]
        matched = (cnt == 1) & (
            best_pred > self.cfg.prediction_probability_threshold
        )
        return matched, np.asarray(best_pos)[:R], best_pred

    def decide_device(
        self,
        q_enc: np.ndarray, q_len: np.ndarray,
        q_wo: np.ndarray, q_wo_len: np.ndarray,
        cand_d, rows: np.ndarray, tl: int, wl: int,
        narrow: int = 0, col_lo: int = 0,
    ):
        """Like :meth:`decide` but returning raw per-row statistics
        (n_at_max, best_pos, best_pred) as (padded) device vectors — the
        caller merges waves, applies the match rule, and packs/fetches.  ``narrow``/``col_lo`` select the
        candidate-column window [col_lo, col_lo+narrow) to score."""
        cfg = self.cfg
        R = len(rows)
        k = narrow if narrow else int(cand_d.shape[1]) - col_lo
        # rows per scan step: bounded by the kernel's device temporaries
        # (pair_bytes × k pairs within ~256 MB), by the configured cap, and by
        # the row count itself so small batches do not pad to a full step
        cap = cfg.rerank_chunk_cap
        chunk = int(np.clip((1 << 28) // max(pair_bytes(tl, wl) * k, 1), 1, cap))
        chunk = min(chunk, 1 << max(R - 1, 0).bit_length())
        n_dev = self.mesh.devices.size if self.mesh is not None else 1
        step = chunk * n_dev
        rp = ((R + step - 1) // step) * step

        kern = partial(
            _rerank_decide_kernel,
            tl=tl, wl=wl, depth=self.depth,
            chunk=chunk, threshold=cfg.prediction_probability_threshold,
            narrow=narrow, col_lo=col_lo,
        )
        if self.mesh is None:
            fn = kern
            put = jnp.asarray
        else:
            # data-parallel over the row axis (truth side + model replicated)
            from jax.sharding import NamedSharding, PartitionSpec as P

            from jax import shard_map

            axis = self.mesh.axis_names[0]
            fn = jax.jit(shard_map(
                kern,
                mesh=self.mesh,
                in_specs=(P(axis), P(axis), P(axis), P(axis),
                          P(), P(), P(), P(), P(), P(), P(),
                          P(), P(), P(), P(), P(),
                          P(), P(axis), P(), P()),
                out_specs=(P(axis), P(axis), P(axis)),
                check_vma=False,
            ))
            row_sh = NamedSharding(self.mesh, P(axis))
            put = lambda x: jax.device_put(x, row_sh)  # noqa: E731

        def pad(x, width=None):
            out_shape = (rp,) + (() if width is None else (width,))
            out = np.zeros(out_shape, x.dtype)
            out[:R] = x if width is None else x[:, :width]
            return put(out)

        return fn(
            pad(q_enc, tl), pad(q_len.astype(np.int32)),
            pad(q_wo, tl), pad(q_wo_len.astype(np.int32)),
            self.t_enc, self.t_len, self.t_wchars, self.t_start, self.t_wlen,
            self.t_nwords, self.t_counts,
            *self.m,
            cand_d, pad(rows.astype(np.int32)),
            self.n_truth, self._put(np.float32(self.base_margin)),
        )

    def score(
        self,
        q_enc: np.ndarray, q_len: np.ndarray,
        q_wo: np.ndarray, q_wo_len: np.ndarray,
        pair_q: np.ndarray, pair_t: np.ndarray,
        t_len_host: np.ndarray,
    ) -> np.ndarray:
        """Predictions for pairs (pair_q → query row, pair_t → truth row)."""
        cfg = self.cfg
        q_enc_d = jnp.asarray(q_enc)
        q_len_d = jnp.asarray(q_len.astype(np.int32))
        q_wo_d = jnp.asarray(q_wo)
        q_wo_len_d = jnp.asarray(q_wo_len.astype(np.int32))

        n = len(pair_q)
        out = np.zeros(n, dtype=np.float32)
        pair_len = np.maximum(q_len[pair_q], t_len_host[pair_t])
        max_word = np.maximum(self._wlen_max[pair_t], 1)
        buckets = [b for b in cfg.length_buckets if b < q_enc.shape[1]] + [q_enc.shape[1]]
        w_buckets = [8, 16, 32, 64, q_enc.shape[1]]
        tb = np.searchsorted(np.asarray(buckets), pair_len)
        wb = np.searchsorted(np.asarray(w_buckets), max_word)

        pending = []
        for ti, TL in enumerate(buckets):
            for wi, WL in enumerate(w_buckets):
                if WL > TL:
                    continue
                sel = np.flatnonzero((tb == ti) & (wb == wi))
                if len(sel) == 0:
                    continue
                chunk = int(np.clip((1 << 22) // (TL * WL), 64, cfg.pair_block))
                for s in range(0, len(sel), chunk):
                    idx = sel[s : s + chunk]
                    m = len(idx)
                    prs = np.zeros((2, chunk), np.int32)
                    prs[0, :m] = pair_q[idx]
                    prs[1, :m] = pair_t[idx]
                    preds = _fused_rerank_kernel(
                        q_enc_d, q_len_d, q_wo_d, q_wo_len_d,
                        self.t_enc, self.t_len, self.t_wchars, self.t_start, self.t_wlen,
                        self.t_nwords, self.t_counts,
                        *self.m,
                        jnp.asarray(prs),
                        self.n_truth, self.base_margin,
                        tl=TL, wl=WL, depth=self.depth,
                    )
                    pending.append((idx, m, preds))
        for idx, m, preds in pending:
            out[idx] = np.asarray(preds)[:m]
        return out
