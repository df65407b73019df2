"""Fused stage-2 fuzzy matching: device-resident gathers + dual ratio kernel.

Reference semantics (predict.py:140-156): pairs passing the length-delta
prefilter get the rounded Levenshtein ratio; if that is ≤ the threshold the
token-sort ratio is used instead.  Both ratios are computed in ONE device
program per chunk (the LCS kernel is cheap; a second host round-trip is
not), and only pair-index vectors cross the host↔device
boundary.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from doppelspeller.config import Config, get_config
from doppelspeller.ops.levenshtein import lcs_kernel

LOGGER = logging.getLogger(__name__)


@partial(jax.jit, static_argnames=("tl", "threshold"))
def _fuzzy_kernel(
    q_enc, q_len, q_ts, q_ts_len,      # query-side device arrays (per call)
    t_enc, t_len, t_ts, t_ts_len,      # truth-side device arrays (resident)
    pairs,                             # (2, B) int32: one transfer per chunk
    *, tl: int, threshold: int,
):
    pair_q = pairs[0]
    pair_t = pairs[1]
    """Rounded final ratio per pair: plain ratio if > threshold else
    token-sort ratio (banker's rounding, reference common.py:161-167)."""

    def rounded_ratio(a, la, b, lb):
        lcs = lcs_kernel(a, la, b, lb)
        total = jnp.maximum(la + lb, 1).astype(jnp.float32)
        r = 200.0 * lcs.astype(jnp.float32) / total
        return jnp.round(r).astype(jnp.int32)  # round-half-even = python round

    a = q_enc[pair_q][:, :tl]
    la = q_len[pair_q]
    b = t_enc[pair_t][:, :tl]
    lb = t_len[pair_t]
    r1 = rounded_ratio(a, la, b, lb)

    a2 = q_ts[pair_q][:, :tl]
    la2 = q_ts_len[pair_q]
    b2 = t_ts[pair_t][:, :tl]
    lb2 = t_ts_len[pair_t]
    r2 = rounded_ratio(a2, la2, b2, lb2)

    return jnp.where(r1 > threshold, r1, r2)


@partial(jax.jit, static_argnames=("tl", "threshold", "chunk"))
def _fuzzy_decide_kernel(
    q_enc, q_len, q_ts, q_ts_len,      # (R, TL) bucket-sliced query arrays
    t_enc, t_len, t_ts, t_ts_len,      # truth-side device arrays (resident)
    t_wlen_max,                        # int32[n_truth] max word length/title
    cand,                              # (R_all, K) int32 device-resident top-k
    rows,                              # (R,) int32 rows of ``cand`` to process
    *, tl: int, threshold: int, chunk: int,
):
    """Stage-2 decision for a bucket of query rows entirely on device.

    Per row: length-delta prefilter (predict.py:150) → plain ratio, token-sort
    fallback (predict.py:147-156) → keep ratio>threshold, per-row max, tied
    distinct maxima drop the row to stage 3 (predict.py:172-181).
    Returns (matched bool[R], best_pos int32[R] — truth position of the best
    candidate, best_ratio int32[R], overflow bool[R], probe_tl int32[R],
    probe_wl int32[R]).  The probe — max candidate title/word length per
    row, consumed by the stage-3 bucket decision — rides here because this
    kernel already gathers every candidate's length, where in the
    retrieval program it would be a separate gather.
    Rows are processed in ``chunk``-sized slices under lax.scan — ONE
    device program regardless of R.
    """
    K = cand.shape[1]
    R = rows.shape[0]

    def step(_, sl):
        qe, ql, qts, qtsl, rws = sl                 # (C, ...) slice
        C = qe.shape[0]
        cd = cand[rws]                              # (C, K)
        pos = cd.reshape(-1)                        # (C*K,)
        te = t_enc[pos][:, :tl]
        tle = t_len[pos]
        tts = t_ts[pos][:, :tl]
        ttsl = t_ts_len[pos]
        probe_tl = tle.reshape(C, K).max(axis=1)
        probe_wl = t_wlen_max[pos].reshape(C, K).max(axis=1)

        ql_r = jnp.repeat(ql, K)
        tot = ql_r + tle
        delta = jnp.abs(ql_r - tle)
        del_ratio = (tot - delta).astype(jnp.float32) / jnp.maximum(tot, 1) * 100.0
        consider = del_ratio >= threshold           # (C*K,)

        def rounded_ratio(a, la, b, lb):
            lcs = lcs_kernel(a, la, b, lb)
            total = jnp.maximum(la + lb, 1).astype(jnp.float32)
            return jnp.round(200.0 * lcs.astype(jnp.float32) / total).astype(jnp.int32)

        a = jnp.repeat(qe, K, axis=0)[:, :tl]
        r1 = rounded_ratio(a, ql_r, te, tle)
        a2 = jnp.repeat(qts, K, axis=0)[:, :tl]
        r2 = rounded_ratio(a2, jnp.repeat(qtsl, K), tts, ttsl)
        ratio = jnp.where(r1 > threshold, r1, r2)
        ratio = jnp.where(consider, ratio, 0).reshape(C, K)

        keep = ratio > threshold
        masked = jnp.where(keep, ratio, -1)
        mx = masked.max(axis=1)                     # (C,)
        cnt = (masked == mx[:, None]).sum(axis=1)
        matched = (mx > -1) & (cnt == 1)
        best_col = jnp.argmax(masked, axis=1).astype(jnp.int32)
        best_pos = jnp.take_along_axis(cd, best_col[:, None], axis=1)[:, 0]
        # any considered pair with a string longer than the compiled tile
        # (query or candidate, plain or token-sorted) was scored truncated —
        # flag the row so the host re-decides it exactly.  Unreachable when
        # the tile is derived from the threshold; real under fuzzy_tile_cap.
        too_long = jnp.maximum(jnp.maximum(tle, ttsl), ql_r) > tl
        over = (consider & too_long).reshape(C, K).any(axis=1)
        return None, (matched, best_pos, mx, over, probe_tl, probe_wl)

    n_chunks = R // chunk
    xs = tuple(
        x.reshape((n_chunks, chunk) + x.shape[1:])
        for x in (q_enc, q_len, q_ts, q_ts_len, rows)
    )
    _, outs = jax.lax.scan(step, None, xs)
    return tuple(o.reshape(-1) for o in outs)


class FuzzyEngine:
    """Device-resident stage-2 scorer over a fixed truth set."""

    def __init__(
        self,
        truth_enc: np.ndarray, truth_len: np.ndarray,
        ts_truth_enc: np.ndarray, ts_truth_len: np.ndarray,
        config: Optional[Config] = None,
        mesh=None,
        truth_wlen_max: Optional[np.ndarray] = None,
    ):
        self.cfg = config or get_config()
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            put = lambda x: jax.device_put(x, NamedSharding(mesh, P()))  # noqa: E731
        else:
            put = jnp.asarray
        self._put = put
        self.t_enc = put(truth_enc)
        self.t_len = put(truth_len.astype(np.int32))
        self.t_ts = put(ts_truth_enc)
        self.t_ts_len = put(ts_truth_len.astype(np.int32))
        # max word length per title, for the stage-3 bucket probe that the
        # decide kernel piggy-backs on its candidate gathers
        if truth_wlen_max is None:
            truth_wlen_max = np.zeros(len(truth_len), np.int32)
        self.t_wlen_max = put(truth_wlen_max.astype(np.int32))

    def decide(
        self,
        q_enc: np.ndarray, q_len: np.ndarray,       # (R, L) bucket-sliced host
        ts_q_enc: np.ndarray, ts_q_len: np.ndarray,
        cand_d,                                     # (R_all, K) device-resident
        rows: np.ndarray,                           # (R,) rows of cand_d
        tl: int,
    ):
        """Device decisions for a bucket of rows (see _fuzzy_decide_kernel).
        Returns host (matched, best_pos, best_ratio, overflow) trimmed to R."""
        R = len(rows)
        matched, best_pos, best_ratio, over, _ptl, _pwl = self.decide_device(
            q_enc, q_len, ts_q_enc, ts_q_len, cand_d, rows, tl
        )
        return (np.asarray(matched)[:R], np.asarray(best_pos)[:R],
                np.asarray(best_ratio)[:R], np.asarray(over)[:R])

    def decide_device(
        self,
        q_enc: np.ndarray, q_len: np.ndarray,
        ts_q_enc: np.ndarray, ts_q_len: np.ndarray,
        cand_d, rows: np.ndarray, tl: int,
    ):
        """Like :meth:`decide` but the (padded) result vectors stay on device
        — the caller packs and fetches them in one transfer."""
        cfg = self.cfg
        R = len(rows)
        k = int(cand_d.shape[1])
        # bound the (C*K, tl, tl) match-mask tensor of the LCS kernel
        chunk = int(np.clip((1 << 26) // max(k * tl * tl, 1), 8, 256))
        n_dev = self.mesh.devices.size if self.mesh is not None else 1
        step = chunk * n_dev
        rp = ((R + step - 1) // step) * step

        if self.mesh is None:
            fn = partial(
                _fuzzy_decide_kernel,
                tl=tl, threshold=cfg.levenshtein_ratio_threshold, chunk=chunk,
            )
            put = jnp.asarray
        else:
            # data-parallel over the row axis: each device decides its local
            # rows (the truth side + candidate matrix are replicated)
            from jax.sharding import PartitionSpec as P

            try:
                from jax import shard_map
            except ImportError:  # pragma: no cover - older jax
                from jax.experimental.shard_map import shard_map

            axis = self.mesh.axis_names[0]
            fn = jax.jit(shard_map(
                partial(
                    _fuzzy_decide_kernel,
                    tl=tl, threshold=cfg.levenshtein_ratio_threshold, chunk=chunk,
                ),
                mesh=self.mesh,
                in_specs=(P(axis), P(axis), P(axis), P(axis),
                          P(), P(), P(), P(), P(), P(), P(axis)),
                out_specs=(P(axis),) * 6,
                check_vma=False,
            ))
            from jax.sharding import NamedSharding

            row_sh = NamedSharding(self.mesh, P(axis))
            put = lambda x: jax.device_put(x, row_sh)  # noqa: E731

        def pad(x, width=None):
            out_shape = (rp,) + (() if width is None else (width,))
            out = np.zeros(out_shape, x.dtype)
            out[:R] = x if width is None else x[:, :width]
            return put(out)

        return fn(
            pad(q_enc, tl), pad(q_len.astype(np.int32)),
            pad(ts_q_enc, tl), pad(ts_q_len.astype(np.int32)),
            self.t_enc, self.t_len, self.t_ts, self.t_ts_len,
            self.t_wlen_max,
            cand_d, pad(rows.astype(np.int32)),
        )

    def ratios(
        self,
        q_enc: np.ndarray, q_len: np.ndarray,
        ts_q_enc: np.ndarray, ts_q_len: np.ndarray,
        pair_q: np.ndarray, pair_t: np.ndarray,
        t_len_host: np.ndarray, ts_t_len_host: np.ndarray,
    ) -> np.ndarray:
        """Final rounded ratios for N (query-row, truth-row) pairs."""
        cfg = self.cfg
        thr = cfg.levenshtein_ratio_threshold
        q_enc_d = jnp.asarray(q_enc)
        q_len_d = jnp.asarray(q_len.astype(np.int32))
        q_ts_d = jnp.asarray(ts_q_enc)
        q_ts_len_d = jnp.asarray(ts_q_len.astype(np.int32))

        n = len(pair_q)
        out = np.zeros(n, dtype=np.int32)
        # bucket on the max length across BOTH string variants
        pair_len = np.maximum.reduce([
            q_len[pair_q], t_len_host[pair_t],
            ts_q_len[pair_q], ts_t_len_host[pair_t],
        ])
        buckets = [b for b in cfg.length_buckets if b < q_enc.shape[1]] + [q_enc.shape[1]]
        bi = np.searchsorted(np.asarray(buckets), pair_len)
        pending = []
        for i, tl in enumerate(buckets):
            sel = np.flatnonzero(bi == i)
            if len(sel) == 0:
                continue
            # bound the bit-parallel kernel's (B, Lb, La) match-mask tensor
            chunk = int(np.clip((1 << 25) // (tl * tl), 64, cfg.pair_block))
            for s in range(0, len(sel), chunk):
                idx = sel[s : s + chunk]
                m = len(idx)
                prs = np.zeros((2, chunk), np.int32)
                prs[0, :m] = pair_q[idx]
                prs[1, :m] = pair_t[idx]
                r = _fuzzy_kernel(
                    q_enc_d, q_len_d, q_ts_d, q_ts_len_d,
                    self.t_enc, self.t_len, self.t_ts, self.t_ts_len,
                    jnp.asarray(prs),
                    tl=tl, threshold=thr,
                )
                pending.append((idx, m, r))
        for idx, m, r in pending:
            out[idx] = np.asarray(r)[:m]
        return out
