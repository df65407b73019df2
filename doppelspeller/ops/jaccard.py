"""Device-side IDF-weighted Jaccard scoring + fused top-k.

Replacement for the reference's numba scatter-add kernel ``fast_jaccard``
(match_maker.py:16-50) and ``fast_arg_top_k`` (match_maker.py:53-71).
Instead of an inverted-index scatter per query, a whole block of queries is
scored at once as one matrix product:

    scores[q, t] = Σ_g  W[q, g] · bits[g, t]

where ``W`` is the (query-block × trigram-union) IDF-weight matrix and
``bits`` is unpacked on the fly from the bit-packed device-resident truth
matrix (1 bit per (trigram, title) entry).  The modified-Jaccard
normalization (match_maker.py:50) and a running top-k merge are fused behind
the same jit so the score matrices never leave the device.

Shapes are fully static: the host planner (ngram_index.plan_query_blocks)
pads every block to one of a few union buckets, so XLA compiles one program
per occupied bucket.
"""

from __future__ import annotations

import logging
import time
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from doppelspeller.config import Config, get_config
from doppelspeller.ops.ngram_index import TruthIndex, plan_query_blocks
from doppelspeller.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)


def unpack_bits(packed: jnp.ndarray) -> jnp.ndarray:
    """(R, NB) uint8 → (R, NB*8) {0,1} uint8, little-endian bit order."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1)
    return bits.reshape(packed.shape[0], -1)


def window_max(jacc: jnp.ndarray, window: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(QB, T) scores → per-window (max, first argmax offset), both
    (QB, T // window), over runs of ``window`` consecutive titles."""
    qb, t = jacc.shape
    wv = jacc.reshape(qb, t // window, window)
    return wv.max(axis=2), jnp.argmax(wv, axis=2).astype(jnp.int32)


def topk_over_blocks(
    rows: jnp.ndarray,        # uint8[R, ntp_local//8] trigram (or fold) rows
    sums: jnp.ndarray,        # float32[ntp_local] per-title IDF sums
    weights: jnp.ndarray,     # float32[QB, R]
    maxint: jnp.ndarray,      # float32[QB]
    global_offset,            # int32: global title position of column 0
    nt,                       # int32: number of real titles globally
    *,
    k: int,
    title_block: int,
    score_dtype: str = "float32",
    folds: int = 1,
    window: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Core scorer: scan title blocks, fuse matmul + jaccard + running top-k.

    Shared by the single-device engines and the shard_map per-device path
    (where ``global_offset`` = shard_index · local_titles).

    ``folds`` > 1: ``rows`` stacks ``folds`` equally tall row matrices and
    ``weights`` the matching column blocks; the numerator is the elementwise
    MIN of the per-fold products (the multi-hash folded upper bound,
    ops/fold.py).  ``window`` > 1: each block's scores are reduced to the max
    of every run of ``window`` consecutive titles (first max kept) before
    the top-k, which then scans a ``window``× narrower matrix; only
    per-window runner-ups are lost.  Blocks narrower than ``k`` windows
    select exactly."""
    dtype = jnp.dtype(score_dtype)
    # float32 scoring is the exact oracle: ask for true f32 products (the
    # GPU's default f32 matmul runs in TF32)
    precision = jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None
    ntp = rows.shape[1] * 8
    nblocks = ntp // title_block
    w = weights.astype(dtype)
    qb = weights.shape[0]
    h = rows.shape[0] // folds
    use_window = window > 1 and title_block // window >= k

    def body(carry, blk):
        vals_c, idx_c = carry
        sl = jax.lax.dynamic_slice_in_dim(rows, blk * (title_block // 8), title_block // 8, axis=1)
        bits = unpack_bits(sl).astype(dtype)       # (R, TB)
        scores = None
        for f in range(folds):
            s = jax.lax.dot_general(
                w[:, f * h:(f + 1) * h], bits[f * h:(f + 1) * h],
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=precision,
            )                                      # (QB, TB) f32
            scores = s if scores is None else jnp.minimum(scores, s)
        sums_blk = jax.lax.dynamic_slice_in_dim(sums, blk * title_block, title_block)
        denom = sums_blk[None, :] + maxint[:, None] - scores
        jacc = scores / jnp.maximum(denom, 1e-9)
        tpos = (
            global_offset + blk * title_block
            + jax.lax.broadcasted_iota(jnp.int32, (1, title_block), 1)
        )
        jacc = jnp.where(tpos < nt, jacc, -1.0)
        if use_window:
            wmax, warg = window_max(jacc, window)
            v, wi = jax.lax.top_k(wmax, k)
            i = wi * window + jnp.take_along_axis(warg, wi, axis=1)
        else:
            v, i = jax.lax.top_k(jacc, k)          # (QB, k)
        gi = (global_offset + blk * title_block + i).astype(jnp.int32)
        vals = jnp.concatenate([vals_c, v], axis=1)
        idxs = jnp.concatenate([idx_c, gi], axis=1)
        v2, sel = jax.lax.top_k(vals, k)
        i2 = jnp.take_along_axis(idxs, sel, axis=1)
        return (v2, i2), None

    init = (
        jnp.full((qb, k), -jnp.inf, dtype=jnp.float32),
        jnp.zeros((qb, k), dtype=jnp.int32),
    )
    (vals, idxs), _ = jax.lax.scan(body, init, jnp.arange(nblocks))
    return vals, idxs


def densify_weights(w_pos: jnp.ndarray, w_val: jnp.ndarray, union_size: int,
                    dtype) -> jnp.ndarray:
    """Scatter sparse (positions-into-union, values) → dense (QB, U) weights.
    Position ``union_size`` is the padding slot (dropped)."""
    qb, lq = w_pos.shape
    rq = jax.lax.broadcasted_iota(jnp.int32, (qb, lq), 0)
    w = jnp.zeros((qb, union_size + 1), dtype)
    w = w.at[rq, w_pos].set(w_val.astype(dtype), mode="drop")
    return w[:, :union_size]


def union_weights(idf_tbl, fb_tbl, union_ids, wp, u: int):
    """Per-block weights rebuilt on device from resident IDF tables.

    Returns (w_val float32[QB, LQ], maxint float32[QB], wp clamped to the
    padding slot ``u``)."""
    zero = jnp.zeros(1, jnp.float32)
    uidf = jnp.concatenate([idf_tbl[union_ids], zero])  # (U+1,) pad→0
    ufb = jnp.concatenate([fb_tbl[union_ids], zero])
    wp_c = jnp.minimum(wp, u)
    return uidf[wp_c], ufb[wp_c].sum(axis=1), wp_c


@partial(jax.jit, static_argnames=("u", "qb", "lq", "k", "score_dtype",
                                   "title_block", "probe"))
def _topk_multiblock(
    packed: jnp.ndarray,      # uint8[V, ntp//8]
    sums: jnp.ndarray,        # float32[ntp]
    idf_tbl: jnp.ndarray,     # float32[V] ln(N/df), 0 unobserved
    fb_tbl: jnp.ndarray,      # float32[V] idf-or-max-idf fallback
    buf: jnp.ndarray,         # int32[G*(U + QB*LQ)] — ONE transfer per group
    nt: jnp.ndarray,          # int32 scalar
    t_len: Optional[jnp.ndarray] = None,    # int32[nt_pad] (probe)
    t_wlen: Optional[jnp.ndarray] = None,   # int32[nt_pad] (probe)
    *,
    u: int, qb: int, lq: int, k: int, score_dtype: str,
    title_block: int, probe: bool = False,
):
    """Score G query blocks in ONE device program (lax.scan over blocks).

    Per-block IDF weights and the max-intersection bound are reconstructed
    on device from resident tables, so the host ships only trigram ids and
    positions, one buffer and one dispatch per group of blocks.
    With ``probe=True`` also returns the per-query max candidate title
    length and word length (int32[G, 2, QB]) so the cascade can pick its
    static DP buckets without fetching the candidate matrix.
    Returns (float32[G, QB, k], int32[G, QB, k][, int32[G, 2, QB]]).
    """
    dtype = jnp.dtype(score_dtype)
    G = buf.shape[0] // (u + qb * lq)
    flat = buf.reshape(G, u + qb * lq)
    unions = flat[:, :u]                                   # (G, U)
    w_pos = flat[:, u:].reshape(G, qb, lq)                 # (G, QB, LQ)

    def step(_, x):
        union_ids, wp = x
        w_val, maxint, wp_c = union_weights(idf_tbl, fb_tbl, union_ids, wp, u)
        w = densify_weights(wp_c, w_val, u, dtype)
        vals, pos = topk_over_blocks(
            packed[union_ids], sums, w, maxint, jnp.int32(0), nt,
            k=k, title_block=title_block, score_dtype=score_dtype,
        )
        if probe:
            tl = t_len[pos].max(axis=1)                     # (QB,)
            wl = t_wlen[pos].max(axis=1)
            return None, (vals, pos, jnp.stack([tl, wl], axis=0))
        return None, (vals, pos)

    _, out = jax.lax.scan(step, None, (unions, w_pos))
    return out


def group_plan_buffers(plans, g: int):
    """Stack plans into padded G-sized int32 buffers (ONE transfer each),
    grouping plans of the same union bucket so every group is a single
    static-shaped program.  Padding blocks reuse zeros (their outputs are
    discarded).  Returns ([(plan_chunk, buf, union_size)], qb, lq)."""
    qb, lq = plans[0].w_pos.shape
    by_bucket = {}
    for p in plans:
        by_bucket.setdefault(p.union_ids.shape[0], []).append(p)
    groups = []
    for u in sorted(by_bucket):
        same = by_bucket[u]
        for s in range(0, len(same), g):
            chunk = same[s : s + g]
            groups.append((chunk, _plan_buffer(chunk, g, u, qb, lq), u))
    return groups, qb, lq


def _plan_buffer(chunk, g: int, u: int, qb: int, lq: int) -> np.ndarray:
    per = u + qb * lq
    buf = np.zeros(g * per, dtype=np.int32)
    for j, p in enumerate(chunk):
        buf[j * per : j * per + u] = p.union_ids
        buf[j * per + u : (j + 1) * per] = p.w_pos.reshape(-1)
    return buf


def folded_wanted(cfg: Config, num_titles: int, truth) -> bool:
    """Whether ``retrieval_mode`` engages the two-stage folded engine:
    'folded' forces it, 'auto' engages it at >= folded_min_titles titles
    when the truth encodings are available, 'exact' disables it."""
    mode = cfg.retrieval_mode
    want = mode == "folded" or (
        mode == "auto" and truth is not None
        and num_titles >= cfg.folded_min_titles
    )
    if want and truth is None:
        raise ValueError(
            "retrieval_mode='folded' needs the truth TitleSet (encodings) — "
            "pass truth= to the scorer"
        )
    if want and mode == "auto":
        LOGGER.info(
            "retrieval_mode='auto' engages FOLDED retrieval at %d titles: "
            "only the coarse top-%d is approximate; set retrieval_mode="
            "'exact' for exact top-k", num_titles, cfg.rescore_depth,
        )
    return want


class JaccardScorer:
    """Device-resident retrieval engine over a TruthIndex.

    The analogue of reference MatchMaker.get_closest_matches
    (match_maker.py:192-203), but batched: ``topk(queries)`` scores *all*
    queries in static-shaped blocks and returns sorted candidate matrices.
    """

    def __init__(self, index: TruthIndex, config: Optional[Config] = None,
                 device=None, truth: Optional[TitleSet] = None):
        self.cfg = config or get_config()
        self.index = index
        self.device = device
        self.sums_d = jax.device_put(index.sums, device)
        self.nt_d = jnp.int32(index.num_titles)
        self.score_dtype = self.cfg.score_dtype
        # resident IDF tables for on-device weight/max-intersection
        # reconstruction (the multiblock path ships only ids + positions)
        self.idf_d = jax.device_put(index.idf, device)
        fb = np.where(index.df > 0, index.idf, np.float32(index.max_idf))
        self.fb_d = jax.device_put(fb.astype(np.float32), device)
        # two-stage folded retrieval (ops/fold.py): coarse upper-bound pass
        # over a small resident folded matrix + exact rescore — no per-block
        # row gather.  Needs the truth ENCODINGS; small indexes stay exact.
        self.folded = None
        self.packed_d = None
        if folded_wanted(self.cfg, index.num_titles, truth):
            from doppelspeller.ops.fold import FoldedEngine

            self.folded = FoldedEngine(index, truth, self.cfg, device)
            return
        if index.packed.shape[1] == 0:
            raise ValueError(
                "index holds no packed matrix (mesh-built shard-only index); "
                "score it with ShardedJaccardScorer on the mesh, or rebuild "
                "single-device"
            )
        self.packed_d = jax.device_put(index.packed, device)

    def topk_device(
        self,
        queries: TitleSet,
        k: Optional[int] = None,
        rows: Optional[np.ndarray] = None,
        probe_tables=None,
    ):
        """Top-k for every query, results LEFT ON DEVICE.

        Returns (pending, plans) where ``pending`` is a list of
        (plan_chunk, vals (G, QB, k) f32, pos (G, QB, k) i32[, tlw
        (G, 2, QB) i32 when probe_tables is given]) device arrays; the
        chunks cover ``plans`` but may be reordered across union buckets.
        Callers fetch or feed the next cascade stage.
        """
        k = k or self.cfg.top_n_predicting
        if self.index.num_titles < k:
            raise ValueError(f"index has {self.index.num_titles} titles < k={k}")
        t0 = time.time()
        if self.folded is not None:
            from doppelspeller.ops.fold import plan_id_blocks

            plans = plan_id_blocks(queries, self.cfg, rows=rows)
            if not plans:
                return [], plans
            qb, lq = plans[0].ids.shape
            # keep ~dispatch_blocks·query_block queries per device program
            # regardless of the folded block size
            g = max(1, self.cfg.dispatch_blocks * self.cfg.query_block // qb)
            pending = [
                self.folded.dispatch(plans[s : s + g], g, qb, lq, k,
                                     probe_tables=probe_tables)
                for s in range(0, len(plans), g)
            ]
            LOGGER.info(
                "topk_device[folded]: %d blocks / %d groups dispatched in "
                "%.2fs", len(plans), len(pending), time.time() - t0,
            )
            return pending, plans
        plans = plan_query_blocks(queries, self.index, self.cfg, rows=rows)
        if not plans:
            return [], plans
        g = max(1, self.cfg.dispatch_blocks)
        qb, lq = plans[0].w_pos.shape
        probe = probe_tables is not None
        t_len_d, t_wlen_d = probe_tables if probe else (None, None)

        def dispatch(chunk, u):
            out = _topk_multiblock(
                self.packed_d, self.sums_d, self.idf_d, self.fb_d,
                jnp.asarray(_plan_buffer(chunk, g, u, qb, lq)), self.nt_d,
                t_len_d, t_wlen_d,
                u=u, qb=qb, lq=lq, k=k, score_dtype=self.score_dtype,
                title_block=self.cfg.title_block, probe=probe,
            )
            return (chunk,) + tuple(out)

        # streamed dispatch: groups go to the device as soon as a union
        # bucket accumulates g plans, so host-side buffer packing overlaps
        # device compute (plans arrive title-sorted, so consecutive blocks
        # usually share a bucket)
        pending = []
        acc = {}
        for p in plans:
            u = p.union_ids.shape[0]
            acc.setdefault(u, []).append(p)
            if len(acc[u]) == g:
                pending.append(dispatch(acc.pop(u), u))
        for u in sorted(acc):
            pending.append(dispatch(acc[u], u))
        LOGGER.info(
            "topk_device: %d blocks / %d groups planned+dispatched in %.2fs",
            len(plans), len(pending), time.time() - t0,
        )
        return pending, plans

    def topk(
        self,
        queries: TitleSet,
        k: Optional[int] = None,
        rows: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k candidates for every query (or the subset ``rows``).

        Returns (scores float32[N, k], positions int32[N, k]) where positions
        index into ``index.title_ids``, sorted by descending jaccard score.
        """
        k = k or self.cfg.top_n_predicting
        t0 = time.time()
        pending, plans = self.topk_device(queries, k=k, rows=rows)
        t_dispatch = time.time() - t0
        out_scores, out_pos = collect_topk(pending, plans, len(queries), rows, k)
        LOGGER.info(
            "topk: %d blocks / %d dispatches | dispatch %.2fs | fetch %.2fs",
            len(plans), len(pending), t_dispatch, time.time() - t0 - t_dispatch,
        )
        return out_scores, out_pos

    def topk_title_ids(self, queries: TitleSet, k: Optional[int] = None,
                       rows: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Like :meth:`topk` but mapping positions to external title ids."""
        scores, pos = self.topk(queries, k=k, rows=rows)
        return scores, self.index.title_ids[pos]


def collect_topk(pending, plans, n_queries: int, rows, k: int):
    """Fetch every pending group in ONE batched device_get and scatter the
    per-block results back to query-row order (shared by the single-device
    and mesh scorers)."""
    rows_all = np.arange(n_queries) if rows is None else np.asarray(rows)
    row_of = {int(r): j for j, r in enumerate(rows_all)}
    out_scores = np.zeros((len(rows_all), k), dtype=np.float32)
    out_pos = np.zeros((len(rows_all), k), dtype=np.int32)
    vals_all, pos_all = jax.device_get(
        ([p[1] for p in pending], [p[2] for p in pending])
    )
    for gi, (chunk, *_rest) in enumerate(pending):
        for s, plan in enumerate(chunk):
            j = np.fromiter(
                (row_of[int(q)] for q in plan.query_rows), dtype=np.int64,
                count=plan.n_valid,
            )
            out_scores[j] = vals_all[gi][s, : plan.n_valid]
            out_pos[j] = pos_all[gi][s, : plan.n_valid]
    return out_scores, out_pos
