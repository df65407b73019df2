"""Two-stage folded retrieval: coarse upper-bound scoring + exact rescore.

The exact retrieval path (ops/jaccard.py) pays for its own generality: a
query block of 128 title-sorted queries carries a trigram-id union of
~1000-2000 rows, yet each query holds only ~20-45 trigrams — ≥97 % of the
(QB × U) weight matrix is zeros, and every block re-gathers the union's bit
rows (U × ntp/8 bytes) from device memory.

This module removes both costs (reference capability: match_maker.py:16-50):

* **Coarse stage** — the 37³ trigram vocabulary is folded into ``C``
  df-balanced buckets (``build_fold_map``).  The folded occupancy matrix
  ``Mc[C, ntp/8]`` (bit t of row c set ⟺ title t contains any trigram of
  bucket c) is ~34 MB at 500k titles — permanently device-resident, so the
  per-block row gather disappears entirely, and the scoring product
  contracts over C instead of the union.  With ``fold_hashes`` independent
  partitions the coarse numerator is the elementwise MIN of the per-hash
  products (a count-min bound).  Folded scores are a *monotone upper bound*
  of the exact IDF-weighted Jaccard: every shared trigram contributes its
  full IDF; bucket collisions can only add.
* **Exact rescore** — the coarse top-``rescore_depth`` candidates per
  query are rescored exactly against the per-title trigram-list matrix
  ``TL[ntp, Ltw]`` (device-resident), restoring exact scores and exact
  ordering.  The only approximation left is coarse *recall*: a true
  top-k candidate is lost only if > rescore_depth titles beat its upper
  bound.  The cascade only consumes the head of the candidate list, and
  the oracle anchor of ``chip_smoke.py`` gates the end-to-end effect.

The coarse pass runs as the Pallas-Triton kernel of ops/coarse_triton.py on
the GPU and as ``jaccard.topk_over_blocks`` elsewhere (backend.coarse_route).

With ``C`` ≥ the number of observed trigrams the fold map is injective on
observed ids and the coarse stage IS the exact computation (tests exploit
this for bit-equality against the exact path).
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Tuple

import numpy as np

from doppelspeller.config import TRIGRAM_VOCAB_SIZE, Config, get_config
from doppelspeller.utils import text as T
from doppelspeller.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)

V = TRIGRAM_VOCAB_SIZE


def build_fold_map(df: np.ndarray, fold_dim: int, seed: int = 0) -> np.ndarray:
    """int32[V+1] trigram id → bucket in [0, fold_dim); slot V (the invalid
    sentinel) → fold_dim.

    Greedy df-balancing: observed trigrams in descending-df order each go
    to the least-loaded bucket (load = Σ df), so every bucket ends up with
    ≈ total_df / C titles touching it and the expected spurious coarse
    mass is uniform.  When fold_dim ≥ #observed trigrams each observed id
    gets its own bucket (the map is injective → coarse == exact).
    Unobserved ids carry zero scoring weight and zero occupancy; they are
    round-robined for determinism only.

    ``seed`` > 0 jitters the greedy order (multiplicative df noise) to
    produce an INDEPENDENT partition with the same balance property — the
    two-hash count-min bound (fold_hashes=2) needs partitions whose
    collisions are uncorrelated.  Seeded runs are deterministic.
    """
    fold = np.empty(V + 1, dtype=np.int32)
    fold[V] = fold_dim
    if seed == 0:
        key = -df.astype(np.float64)
    else:
        r = np.random.default_rng(seed)
        key = -(df.astype(np.float64) * r.uniform(0.5, 2.0, V))
    order = np.argsort(key, kind="stable")
    heap = [(0, c) for c in range(fold_dim)]  # already a valid heap
    observed = int((df > 0).sum())
    obs_mask = df > 0
    obs_in_order = order[obs_mask[order]]
    rest = order[~obs_mask[order]]
    assert len(obs_in_order) == observed
    for g in obs_in_order:
        load, c = heapq.heappop(heap)
        fold[g] = c
        heapq.heappush(heap, (load + int(df[g]), c))
    if observed < V:
        fold[rest] = np.arange(len(rest), dtype=np.int64) % fold_dim
    return fold


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_folded_matrix(
    encoded: np.ndarray,
    lengths: np.ndarray,
    fold_map: np.ndarray,
    fold_dim: int,
    ntp: int,
    device=None,
    block: int = 32768,
):
    """uint8[fold_dim, ntp//8] folded occupancy bits, built ON DEVICE from
    the encoded titles (same little-endian packing as the main index,
    index_device._scatter_block) — only the encodings are uploaded, never a
    bit matrix."""
    import jax
    import jax.numpy as jnp

    from doppelspeller.ops.index_device import _device_trigram_ids

    C = fold_dim
    fold_d = jax.device_put(fold_map.astype(np.int32), device)

    @partial(jax.jit, donate_argnums=(0,))
    def scatter(mc, enc_blk, len_blk, byte0):
        TB = enc_blk.shape[0]
        ids = _device_trigram_ids(enc_blk, len_blk)          # (TB, S), V=pad
        f = fold_d[ids]                                      # (TB, S), C=pad
        # per-title dedup IN BUCKET SPACE: two distinct trigrams of one
        # title folding to the same bucket must set its bit once (the byte
        # scatter-add below would otherwise carry into neighbour bits)
        f = jnp.sort(f, axis=1)
        dup = jnp.concatenate(
            [jnp.zeros((TB, 1), bool), f[:, 1:] == f[:, :-1]], axis=1
        )
        f = jnp.where(dup, C, f)
        t = jax.lax.broadcasted_iota(jnp.int32, f.shape, 0)
        bitval = jnp.uint8(1) << (t % 8).astype(jnp.uint8)
        blk = jnp.zeros((C + 1, TB // 8), jnp.uint8)
        blk = blk.at[f.reshape(-1), (t // 8).reshape(-1)].add(
            bitval.reshape(-1), mode="drop"
        )
        return jax.lax.dynamic_update_slice(mc, blk[:C], (0, byte0))

    mc = jax.device_put(jnp.zeros((C, ntp // 8), jnp.uint8), device)
    nt = encoded.shape[0]
    L = encoded.shape[1]
    for s in range(0, ntp, block):
        tb = _round_up(min(block, ntp - s), 8)
        enc = np.zeros((tb, L), np.uint8)
        lens = np.zeros((tb,), np.int32)
        real = min(nt - s, tb) if s < nt else 0
        if real > 0:
            enc[:real] = encoded[s : s + real]
            lens[:real] = lengths[s : s + real]
        mc = scatter(mc, jax.device_put(jnp.asarray(enc), device),
                     jax.device_put(jnp.asarray(lens), device),
                     jnp.int32(s // 8))
    return mc


def build_trigram_list_matrix(
    encoded: np.ndarray,
    lengths: np.ndarray,
    ntp: int,
    device=None,
    block: int = 65536,
    ltw: Optional[int] = None,
) -> Tuple[object, int]:
    """(uint16[ntp, Ltw] device matrix, Ltw): per-title sorted unique trigram
    ids, sentinel V in unused slots.  The exact-rescore stage gathers rows
    of this instead of bit columns of the packed matrix.  uint16 storage —
    every id and the V=50653 sentinel fit — halves the bytes of the
    rescore's gather and the resident footprint.

    ``ltw`` forces the row width — the mesh build passes a global width so
    every shard's matrix tiles into one sharded array."""
    import jax
    import jax.numpy as jnp

    from doppelspeller.ops.index_device import _device_trigram_ids

    nt = encoded.shape[0]
    L = encoded.shape[1]
    if ltw is None:
        l_eff = int(lengths.max(initial=3)) if nt else 3
        ltw = max(_round_up(l_eff - 2, 8), 8)

    @jax.jit
    def ids_block(enc_blk, len_blk):
        ids = _device_trigram_ids(enc_blk, len_blk)          # sorted, V pad
        s = ids.shape[1]
        if s < ltw:
            ids = jnp.concatenate(
                [ids, jnp.full((ids.shape[0], ltw - s), V, jnp.int32)], axis=1
            )
        return ids[:, :ltw].astype(jnp.uint16)

    parts = []
    for s in range(0, ntp, block):
        tb = _round_up(min(block, ntp - s), 8)
        enc = np.zeros((tb, L), np.uint8)
        lens = np.full((tb,), 3, np.int32)   # pad rows: 1 trigram of pads
        real = min(nt - s, tb) if s < nt else 0
        if real > 0:
            enc[:real] = encoded[s : s + real]
            lens[:real] = lengths[s : s + real]
        blk = ids_block(jax.device_put(jnp.asarray(enc), device),
                        jax.device_put(jnp.asarray(lens), device))
        # pad-title rows must stay all-V so they can never match a query id
        if real < tb:
            blk = blk.at[real:].set(V)
        parts.append(blk[: min(tb, ntp - s)])
    return jnp.concatenate(parts, axis=0), ltw


@dataclass
class IdBlockPlan:
    """One folded-retrieval block: ≤ query_block queries' trigram ids.

    Mirrors the exact planner's QueryBlockPlan surface used downstream
    (query_rows / n_valid); no union — the coarse matmul contracts over
    the fixed fold dimension, and per-query weights + the max-intersection
    bound are reconstructed on device from resident tables."""

    query_rows: np.ndarray    # int64[n_valid] row numbers into the query set
    ids: np.ndarray           # int32[query_block, LQ] trigram ids, V invalid
    n_valid: int


def plan_id_blocks(
    queries: TitleSet,
    config: Optional[Config] = None,
    rows: Optional[np.ndarray] = None,
) -> List[IdBlockPlan]:
    """Chunk queries into fixed-shape id blocks (no unions, no buckets —
    every block compiles to the same program)."""
    cfg = config or get_config()
    if rows is None:
        rows = np.arange(len(queries), dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return []
    qb = cfg.fold_query_block or cfg.query_block
    ids_all = queries.trigram_ids()[rows]      # cached per TitleSet
    counts = (ids_all != T.BIG_TRIGRAM).sum(axis=1)
    need = int(counts.max(initial=1))
    lq = next(b for b in (cfg.max_query_trigrams, 128, 253)
              if need <= b or b == 253)
    if ids_all.shape[1] < lq:
        ids_all = np.concatenate([
            ids_all,
            np.full((ids_all.shape[0], lq - ids_all.shape[1]),
                    T.BIG_TRIGRAM, np.int32),
        ], axis=1)
    ids_all = np.minimum(ids_all[:, :lq], np.int32(V))       # invalid → V
    plans: List[IdBlockPlan] = []
    for s in range(0, len(rows), qb):
        sel = slice(s, min(s + qb, len(rows)))
        m = sel.stop - sel.start
        blk = np.full((qb, lq), V, dtype=np.int32)
        blk[:m] = ids_all[sel]
        plans.append(IdBlockPlan(query_rows=rows[sel], ids=blk, n_valid=m))
    return plans


def _coarse_weights(ids, idf_ext, fold_ext, C, dtype):
    """(QB, C) folded weights + per-query exact weights from resident tables.

    Returns (wfold, w_val) where wfold[q, c] = Σ idf over the query's
    trigrams folding to bucket c (scatter-ADD: within-query bucket
    collisions keep the coarse score an upper bound of the exact one)."""
    import jax
    import jax.numpy as jnp

    qb, lq = ids.shape
    w_val = idf_ext[ids]                                     # (QB, LQ), 0 pad
    fpos = fold_ext[ids]                                     # (QB, LQ), C pad
    rq = jax.lax.broadcasted_iota(jnp.int32, (qb, lq), 0)
    w = jnp.zeros((qb, C + 1), jnp.float32)
    w = w.at[rq, fpos].add(w_val, mode="drop")
    return w[:, :C].astype(dtype), w_val


def _rescore_exact(tl_mat, sums, ids, w_val, maxint, vals_c, pos_c, nt, k):
    """Exact rescore of the coarse top-k' candidates.

    ``tl_mat`` int32[ntp, Ltw] per-title sorted unique trigram ids (V pad);
    gathering k' rows per query replaces gathering the full bit-row union.
    Exact numerator: Σ_l w_val[q, l] · [ids[q, l] ∈ TL[pos]] — ids are
    per-query unique, TL rows are per-title unique, so each shared trigram
    counts exactly once.  Returns exact (scores, positions) top-k.
    """
    import jax
    import jax.numpy as jnp

    qb, kp = pos_c.shape
    lq = ids.shape[1]
    safe = jnp.maximum(pos_c, 0)
    tlg = tl_mat[safe]                                       # (QB, k', Ltw)

    def body(l, acc):
        idl = ids[:, l]
        hit = (tlg == idl[:, None, None]).any(axis=2)        # (QB, k')
        return acc + w_val[:, l, None] * hit

    c = jax.lax.fori_loop(0, lq, body, jnp.zeros((qb, kp), jnp.float32))
    s = sums[safe]
    denom = s + maxint[:, None] - c
    jacc = c / jnp.maximum(denom, 1e-9)
    jacc = jnp.where((pos_c >= 0) & (pos_c < nt), jacc, -1.0)
    v, sel = jax.lax.top_k(jacc, k)
    p = jnp.take_along_axis(pos_c, sel, axis=1)
    return v, p


def resolve_coarse_route(cfg: Config, device=None) -> str:
    """'triton' or 'xla' for the coarse pass.  ``retrieval_impl='auto'``
    asks backend.coarse_route; the kernel computes bf16 windowed maxima
    only, so 'auto' keeps the plain scorer for float32 scoring or with
    window selection off, and an explicit 'triton' there is an error."""
    from doppelspeller.backend import coarse_route

    impl = cfg.retrieval_impl
    fits = cfg.retrieval_window_select and cfg.score_dtype == "bfloat16"
    if impl == "auto":
        return coarse_route(device) if fits else "xla"
    if impl == "triton" and not fits:
        raise ValueError(
            "retrieval_impl='triton' needs score_dtype='bfloat16' and "
            "retrieval_window_select=True"
        )
    if impl not in ("xla", "triton"):
        raise ValueError(f"unknown retrieval_impl {impl!r}")
    return impl


def coarse_candidates(mc, sums, wfold, maxint, nt, *, kprime: int, folds: int,
                      title_block: int, score_dtype: str, route: str,
                      window: int):
    """Coarse top-k' (scores, local title positions) by the folded upper
    bound — the one call site of both coarse routes.  ``route`` is
    resolve_coarse_route's choice; tests alone pass "triton_interpret" to
    run the kernel in the Pallas interpreter on the CPU."""
    import jax.numpy as jnp

    from doppelspeller.ops.jaccard import topk_over_blocks

    # the kernel keeps one candidate per 8-title window, so a shard of fewer
    # than 8·k' titles cannot fill k' slots; there the plain scorer, whose
    # window rule also selects exactly on such narrow blocks, runs instead
    if route in ("triton", "triton_interpret") and mc.shape[1] >= kprime:
        from doppelspeller.ops.coarse_triton import coarse_topk

        return coarse_topk(mc, sums, wfold, maxint, nt, k=kprime, folds=folds,
                           interpret=route == "triton_interpret")
    return topk_over_blocks(
        mc, sums, wfold, maxint, jnp.int32(0), nt, k=kprime,
        title_block=title_block, score_dtype=score_dtype, folds=folds,
        window=window,
    )


def fold_group_weights(flat, idf_ext, fb_ext, fold_ext, *, C: int, folds: int,
                       dtype):
    """Weights of a whole (G, QB, LQ) id group in one scatter: returns
    (wfold (G, QB, folds·C), w_val (G, QB, LQ), maxint (G, QB)).  The
    per-hash weight blocks are concatenated along C to match the stacked
    ``mc``."""
    import jax.numpy as jnp

    G, qb, lq = flat.shape
    ids_flat = flat.reshape(G * qb, lq)
    fold_ext2 = fold_ext.reshape(folds, -1)
    parts = []
    for f in range(folds):
        wf, wval_all = _coarse_weights(ids_flat, idf_ext, fold_ext2[f], C, dtype)
        parts.append(wf)
    wfold_all = parts[0] if folds == 1 else jnp.concatenate(parts, axis=1)
    maxint_all = fb_ext[ids_flat].sum(axis=1)
    return (wfold_all.reshape(G, qb, folds * C), wval_all.reshape(G, qb, lq),
            maxint_all.reshape(G, qb))


def _folded_multiblock_impl(
    mc, sums, tl_mat, idf_ext, fb_ext, fold_ext, buf, nt, t_len, t_wlen, *,
    C, qb, lq, k, kprime, score_dtype, route, title_block, window, probe,
    folds,
):
    """Score G folded query blocks in ONE device program (lax.scan).

    Same contract as jaccard._topk_multiblock but the host ships ONLY the
    (G·QB·LQ) trigram ids: weights fold on device, the coarse pass reads
    the resident ``mc`` (no gather), and the top-k' survivors are rescored
    exactly against ``tl_mat``.  Returns (f32[G, QB, k], i32[G, QB, k]
    [, i32[G, 2, QB]])."""
    import jax
    import jax.numpy as jnp

    G = buf.shape[0] // (qb * lq)
    # ids ship as uint16 (V = 50653 and its sentinel fit); widen on device
    flat = buf.reshape(G, qb, lq).astype(jnp.int32)
    # fold the WHOLE group's weights in one scatter before the scan: one
    # (G·QB, C) scatter-add instead of G per-block scatters, and the
    # idf/fold gathers leave the per-block program
    wfold_all, wval_all, maxint_all = fold_group_weights(
        flat, idf_ext, fb_ext, fold_ext, C=C, folds=folds,
        dtype=jnp.dtype(score_dtype),
    )

    def step(_, blk):
        ids, wfold, w_val, maxint = blk
        vals_c, pos_c = coarse_candidates(
            mc, sums, wfold, maxint, nt, kprime=kprime, folds=folds,
            title_block=title_block, score_dtype=score_dtype, route=route,
            window=window,
        )
        if tl_mat is not None:
            vals, pos = _rescore_exact(
                tl_mat, sums, ids, w_val, maxint, vals_c, pos_c, nt, k
            )
        else:
            vals, pos = vals_c[:, :k], pos_c[:, :k]
        if probe:
            tl = t_len[pos].max(axis=1)
            wl = t_wlen[pos].max(axis=1)
            return None, (vals, pos, jnp.stack([tl, wl], axis=0))
        return None, (vals, pos)

    _, out = jax.lax.scan(step, None, (flat, wfold_all, wval_all, maxint_all))
    return out


_folded_multiblock = None


def folded_multiblock(*args, **kwargs):
    """jit wrapper (deferred so importing fold.py never initializes jax)."""
    global _folded_multiblock
    if _folded_multiblock is None:
        import jax

        _folded_multiblock = partial(
            jax.jit, static_argnames=(
                "C", "qb", "lq", "k", "kprime", "score_dtype", "route",
                "title_block", "window", "probe", "folds",
            ),
        )(_folded_multiblock_impl)
    return _folded_multiblock(*args, **kwargs)


def coarse_window(cfg: Config) -> int:
    """Titles per coarse pre-select window (1 = no windowing)."""
    from doppelspeller.ops.coarse_triton import WINDOW

    return WINDOW if cfg.retrieval_window_select else 1


class FoldedEngine:
    """Device-resident folded-retrieval state for one TruthIndex.

    Built by JaccardScorer when ``cfg.retrieval_mode`` selects folding; the
    truth *encodings* are required (the folded matrix and the trigram-list
    matrix are built on device from them — the multi-GB packed matrix is
    never touched)."""

    def __init__(self, index, truth: TitleSet, cfg: Config, device=None):
        import jax
        import jax.numpy as jnp

        self.cfg = cfg
        self.C = cfg.fold_dim
        self.kprime = cfg.rescore_depth
        self.folds = max(1, cfg.fold_hashes)
        self.route = resolve_coarse_route(cfg, device)
        ntp = index.padded_titles
        folds_np = [build_fold_map(index.df, self.C, seed=f)
                    for f in range(self.folds)]
        mcs = [build_folded_matrix(
            truth.encoded, truth.lengths, fm, self.C, ntp, device=device,
        ) for fm in folds_np]
        self.mc_d = mcs[0] if self.folds == 1 else jnp.concatenate(mcs, axis=0)
        self.fold_ext_d = jax.device_put(np.stack(folds_np), device)
        if self.kprime > 0:
            self.tl_d, self.ltw = build_trigram_list_matrix(
                truth.encoded, truth.lengths, ntp, device=device,
            )
        else:
            self.tl_d, self.ltw = None, 0
        zero = np.zeros(1, np.float32)
        self.idf_ext_d = jax.device_put(
            np.concatenate([index.idf, zero]), device
        )
        fb = np.where(index.df > 0, index.idf, np.float32(index.max_idf))
        self.fb_ext_d = jax.device_put(
            np.concatenate([fb.astype(np.float32), zero]), device
        )
        self.sums_d = jax.device_put(index.sums, device)
        self.nt_d = jnp.int32(index.num_titles)
        LOGGER.info(
            "[FoldedEngine] C=%d hashes=%d kprime=%d ltw=%d route=%s: "
            "Mc %.1f MB, TL %.1f MB",
            self.C, self.folds, self.kprime, self.ltw, self.route,
            self.mc_d.nbytes / 1e6,
            (self.tl_d.nbytes / 1e6) if self.tl_d is not None else 0.0,
        )

    def statics(self, k: int) -> dict:
        """The static arguments shared by every folded program."""
        return dict(
            C=self.C, k=k,
            kprime=max(self.kprime, k) if self.kprime > 0 else k,
            score_dtype=self.cfg.score_dtype, route=self.route,
            title_block=self.cfg.title_block, window=coarse_window(self.cfg),
            folds=self.folds,
        )

    def dispatch(self, chunk, g, qb, lq, k, probe_tables=None):
        """Run one G-group of IdBlockPlans; returns (chunk, vals, pos[, tlw])."""
        import jax.numpy as jnp

        buf = np.full((g, qb, lq), V, dtype=np.uint16)
        for j, p in enumerate(chunk):
            buf[j] = p.ids
        probe = probe_tables is not None
        t_len_d, t_wlen_d = probe_tables if probe else (None, None)
        out = folded_multiblock(
            self.mc_d, self.sums_d, self.tl_d,
            self.idf_ext_d, self.fb_ext_d, self.fold_ext_d,
            jnp.asarray(buf.reshape(-1)), self.nt_d, t_len_d, t_wlen_d,
            qb=qb, lq=lq, probe=probe, **self.statics(k),
        )
        return (chunk,) + tuple(out)
