"""The 66-dim (query, candidate) feature kernel.

Replacement for the reference's numba guvectorize kernel
``construct_features`` (feature_engineering.py:66-169).  Exact layout
(SURVEY.md §2.2):

    [0]      query #chars                    [1]  candidate #chars
    [2]      query #words                    [3]  candidate #words
    [4]      floor(ratio(query, candidate))
    [5]      floor(ratio(reconstructed, candidate))
    [6:21]   per-candidate-word best sliding-window ratio   (NaN-padded, 15)
    [21:36]  per-candidate-word length                      (NaN-padded)
    [36:51]  per-candidate-word IDF ln(N/count)             (NaN-padded)
    [51:66]  1 + (nanmax(idf) − idf) / candidate_#words

Integer ratio semantics follow the reference's uint8 cast = floor
(feature_engineering.py:25 signature).  The reference's uint8 DP-cell
overflow for pairs with |a|+|b| > 255 is NOT replicated (documented
deviation — it is an overflow bug, not a feature).

Design: all string work (word splitting, space removal) is vectorized numpy
on the host; the device kernel receives static-shaped (B, W=15, WL) word
tensors and runs the sliding-window LCS for *all* (pair, word, window
position) triples simultaneously — bit-parallel over word positions for
words of ≤ 32 chars, as a cummax-scan DP otherwise — then reconstructs the
best-match title and scores it.
Pairs are bucketed by (max title length, max word length) so XLA compiles a
handful of static programs.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from doppelspeller.config import ALPHABET, Config, SPACE_CODE, get_config
from doppelspeller.ops.levenshtein import lcs_kernel

FEATURES_COUNT = 66
NUM_WORD_SLOTS = 15
WL_BITS = 32  # bit-parallel word-length capacity (one uint32 per window)
_BIG = 1 << 20


# ---------------------------------------------------------------- host prep

def split_words_host(enc: np.ndarray, lengths: np.ndarray, w_slots: int = NUM_WORD_SLOTS):
    """Vectorized word-boundary extraction.

    Returns (word_start int32[B, W], word_len int32[B, W], n_words int32[B]).
    Word slots beyond the actual count have word_len == 0.  ``n_words`` is the
    *uncapped* word count (spaces + 1, reference feature_engineering.py:105).
    """
    B, L = enc.shape
    pos = np.arange(L + 1, dtype=np.int32)
    ext = np.zeros((B, L + 1), dtype=bool)
    ext[:, :L] = enc == SPACE_CODE
    ext[:, :L] &= pos[:L][None, :] < lengths[:, None]
    ext[np.arange(B), lengths] = True  # sentinel space at position len
    pos_or_big = np.where(ext, pos[None, :], _BIG)
    spos = np.sort(pos_or_big, axis=1)[:, :w_slots].astype(np.int32)
    valid = spos < _BIG
    start = np.concatenate(
        [np.zeros((B, 1), np.int32), spos[:, :-1] + 1], axis=1
    )
    wlen = np.where(valid, spos - start, 0).astype(np.int32)
    start = np.where(valid, start, 0).astype(np.int32)
    n_words = (enc == SPACE_CODE)
    n_words = (n_words & (np.arange(L)[None, :] < lengths[:, None])).sum(axis=1) + 1
    return start, wlen, n_words.astype(np.int32)


def gather_word_chars(enc: np.ndarray, start: np.ndarray, wlen: np.ndarray, wl_max: int):
    """uint8[B, W, wl_max] word characters, zero-padded."""
    B, L = enc.shape
    W = start.shape[1]
    j = np.arange(wl_max, dtype=np.int32)
    idx = np.clip(start[:, :, None] + j[None, None, :], 0, L - 1)
    chars = enc[np.arange(B)[:, None, None], idx]
    return (chars * (j[None, None, :] < wlen[:, :, None])).astype(np.uint8)


def remove_spaces_host(enc: np.ndarray, lengths: np.ndarray):
    """Stable compaction: drop spaces (and padding) from each row.

    Returns (enc_wo uint8[B, L], len_wo int32[B]).
    """
    B, L = enc.shape
    pos = np.arange(L, dtype=np.int32)[None, :]
    keep = (enc != SPACE_CODE) & (pos < lengths[:, None])
    # O(L) stable compaction: each kept char's target column is the running
    # count of kept chars before it (a per-row stable argsort is ~50x
    # slower at the 50k x 256 scale of a full stage-3 batch)
    tgt = np.cumsum(keep, axis=1, dtype=np.int32) - 1
    out = np.zeros((B, L), np.uint8)
    np.put_along_axis(out, np.where(keep, tgt, L - 1), np.where(keep, enc, 0),
                      axis=1)
    len_wo = tgt[:, -1] + 1
    return out, len_wo.astype(np.int32)


# ------------------------------------------------------------- device kernel

@jax.jit
def _features_kernel(
    q_enc: jnp.ndarray,       # uint8[B, TL]
    q_len: jnp.ndarray,       # int32[B]
    t_enc: jnp.ndarray,       # uint8[B, TL]
    t_len: jnp.ndarray,       # int32[B]
    word_chars: jnp.ndarray,  # uint8[B, W, WL]
    word_len: jnp.ndarray,    # int32[B, W]
    n_words_t: jnp.ndarray,   # int32[B] uncapped
    q_wo: jnp.ndarray,        # uint8[B, TL] query without spaces
    q_wo_len: jnp.ndarray,    # int32[B]
    word_counts: jnp.ndarray, # float32[B, W] truth-DB word document counts
    n_truth: jnp.ndarray,     # float32 scalar
) -> jnp.ndarray:
    B, W, WL = word_chars.shape
    TL = q_wo.shape[1]

    valid_word = word_len > 0                                   # (B, W)

    # ---- basic features ----
    pos_t = jax.lax.broadcasted_iota(jnp.int32, (B, q_enc.shape[1]), 1)
    n_words_q = (
        ((q_enc == SPACE_CODE) & (pos_t < q_len[:, None])).sum(axis=1) + 1
    ).astype(jnp.float32)
    lev = _floor_ratio(lcs_kernel(q_enc, q_len, t_enc, t_len), q_len + t_len)

    # ---- sliding-window LCS for every (pair, word, position) ----
    best_ratio, best_p = window_best(word_chars, word_len, q_wo, q_wo_len)
    # parity with the reference's strict '>' update (feature_engineering.py:147)
    best_ratio = jnp.maximum(best_ratio, 0.0)

    # ---- reconstructed title ----
    matched = best_ratio > 0.0
    best_win_len = jnp.clip(
        jnp.minimum(word_len, q_wo_len[:, None] - best_p), 0
    )
    rec_len = jnp.where(matched, best_win_len, 1) * valid_word   # (B, W)
    seg = rec_len + valid_word.astype(jnp.int32)                 # + joiner space
    offsets = jnp.cumsum(seg, axis=1) - seg                      # exclusive
    recon_len = jnp.maximum(seg.sum(axis=1) - 1, 0)              # drop last space
    # segment lookup: output position t belongs to the last word whose
    # segment start is ≤ t (valid words form a prefix, so the cumulative
    # indicator is monotone in w and its backward difference is a free
    # one-hot).  All per-position gathers are expressed as products over
    # the 15-word axis / a one-hot char matmul.
    t_pos = jax.lax.broadcasted_iota(jnp.int32, (B, TL), 1)
    # bfloat16 one-hot matmuls where exactness holds: the gathered values
    # (offsets ≤ TL+W, positions/lengths ≤ TL, char codes ≤ 37) are integers
    # ≤ 256, which bf16 represents exactly, and each one-hot row has a single
    # 1.0 so the f32-accumulated dot is exact.  Halves the memory traffic of
    # the fattest intermediates in the kernel ((B, TL, TL) and (B, W, TL)).
    # The float32 fallbacks ask for true f32 products (the GPU's default
    # f32 matmul runs in TF32, which would round the gathered integers).
    sel_dt = jnp.bfloat16 if TL + W <= 256 else jnp.float32
    ind = (offsets[:, :, None] <= t_pos[:, None, :]).astype(sel_dt)
    sel = ind - jnp.concatenate(                                   # (B, W, TL)
        [ind[:, 1:, :], jnp.zeros((B, 1, TL), sel_dt)], axis=1
    )                                                              # one-hot in w
    g = lambda x: jax.lax.dot_general(                             # noqa: E731
        x.astype(sel_dt)[:, None, :], sel,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=_exact_precision(sel_dt),
    )[:, 0, :]
    m_t = g(matched) > 0.5
    rl_t = g(rec_len).astype(jnp.int32)
    j_t = t_pos - g(offsets).astype(jnp.int32)
    src = jnp.clip(g(best_p).astype(jnp.int32) + j_t, 0, TL - 1)
    # char pick: one-hot over source positions as a matrix product (codes
    # ≤ 37, exact)
    ch_dt = jnp.bfloat16 if TL <= 256 else jnp.float32
    s_iota = jax.lax.broadcasted_iota(jnp.int32, (B, TL, TL), 2)
    ch_oh = (src[:, :, None] == s_iota).astype(ch_dt)              # (B, TL, TL)
    ch = jax.lax.dot_general(
        ch_oh, q_wo.astype(ch_dt),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=_exact_precision(ch_dt),
    ).astype(jnp.uint8)
    ch = jnp.where(m_t & (j_t < rl_t), ch, jnp.uint8(SPACE_CODE))
    recon = jnp.where(t_pos < recon_len[:, None], ch, jnp.uint8(0))
    recon_ratio = _floor_ratio(
        lcs_kernel(recon, recon_len, t_enc, t_len), recon_len + t_len
    )

    # ---- word IDF features ----
    nan = jnp.float32(jnp.nan)
    idf = jnp.where(
        valid_word, jnp.log(n_truth / jnp.maximum(word_counts, 1.0)), nan
    )
    idf_max = _nanmax(idf, axis=1, keepdims=True)
    ranks = 1.0 + (idf_max - idf) / n_words_t[:, None].astype(jnp.float32)

    best_ratios_f = jnp.where(valid_word, best_ratio, nan)
    word_len_f = jnp.where(valid_word, word_len.astype(jnp.float32), nan)

    basic = jnp.stack(
        [
            q_len.astype(jnp.float32),
            t_len.astype(jnp.float32),
            n_words_q,
            n_words_t.astype(jnp.float32),
            lev,
            recon_ratio,
        ],
        axis=1,
    )
    return jnp.concatenate([basic, best_ratios_f, word_len_f, idf, ranks], axis=1)


def pair_bytes(tl: int, wl: int) -> int:
    """Rough device bytes per pair of the features kernel's largest
    intermediates: the (TL, TL) char one-hot plus the window-match state
    (bit-parallel for words ≤ 32 chars, the (W, TL, WL+1) DP otherwise)."""
    window = 15 * tl * 12 if wl <= WL_BITS else 15 * tl * (wl + 1) * 8
    return 2 * tl * tl + window


def _exact_precision(dtype):
    return jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None


def window_best(word_chars, word_len, q_wo, q_wo_len):
    """Best sliding-window ratio (−1 for an empty word) and the first window
    start reaching it, for every (pair, word): (f32[B, W], i32[B, W]).

    The bit-parallel form packs a word's positions into one uint32, so word
    buckets of ≤ 32 chars take it; longer words (rare) take the DP scan."""
    if word_chars.shape[2] <= WL_BITS:
        return _window_best_bitparallel(word_chars, word_len, q_wo, q_wo_len)
    return _window_best_xla(word_chars, word_len, q_wo, q_wo_len)


def _window_best_bitparallel(word_chars, word_len, q_wo, q_wo_len):
    """Sliding-window word match for words of ≤ 32 chars, bit-parallel.

    For every (pair, word, window start p) the LCS of the word against the
    window q_wo[p : p + min(|word|, |q_wo| − p)] is computed with the
    Crochemore–Iliopoulos–Pinzón bit-vector recurrence over the word's
    positions, one uint32 ``V`` per (pair, word, p):

        V ← mask;  per window char c:  U = V & Match[c];  V = (V + U) | (V − U)
        LCS = |word| − popcount(V)

    All windows advance together: step j feeds every window its j-th char,
    so the state is (B, W, TL) uint32 over ≤ WL steps — 32× smaller than
    the DP scan's (B, W, TL, WL+1) int32.  Same outputs as
    :func:`_window_best_xla`."""
    B, W, WL = word_chars.shape
    TL = q_wo.shape[1]
    P = TL
    n_codes = len(ALPHABET)
    # match table: bit i of table[b, w, c] ⟺ word char i == c (pad c=0 never)
    codes = jnp.arange(n_codes, dtype=jnp.int32)
    i_iota = jnp.arange(WL, dtype=jnp.int32)
    eq = (
        (word_chars.astype(jnp.int32)[..., None] == codes)
        & (codes > 0)
        & (i_iota < word_len[..., None])[..., None]
    )                                                            # (B, W, WL, C)
    bit_i = (jnp.uint32(1) << i_iota.astype(jnp.uint32))[:, None]
    table = jnp.where(eq, bit_i, jnp.uint32(0)).sum(axis=2, dtype=jnp.uint32)
    # per text position a: Match[q_wo[a]] (zero past the string end), padded
    # with WL zero columns so every window's step-j slice is in range
    a_iota = jnp.arange(TL, dtype=jnp.int32)
    q_idx = jnp.where(a_iota < q_wo_len[:, None], q_wo.astype(jnp.int32), 0)
    mq = jnp.take_along_axis(
        table, jnp.broadcast_to(q_idx[:, None, :], (B, W, TL)), axis=2
    )
    mq = jnp.concatenate([mq, jnp.zeros((B, W, WL), jnp.uint32)], axis=2)

    wlen = jnp.minimum(word_len, WL_BITS)
    wmask = jnp.where(
        wlen >= 32, jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << jnp.minimum(wlen, 31).astype(jnp.uint32)) - 1,
    )[:, :, None]                                                # (B, W, 1)
    p_iota = jnp.arange(P, dtype=jnp.int32)
    win_len = jnp.clip(
        jnp.minimum(word_len[:, :, None], q_wo_len[:, None, None] - p_iota), 0
    )                                                            # (B, W, P)

    def step(j, v):
        m = jax.lax.dynamic_slice_in_dim(mq, j, P, axis=2)
        u = v & m
        nv = ((v + u) | (v - u)) & wmask
        return jnp.where(j < win_len, nv, v)

    v = jax.lax.fori_loop(0, WL, step, jnp.broadcast_to(wmask, (B, W, P)))
    lcs = word_len[:, :, None] - jax.lax.population_count(v).astype(jnp.int32)
    total = (word_len[:, :, None] + win_len).astype(jnp.float32)
    ratio = jnp.floor(200.0 * lcs.astype(jnp.float32) / jnp.maximum(total, 1.0))
    valid = (p_iota < q_wo_len[:, None, None]) & (word_len > 0)[:, :, None]
    ratio = jnp.where(valid, ratio, -1.0)
    return jnp.max(ratio, axis=2), jnp.argmax(ratio, axis=2).astype(jnp.int32)


def _window_best_xla(word_chars, word_len, q_wo, q_wo_len):
    """DP-scan formulation of the sliding-window match (any word length;
    the reference for :func:`_window_best_bitparallel`)."""
    B, W, WL = word_chars.shape
    TL = q_wo.shape[1]
    P = TL
    valid_word = word_len > 0

    p_iota = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)     # (B, P)
    j_iota = jax.lax.broadcasted_iota(jnp.int32, (P, WL), 1)    # (P, WL)
    pj = jax.lax.broadcasted_iota(jnp.int32, (P, WL), 0) + j_iota  # p + j
    pj_clip = jnp.minimum(pj, TL - 1)
    # window chars wc[b, p, j] = q_wo[b, p+j], zeroed past the string end
    wc = (q_wo[:, pj_clip] * (pj < q_wo_len[:, None, None])).astype(jnp.uint8)  # (B, P, WL)

    win_len = jnp.clip(
        jnp.minimum(word_len[:, :, None], q_wo_len[:, None, None] - p_iota[:, None, :]),
        0,
    )                                                            # (B, W, P)
    win_valid = (p_iota[:, None, :] < q_wo_len[:, None, None]) & valid_word[:, :, None]

    # window char j participates only when j < win_len (the reference's
    # window is q_wo[p : p + word_len], truncated at the string end)
    j_in_window = jnp.arange(WL, dtype=jnp.int32) < win_len[..., None]  # (B, W, P, WL)

    def dp_step(dp, i):
        ai = jax.lax.dynamic_index_in_dim(word_chars, i, axis=2, keepdims=False)  # (B, W)
        valid_i = i < word_len                                   # (B, W)
        eq = (wc[:, None, :, :] == ai[:, :, None, None]) & (wc[:, None, :, :] > 0)
        eq = (eq & j_in_window & valid_i[:, :, None, None]).astype(jnp.int32)  # (B, W, P, WL)
        cand = jnp.maximum(dp[..., 1:], dp[..., :-1] + eq)
        new = jax.lax.cummax(cand, axis=3)
        new = jnp.concatenate([jnp.zeros((B, W, P, 1), jnp.int32), new], axis=-1)
        return jnp.where(valid_i[:, :, None, None], new, dp), None

    dp0 = jnp.zeros((B, W, P, WL + 1), jnp.int32)
    dp, _ = jax.lax.scan(dp_step, dp0, jnp.arange(WL))
    # LCS of word vs window = running max at the last column (row is
    # non-decreasing, so the value at column WL equals the value at win_len)
    lcs_wp = dp[..., WL]                                         # (B, W, P)

    total_wp = (word_len[:, :, None] + win_len).astype(jnp.float32)
    ratio_wp = jnp.floor(200.0 * lcs_wp.astype(jnp.float32) / jnp.maximum(total_wp, 1.0))
    ratio_wp = jnp.where(win_valid, ratio_wp, -1.0)

    best_ratio = jnp.max(ratio_wp, axis=2)                       # (B, W)
    best_p = jnp.argmax(ratio_wp, axis=2).astype(jnp.int32)      # first max
    return best_ratio, best_p


def _floor_ratio(lcs: jnp.ndarray, total: jnp.ndarray) -> jnp.ndarray:
    total_f = total.astype(jnp.float32)
    return jnp.floor(
        jnp.where(total_f > 0, 200.0 * lcs.astype(jnp.float32) / jnp.maximum(total_f, 1.0), 100.0)
    )


def _nanmax(x: jnp.ndarray, axis: int, keepdims: bool) -> jnp.ndarray:
    big_neg = jnp.float32(-jnp.inf)
    m = jnp.max(jnp.where(jnp.isnan(x), big_neg, x), axis=axis, keepdims=keepdims)
    all_nan = jnp.all(jnp.isnan(x), axis=axis, keepdims=keepdims)
    return jnp.where(all_nan, jnp.float32(jnp.nan), m)


# ------------------------------------------------- resident pair features

@partial(jax.jit, static_argnames=("tl", "wl"))
def _pair_features_kernel(
    q_enc, q_len, q_wo, q_wo_len,              # (U, L) resident query side
    t_enc, t_len, t_wchars, t_start, t_wlen, t_nwords, t_counts,  # resident truth
    pairs,                                      # int32[2, B] (q row, truth row)
    n_truth,
    *, tl: int, wl: int,
):
    """66-dim features for B (query row, truth row) index pairs, everything
    gathered on device from resident tables — the training analogue of the
    fused rerank kernel (per chunk only one (2, B) int32 buffer goes up and
    one (B, 66) float32 matrix comes down, instead of ~750 B/pair of
    pre-gathered char tensors)."""
    from doppelspeller.ops.rerank import _word_chars

    pair_q = pairs[0]
    pair_t = pairs[1]
    chars = _word_chars(t_wchars, t_start, t_wlen, t_enc, pair_t, wl)
    return _features_kernel(
        q_enc[pair_q][:, :tl], q_len[pair_q],
        t_enc[pair_t][:, :tl], jnp.maximum(t_len[pair_t], 1),
        chars, t_wlen[pair_t], jnp.maximum(t_nwords[pair_t], 1),
        q_wo[pair_q][:, :tl], jnp.maximum(q_wo_len[pair_q], 1),
        t_counts[pair_t].astype(jnp.float32), n_truth,
    )


def features_for_pairs(
    pair_q: np.ndarray,        # int[M] indices into the unique query rows
    pair_t: np.ndarray,        # int[M] truth row positions
    q_enc: np.ndarray,         # uint8[U, L] unique query encodings
    q_len: np.ndarray,         # int32[U]
    truth_enc: np.ndarray,     # uint8[T, L]
    truth_len: np.ndarray,     # int32[T]
    counts_matrix: np.ndarray, # uint32[T, W] truth-DB word document counts
    config: Optional[Config] = None,
) -> np.ndarray:
    """float32[M, 66] features via the resident-gather path (training-side
    twin of the rerank engine; reference feature_engineering.py:322-378).

    The query/truth tables go to the device ONCE; per chunk only the pair
    index buffer is transferred."""
    cfg = config or get_config()
    n = len(pair_q)
    out = np.zeros((n, FEATURES_COUNT), dtype=np.float32)
    if n == 0:
        return out
    pair_q = np.asarray(pair_q, dtype=np.int32)
    pair_t = np.asarray(pair_t, dtype=np.int32)

    q_wo, q_wo_len = remove_spaces_host(q_enc, q_len)
    start, wlen, nwords = split_words_host(truth_enc, truth_len)
    wchars = gather_word_chars(truth_enc, start, wlen, 32)
    wlen_max = wlen.max(axis=1)

    dev = (
        jnp.asarray(q_enc), jnp.asarray(q_len.astype(np.int32)),
        jnp.asarray(q_wo), jnp.asarray(q_wo_len),
        jnp.asarray(truth_enc), jnp.asarray(truth_len.astype(np.int32)),
        jnp.asarray(wchars), jnp.asarray(start), jnp.asarray(wlen),
        jnp.asarray(nwords), jnp.asarray(counts_matrix.astype(np.float32)),
    )
    n_truth_d = jnp.float32(truth_enc.shape[0])

    L = q_enc.shape[1]
    pair_len = np.maximum(q_len[pair_q], truth_len[pair_t])
    buckets = [b for b in cfg.length_buckets if b < L] + [L]
    w_buckets = [b for b in (8, 16, 32, 64) if b < L] + [L]
    tb_idx = np.searchsorted(np.asarray(buckets), np.minimum(pair_len, L))
    wb_idx = np.searchsorted(np.asarray(w_buckets),
                             np.maximum(wlen_max[pair_t], 1))
    # a word is a substring of its title, so WL bucket <= TL bucket holds for
    # the current grids — clamp anyway so a future grid change cannot open a
    # dispatch hole (the stage-3 loop only visits WL <= TL cells)
    ti_min_for_w = np.searchsorted(np.asarray(buckets), np.asarray(w_buckets))
    tb_idx = np.maximum(tb_idx, ti_min_for_w[wb_idx])

    n_dispatched = 0
    pending = []
    for ti, TL in enumerate(buckets):
        for wi, WL in enumerate(w_buckets):
            if WL > TL:
                continue
            sel = np.flatnonzero((tb_idx == ti) & (wb_idx == wi))
            if len(sel) == 0:
                continue
            chunk = int(np.clip((1 << 28) // pair_bytes(TL, WL), 64, 4096))
            for s in range(0, len(sel), chunk):
                idx = sel[s : s + chunk]
                pad = chunk - len(idx)
                pq = np.concatenate([pair_q[idx], np.zeros(pad, np.int32)])
                pt = np.concatenate([pair_t[idx], np.zeros(pad, np.int32)])
                feats = _pair_features_kernel(
                    *dev, jnp.asarray(np.stack([pq, pt])), n_truth_d,
                    tl=TL, wl=WL,
                )
                pending.append((idx, len(idx), feats))
                n_dispatched += len(idx)
    assert n_dispatched == n, f"pair dispatch hole: {n_dispatched} != {n}"
    # ONE batched fetch: the device->host copies of all chunks overlap
    vals = jax.device_get([f for _, _, f in pending])
    for (idx, m, _), v in zip(pending, vals):
        out[idx] = v[:m]
    return out


# ---------------------------------------------------------------- host entry

def construct_features(
    q_enc: np.ndarray,
    q_len: np.ndarray,
    t_enc: np.ndarray,
    t_len: np.ndarray,
    word_counts: np.ndarray,
    n_truth: int,
    config: Optional[Config] = None,
    *,
    t_words=None,       # optional precomputed (start, wlen, n_words_t)
    q_wo_pre=None,      # optional precomputed (q_wo, q_wo_len)
) -> np.ndarray:
    """Compute float32[N, 66] features for N (query, candidate) pairs.

    ``word_counts`` is uint32[N, 15]: truth-DB document counts of the first
    15 candidate words (reference feature_engineering.py:309-319).
    Callers scoring many pairs against the same truth/query rows should pass
    pre-gathered ``t_words``/``q_wo_pre`` (see pipeline.Matcher).

    All device chunks are dispatched before any result is fetched, so the
    device pipeline stays full while the host gathers the next chunk.
    """
    cfg = config or get_config()
    n = len(q_len)
    q_len = np.asarray(q_len, dtype=np.int32)
    t_len = np.asarray(t_len, dtype=np.int32)
    out = np.zeros((n, FEATURES_COUNT), dtype=np.float32)

    # host prep (vectorized numpy)
    if t_words is None:
        start, wlen, n_words_t = split_words_host(t_enc, t_len)
    else:
        start, wlen, n_words_t = t_words
    if q_wo_pre is None:
        q_wo, q_wo_len = remove_spaces_host(q_enc, q_len)
    else:
        q_wo, q_wo_len = q_wo_pre

    max_word = wlen.max(axis=1)
    pair_len = np.maximum(q_len, t_len)
    buckets = [b for b in cfg.length_buckets if b < q_enc.shape[1]] + [q_enc.shape[1]]
    w_buckets = [8, 16, 32, 64, q_enc.shape[1]]
    tb_idx = np.searchsorted(np.asarray(buckets), pair_len)
    wb_idx = np.searchsorted(np.asarray(w_buckets), np.maximum(max_word, 1))

    pending = []
    for ti, TL in enumerate(buckets):
        for wi, WL in enumerate(w_buckets):
            if WL > TL:
                continue
            sel = np.flatnonzero((tb_idx == ti) & (wb_idx == wi))
            if len(sel) == 0:
                continue
            # chunk size bounded by the DP-state footprint (B·15·TL·WL·4B)
            chunk = int(np.clip((1 << 22) // (TL * WL), 64, cfg.pair_block))
            wchars = gather_word_chars(t_enc[sel], start[sel], wlen[sel], WL)
            for s in range(0, len(sel), chunk):
                idx = sel[s : s + chunk]
                m = len(idx)
                pad = chunk - m

                def pad2(x, fill=0):
                    if pad == 0:
                        return x
                    shape = (pad,) + x.shape[1:]
                    return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=0)

                feats = _features_kernel(
                    jnp.asarray(pad2(q_enc[idx, :TL])),
                    jnp.asarray(pad2(q_len[idx])),
                    jnp.asarray(pad2(t_enc[idx, :TL])),
                    jnp.asarray(pad2(np.maximum(t_len[idx], 1))),
                    jnp.asarray(pad2(wchars[s : s + chunk])),
                    jnp.asarray(pad2(wlen[idx])),
                    jnp.asarray(pad2(np.maximum(n_words_t[idx], 1))),
                    jnp.asarray(pad2(q_wo[idx, :TL])),
                    jnp.asarray(pad2(np.maximum(q_wo_len[idx], 1))),
                    jnp.asarray(pad2(word_counts[idx].astype(np.float32))),
                    jnp.float32(n_truth),
                )
                pending.append((idx, m, feats))
    for idx, m, feats in pending:
        out[idx] = np.asarray(feats[:m])
    return out
