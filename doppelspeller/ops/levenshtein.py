"""Batched Levenshtein-ratio (indel/LCS) kernels.

Replacement for the reference's numba DP kernel
``fast_levenshtein_ratio`` (feature_engineering.py:25-63) and the
python-Levenshtein C ``ratio`` (common.py:161-167).

Key identity: the reference DP uses substitution cost 2 and ins/del cost 1 —
the *indel* distance — and indel(a, b) = |a| + |b| − 2·LCS(a, b), so

    ratio(a, b) = 100 · 2 · LCS(a, b) / (|a| + |b|).

We therefore compute LCS length with a scan over the rows of the DP matrix
where each row update is expressed as a **cummax** (runs on the VPU with no
sequential inner loop):

    row_i[j] = cummax_j( max(row_{i-1}[j], row_{i-1}[j-1] + eq[i, j]) )

This is exact: LCS satisfies dp[i][j] = max(dp[i-1][j], dp[i][j-1],
dp[i-1][j-1] + eq), and unrolling the dp[i][j-1] term yields a running max.
Batched over pairs, padded/masked to static length buckets.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from doppelspeller.config import Config, get_config

_BUCKETS = (32, 64, 128, 256)


@jax.jit
def lcs_kernel(a: jnp.ndarray, la: jnp.ndarray, b: jnp.ndarray, lb: jnp.ndarray) -> jnp.ndarray:
    """LCS length for each pair — bit-parallel CIP over uint32 words.

    a: uint8[B, La] (zero-padded), la: int32[B]; likewise b/lb.
    Returns int32[B].  The DP column over `a`'s positions is packed into
    ⌈La/32⌉ uint32 words; one update per `b` char with explicit carry/borrow
    chains across words:  U = V & M[c];  V = ((V+U) | (V−U)) & mask.
    """
    B, La = a.shape
    Lb = b.shape[1]
    n_words = (La + 31) // 32
    if La % 32:  # pad the bit axis to whole words
        a = jnp.concatenate(
            [a, jnp.zeros((B, n_words * 32 - La), a.dtype)], axis=1
        )
        La = n_words * 32

    pos = jnp.arange(La, dtype=jnp.int32)
    a_valid = (pos[None, :] < la[:, None]) & (a > 0)
    b_pos = jnp.arange(Lb, dtype=jnp.int32)
    b_valid = (b_pos[None, :] < lb[:, None]) & (b > 0)

    # match masks: M[b_i, j, w] = bits i (within word w) where a[b_i,i]==b[b_i,j]
    eq = (a[:, None, :] == b[:, :, None]) & a_valid[:, None, :] & b_valid[:, :, None]
    pow2 = (jnp.uint32(1) << (pos % 32).astype(jnp.uint32))  # (La,)
    eq_w = eq.astype(jnp.uint32) * pow2[None, None, :]
    M = eq_w.reshape(B, Lb, n_words, -1).sum(axis=3, dtype=jnp.uint32)  # (B,Lb,W)

    word_pos = pos.reshape(n_words, -1)
    mask_a = (
        ((word_pos[None, :, :] < la[:, None, None]).astype(jnp.uint32)
         * pow2.reshape(1, n_words, -1)).sum(axis=2, dtype=jnp.uint32)
    )                                                       # (B, n_words)

    def step(V, M_j):
        U = [V[k] & M_j[:, k] for k in range(n_words)]
        # V + U with carry chain
        S = []
        carry = jnp.zeros((B,), jnp.uint32)
        for k in range(n_words):
            s1 = V[k] + U[k]
            c1 = (s1 < V[k]).astype(jnp.uint32)
            s2 = s1 + carry
            c2 = (s2 < s1).astype(jnp.uint32)
            S.append(s2)
            carry = c1 | c2
        # V − U with borrow chain
        D = []
        borrow = jnp.zeros((B,), jnp.uint32)
        for k in range(n_words):
            d1 = V[k] - U[k]
            b1 = (V[k] < U[k]).astype(jnp.uint32)
            d2 = d1 - borrow
            b2 = (d1 < borrow).astype(jnp.uint32)
            D.append(d2)
            borrow = b1 | b2
        newV = [(S[k] | D[k]) & mask_a[:, k] for k in range(n_words)]
        return tuple(newV), None

    V0 = tuple(mask_a[:, k] for k in range(n_words))
    V, _ = jax.lax.scan(step, V0, jnp.moveaxis(M, 1, 0))   # scan over b chars
    zeros = sum(
        jax.lax.population_count(V[k]).astype(jnp.int32) for k in range(n_words)
    )
    # LCS = |a| − #ones(V): V starts at mask (popcount la) and loses one bit
    # per matched char
    la_eff = jnp.minimum(la, La)
    return la_eff - zeros


@jax.jit
def lcs_kernel_scan(a: jnp.ndarray, la: jnp.ndarray, b: jnp.ndarray, lb: jnp.ndarray) -> jnp.ndarray:
    """Reference formulation: LCS via cummax row scan (used by tests to
    cross-check the bit-parallel kernel)."""
    B, La = a.shape
    Lb = b.shape[1]
    col = jax.lax.broadcasted_iota(jnp.int32, (B, Lb), 1)
    b_valid = col < lb[:, None]

    def row_step(dp, ai_and_valid):
        ai, valid_i = ai_and_valid
        eq = ((b == ai[:, None]) & b_valid).astype(jnp.int32)
        cand = jnp.maximum(dp[:, 1:], dp[:, :-1] + eq)
        new_core = jax.lax.cummax(cand, axis=1)
        new = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), new_core], axis=1)
        dp = jnp.where(valid_i[:, None], new, dp)
        return dp, None

    dp0 = jnp.zeros((B, Lb + 1), jnp.int32)
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (La, 1), 0)[:, 0]
    valid = row_ids[:, None] < la[None, :]          # (La, B)
    dp, _ = jax.lax.scan(row_step, dp0, (a.T, valid))
    return dp[:, Lb]


@jax.jit
def ratio_kernel(a: jnp.ndarray, la: jnp.ndarray, b: jnp.ndarray, lb: jnp.ndarray) -> jnp.ndarray:
    """Unrounded ratio·100 ∈ [0, 100] float32 for each pair."""
    lcs = lcs_kernel(a, la, b, lb)
    total = (la + lb).astype(jnp.float32)
    return jnp.where(total > 0, 200.0 * lcs.astype(jnp.float32) / total, 100.0)


def _bucket_of(n: int, buckets: Tuple[int, ...]) -> int:
    for bkt in buckets:
        if n <= bkt:
            return bkt
    return buckets[-1]


def batched_ratio(
    enc_a: np.ndarray,
    len_a: np.ndarray,
    enc_b: np.ndarray,
    len_b: np.ndarray,
    config: Optional[Config] = None,
) -> np.ndarray:
    """Host wrapper: unrounded float32 ratios for N pairs, any lengths ≤ 256.

    Pairs are grouped into static length buckets (max of the two lengths) and
    padded to fixed chunk sizes so XLA compiles at most |buckets| programs.
    Callers apply the reference's integer semantics:
    ``np.round`` (banker's, = python-Levenshtein int(round(x)), common.py:162)
    or ``np.floor`` (numba's float→uint8 cast, feature_engineering.py:25).
    """
    cfg = config or get_config()
    n = len(len_a)
    len_a = np.asarray(len_a, dtype=np.int32)
    len_b = np.asarray(len_b, dtype=np.int32)
    out = np.zeros(n, dtype=np.float32)
    pair_len = np.maximum(len_a, len_b)
    buckets = [b for b in cfg.length_buckets if b < enc_a.shape[1]] + [enc_a.shape[1]]
    bucket_idx = np.searchsorted(np.asarray(buckets), pair_len)
    pending = []
    for bi, bkt in enumerate(buckets):
        sel = np.flatnonzero(bucket_idx == bi)
        if len(sel) == 0:
            continue
        # bound the (B, Lb, La) match-mask tensor of the bit-parallel kernel
        chunk = int(np.clip((1 << 25) // (bkt * bkt), 64, cfg.pair_block))
        for start in range(0, len(sel), chunk):
            idx = sel[start : start + chunk]
            m = len(idx)
            a = np.zeros((chunk, bkt), dtype=np.uint8)
            b = np.zeros((chunk, bkt), dtype=np.uint8)
            a[:m] = enc_a[idx, :bkt]
            b[:m] = enc_b[idx, :bkt]
            la = np.zeros(chunk, dtype=np.int32)
            lb = np.zeros(chunk, dtype=np.int32)
            la[:m] = np.minimum(len_a[idx], bkt)
            lb[:m] = np.minimum(len_b[idx], bkt)
            r = ratio_kernel(jnp.asarray(a), jnp.asarray(la), jnp.asarray(b), jnp.asarray(lb))
            pending.append((idx, m, r))
    for idx, m, r in pending:
        out[idx] = np.asarray(r)[:m]
    return out


def ratio_rounded(
    enc_a: np.ndarray, len_a: np.ndarray, enc_b: np.ndarray, len_b: np.ndarray,
    config: Optional[Config] = None,
) -> np.ndarray:
    """int ratios with banker's rounding — parity with common.py:161-162."""
    return np.round(batched_ratio(enc_a, len_a, enc_b, len_b, config)).astype(np.int32)
