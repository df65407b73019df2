"""The sliding-window word match behind the word features (66-dim layout
[6:21]): the bit-parallel form (words of ≤ 32 chars) and the DP scan
(longer words) against a pure-Python oracle of the reference semantics
(feature_engineering.py:120-147): for each window start p of the spaceless
query, ratio = floor(200·LCS(q_wo[p:p+|w|], w) / (|window| + |w|)), best =
the max over p, and the reported start is the FIRST p reaching it."""

import numpy as np
import pytest

import jax.numpy as jnp

from doppelspeller.ops.features import (
    _window_best_bitparallel,
    _window_best_xla,
    gather_word_chars,
    remove_spaces_host,
    split_words_host,
    window_best,
)
from doppelspeller.utils import text as T


def _lcs(a: str, b: str) -> int:
    dp = [0] * (len(b) + 1)
    for ca in a:
        prev = 0
        for j, cb in enumerate(b, 1):
            cur = dp[j]
            dp[j] = max(dp[j], dp[j - 1], prev + (ca == cb))
            prev = cur
    return dp[len(b)]


def _oracle(q_wo: str, word: str):
    """(best ratio, first best window start); (-1, 0) for no window."""
    best, best_p = -1.0, 0
    if not word:
        return best, best_p
    for p in range(len(q_wo)):
        win = q_wo[p : p + len(word)]
        r = float(int(200 * _lcs(win, word) / (len(win) + len(word))))
        if r > best:
            best, best_p = r, p
    return best, best_p


def _run(fn, pairs, TL, WL):
    q = [a for a, _ in pairs]
    t = [b for _, b in pairs]
    L = 255
    q_enc, t_enc = T.encode_titles(q, L), T.encode_titles(t, L)
    q_len = np.array([len(s) for s in q], np.int32)
    t_len = np.array([len(s) for s in t], np.int32)
    start, wlen, _ = split_words_host(t_enc, t_len)
    q_wo, q_wo_len = remove_spaces_host(q_enc, q_len)
    wchars = gather_word_chars(t_enc, start, wlen, WL)
    r, p = fn(jnp.asarray(wchars), jnp.asarray(wlen), jnp.asarray(q_wo[:, :TL]),
              jnp.asarray(np.maximum(q_wo_len, 1)))
    return np.asarray(r), np.asarray(p)


def _check(pairs, r, p):
    for i, (q, t) in enumerate(pairs):
        q_wo = q.replace(" ", "")
        words = t.split(" ")[:15]
        for k in range(15):
            want = _oracle(q_wo, words[k]) if k < len(words) else (-1.0, 0)
            assert (r[i, k], p[i, k]) == want, (q, t, k)


PAIRS = [
    ("coolblue bv", "coolblue bv"),
    ("coolbluebv", "coolblue bv"),
    ("internationalhouse newcastle", "international house newcastle"),
    ("heyside crick et club", "heyside cricket club"),
    ("zzz qqq", "coolblue bv"),
    ("abc", "abc holdings 42"),
    # ties: several window starts reach the same best ratio
    ("ab ab ab ab", "ab ba"),
    ("aaaaaaaa", "aa a aaa"),
    ("a b c d e f g", "aa bb cc dd ee ff gg hh ii jj kk ll mm nn oo pp"),
]


def _pairs_for(TL, WL, rng):
    """Hand pairs cut to the tile plus random pairs whose longest word
    fills the WL bucket."""
    out = [(a[:TL].strip() or "a", b[:TL].strip() or "a") for a, b in PAIRS
           if max(map(len, b.split())) <= WL]
    alpha = "abcdefgh"
    for _ in range(6):
        lw = rng.randint(max(WL // 2, 1), WL + 1)
        word = "".join(rng.choice(list(alpha), lw))
        other = "".join(rng.choice(list(alpha), rng.randint(1, 6)))
        t = f"{word} {other}"[:TL].strip()
        q = "".join(rng.choice(list(alpha + " "), rng.randint(1, TL))).strip() or "a"
        out.append((q, t))
    return out


@pytest.mark.parametrize("TL,WL", [(32, 8), (32, 16), (32, 32), (64, 16),
                                   (64, 32), (64, 64), (128, 64)])
def test_window_best_matches_oracle(TL, WL):
    """window_best (bit-parallel at WL ≤ 32, DP scan above) equals the
    oracle, ties included."""
    pairs = _pairs_for(TL, WL, np.random.RandomState(TL + WL))
    r, p = _run(window_best, pairs, TL, WL)
    _check(pairs, r, p)


@pytest.mark.parametrize("TL,WL", [(32, 8), (64, 32)])
def test_bitparallel_equals_dp_scan_random(TL, WL):
    """Both forms agree on random code tensors, including empty words,
    words longer than the remaining query, and the 32-bit full mask."""
    rng = np.random.RandomState(TL * WL)
    B = 29
    q_wo = rng.randint(2, 8, (B, TL)).astype(np.uint8)
    q_wo_len = rng.randint(1, TL + 1, B).astype(np.int32)
    wlen = rng.randint(0, WL + 1, (B, 15)).astype(np.int32)
    wlen[:, 7:] = 0
    wlen[0, 0] = WL
    wchars = (rng.randint(2, 8, (B, 15, WL)) *
              (np.arange(WL) < wlen[:, :, None])).astype(np.uint8)
    args = [jnp.asarray(x) for x in (wchars, wlen, q_wo, q_wo_len)]
    r_b, p_b = _window_best_bitparallel(*args)
    r_x, p_x = _window_best_xla(*args)
    np.testing.assert_array_equal(np.asarray(r_b), np.asarray(r_x))
    np.testing.assert_array_equal(np.asarray(p_b), np.asarray(p_x))
