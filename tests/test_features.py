"""66-dim feature kernel parity vs an independent pure-Python oracle.

The oracle follows the reference semantics of construct_features
(feature_engineering.py:66-169) — floor-truncated ratios, first-max window
selection, space-joined reconstruction, NaN padding — implemented from the
spec, not from the kernel.
"""

import math
import random
import string

import numpy as np
import pytest

from doppelspeller.config import Config
from doppelspeller.ops.features import (
    FEATURES_COUNT,
    construct_features,
    remove_spaces_host,
    split_words_host,
)
from doppelspeller.utils import text as T


def _lcs(a: str, b: str) -> int:
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return 0
    dp = [0] * (n + 1)
    for i in range(1, m + 1):
        prev = 0
        for j in range(1, n + 1):
            tmp = dp[j]
            dp[j] = max(dp[j], dp[j - 1], prev + (1 if a[i - 1] == b[j - 1] else 0))
            prev = tmp
    return dp[n]


def _floor_ratio(a: str, b: str) -> float:
    total = len(a) + len(b)
    if total == 0:
        return 100.0
    return float(int(200 * _lcs(a, b) / total))


def oracle_features(q: str, t: str, counts, n_truth: int) -> np.ndarray:
    W = 15
    nan = float("nan")
    q_words = q.count(" ") + 1
    t_words = t.count(" ") + 1
    lev = _floor_ratio(q, t)
    q_wo = q.replace(" ", "")
    words = t.split(" ")[:W]

    best_ratios = [nan] * W
    wlens = [nan] * W
    idfs = [nan] * W
    recon_parts = []
    for k, w in enumerate(words):
        best, best_match = 0, " "
        for p in range(len(q_wo)):
            win = q_wo[p : p + len(w)]
            r = int(200 * _lcs(win, w) / (len(win) + len(w)))
            if r > best:
                best, best_match = r, win
        best_ratios[k] = float(best)
        wlens[k] = float(len(w))
        idfs[k] = math.log(n_truth / counts[k])
        recon_parts.append(best_match)
    recon = " ".join(recon_parts)
    recon_ratio = _floor_ratio(recon, t)
    idf_max = np.nanmax(np.array(idfs, dtype=np.float64))
    ranks = [1.0 + (idf_max - v) / t_words for v in idfs]
    out = np.array(
        [len(q), len(t), q_words, t_words, lev, recon_ratio]
        + best_ratios + wlens + idfs + ranks,
        dtype=np.float32,
    )
    return out


def _prep(pairs, truth_titles, cfg):
    """pairs: list of (query_transformed, truth_transformed)."""
    counter = T.get_words_counter([t.split() for t in truth_titles])
    n_truth = len(truth_titles)
    q_enc = T.encode_titles([p[0] for p in pairs], cfg.max_characters)
    t_enc = T.encode_titles([p[1] for p in pairs], cfg.max_characters)
    q_len = np.array([len(p[0]) for p in pairs], dtype=np.int32)
    t_len = np.array([len(p[1]) for p in pairs], dtype=np.int32)
    counts = np.zeros((len(pairs), 15), dtype=np.uint32)
    for i, (_, t) in enumerate(pairs):
        for k, w in enumerate(t.split()[:15]):
            counts[i, k] = counter[w]
    return q_enc, q_len, t_enc, t_len, counts, n_truth, counter


TRUTH = [
    "coolblue bv",
    "international house newcastle",
    "heyside cricket club",
    "the coolblue group",
    "abc holdings 42",
    "newcastle international airport",
]


def test_split_words_host():
    cfg = Config(data_path="/tmp/x")
    enc = T.encode_titles(["ab cd e", "xyz"], cfg.max_characters)
    lens = np.array([7, 3], dtype=np.int32)
    start, wlen, n_words = split_words_host(enc, lens)
    assert n_words.tolist() == [3, 1]
    assert start[0, :3].tolist() == [0, 3, 6]
    assert wlen[0, :3].tolist() == [2, 2, 1]
    assert wlen[0, 3:].sum() == 0
    assert wlen[1, 0] == 3 and wlen[1, 1:].sum() == 0


def test_remove_spaces_host():
    cfg = Config(data_path="/tmp/x")
    enc = T.encode_titles(["ab cd e"], cfg.max_characters)
    out, lens = remove_spaces_host(enc, np.array([7], dtype=np.int32))
    assert lens[0] == 5
    assert T.decode_title(out[0]) == "abcde"


@pytest.mark.parametrize(
    "query,truth",
    [
        ("coolblue bv", "coolblue bv"),              # identical
        ("coolbluebv", "coolblue bv"),               # missing space
        ("internationalhouse newcastle", "international house newcastle"),
        ("heyside crick et club", "heyside cricket club"),
        ("zzz qqq", "coolblue bv"),                  # no match at all
        ("abc", "abc holdings 42"),                  # query shorter than truth
        ("the coolblue group bv extra words here", "the coolblue group"),
    ],
)
def test_feature_parity_hand_cases(query, truth):
    cfg = Config(data_path="/tmp/x", pair_block=256)
    pairs = [(T.transform_title(query), T.transform_title(truth))]
    q_enc, q_len, t_enc, t_len, counts, n_truth, _ = _prep(pairs, TRUTH, cfg)
    got = construct_features(q_enc, q_len, t_enc, t_len, counts, n_truth, cfg)
    want = oracle_features(pairs[0][0], pairs[0][1], counts[0], n_truth)
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5, equal_nan=True)


def test_feature_parity_random_pairs():
    rng = random.Random(3)
    alphabet = string.ascii_lowercase[:8] + "  01"
    truth_titles = []
    for _ in range(30):
        ln = rng.randint(5, 50)
        t = T.transform_title("".join(rng.choice(alphabet) for _ in range(ln)))
        truth_titles.append(t)
    pairs = []
    for _ in range(40):
        t = rng.choice(truth_titles)
        ln = rng.randint(3, 45)
        q = T.transform_title("".join(rng.choice(alphabet) for _ in range(ln)))
        pairs.append((q, t))
    # also near-duplicates
    for i in range(5):
        t = truth_titles[i]
        q = T.transform_title(t[: max(3, len(t) - 2)])
        pairs.append((q, t))

    cfg = Config(data_path="/tmp/x", pair_block=256)
    q_enc, q_len, t_enc, t_len, counts, n_truth, _ = _prep(pairs, truth_titles, cfg)
    got = construct_features(q_enc, q_len, t_enc, t_len, counts, n_truth, cfg)
    assert got.shape == (len(pairs), FEATURES_COUNT)
    for i, (q, t) in enumerate(pairs):
        want = oracle_features(q, t, counts[i], n_truth)
        np.testing.assert_allclose(
            got[i], want, rtol=1e-5, atol=1e-5, equal_nan=True,
            err_msg=f"pair {i}: q={q!r} t={t!r}",
        )


def test_many_words_title():
    # >15 words: only the first 15 get word features
    truth = " ".join(["w%d" % i for i in range(20)])
    truth = T.transform_title(truth)
    query = T.transform_title("w1 w2 w3")
    cfg = Config(data_path="/tmp/x", pair_block=64)
    pairs = [(query, truth)]
    q_enc, q_len, t_enc, t_len, counts, n_truth, _ = _prep(pairs, [truth], cfg)
    got = construct_features(q_enc, q_len, t_enc, t_len, counts, n_truth, cfg)
    want = oracle_features(query, truth, counts[0], n_truth)
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5, equal_nan=True)
    assert got[0, 3] == 20.0  # uncapped word count
    assert not np.isnan(got[0, 6 + 14])  # 15th word has features


def test_encoded_wo_equals_remove_spaces_host():
    """TitleSet.encoded_wo (string-codec path, built lazily once) must equal
    the vectorized window compaction of the encoded matrix — stage 3 relies
    on them interchangeably."""
    from doppelspeller.config import Config
    from doppelspeller.ops.features import remove_spaces_host
    from doppelspeller.utils.io import TitleSet

    cfg = Config(max_characters=32)  # force truncation on the long title
    ts = TitleSet.from_titles(
        ["  Some Big Corp LTD!!", "a b c d", "nospaces",
         "a really long title with many words that truncates somewhere"],
        config=cfg,
    )
    enc_wo, len_wo = ts.encoded_wo
    ref_enc, ref_len = remove_spaces_host(ts.encoded, ts.lengths)
    assert np.array_equal(len_wo, ref_len)
    assert np.array_equal(enc_wo, ref_enc)


@pytest.mark.heavy
def test_features_for_pairs_matches_construct_features():
    """The resident-gather pair path (training hot path) must produce the
    same 66-dim features as the host-shipped construct_features path for
    identical (query, truth-row) pairs."""
    from doppelspeller.ops.features import features_for_pairs

    rng = random.Random(7)
    words = ["alpha", "betaworks", "gamma", "deltacorp", "epsilon",
             "zetaholdings", "eta", "thetaventures"]

    def title(n):
        return " ".join(rng.choice(words) for _ in range(n))

    truth_titles = [T.transform_title(title(rng.randint(1, 6))) for _ in range(40)]
    q_titles = [T.transform_title(title(rng.randint(1, 5))) for _ in range(25)]
    cfg = Config(data_path="/tmp/x", pair_block=64)
    L = cfg.max_characters
    t_enc = T.encode_titles(truth_titles, L)
    t_len = np.array([min(len(t), L) for t in truth_titles], np.int32)
    q_enc = T.encode_titles(q_titles, L)
    q_len = np.array([min(len(t), L) for t in q_titles], np.int32)
    counts = np.zeros((len(truth_titles), 15), np.uint32)
    for i, t in enumerate(truth_titles):
        for k, w in enumerate(t.split()[:15]):
            counts[i, k] = 3 + (hash(w) % 50)

    pair_q = np.array([rng.randrange(len(q_titles)) for _ in range(120)], np.int32)
    pair_t = np.array([rng.randrange(len(truth_titles)) for _ in range(120)], np.int32)

    got = features_for_pairs(pair_q, pair_t, q_enc, q_len, t_enc, t_len, counts, cfg)
    want = construct_features(
        q_enc[pair_q], q_len[pair_q], t_enc[pair_t], t_len[pair_t],
        counts[pair_t], len(truth_titles), cfg,
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
