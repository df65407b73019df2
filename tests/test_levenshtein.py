"""LCS/ratio kernel parity vs an independent pure-Python DP oracle.

The oracle implements the reference semantics from first principles:
indel distance (substitution cost 2) as in feature_engineering.py:25-63,
ratio = ((m+n) − dist)/(m+n) · 100.
"""

import random
import string

import numpy as np

from doppelspeller.config import Config
from doppelspeller.ops.levenshtein import batched_ratio, lcs_kernel, ratio_rounded
from doppelspeller.utils import text as T

import jax.numpy as jnp


def oracle_indel_distance(a: str, b: str) -> int:
    m, n = len(a), len(b)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev_diag = dp[0]
        dp[0] = i
        for j in range(1, n + 1):
            tmp = dp[j]
            sub = prev_diag + (0 if a[i - 1] == b[j - 1] else 2)
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, sub)
            prev_diag = tmp
    return dp[n]


def oracle_ratio(a: str, b: str) -> float:
    total = len(a) + len(b)
    if total == 0:
        return 100.0
    return (total - oracle_indel_distance(a, b)) / total * 100.0


def oracle_lcs(a: str, b: str) -> int:
    return (len(a) + len(b) - oracle_indel_distance(a, b)) // 2


def _encode_pairs(pairs, width=255):
    a = np.zeros((len(pairs), width), dtype=np.uint8)
    b = np.zeros((len(pairs), width), dtype=np.uint8)
    la = np.zeros(len(pairs), dtype=np.int32)
    lb = np.zeros(len(pairs), dtype=np.int32)
    for i, (x, y) in enumerate(pairs):
        ea, eb = T.encode_title(x, width), T.encode_title(y, width)
        a[i], b[i] = ea, eb
        la[i], lb[i] = len(x), len(y)
    return a, la, b, lb


HAND_PAIRS = [
    ("abc", "abc"),
    ("abc", "abd"),
    ("kitten", "sitting"),
    ("coolblue bv", "coolblue"),
    ("a", "b"),
    ("abc", ""),
    ("hello world", "world hello"),
    ("xyz", "zyx"),
    ("aaaa", "aa"),
    ("the quick brown fox", "the quick brown fox jumps"),
]


def test_lcs_kernel_hand_pairs():
    a, la, b, lb = _encode_pairs(HAND_PAIRS, width=32)
    got = np.asarray(lcs_kernel(jnp.asarray(a), jnp.asarray(la), jnp.asarray(b), jnp.asarray(lb)))
    want = np.array([oracle_lcs(x, y) for x, y in HAND_PAIRS])
    np.testing.assert_array_equal(got, want)


def test_ratio_random_strings():
    rng = random.Random(7)
    alphabet = string.ascii_lowercase[:6] + " 01"
    pairs = []
    for _ in range(200):
        la = rng.randint(1, 60)
        lb = rng.randint(1, 60)
        pairs.append(
            (
                "".join(rng.choice(alphabet) for _ in range(la)).strip() or "a",
                "".join(rng.choice(alphabet) for _ in range(lb)).strip() or "b",
            )
        )
    a, la, b, lb = _encode_pairs(pairs)
    cfg = Config(data_path="/tmp/x", pair_block=64)
    got = batched_ratio(a, la, b, lb, cfg)
    want = np.array([oracle_ratio(x, y) for x, y in pairs], dtype=np.float32)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_ratio_long_strings():
    pairs = [("abcdefghij" * 25, "abcdefghij" * 25), ("a" * 200, "a" * 100 + "b" * 100)]
    a, la, b, lb = _encode_pairs(pairs)
    cfg = Config(data_path="/tmp/x", pair_block=8)
    got = batched_ratio(a, la, b, lb, cfg)
    want = np.array([oracle_ratio(x, y) for x, y in pairs], dtype=np.float32)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_rounding_is_bankers():
    # python-Levenshtein semantics: int(round(x)) with banker's rounding.
    # LCS=5, la=7, lb=9 → 1000/16 = 62.5 → rounds to 62 (not 63)
    assert round(62.5) == 62  # sanity: python3 banker's rounding
    pairs = [("abcdexy", "abcdezzzz")]
    assert oracle_lcs(*pairs[0]) == 5
    a, la, b, lb = _encode_pairs(pairs)
    got = ratio_rounded(a, la, b, lb, Config(data_path="/tmp/x", pair_block=8))
    assert got[0] == 62


def test_bitparallel_matches_scan_kernel():
    import jax.numpy as jnp
    from doppelspeller.ops.levenshtein import lcs_kernel, lcs_kernel_scan

    rng = random.Random(99)
    alphabet = string.ascii_lowercase[:9] + " 012"
    pairs = []
    for _ in range(150):
        la = rng.randint(1, 250)
        lb = rng.randint(1, 250)
        pairs.append((
            "".join(rng.choice(alphabet) for _ in range(la)).strip() or "a",
            "".join(rng.choice(alphabet) for _ in range(lb)).strip() or "b",
        ))
    a, la, b, lb = _encode_pairs(pairs, width=255)
    got = np.asarray(lcs_kernel(jnp.asarray(a), jnp.asarray(la), jnp.asarray(b), jnp.asarray(lb)))
    want = np.asarray(lcs_kernel_scan(jnp.asarray(a), jnp.asarray(la), jnp.asarray(b), jnp.asarray(lb)))
    np.testing.assert_array_equal(got, want)
