"""Host-side text primitives: normalization, char codec, trigram ids, IDF.

Behavioural parity with reference common.py:20-158 (title normalization,
per-title-unique word/n-gram counters, natural-log IDF) — but vectorized with
numpy so a single host core can feed the device, and with a *fixed* trigram
vocabulary (every possible 3-gram of the 37-char post-transform alphabet gets
a static id) so the device index layout never depends on the dataset.
"""

from __future__ import annotations

import math
import re
import unicodedata
from collections import Counter
from typing import Iterable, List, Sequence

import numpy as np

from doppelspeller.config import (
    ALPHABET,
    N_TEXT_CHARS,
    PAD_CODE,
    TRIGRAM_VOCAB_SIZE,
    get_config,
)

_KEEP_RE = re.compile(r"[^a-zA-Z0-9\s]+")
_WS_RE = re.compile(r"\s")
_SPACES_RE = re.compile(r" +")

# char -> code for the uint8 feature encoding ('-'=0 pad, ' '=1, 'a'..'z'=2..27,
# '0'..'9'=28..37); reference feature_engineering.py:200-205.
CHAR_ENCODING = {ch: i for i, ch in enumerate(ALPHABET)}
CHAR_DECODING = {i: ch for ch, i in CHAR_ENCODING.items()}

# Lookup table from the uint8 feature code to the trigram "text char" id
# (space=0, a..z=1..26, 0..9=27..36).  Pad (code 0) maps to -1 (invalid).
_FEATURE_TO_TEXT = np.full(256, -1, dtype=np.int32)
for _ch, _code in CHAR_ENCODING.items():
    if _ch == "-":
        continue
    if _ch == " ":
        _FEATURE_TO_TEXT[_code] = 0
    elif "a" <= _ch <= "z":
        _FEATURE_TO_TEXT[_code] = 1 + (ord(_ch) - ord("a"))
    else:  # digit
        _FEATURE_TO_TEXT[_code] = 27 + (ord(_ch) - ord("0"))


def transform_title(title: str, max_characters: int | None = None, n_grams: int | None = None) -> str:
    """Normalize a raw title to lower-case alphanumeric text.

    Same transform as reference common.py:20-47: NFD-decompose, strip
    non-ascii, lower-case, '-'→space, keep [a-zA-Z0-9\\s], collapse runs of
    spaces, trim, truncate to ``max_characters`` (re-strip), and left-pad
    with '0' to at least ``n_grams`` chars.
    """
    cfg = get_config()
    max_characters = max_characters or cfg.max_characters
    n_grams = n_grams or cfg.n_grams

    text = unicodedata.normalize("NFD", title)
    text = text.encode("ascii", "ignore").decode("utf-8").lower().replace("-", " ")
    text = _KEEP_RE.sub("", text)
    # all whitespace becomes plain spaces before collapsing (the reference
    # keeps \t etc. and would crash in its char encoder; documented deviation)
    text = _WS_RE.sub(" ", text)
    text = _SPACES_RE.sub(" ", text).strip()
    n_chars = len(text)
    text = text[:max_characters].strip()
    if n_chars < n_grams:
        return text.rjust(n_grams, "0")
    return text


def transform_titles(titles: Iterable[str]) -> List[str]:
    return [transform_title(t) for t in titles]


def get_n_grams(title: str, n: int | None = None) -> set:
    """Set of all character n-grams of ``title`` (reference common.py:150-151)."""
    n = n or get_config().n_grams
    return {title[i : i + n] for i in range(len(title) - n + 1)}


def get_words_counter(words_lists: Iterable[Sequence[str]]) -> Counter:
    """Document-frequency counter: each word counted once per title
    (reference common.py:140-142)."""
    counter: Counter = Counter()
    for words in words_lists:
        counter.update(set(words))
    return counter


def idf_word(word: str, words_counter: Counter, number_of_titles: int) -> float:
    """Natural-log inverse document frequency (reference common.py:154-158)."""
    return math.log(number_of_titles / words_counter[word])


def encode_title(title: str, max_characters: int | None = None) -> np.ndarray:
    """uint8[max_characters] char codes, zero-padded
    (reference feature_engineering.py:298-307)."""
    max_characters = max_characters or get_config().max_characters
    out = np.zeros(max_characters, dtype=np.uint8)
    n = min(len(title), max_characters)
    for i in range(n):
        out[i] = CHAR_ENCODING[title[i]]
    return out


def encode_titles(titles: Sequence[str], max_characters: int | None = None) -> np.ndarray:
    """Vectorized batch version of :func:`encode_title` → uint8[B, L]."""
    max_characters = max_characters or get_config().max_characters
    out = np.zeros((len(titles), max_characters), dtype=np.uint8)
    # Vectorize through a single byte buffer: all transformed chars are ascii.
    lut = np.zeros(128, dtype=np.uint8)
    for ch, code in CHAR_ENCODING.items():
        lut[ord(ch)] = code
    for i, t in enumerate(titles):
        b = np.frombuffer(t[:max_characters].encode("ascii"), dtype=np.uint8)
        out[i, : len(b)] = lut[b]
    return out


def decode_title(codes: np.ndarray) -> str:
    return "".join(CHAR_DECODING[int(c)] for c in codes if c != PAD_CODE)


def trigram_ids_from_codes(codes: np.ndarray, length: int) -> np.ndarray:
    """Sorted unique trigram ids (int32) of an encoded title.

    The id of a trigram (c0, c1, c2) over the 37-char text alphabet is
    c0*37² + c1*37 + c2 — a static, dataset-independent vocabulary.
    """
    if length < 3:
        raise ValueError("transformed titles are always >= 3 chars")
    text = _FEATURE_TO_TEXT[codes[:length]]
    ids = text[:-2] * (N_TEXT_CHARS * N_TEXT_CHARS) + text[1:-1] * N_TEXT_CHARS + text[2:]
    return np.unique(ids.astype(np.int32))


BIG_TRIGRAM = np.int32(1 << 30)  # sorts after every real trigram id


def trigram_ids_matrix(encoded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized per-title unique trigram ids.

    Returns int32[B, L-2] sorted ascending per row, with invalid/duplicate
    slots set to BIG_TRIGRAM.  No Python-level per-row loops.
    """
    B, L = encoded.shape
    # trim to the longest actual title: the encoding is padded to 256 but
    # typical titles are ~30-60 chars, and everything below is O(B·L)
    L_eff = int(lengths.max(initial=3)) if B else 3
    if L_eff < L:
        encoded = encoded[:, :L_eff]
        L = L_eff
    text = _FEATURE_TO_TEXT[encoded]                       # (B, L) −1 for pads
    ids = (
        text[:, :-2] * (N_TEXT_CHARS * N_TEXT_CHARS)
        + text[:, 1:-1] * N_TEXT_CHARS
        + text[:, 2:]
    ).astype(np.int64)
    pos = np.arange(L - 2, dtype=np.int32)[None, :]
    valid = pos <= (lengths[:, None] - 3)
    ids = np.where(valid, ids, np.int64(BIG_TRIGRAM))
    ids.sort(axis=1)
    dup = np.zeros_like(ids, dtype=bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    ids = np.where(dup, np.int64(BIG_TRIGRAM), ids)
    ids.sort(axis=1)
    return ids.astype(np.int32)


def trigram_df_table(encoded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Document frequency per trigram id over the full fixed vocabulary.

    Equivalent to reference get_n_grams_counter (common.py:145-147) but as a
    dense int32[V] table.
    """
    df = np.zeros(TRIGRAM_VOCAB_SIZE, dtype=np.int32)
    for i in range(encoded.shape[0]):
        g = trigram_ids_from_codes(encoded[i], int(lengths[i]))
        df[g] += 1
    return df


def idf_table_from_df(df: np.ndarray, number_of_titles: int) -> np.ndarray:
    """float32[V] IDF table: log(N/df) where df>0, else 0 (unobserved
    trigrams contribute nothing to truth-side sums; queries containing them
    use the max-IDF fallback, reference match_maker.py:95,151)."""
    idf = np.zeros_like(df, dtype=np.float32)
    nz = df > 0
    idf[nz] = np.log(number_of_titles / df[nz].astype(np.float64)).astype(np.float32)
    return idf
