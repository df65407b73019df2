"""Unit tests for host text primitives (parity with reference tests/test_common.py)."""

import math

import numpy as np

from doppelspeller.utils import text as T


def test_transform_title_golden():
    # Golden case from reference tests/test_common.py:16-19
    title = '''LKJblksd skjasl dfkjf &* 8*&&&8 GGdjsdkj--sdsd-"sdi..//' d'  k   bkjh77_asda33'''
    assert T.transform_title(title) == "lkjblksd skjasl dfkjf 88 ggdjsdkj sdsd sdi d k bkjh77asda33"


def test_transform_title_accents_and_padding():
    assert T.transform_title("Café") == "cafe"
    # short titles are left-padded with '0' to n_grams chars (common.py:34-38)
    assert T.transform_title("a") == "00a"
    assert T.transform_title("") == "000"
    assert T.transform_title("A-B") == "a b"


def test_transform_title_truncation():
    long = "ab " * 200
    out = T.transform_title(long)
    assert len(out) <= 255
    assert not out.endswith(" ")


def test_words_counter_per_title_unique():
    words_lists = [
        ["first", "second", "first", "third", "first"],
        ["first", "first"],
        ["fifth"],
    ]
    counter = T.get_words_counter(words_lists)
    assert dict(counter) == {"first": 2, "second": 1, "third": 1, "fifth": 1}


def test_idf_word():
    words_lists = [
        ["first", "second", "first", "third", "first"],
        ["first", "first"],
        ["fifth"],
    ]
    counter = T.get_words_counter(words_lists)
    assert round(T.idf_word("first", counter, 3), 5) == 0.40547


def test_n_grams():
    assert T.get_n_grams("abcd", 3) == {"abc", "bcd"}
    assert T.get_n_grams("aaa", 3) == {"aaa"}


def test_encode_decode_roundtrip():
    title = "coolblue bv 42"
    codes = T.encode_title(title)
    assert codes.shape == (255,)
    assert codes.dtype == np.uint8
    assert T.decode_title(codes) == title
    # 'c'=4 per the reference docstring example (feature_engineering.py:28-29)
    assert codes[0] == 4
    assert T.CHAR_ENCODING[" "] == 1
    assert T.CHAR_ENCODING["-"] == 0


def test_encode_titles_batch_matches_single():
    titles = ["abc", "hello world 123", "x" * 300]
    tr = [T.transform_title(t) for t in titles]
    batch = T.encode_titles(tr)
    for i, t in enumerate(tr):
        np.testing.assert_array_equal(batch[i], T.encode_title(t))


def test_trigram_ids_match_string_ngrams():
    title = "hello world"
    codes = T.encode_title(title)
    ids = T.trigram_ids_from_codes(codes, len(title))
    assert len(ids) == len(T.get_n_grams(title, 3))
    assert len(np.unique(ids)) == len(ids)
    # ids must be < 37^3 and >= 0
    assert ids.min() >= 0 and ids.max() < 37 ** 3


def test_idf_table():
    df = np.zeros(100, dtype=np.int32)
    df[3] = 2
    df[7] = 1
    idf = T.idf_table_from_df(df, 4)
    assert idf[0] == 0.0
    assert math.isclose(idf[3], math.log(2), rel_tol=1e-6)
    assert math.isclose(idf[7], math.log(4), rel_tol=1e-6)
