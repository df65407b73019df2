"""Native C++ module parity vs the pure-python implementations."""

import numpy as np
import pytest

from doppelspeller.config import Config
from doppelspeller.native import (
    build_index_native,
    get_lib,
    transform_titles_native,
)
from doppelspeller.utils import text as T

pytestmark = pytest.mark.skipif(get_lib() is None, reason="no C++ toolchain")

TITLES = [
    "Great Expectations Ministries",
    "DMG Events (UK) Limited",
    '''LKJblksd skjasl dfkjf &* 8*&&&8 GGdjsdkj--sdsd-"sdi..//' d'  k   bkjh77_asda33''',
    "Café au Lait S.A.",
    "a",
    "",
    "Ümlaut Österreich GmbH",
    "x" * 400,
    "multi    spaces   here",
    "trailing-dash-",
    "12345",
]


def test_transform_parity():
    out = transform_titles_native(TITLES, 255, 3)
    assert out is not None
    transformed, enc, lens = out
    for i, t in enumerate(TITLES):
        want = T.transform_title(t)
        assert transformed[i] == want, f"{t!r}: {transformed[i]!r} != {want!r}"
        np.testing.assert_array_equal(enc[i], T.encode_title(want))
        assert lens[i] == min(len(want), 255)


def test_transform_whitespace_fallback():
    out = transform_titles_native(["tab\there", "new\nline"], 255, 3)
    assert out is not None
    transformed, enc, lens = out
    for i, t in enumerate(["tab\there", "new\nline"]):
        assert transformed[i] == T.transform_title(t)


def test_build_index_parity():
    cfg = Config(data_path="/tmp/x", title_block=128)
    from doppelspeller.utils.io import TitleSet
    import os

    os.environ.pop("DOPPEL_DISABLE_NATIVE", None)
    titles = [T.transform_title(t) for t in TITLES if T.transform_title(t)]
    ts = TitleSet.from_titles(titles, config=cfg)
    ntp = 128
    native = build_index_native(ts.encoded, ts.lengths, 37 ** 3, ntp)
    assert native is not None
    packed, df, flat_ids, flat_counts = native

    # oracle: python trigram sets
    df_want = np.zeros(37 ** 3, dtype=np.int32)
    nnz = 0
    for i, t in enumerate(ts.transformed):
        g = T.trigram_ids_from_codes(ts.encoded[i], int(ts.lengths[i]))
        df_want[g] += 1
        assert flat_counts[i] == len(g)
        np.testing.assert_array_equal(np.sort(flat_ids[nnz : nnz + len(g)]), g)
        nnz += len(g)
        for gid in g:
            assert packed[gid, i // 8] & (1 << (i % 8))
    np.testing.assert_array_equal(df, df_want)
    assert packed.sum(dtype=np.int64) > 0
