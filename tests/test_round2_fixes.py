"""Round-2 regression tests: ADVICE.md findings + VERDICT.md missing items.

* CSV schema validation with actionable errors (reference common.py:78-81).
* Zero-IDF everywhere-trigram vs unobserved-trigram fallback
  (reference match_maker.py:151,197: only ABSENT trigrams use max_idf).
* Index-checkpoint staleness detection via content hash.
* Native transform parity on the \\x1c-\\x1f separator controls (python's
  str-mode \\s matches them).
"""

import math

import numpy as np
import pytest

from doppelspeller.config import Config
from doppelspeller.ops.ngram_index import build_truth_index, plan_query_blocks
from doppelspeller.utils import text as T
from doppelspeller.utils.io import TitleSet, load_ground_truth, load_test_data


def test_csv_schema_validation(tmp_path):
    bad = tmp_path / "example_truth.csv"
    bad.write_text("wrong_id|name\n1|acme corp\n")
    cfg = Config(data_path=str(tmp_path))
    with pytest.raises(ValueError, match="missing required column.*company_id"):
        load_ground_truth(cfg)

    good = tmp_path / "example_truth.csv"
    good.write_text("company_id|name\n1|acme corp\n")
    ts = load_ground_truth(cfg)
    assert ts.transformed == ["acme corp"]

    (tmp_path / "example_test.csv").write_text("test_index;name\n0;x\n")
    with pytest.raises(ValueError, match="delimiter"):
        load_test_data(cfg)


def test_everywhere_trigram_uses_zero_idf_not_fallback(tmp_path):
    """A trigram in EVERY truth title has idf 0 and df N — the reference adds
    nothing for it (it IS in the mapping); only truly unobserved query
    trigrams fall back to max_idf."""
    cfg = Config(data_path=str(tmp_path), title_block=128, query_block=8,
                 score_dtype="float32")
    truth_titles = [f"zzz alpha{i}" for i in range(40)]  # 'zzz' in every title
    truth = TitleSet.from_titles(truth_titles, config=cfg)
    index = build_truth_index(truth, cfg)

    # oracle max_intersection with reference semantics
    from collections import Counter

    gram_counter = Counter()
    for t in truth.transformed:
        gram_counter.update(T.get_n_grams(t, 3))
    idf_map = {g: math.log(len(truth_titles) / c) for g, c in gram_counter.items()}
    max_idf = max(idf_map.values())

    q = "zzz alphaQQ"  # contains the everywhere-trigram + unobserved ones
    queries = TitleSet.from_titles([q], config=cfg)
    plans = plan_query_blocks(queries, index, cfg)
    assert len(plans) == 1
    got = float(plans[0].max_intersection[0])
    want = sum(idf_map.get(g, max_idf) for g in T.get_n_grams(queries.transformed[0], 3))
    assert got == pytest.approx(want, rel=1e-5)
    # sanity: the everywhere-trigram really has idf exactly 0
    zzz_id = int(T.trigram_ids_from_codes(truth.encoded[0], int(truth.lengths[0]))[0:1][0])
    assert (index.idf[index.df == len(truth_titles)] == 0.0).all()
    assert (index.df > 0).sum() > 0


def test_index_checkpoint_detects_title_edit(tmp_path):
    """Same ids + count but edited titles must invalidate the checkpoint."""
    from doppelspeller.pipeline import Matcher

    cfg = Config(data_path=str(tmp_path), title_block=128, query_block=8,
                 score_dtype="float32")
    titles = [f"gamma corp {i}" for i in range(30)]
    ids = np.arange(1, 31, dtype=np.int64)
    truth_a = TitleSet.from_titles(titles, ids=ids, config=cfg)
    index_a = build_truth_index(truth_a, cfg)
    index_a.save(cfg.index_path)

    # unchanged titles: checkpoint accepted
    m = Matcher(cfg, truth=truth_a)
    assert m.index.content_hash == index_a.content_hash

    # edited title, same id: checkpoint rejected, index rebuilt
    titles_b = list(titles)
    titles_b[7] = "totally different name"
    truth_b = TitleSet.from_titles(titles_b, ids=ids, config=cfg)
    m2 = Matcher(cfg, truth=truth_b)
    assert m2.index.content_hash != index_a.content_hash
    got = T.trigram_ids_matrix(truth_b.encoded[7:8], truth_b.lengths[7:8])
    g0 = int(got[0, 0])
    # the rebuilt index must know about the edited title's trigrams
    assert m2.index.df[g0] > 0


def test_native_separator_controls_parity():
    from doppelspeller.native import get_lib, transform_titles_native

    if get_lib() is None:
        pytest.skip("no C++ toolchain")
    titles = ["acme\x1ccorp", "a\x1db", "x\x1e y", "q\x1f\x1fz", "plain title"]
    out = transform_titles_native(titles, 255, 3)
    assert out is not None
    transformed, enc, lens = out
    for i, t in enumerate(titles):
        want = T.transform_title(t)
        assert transformed[i] == want, f"{t!r}: {transformed[i]!r} != {want!r}"
        np.testing.assert_array_equal(enc[i], T.encode_title(want))
