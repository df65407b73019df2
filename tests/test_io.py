"""CSV loaders and the output writer, read and written with the standard
library's csv module (reference common.py:75-120, predict.py:319-321,
cli.py:86-132)."""

import numpy as np
import pytest

from doppelspeller.config import Config
from doppelspeller.utils import text as T
from doppelspeller.utils.io import (
    load_ground_truth,
    load_test_data,
    load_train_data,
    read_csv_columns,
)


@pytest.fixture()
def cfg(tmp_path):
    return Config(data_path=str(tmp_path))


def _write(path, text):
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def test_loaders_read_pipe_delimited_files(cfg):
    _write(cfg.ground_truth_path,
           'company_id|name\n7|Acme Holdings Ltd\n9|"Pipe | Co"\n12|Café Crème\n')
    _write(cfg.train_path,
           "train_index|name|company_id\n0|acme holdngs|7\n1|nobody|-1\n")
    _write(cfg.test_path, "test_index|name\n5|acme\n6|creme cafe\n\n")
    truth = load_ground_truth(cfg)
    assert truth.ids.tolist() == [7, 9, 12]
    assert truth.titles == ["Acme Holdings Ltd", "Pipe | Co", "Café Crème"]
    assert truth.transformed == [T.transform_title(t) for t in truth.titles]
    assert truth.ids.dtype == np.int64
    train = load_train_data(cfg)
    assert train.ids.tolist() == [0, 1] and train.labels.tolist() == [7, -1]
    test = load_test_data(cfg)                  # trailing blank line ignored
    assert test.ids.tolist() == [5, 6] and test.titles == ["acme", "creme cafe"]


def test_missing_column_is_a_clear_error(cfg):
    _write(cfg.ground_truth_path, "id|name\n1|x\n")
    with pytest.raises(ValueError, match="missing required column"):
        load_ground_truth(cfg)
    # the wrong delimiter reads as one column and fails the same way
    _write(cfg.ground_truth_path, "company_id,name\n1,x\n")
    with pytest.raises(ValueError, match="delimiter"):
        load_ground_truth(cfg)


def test_read_csv_columns_keeps_header_order(tmp_path):
    p = tmp_path / "x.csv"
    _write(p, "b|a\n1|x\n2|y\n")
    cols = read_csv_columns(str(p), "|", ("a",))
    assert list(cols) == ["b", "a"]
    assert cols == {"b": ["1", "2"], "a": ["x", "y"]}


def test_output_writer_and_accuracy_report(tmp_path):
    from doppelspeller.pipeline import PredictionResult, accuracy_report

    res = PredictionResult(
        test_index=np.array([3, 1, 2, 0], np.int64),
        match_title_id=np.array([30, -1, 20, 11], np.int64),
        prediction=np.ones(4, np.float32), stage=np.zeros(4, np.uint8),
        transformed=["d", "b", "c", "a"], match_transformed=[None] * 4,
    )
    out = tmp_path / "final_output.csv"
    res.save_csv(str(out), "|")
    assert out.read_text() == "title_id|test_index\n11|0\n-1|1\n20|2\n30|3\n"
    actuals = tmp_path / "actuals.csv"
    _write(actuals, "test_index|name|company_id\n0|a|10\n1|b|-1\n2|c|20\n3|d|-1\n")
    report = accuracy_report(str(actuals), str(out), "|")
    assert report == {
        "correctly_matched": 1, "incorrectly_matched": 2,
        "correctly_not_found": 1, "incorrectly_not_found": 0,
        "custom_error": 10,
    }
