"""CSV ingestion → packed host arrays.

Reference equivalents: common.py:50-137 (read_and_transform_input_csv and the
typed loaders).  Instead of a pandas dataframe with object columns, loading
produces a ``TitleSet`` of dense numpy arrays ready to ship to the device;
the CSV files are read with the standard library's ``csv`` module.
"""

from __future__ import annotations

import csv
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from doppelspeller.config import Config, get_config
from doppelspeller.utils import text as T

LOGGER = logging.getLogger(__name__)


@dataclass
class TitleSet:
    """A collection of titles with all derived encodings."""

    titles: List[str]                 # raw input titles
    transformed: List[str]            # normalized titles
    ids: np.ndarray                   # int64[B] title_id / test_index / train_index
    encoded: np.ndarray               # uint8[B, max_chars] char codes
    lengths: np.ndarray               # int32[B] transformed lengths
    labels: Optional[np.ndarray] = None  # int64[B] title_id labels (train only)
    _words: Optional[List[List[str]]] = field(default=None, repr=False)
    _wo: Optional[tuple] = field(default=None, repr=False)
    _ts: Optional[tuple] = field(default=None, repr=False)
    _tri: Optional[np.ndarray] = field(default=None, repr=False)

    def __len__(self) -> int:
        return len(self.transformed)

    @property
    def words(self) -> List[List[str]]:
        if self._words is None:
            self._words = [t.split() for t in self.transformed]
        return self._words

    @property
    def encoded_wo(self) -> tuple:
        """Spaceless encodings (enc uint8[B, L], len int32[B]), lazily built
        once per set — equals features.remove_spaces_host(encoded, lengths)
        but through the string codec (a vectorized numpy compaction of the
        full (B, 256) window costs ~3 s at 50k rows on a slow host core;
        this is paid once and reused across predict calls)."""
        if self._wo is None:
            L = self.encoded.shape[1]
            wo = [t[:L].replace(" ", "") for t in self.transformed]
            enc = T.encode_titles(wo, L)
            ln = np.array([min(len(t), L) for t in wo], dtype=np.int32)
            self._wo = (enc, ln)
        return self._wo

    @property
    def encoded_token_sorted(self) -> tuple:
        """Token-sorted encodings (enc uint8[B, L], len int32[B]), lazily
        built once per set — the fuzzy stage's token-sort-ratio fallback
        (reference common.py:165-167) re-sorts every remaining query's words
        on each predict call (~1 s of single-core Python at 100k rows);
        cached here like :pyattr:`encoded_wo` so repeat predicts reuse it."""
        if self._ts is None:
            L = self.encoded.shape[1]
            ts = [" ".join(sorted(t.split())) for t in self.transformed]
            enc = T.encode_titles(ts, L)
            ln = np.array([min(len(t), L) for t in ts], dtype=np.int32)
            self._ts = (enc, ln)
        return self._ts

    def trigram_ids(self) -> np.ndarray:
        """int32[B, W] per-title sorted unique trigram ids (BIG_TRIGRAM in
        invalid/duplicate slots), computed once per set.  Both retrieval
        planners used to recompute this on every predict call — ~0.4 s of
        single-core numpy per 100k-query rep on this host, charged to the
        bench's retrieval stage."""
        if self._tri is None:
            self._tri = T.trigram_ids_matrix(self.encoded, self.lengths)
        return self._tri

    @classmethod
    def from_titles(
        cls,
        titles: List[str],
        ids: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        config: Optional[Config] = None,
    ) -> "TitleSet":
        cfg = config or get_config()
        from doppelspeller.native import transform_titles_native

        native = transform_titles_native(titles, cfg.max_characters, cfg.n_grams)
        if native is not None:
            transformed, encoded, lengths = native
        else:
            transformed = T.transform_titles(titles)
            encoded = T.encode_titles(transformed, cfg.max_characters)
            lengths = np.array(
                [min(len(t), cfg.max_characters) for t in transformed], dtype=np.int32
            )
        if ids is None:
            ids = np.arange(len(titles), dtype=np.int64)
        return cls(
            titles=list(titles),
            transformed=transformed,
            ids=np.asarray(ids, dtype=np.int64),
            encoded=encoded,
            lengths=lengths,
            labels=None if labels is None else np.asarray(labels, dtype=np.int64),
        )


def read_csv_columns(path: str, delimiter: str,
                     required_columns: tuple) -> Dict[str, List[str]]:
    """Load a delimited file with a header row as {column: [raw strings]}
    and validate its schema (reference common.py:78-81,94-97,110-113: a clear
    error on missing columns instead of a raw KeyError)."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter=delimiter)
        header = next(reader, [])
        rows = [r for r in reader if r]
    missing = [c for c in required_columns if c not in header]
    if missing:
        raise ValueError(
            f"Invalid input file {path}: missing required column(s) "
            f"{missing} (found {header}, delimiter {delimiter!r})"
        )
    cols = {name: [] for name in header}
    for r in rows:
        for name, value in zip(header, r):
            cols[name].append(value)
    return cols


def _int_column(values: List[str]) -> np.ndarray:
    return np.asarray([int(float(v)) for v in values], dtype=np.int64)


def load_ground_truth(config: Optional[Config] = None) -> TitleSet:
    """Truth DB loader (reference common.py:75-88)."""
    cfg = config or get_config()
    LOGGER.info("Reading and transforming the ground truth data!")
    df = read_csv_columns(
        cfg.ground_truth_path, cfg.delimiter,
        (cfg.truth_id_column, cfg.truth_title_column),
    )
    ts = TitleSet.from_titles(
        df[cfg.truth_title_column],
        ids=_int_column(df[cfg.truth_id_column]),
        config=cfg,
    )
    LOGGER.info("Read %d rows from the ground truth data input!", len(ts))
    return ts


def load_train_data(config: Optional[Config] = None) -> TitleSet:
    """Train loader (reference common.py:91-104); ``labels`` holds the
    title_id column (−1 = not in truth)."""
    cfg = config or get_config()
    LOGGER.info("Reading and transforming the train data!")
    df = read_csv_columns(
        cfg.train_path, cfg.delimiter,
        (cfg.train_index_column, cfg.truth_title_column, cfg.truth_id_column),
    )
    ts = TitleSet.from_titles(
        df[cfg.truth_title_column],
        ids=_int_column(df[cfg.train_index_column]),
        labels=_int_column(df[cfg.truth_id_column]),
        config=cfg,
    )
    LOGGER.info("Read %d rows from the train data input!", len(ts))
    return ts


def load_test_data(config: Optional[Config] = None) -> TitleSet:
    """Test loader (reference common.py:107-120)."""
    cfg = config or get_config()
    LOGGER.info("Reading and transforming the test data!")
    df = read_csv_columns(
        cfg.test_path, cfg.delimiter,
        (cfg.test_index_column, cfg.truth_title_column),
    )
    ts = TitleSet.from_titles(
        df[cfg.truth_title_column],
        ids=_int_column(df[cfg.test_index_column]),
        config=cfg,
    )
    LOGGER.info("Read %d rows from the test data input!", len(ts))
    return ts


def single_title_set(title: str, config: Optional[Config] = None) -> TitleSet:
    """One-row TitleSet for single-title search (reference common.py:123-137)."""
    return TitleSet.from_titles([title], ids=np.array([0], dtype=np.int64), config=config)
