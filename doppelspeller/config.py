"""Configuration for the matcher.

Reference knob set: settings.py:1-77.  Rebuilt as a frozen dataclass that is
validated at construction, with the same `PROJECT_DATA_PATH` env-var override
(reference settings.py:8-12) plus device blocking/sharding knobs.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field, replace
from typing import Tuple


def _default_data_path() -> str:
    path = os.environ.get("PROJECT_DATA_PATH")
    if not path:
        path = os.path.abspath("./data/")
        warnings.warn(
            f"Environment variable PROJECT_DATA_PATH not set! Using {path} as default!"
        )
    return os.path.abspath(path)


# The post-transform character alphabet.  Index 0 is the pad/fill character
# (reference: R_FILL_CHARACTER '-', settings.py:69-70); transformed titles can
# only contain [a-z0-9 ], so '-' never collides with real text.
ALPHABET = "- abcdefghijklmnopqrstuvwxyz0123456789"
PAD_CODE = 0
SPACE_CODE = 1
# Characters that can actually appear in a transformed title (36 letters/digits
# + space = 37).  The fixed trigram vocabulary is 37**3 — every possible
# 3-gram gets a static integer id, so no host-side vocab dictionary is needed
# and the index layout is identical for every dataset.
N_TEXT_CHARS = 37  # [ a-z0-9] mapped to 0..36 (space=0) for trigram ids
TRIGRAM_VOCAB_SIZE = N_TEXT_CHARS ** 3  # 50653


@dataclass(frozen=True)
class Config:
    # ---- paths / IO (reference settings.py:17-62) ----
    data_path: str = field(default_factory=_default_data_path)
    ground_truth_file: str = "example_truth.csv"
    train_file: str = "example_train.csv"
    test_file: str = "example_test.csv"
    test_with_actuals_file: str = "example_test_with_actuals.csv"
    final_output_file: str = "final_output.csv"
    model_file: str = "model.npz"
    index_file: str = "index.npz"
    delimiter: str = "|"
    # Source-file column names (reference settings.py:20-43)
    truth_id_column: str = "company_id"
    truth_title_column: str = "name"
    train_index_column: str = "train_index"
    test_index_column: str = "test_index"

    # ---- text / n-grams (reference settings.py:14-15,65-72) ----
    n_grams: int = 3
    max_characters: int = 255
    number_of_words_features: int = 15

    # ---- retrieval (reference settings.py:55-59) ----
    top_n_training: int = 10
    top_n_predicting: int = 100

    # ---- thresholds (reference settings.py:75-77) ----
    levenshtein_ratio_threshold: int = 94
    prediction_probability_threshold: float = 0.9
    false_positive_penalty_factor: float = 5.0
    train_not_found_value: int = -1

    # ---- training (reference settings.py:46-49 + train.py:99-112) ----
    evaluation_fraction_generated: float = 0.05
    evaluation_fraction_negative: float = 0.1
    evaluation_fraction_positive: float = 0.05
    gbt_max_depth: int = 5
    gbt_eta: float = 0.1
    gbt_min_child_weight: float = 1.0
    gbt_num_boost_round: int = 1000
    gbt_early_stopping_rounds: int = 50
    gbt_lambda: float = 1.0
    gbt_max_bins: int = 256
    seed: int = 0

    # ---- device execution knobs (new; no reference equivalent) ----
    # matmul dtype for jaccard scoring: bfloat16 runs the tensor cores at
    # full rate with ~0.3% relative score error (top-k recall is unaffected
    # in tests); float32 (true f32 products) is faithful to the set-math
    # oracle
    score_dtype: str = "bfloat16"
    # coarse folded scorer: "auto" → backend.coarse_route (the Pallas-Triton
    # kernel of ops/coarse_triton.py on the GPU, plain XLA on the CPU);
    # "xla" / "triton" force a route
    retrieval_impl: str = "auto"
    # windowed pre-selection inside the FOLDED coarse pass: scores are
    # reduced to the max of every 8 consecutive titles before the coarse
    # top-k', which then scans an 8× narrower matrix.  Only per-window
    # runner-ups are lost, and only from the candidate funnel: the
    # survivors are rescored exactly.
    retrieval_window_select: bool = True
    # two-stage folded retrieval (ops/fold.py): "auto" engages it when the
    # scorer has the truth encodings and the index has >= folded_min_titles
    # titles; "folded" forces it; "exact" disables.  The coarse pass scores
    # an upper bound over fold_dim df-balanced trigram buckets from a small
    # permanently-resident matrix (no per-block row gather), then the top
    # rescore_depth candidates per query are rescored EXACTLY against the
    # per-title trigram lists — only coarse recall@rescore_depth is
    # approximate (gated by the oracle anchor of chip_smoke.py).
    # rescore_depth=0 returns raw coarse top-k.
    retrieval_mode: str = "auto"
    fold_dim: int = 512
    # independent df-balanced fold partitions; the coarse numerator is the
    # elementwise MIN of the per-hash upper bounds (count-min sketch — each
    # is a monotone upper bound, their min is a tighter one, so coarse
    # recall rises at the cost of one extra resident Mc + matmul per hash)
    fold_hashes: int = 2
    rescore_depth: int = 128
    folded_min_titles: int = 200_000
    # query-block size for the FOLDED path only (0 → query_block).  The
    # exact path keeps QB small because its contraction is the per-block
    # trigram UNION, which grows with QB — but the folded contraction is
    # fixed at fold_dim regardless of QB.
    fold_query_block: int = 0
    # index construction: "auto" → backend.index_build_route (on-device
    # build on the GPU: only the encoded titles are uploaded instead of the
    # multi-GB packed matrix; host numpy/C++ on the CPU); "host" / "device"
    # force a path
    index_build_impl: str = "auto"
    # queries scored per device step (rows of the scoring matmul); the exact
    # path's cost is O(per-block trigram union), which grows with the block
    query_block: int = 128
    # compact per-query trigram-slot width for the sparse weight transfer:
    # runs whose queries all have <= this many unique trigrams ship
    # (query_block x max_query_trigrams) sparse weights; any longer query
    # switches the whole run to the full width.  No trigrams are dropped.
    max_query_trigrams: int = 64
    # truth titles per inner matmul tile
    title_block: int = 32768
    # static union-size buckets for query-block plans: each block's trigram
    # union is padded to the smallest bucket that holds it (scoring cost is
    # O(union); one compiled program per occupied bucket).  The largest
    # bucket is the planner's hard cap (blocks split above it).
    union_buckets: Tuple[int, ...] = (1024, 1536, 2048, 3072, 4096, 6144, 8192)
    # query blocks scored per device dispatch (lax.scan inside one program,
    # one host→device buffer and one dispatch per group)
    dispatch_blocks: int = 32
    # batched pair block for levenshtein/feature kernels
    pair_block: int = 8192
    # fixed rerank dispatch size (rows per stage-3 slab; padded, so every
    # slab reuses one compiled program per (length, word-length) bucket)
    model_slab: int = 2048
    # adaptive candidate depth for the model stage: wave A scores only the
    # top model_depth_initial jaccard candidates per row; rows whose best
    # wave-A probability >= model_widen_threshold are re-decided over all
    # top_n_predicting candidates (wave B).  Rows below the threshold are
    # final-unmatched without scoring the tail — on jaccard-sorted
    # candidates the argmax virtually always sits in the head (parity
    # gated by tests + the oracle anchor).  0 disables (always score every
    # candidate, the reference-shaped behavior).
    model_depth_initial: int = 32
    model_widen_threshold: float = 0.3
    # rows whose wave-A best probability is >= this are decided from the
    # head alone (no wave B): on jaccard-sorted candidates the head argmax
    # is essentially always the global argmax, and the tail could only
    # overturn it with a candidate scoring >= the trusted max.  On the full
    # reference example set (10k queries, 537-tree model) 0/10000 final
    # matches differ between 0.995 and never-trusting; on the synthetic
    # bench world trusting trades a few basis points of accuracy for model
    # stage time (scripts/sweep_trust.py measures the curve).  The oracle
    # anchor gates accuracy.  2.0 disables trusting (every widened row
    # scores its full tail)
    model_trust_threshold: float = 0.995
    # cap (in chars) on the fuzzy stage's device DP tile.  The Levenshtein
    # tile costs O(TL²) per pair, so a run dominated by short queries can cap
    # the tile and let the rare long rows overflow to an exact host redo
    # (pipeline host-redo path): a device row is flagged ``over`` whenever a
    # length-prefilter-considered pair has any string longer than the tile.
    # 0 = uncapped (the tile is derived from the threshold so overflow is
    # impossible).  The cap is rounded down to a length bucket.
    fuzzy_tile_cap: int = 0
    # rows per rerank scan step (cap; the per-(tl,wl,k) device-memory budget
    # may choose less).  Bigger steps amortize the per-step fixed cost
    rerank_chunk_cap: int = 512
    # length buckets for DP kernels
    length_buckets: Tuple[int, ...] = (32, 64, 128, 256)
    # mesh axis name used by the sharded index
    mesh_axis: str = "titles"
    # cascade execution: "device" keeps the candidate matrix on the device
    # and runs fuzzy/model decisions there (one program per stage); "host"
    # fetches candidates and assembles pairs on the host (reference-shaped
    # path); "auto" picks device for large batches
    cascade_impl: str = "auto"
    # one-dispatch small-batch cascade (ops/serve_fused.py): "auto" fuses
    # retrieval -> fuzzy -> model into ONE device program (one fetch) for
    # requests of <= one retrieval query block on a single device — the
    # serving hot path; "off" keeps the classic staged path for every size.
    # Rows whose candidates exceed the compiled >=99.9%-coverage rerank
    # bucket are re-decided exactly by the classic host stages.
    serve_fused: str = "auto"

    def __post_init__(self):
        if self.top_n_training > self.top_n_predicting:
            raise ValueError(
                "top_n_training cannot be greater than top_n_predicting "
                "(reference settings.py:58-59)"
            )
        if self.n_grams != 3:
            raise ValueError("only 3-grams are supported (fixed trigram vocab)")
        if self.max_characters > 255:
            raise ValueError("titles are limited to 255 chars (uint8 encoding)")

    # -- derived paths --
    def path(self, name: str) -> str:
        return os.path.join(self.data_path, name)

    @property
    def ground_truth_path(self) -> str:
        return self.path(self.ground_truth_file)

    @property
    def train_path(self) -> str:
        return self.path(self.train_file)

    @property
    def test_path(self) -> str:
        return self.path(self.test_file)

    @property
    def test_with_actuals_path(self) -> str:
        return self.path(self.test_with_actuals_file)

    @property
    def final_output_path(self) -> str:
        return self.path(self.final_output_file)

    @property
    def model_path(self) -> str:
        return self.path(self.model_file)

    @property
    def index_path(self) -> str:
        return self.path(self.index_file)

    def with_(self, **kwargs) -> "Config":
        return replace(self, **kwargs)


_DEFAULT: Config | None = None


def get_config() -> Config:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Config()
    return _DEFAULT


def set_config(config: Config) -> None:
    global _DEFAULT
    _DEFAULT = config
