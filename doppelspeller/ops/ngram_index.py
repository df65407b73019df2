"""The truth-title trigram index: a bit-packed ngram×title matrix.

Replacement for the reference MatchMaker's scipy ``lil_matrix``
inverted index (match_maker.py:74-178).  Design:

* The trigram vocabulary is *fixed*: every possible 3-gram over the 37-char
  post-transform alphabet has a static id (V = 37³ = 50653).  No per-dataset
  vocab dictionary, no host hash maps on the hot path.
* The truth matrix is a **bit-packed occupancy matrix** ``packed[V, ntp/8]``
  (bit t of row g set ⟺ truth title t contains trigram g).  At 500K titles
  it is ~3.3 GB — resident on one device, or sharded over the title axis
  across a mesh.  IDF weighting lives in a separate float32[V] table so
  the big matrix stays 1 bit/entry.
* Per-title IDF sums (the Jaccard denominator term, match_maker.py:102,174)
  are precomputed at build time.

Query-side preparation (the analogue of the reference's query sparse matrix,
match_maker.py:155-165) happens on the host: each query block is compacted to
the *union* of its trigram ids (so the device matmul contracts over a small
shared axis) plus a dense (block × union) IDF-weight matrix.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from doppelspeller.config import TRIGRAM_VOCAB_SIZE, Config, get_config
from doppelspeller.utils import text as T
from doppelspeller.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def title_content_hash(encoded: np.ndarray, lengths: np.ndarray) -> str:
    """Digest of the encoded titles — detects truth-title edits that keep the
    same ids/count (checkpoint-staleness guard)."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(lengths.astype(np.int32)).tobytes())
    h.update(np.ascontiguousarray(encoded).tobytes())
    return h.hexdigest()


@dataclass
class TruthIndex:
    """Host-side representation of the packed truth index."""

    packed: np.ndarray      # uint8[V, ntp//8] little-endian bit-packed occupancy
    idf: np.ndarray         # float32[V] log(N/df), 0 for unobserved trigrams
    df: np.ndarray          # int32[V] document frequency (distinguishes an
                            #   observed everywhere-trigram, idf exactly 0,
                            #   from an unobserved one — reference
                            #   match_maker.py:151 only falls back to max_idf
                            #   for trigrams absent from the mapping)
    sums: np.ndarray        # float32[ntp] per-title IDF sum (0 for padding)
    title_ids: np.ndarray   # int64[nt] external title ids
    num_titles: int         # nt (real titles)
    padded_titles: int      # ntp (multiple of title_block)
    max_idf: float          # fallback IDF for query trigrams absent in truth
    content_hash: str = ""  # digest of the encoded truth titles

    @property
    def vocab_size(self) -> int:
        return self.packed.shape[0]

    @property
    def packed_nbytes(self) -> int:
        """Logical size of the bit matrix, whatever its resident layout."""
        return self.packed.shape[0] * (self.padded_titles // 8)

    def save(self, path: str) -> None:
        """Checkpoint the built index (new capability — the reference rebuilds
        its MatchMaker from CSV on every run, SURVEY.md §5).  A device-built
        packed matrix is fetched once here (the only time it crosses back)."""
        packed = self.packed
        if packed.shape[1] == 0 and self.padded_titles > 0:
            # mesh-built index (parallel/sharded.build_sharded_index): the
            # matrix exists only as per-device shards this TruthIndex cannot
            # see — the SCORER checkpoints it shard-by-shard
            raise ValueError(
                    "cannot checkpoint a mesh-built index from TruthIndex: "
                    "the packed matrix lives only as device shards; call "
                    "ShardedJaccardScorer.save(path) instead (host peak "
                    "stays at one shard)"
                )
        np.savez_compressed(
            path,
            packed=np.asarray(packed),
            idf=self.idf,
            df=self.df,
            sums=self.sums,
            title_ids=self.title_ids,
            num_titles=np.int64(self.num_titles),
            padded_titles=np.int64(self.padded_titles),
            max_idf=np.float32(self.max_idf),
            content_hash=np.str_(self.content_hash),
        )

    @classmethod
    def load(cls, path: str) -> "TruthIndex":
        """Load a checkpoint.  Accepts both the single-chip format and the
        mesh-sharded format written by ShardedJaccardScorer.save (shards are
        concatenated column-wise into a full host matrix — use
        ShardedJaccardScorer.load to keep it sharded)."""
        z = np.load(path)
        if "shard_format" in z.files:
            n_shards = int(z["shard_cols"].shape[0]) - 1
            nbytes = int(z["padded_titles"]) // 8
            packed = np.concatenate(
                [z[f"packed_shard_{i}"] for i in range(n_shards)], axis=1
            )[:, :nbytes]
        else:
            packed = z["packed"]
        return cls(
            packed=packed,
            idf=z["idf"],
            df=z["df"],
            sums=z["sums"],
            title_ids=z["title_ids"],
            num_titles=int(z["num_titles"]),
            padded_titles=int(z["padded_titles"]),
            max_idf=float(z["max_idf"]),
            content_hash=str(z["content_hash"]),
        )


def build_truth_index(truth: TitleSet, config: Optional[Config] = None) -> TruthIndex:
    """Build the packed index from a truth TitleSet.

    Semantics parity: IDF = ln(N/df) with per-title-unique trigram df
    (reference match_maker.py:91-95,135-142); per-title sums as at
    match_maker.py:174.

    With ``cfg.index_build_impl`` "device" (or "auto" where
    backend.index_build_route says so) the bit matrix is built on the device
    from the uploaded encodings (ops/index_device.py) and ``.packed`` is a
    device array — bit-for-bit equal to the host build, without the
    multi-GB host→device transfer.
    """
    cfg = config or get_config()
    impl = cfg.index_build_impl
    if impl == "auto":
        from doppelspeller.backend import index_build_route

        impl = index_build_route()
    if impl == "device":
        from doppelspeller.ops.index_device import build_truth_index_device

        return build_truth_index_device(truth, cfg)
    nt = len(truth)
    ntp = _round_up(max(nt, cfg.title_block), cfg.title_block)
    nbytes = ntp // 8

    LOGGER.info("[TruthIndex] building packed index: %d titles (padded %d)", nt, ntp)

    from doppelspeller.native import build_index_native

    native = build_index_native(truth.encoded, truth.lengths, TRIGRAM_VOCAB_SIZE, ntp)
    if native is not None:
        packed, df, flat_ids, flat_counts = native
        idf = T.idf_table_from_df(df, nt)
        max_idf = float(idf.max()) if nt > 0 else 0.0
        sums = np.zeros(ntp, dtype=np.float32)
        offsets = np.zeros(nt, dtype=np.int64)
        np.cumsum(flat_counts[:-1], out=offsets[1:])
        sums[:nt] = np.add.reduceat(
            idf[flat_ids].astype(np.float64), offsets
        ).astype(np.float32)
    else:
        # pure-numpy fallback
        grams: List[np.ndarray] = [
            T.trigram_ids_from_codes(truth.encoded[i], int(truth.lengths[i]))
            for i in range(nt)
        ]
        df = np.zeros(TRIGRAM_VOCAB_SIZE, dtype=np.int32)
        for g in grams:
            df[g] += 1
        idf = T.idf_table_from_df(df, nt)
        max_idf = float(idf.max()) if nt > 0 else 0.0

        # Bit-pack: bit t of row g ⟺ title t contains trigram g (little-endian)
        packed = np.zeros((TRIGRAM_VOCAB_SIZE, nbytes), dtype=np.uint8)
        all_g = np.concatenate(grams) if grams else np.zeros(0, dtype=np.int32)
        all_t = np.repeat(
            np.arange(nt, dtype=np.int64), [len(g) for g in grams]
        )
        np.bitwise_or.at(
            packed,
            (all_g.astype(np.int64), all_t >> 3),
            (np.uint8(1) << (all_t & 7).astype(np.uint8)),
        )

        sums = np.zeros(ntp, dtype=np.float32)
        for t, g in enumerate(grams):
            sums[t] = idf[g].sum(dtype=np.float64)

    return TruthIndex(
        packed=packed,
        idf=idf,
        df=df,
        sums=sums,
        title_ids=truth.ids.copy(),
        num_titles=nt,
        padded_titles=ntp,
        max_idf=max_idf,
        content_hash=title_content_hash(truth.encoded, truth.lengths),
    )


@dataclass
class QueryBlockPlan:
    """One static-shaped device call: ≤ query_block queries whose trigram-id
    union fits in ``union_size`` slots.

    The (query × union) IDF-weight matrix is shipped *sparse* — per-query
    positions into the union plus values — and densified on device (the
    dense matrix is ~30× larger than the sparse form)."""

    query_rows: np.ndarray    # int64[qb] row numbers into the query set
    union_ids: np.ndarray     # int32[union_size] gather rows (padded with 0)
    w_pos: np.ndarray         # int32[query_block, LQ] positions into union
                              # (== union_size ⇒ padding slot)
    w_val: np.ndarray         # float32[query_block, LQ] IDF weights
    max_intersection: np.ndarray  # float32[query_block] union-IDF upper bound
    n_valid: int              # number of real queries in this block

    @property
    def weights(self) -> np.ndarray:
        """Dense float32[qb, union_size] weight matrix (tests/oracles)."""
        qb, lq = self.w_pos.shape
        u = self.union_ids.shape[0]
        w = np.zeros((qb, u + 1), dtype=np.float32)
        w[np.arange(qb)[:, None], self.w_pos] = self.w_val
        return w[:, :u]


def plan_query_blocks(
    queries: TitleSet,
    index: TruthIndex,
    config: Optional[Config] = None,
    rows: Optional[np.ndarray] = None,
) -> List[QueryBlockPlan]:
    """Fully-vectorized host planner: pack queries into fixed-shape blocks.

    Blocks hold ``cfg.query_block`` queries with a trigram-id union of at
    most ``cfg.query_block * 32`` slots (static shapes — one XLA program).
    A block whose union overflows is split in half recursively, never
    dropping trigrams.  The max-intersection term uses the IDF-or-max-IDF
    fallback of reference match_maker.py:151,197; scoring weights use real
    IDF only (unobserved query trigrams contribute 0 to the numerator,
    exactly like the reference scatter over truth rows, match_maker.py:46-48).
    """
    cfg = config or get_config()
    if rows is None:
        rows = np.arange(len(queries), dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return []

    qb = cfg.query_block
    buckets = sorted(getattr(cfg, "union_buckets", None) or (qb * 32,))
    union_cap = buckets[-1]
    BIG = T.BIG_TRIGRAM

    ids_all = queries.trigram_ids()[rows]      # cached per TitleSet
    valid_all = ids_all != BIG

    # per-query trigram count → one static LQ bucket for the whole run
    # (ladder {max_query_trigrams, 128, 253} keeps the compiled-program
    # count small and independent of the longest title in this batch; no
    # trigrams are ever dropped — a run with any longer query simply uses
    # the next bucket)
    counts = valid_all.sum(axis=1)
    mqt = cfg.max_query_trigrams
    need = int(counts.max(initial=1))
    lq = next(b for b in (mqt, 128, 253) if need <= b or b == 253)
    if ids_all.shape[1] < lq:
        ids_all = np.concatenate([
            ids_all,
            np.full((ids_all.shape[0], lq - ids_all.shape[1]), BIG, np.int32),
        ], axis=1)
        valid_all = ids_all != BIG
    lq = min(lq, ids_all.shape[1])

    clipped = np.clip(ids_all, 0, index.idf.shape[0] - 1)
    idf_g = index.idf[clipped]
    # max-IDF fallback only for trigrams UNOBSERVED in truth (df == 0); an
    # everywhere-trigram has idf exactly 0 but is present in the reference's
    # mapping and adds nothing (match_maker.py:151,197)
    w_fb = np.where(index.df[clipped] > 0, idf_g, np.float32(index.max_idf))
    maxint_all = (w_fb * valid_all).sum(axis=1, dtype=np.float64).astype(np.float32)

    plans: List[QueryBlockPlan] = []

    def emit(sel: np.ndarray) -> None:
        """Build one plan from query indices ``sel`` (into rows/ids_all),
        splitting recursively if the union overflows."""
        blk_ids = ids_all[sel]
        union = np.unique(blk_ids)
        union = union[union != BIG]
        if len(union) > union_cap:
            mid = max(len(sel) // 2, 1)
            emit(sel[:mid])
            emit(sel[mid:])
            return
        m = len(sel)
        # pad the union to the smallest static bucket that holds it — the
        # scoring matmul and bit unpack are O(union), so a 2.2k union in a
        # fixed 8k slot would waste 3.6x the retrieval FLOPs (one compiled
        # program per occupied bucket)
        u_size = next(b for b in buckets if len(union) <= b)
        union_ids = np.zeros(u_size, dtype=np.int32)
        union_ids[: len(union)] = union
        pos = np.searchsorted(union, blk_ids[:, :lq])   # (m, lq)
        v = valid_all[sel][:, :lq]
        pos = np.where(v, pos, u_size)                  # dump column
        w_pos = np.full((qb, lq), u_size, dtype=np.int32)
        w_val = np.zeros((qb, lq), dtype=np.float32)
        w_pos[:m] = pos
        w_val[:m] = idf_g[sel][:, :lq] * v
        maxint = np.zeros(qb, dtype=np.float32)
        maxint[:m] = maxint_all[sel]
        plans.append(
            QueryBlockPlan(
                query_rows=rows[sel],
                union_ids=union_ids,
                w_pos=w_pos,
                w_val=w_val,
                max_intersection=maxint,
                n_valid=m,
            )
        )

    for start in range(0, len(rows), qb):
        emit(np.arange(start, min(start + qb, len(rows)), dtype=np.int64))
    return plans
