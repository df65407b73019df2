"""On-device construction of the packed trigram index.

The host path (ngram_index.build_truth_index) bit-packs with numpy/C++ and
then ships the whole matrix to the device — ~3.3 GB at 500k titles, and
~63 GB of host RAM at 10M titles.  The device path ships only the encoded
titles (~128 MB at 500k) and builds the bit matrix in device memory:

* per title block: trigram ids on device (windowed affine combine of the
  char codes), per-title dedup via an in-row sort, one 2-D scatter-add into
  a (V, TB) occupancy byte matrix, then an 8→1 bit-pack reduction into the
  output columns (dynamic_update_slice into a donated device buffer — no
  multi-GB copy per block);
* document frequencies accumulate per block on device (row sums) and the
  per-title IDF sums run as a second cheap gather pass once the global IDF
  table exists.

Replaces the capability of reference match_maker.py:74-178; produces
bit-for-bit the same packed matrix as the host builder (tested).  The byte
scatter-add of distinct bits never carries, so its order (atomics on the
GPU) cannot change the result.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from doppelspeller.config import TRIGRAM_VOCAB_SIZE, Config, get_config
from doppelspeller.utils import text as T
from doppelspeller.utils.io import TitleSet

LOGGER = logging.getLogger(__name__)

V = TRIGRAM_VOCAB_SIZE
N = T.N_TEXT_CHARS


def _device_trigram_ids(enc: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """int32[B, L-2] per-title unique trigram ids, invalid/duplicate → V.

    Device twin of text.trigram_ids_matrix (same sort-dedup semantics)."""
    B, L = enc.shape
    text = jnp.asarray(T._FEATURE_TO_TEXT, jnp.int32)[enc]          # (B, L)
    ids = text[:, :-2] * (N * N) + text[:, 1:-1] * N + text[:, 2:]  # (B, L-2)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L - 2), 1)
    valid = pos <= (lengths[:, None] - 3)
    ids = jnp.where(valid, ids, V)
    ids = jnp.sort(ids, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), bool), ids[:, 1:] == ids[:, :-1]], axis=1
    )
    return jnp.where(dup, V, ids)


def _scatter_block(enc_blk, len_blk):
    """(packed_blk uint8[V, TB//8], df_blk int32[V]) for one title block.

    One 2-D scatter-add builds the packed byte matrix DIRECTLY: title t of
    the block contributes bit value ``1 << (t % 8)`` at byte column
    ``t // 8`` (little-endian — bit-for-bit the host packer's layout,
    ngram_index.build_truth_index).  Per-title trigram ids are deduped, so
    every (trigram, title) bit is added exactly once and byte sums never
    carry.  Document frequencies come from an elementwise popcount."""
    TB = enc_blk.shape[0]
    ids = _device_trigram_ids(enc_blk, len_blk)                     # (TB, S)
    S = ids.shape[1]
    t = jax.lax.broadcasted_iota(jnp.int32, (TB, S), 0)             # title in block
    bitval = (jnp.uint8(1) << (t % 8).astype(jnp.uint8))
    occ = jnp.zeros((V + 1, TB // 8), jnp.uint8)
    occ = occ.at[ids.reshape(-1), (t // 8).reshape(-1)].add(
        bitval.reshape(-1), mode="drop", unique_indices=False
    )
    packed_blk = occ[:V]
    df_blk = jnp.zeros((V,), jnp.int32)
    for j in range(8):                                              # popcount
        df_blk = df_blk + ((packed_blk >> j) & 1).sum(axis=1, dtype=jnp.int32)
    return packed_blk, df_blk


@partial(jax.jit, donate_argnums=(0, 1))
def _build_block(packed, df, enc_blk, len_blk, byte0):
    """Scatter one title block into the donated packed matrix.

    ``packed`` uint8[V, ntp//8] (donated, updated at byte column ``byte0``),
    ``df`` int32[V] (donated running document frequencies),
    ``enc_blk`` uint8[TB, L] with TB % 8 == 0."""
    packed_blk, df_blk = _scatter_block(enc_blk, len_blk)
    packed = jax.lax.dynamic_update_slice(packed, packed_blk, (0, byte0))
    return packed, df + df_blk


def shard_build_fn(TB: int, axis: str):
    """Per-device builder for a mesh-sharded index (parallel/sharded.py).

    Returns ``fn(enc_l, len_l) -> (packed_l uint8[V, nb_l], df int32[V])``
    to run under ``shard_map`` with in_specs (P(axis, None), P(axis)) and
    out_specs (P(None, axis), P()): each device scatters only its own
    title-column shard from its local slice of the encodings, and document
    frequencies are psum-ed across devices.  No full packed matrix ever
    exists on the host or on any single device — this is the 10M-title
    scale path (ARCHITECTURE.md memory math)."""

    def fn(enc_l, len_l):
        ntp_l = enc_l.shape[0]
        nblk = ntp_l // TB

        def step(i, carry):
            packed_l, df = carry
            enc_b = jax.lax.dynamic_slice_in_dim(enc_l, i * TB, TB, 0)
            len_b = jax.lax.dynamic_slice_in_dim(len_l, i * TB, TB, 0)
            packed_blk, df_blk = _scatter_block(enc_b, len_b)
            packed_l = jax.lax.dynamic_update_slice(
                packed_l, packed_blk, (0, i * (TB // 8))
            )
            return packed_l, df + df_blk

        packed_l = jnp.zeros((V, ntp_l // 8), jnp.uint8)
        df = jnp.zeros((V,), jnp.int32)
        packed_l, df = jax.lax.fori_loop(0, nblk, step, (packed_l, df))
        return packed_l, jax.lax.psum(df, axis)

    return fn


def shard_sums_fn():
    """Per-device per-title IDF sums for a mesh-sharded index: returns
    ``fn(idf_tbl, enc_l, len_l) -> sums_l`` for shard_map with in_specs
    (P(), P(axis, None), P(axis)) and out_specs P(axis)."""

    def fn(idf_tbl, enc_l, len_l):
        ids = _device_trigram_ids(enc_l, len_l)
        w = jnp.concatenate([idf_tbl, jnp.zeros(1, jnp.float32)])
        return w[jnp.minimum(ids, V)].sum(axis=1)

    return fn


@jax.jit
def _sums_block(idf_tbl, enc_blk, len_blk):
    """float32[TB] per-title IDF sums (unique trigrams, like the host path)."""
    ids = _device_trigram_ids(enc_blk, len_blk)
    w = jnp.concatenate([idf_tbl, jnp.zeros(1, jnp.float32)])       # V → 0
    return w[jnp.minimum(ids, V)].sum(axis=1)


def build_truth_index_device(
    truth: TitleSet, config: Optional[Config] = None, block: int = 32768
):
    """Build a TruthIndex whose packed matrix is a DEVICE array.

    Bit-for-bit equal to ngram_index.build_truth_index's packed matrix, but
    only the encoded titles cross the host→device link.  ``index.packed``
    is a jax.Array; JaccardScorer detects this and skips its device_put,
    and TruthIndex.save fetches it once if a checkpoint is requested.
    """
    from doppelspeller.ops.ngram_index import TruthIndex, _round_up, title_content_hash

    cfg = config or get_config()
    nt = len(truth)
    ntp = _round_up(max(nt, cfg.title_block), cfg.title_block)
    import time as _time

    t0 = _time.time()
    df_d = jnp.zeros((V,), jnp.int32)
    L = truth.encoded.shape[1]
    blocks = []
    for s in range(0, ntp, block):
        tb = min(block, ntp - s)
        tb = _round_up(tb, 8)
        enc = np.zeros((tb, L), np.uint8)
        lens = np.zeros((tb,), np.int32)
        real = min(nt - s, tb) if s < nt else 0
        if real > 0:
            enc[:real] = truth.encoded[s : s + real]
            lens[:real] = truth.lengths[s : s + real]
        blocks.append((jnp.asarray(enc), jnp.asarray(lens), s))
    packed = jnp.zeros((V, ntp // 8), jnp.uint8)
    for enc_d, len_d, s in blocks:
        packed, df_d = _build_block(
            packed, df_d, enc_d, len_d, jnp.int32(s // 8)
        )
    df = np.asarray(df_d)
    idf = T.idf_table_from_df(df, nt)
    max_idf = float(idf.max()) if nt > 0 else 0.0
    idf_d = jnp.asarray(idf)
    sums = np.zeros(ntp, dtype=np.float32)
    pend = [
        (s, _sums_block(idf_d, enc_d, len_d)) for enc_d, len_d, s in blocks
    ]
    for s, v in zip([p[0] for p in pend], jax.device_get([p[1] for p in pend])):
        e = min(s + len(v), ntp)
        sums[s:e] = v[: e - s]
    sums[nt:] = 0.0
    LOGGER.info(
        "[TruthIndex] device build: %d titles (padded %d) in %.1fs",
        nt, ntp, _time.time() - t0,
    )
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
