"""Pallas kernel (Triton route) for the folded coarse retrieval pass.

The plain XLA scorer (jaccard.topk_over_blocks) unpacks each title block's
folded bits into a bf16 matrix, runs one matrix product per fold, and only
then takes the two-fold minimum, the Jaccard normalisation and the
per-window maximum — XLA does not fuse a minimum across two products or a
max-reduction epilogue into the product, so the (QB, TB) f32 scores of every
fold go through device memory.

Here one program owns a (query tile × title tile).  It loads the tile's
packed bytes, unpacks each bit plane ``s`` to {0, 1} bf16 by shift and mask
in registers, and runs one ``pl.dot`` per fold against that fold's weights
with f32 accumulation.  Bit plane ``s`` of byte ``b`` is title ``8b + s``,
so the eight planes of a byte are a window of eight consecutive titles: the
kernel keeps the running (max, first argmax) over the planes and writes only
(QB, ntp/8) window maxima and offsets — the scores never leave the SM.
``jaccard.topk_over_blocks(..., window=8)`` computes the same windows in
plain XLA and is this kernel's reference.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

WINDOW = 8          # titles per output window: the 8 bits of one byte


def _coarse_kernel(w_ref, mc_ref, sums_ref, maxint_ref, nt_ref,
                   wmax_ref, warg_ref, *, folds: int, ck: int):
    """One (query tile, title tile) program.

    w_ref      (QT, folds·C) bf16 — this query tile's folded weights
    mc_ref     (folds·C, NB) u8   — this title tile's packed fold rows
    sums_ref   (8, NB) f32        — sums_ref[s, b] = IDF sum of title 8b+s
    maxint_ref (QT,) f32, nt_ref () i32
    wmax_ref   (QT, NB) f32, warg_ref (QT, NB) i32 — per-byte window
    """
    qt = w_ref.shape[0]
    nb = mc_ref.shape[1]
    C = mc_ref.shape[0] // folds
    byte0 = pl.program_id(1) * nb
    maxint = maxint_ref[...]
    nt = nt_ref[...]
    title8 = 8 * (byte0 + jnp.arange(nb, dtype=jnp.int32))

    best = jnp.full((qt, nb), -2.0, jnp.float32)
    arg = jnp.zeros((qt, nb), jnp.int32)
    for s in range(WINDOW):
        num = None
        for f in range(folds):
            def body(i, acc, f=f, s=s):
                c0 = f * C + i * ck
                w = w_ref[:, pl.ds(c0, ck)]
                byt = mc_ref[pl.ds(c0, ck), :].astype(jnp.int32)
                bits = ((byt >> s) & 1).astype(w.dtype)
                return acc + pl.dot(w, bits)

            acc = jax.lax.fori_loop(0, C // ck, body,
                                    jnp.zeros((qt, nb), jnp.float32))
            num = acc if num is None else jnp.minimum(num, acc)
        denom = sums_ref[s, :][None, :] + maxint[:, None] - num
        jacc = num / jnp.maximum(denom, 1e-9)
        jacc = jnp.where((title8 + s < nt)[None, :], jacc, -1.0)
        upd = jacc > best                        # strict: first max wins
        best = jnp.where(upd, jacc, best)
        arg = jnp.where(upd, s, arg)
    wmax_ref[...] = best
    warg_ref[...] = arg


def _tiles(qb: int, nbytes: int, C: int):
    qt = 64 if qb >= 64 else 16
    nb = 64
    while nbytes % nb:
        nb //= 2
    if nb < 16 or C % 16:
        raise ValueError(
            f"coarse kernel needs a multiple of 128 titles and a fold width "
            f"divisible by 16 (got {nbytes * 8} titles, C={C})"
        )
    return qt, nb, min(64, C)


@partial(jax.jit, static_argnames=("folds", "interpret"))
def coarse_window_max(mc, sums, wfold, maxint, nt, *, folds: int,
                      interpret: bool = False):
    """Per-window coarse maxima over all titles.

    mc (folds·C, ntp/8) u8, sums (ntp,) f32, wfold (QB, folds·C),
    maxint (QB,) f32, nt () i32 → (wmax f32[QB, ntp/8], warg i32[QB, ntp/8])
    where window b holds titles 8b..8b+7 and ``warg`` is the offset of its
    first maximum.  ``interpret=True`` runs the kernel in the Pallas
    interpreter (tests only)."""
    qb = wfold.shape[0]
    rows, nbytes = mc.shape
    qt, nb, ck = _tiles(qb, nbytes, rows // folds)
    qbp = -(-qb // qt) * qt
    w = wfold.astype(jnp.bfloat16)
    if qbp != qb:
        w = jnp.pad(w, ((0, qbp - qb), (0, 0)))
        maxint = jnp.pad(maxint, (0, qbp - qb))
    sums8 = sums.reshape(nbytes, WINDOW).T                    # (8, ntp/8)
    wmax, warg = pl.pallas_call(
        partial(_coarse_kernel, folds=folds, ck=ck),
        grid=(qbp // qt, nbytes // nb),
        in_specs=[
            pl.BlockSpec((qt, rows), lambda i, j: (i, 0)),
            pl.BlockSpec((rows, nb), lambda i, j: (0, j)),
            pl.BlockSpec((WINDOW, nb), lambda i, j: (0, j)),
            pl.BlockSpec((qt,), lambda i, j: (i,)),
            pl.BlockSpec((), lambda i, j: ()),
        ],
        out_specs=[
            pl.BlockSpec((qt, nb), lambda i, j: (i, j)),
            pl.BlockSpec((qt, nb), lambda i, j: (i, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((qbp, nbytes), jnp.float32),
            jax.ShapeDtypeStruct((qbp, nbytes), jnp.int32),
        ],
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="coarse_window_max",
    )(w, mc, sums8, maxint.astype(jnp.float32), jnp.asarray(nt, jnp.int32))
    return wmax[:qb], warg[:qb]


def coarse_topk(mc, sums, wfold, maxint, nt, *, k: int, folds: int,
                merge: int = 4096, interpret: bool = False):
    """Top-k titles by coarse score: the kernel's window maxima, then a
    blocked exact top-k (``merge`` windows per block) and a final merge."""
    wmax, warg = coarse_window_max(mc, sums, wfold, maxint, nt, folds=folds,
                                   interpret=interpret)
    qb, nw = wmax.shape
    merge = min(merge, nw)
    while nw % merge:
        merge //= 2
    kb = min(k, merge)
    v, wi = jax.lax.top_k(wmax.reshape(qb, nw // merge, merge), kb)
    wi = wi + (jnp.arange(nw // merge, dtype=jnp.int32) * merge)[None, :, None]
    v, sel = jax.lax.top_k(v.reshape(qb, -1), k)
    wi = jnp.take_along_axis(wi.reshape(qb, -1), sel, axis=1)
    pos = wi * WINDOW + jnp.take_along_axis(warg, wi, axis=1)
    return v, pos.astype(jnp.int32)
