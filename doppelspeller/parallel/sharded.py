"""Multi-chip execution: sharded truth index + data-parallel GBT training.

New capabilities with no reference equivalent (the reference is single-node
numba threading; its README frames distribution as future work, README.md:79-80).
Design per SURVEY.md §2.4:

* **Sharded retrieval**: the bit-packed truth matrix is sharded over the
  *title* axis across a 1-D ``jax.sharding.Mesh``.  Every device scores its
  local shard (same scorer as one device), computes a local top-k, and the
  (score, global-position) pairs are merged with one all-gather —
  k·n_devices candidates reduced back to k on every device.
* **Data-parallel GBT**: samples are sharded over the batch axis; each
  device histograms its shard and the (node, feature, bin) G/H histograms
  are psum-ed inside the tree builder, so all devices grow the identical
  tree (distributed XGBoost-style histogram aggregation).
"""

from __future__ import annotations

import logging
from dataclasses import replace
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from doppelspeller.config import Config, get_config
from doppelspeller.models.gbt import (
    build_tree_kernel,
    margin_grad_hess,
    predict_tree_binned,
)
from doppelspeller.ops.jaccard import (
    collect_topk,
    densify_weights,
    folded_wanted,
    topk_over_blocks,
    union_weights,
)
from doppelspeller.ops.ngram_index import TruthIndex

LOGGER = logging.getLogger(__name__)


def make_mesh(n_devices: Optional[int] = None, axis: str = "titles",
              platform: Optional[str] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices of ``platform``
    (default: JAX's default platform).  ``platform='cpu'`` selects the
    virtual CPU devices (``--xla_force_host_platform_device_count``) even
    when a GPU is the default backend."""
    devices = jax.devices(platform) if platform else jax.devices()
    n = n_devices or len(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n]), (axis,))


# ------------------------------------------------------------ sharded index

class _MeshFolded:
    """Per-shard folded-retrieval state (ops/fold.py brought to the mesh).

    Each device holds its own title-column shard of the folded occupancy
    matrix ``Mc[C, ntp_local/8]`` and its own row shard of the trigram-list
    matrix ``TL[ntp_local, Ltw]``; the fold map and the IDF tables are
    replicated.  Shards are built with the same tested device scatter as the
    single-device engine (fold.build_folded_matrix / build_trigram_list_matrix),
    one device at a time from the local encoding slice — host peak stays
    ≈ one shard of encodings, and no global folded matrix ever exists."""

    def __init__(self, index: TruthIndex, truth, mesh: Mesh, cfg: Config,
                 ntp_pad: int, rep: NamedSharding, axis: str):
        from doppelspeller.ops.fold import (
            build_fold_map,
            build_folded_matrix,
            build_trigram_list_matrix,
            resolve_coarse_route,
        )

        self.C = cfg.fold_dim
        self.kprime = cfg.rescore_depth
        self.folds = max(1, cfg.fold_hashes)
        self.route = resolve_coarse_route(cfg, mesh.devices.flat[0])
        D = mesh.devices.size
        ntp_local = ntp_pad // D
        folds_np = [build_fold_map(index.df, self.C, seed=f)
                    for f in range(self.folds)]
        # global trigram-list width: every shard must agree so the per-shard
        # matrices tile into ONE sharded array
        l_eff = int(truth.lengths.max(initial=3)) if len(truth) else 3
        self.ltw = max(((l_eff - 2 + 7) // 8) * 8, 8)
        import time as _t

        t0 = _t.time()
        mc_shards, tl_shards = [], []
        for i, dev in enumerate(np.ravel(mesh.devices)):
            lo = i * ntp_local
            enc = truth.encoded[lo : lo + ntp_local]
            lens = truth.lengths[lo : lo + ntp_local]
            mcs = [build_folded_matrix(
                enc, lens, fm, self.C, ntp_local, device=dev,
            ) for fm in folds_np]
            mc_shards.append(
                mcs[0] if self.folds == 1 else jnp.concatenate(mcs, axis=0))
            if self.kprime > 0:
                tl, _ = build_trigram_list_matrix(
                    enc, lens, ntp_local, device=dev, ltw=self.ltw,
                )
                tl_shards.append(tl)
        self.mc_d = jax.make_array_from_single_device_arrays(
            (self.folds * self.C, ntp_pad // 8),
            NamedSharding(mesh, P(None, axis)),
            mc_shards,
        )
        if self.kprime > 0:
            self.tl_d = jax.make_array_from_single_device_arrays(
                (ntp_pad, self.ltw), NamedSharding(mesh, P(axis, None)),
                tl_shards,
            )
        else:
            self.tl_d = None
        zero = np.zeros(1, np.float32)
        self.fold_ext_d = jax.device_put(np.stack(folds_np), rep)
        self.idf_ext_d = jax.device_put(
            np.concatenate([index.idf, zero]), rep
        )
        fb = np.where(index.df > 0, index.idf, np.float32(index.max_idf))
        self.fb_ext_d = jax.device_put(
            np.concatenate([fb.astype(np.float32), zero]), rep
        )
        LOGGER.info(
            "[_MeshFolded] C=%d hashes=%d kprime=%d ltw=%d on %d devices in "
            "%.1fs: Mc %.1f MB/shard, TL %.1f MB/shard",
            self.C, self.folds, self.kprime, self.ltw, D, _t.time() - t0,
            self.folds * self.C * (ntp_local // 8) / 1e6,
            (ntp_local * self.ltw * 2 / 1e6) if self.tl_d is not None else 0.0,
        )


class ShardedJaccardScorer:
    """Retrieval over a truth index sharded across a mesh's title axis."""

    def __init__(self, index: TruthIndex, mesh: Mesh,
                 config: Optional[Config] = None, _device_arrays=None,
                 truth=None):
        """``truth``: the TitleSet behind ``index`` — required for the
        two-stage FOLDED retrieval engine (its per-shard matrices are built
        on device from the encodings).  ``retrieval_mode`` is honored
        exactly as by the single-device JaccardScorer (jaccard.folded_wanted)."""
        self.cfg = config or get_config()
        if _device_arrays is None and not isinstance(index.packed, np.ndarray):
            # single-device device-built index (index_device.py) lands on one
            # device; the shard-wise placement below slices on host.  (The
            # no-host-matrix path is build_sharded_index, which constructs
            # per-shard directly on the mesh and passes _device_arrays.)
            index = replace(index, packed=np.asarray(index.packed))
        self.index = index
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        n_dev = mesh.devices.size
        ntp = index.padded_titles
        # pad the title axis to a multiple of (devices * title_block)
        chunk = n_dev * self.cfg.title_block
        ntp_pad = ((ntp + chunk - 1) // chunk) * chunk
        self.ntp = ntp_pad
        # shard-wise placement: each device receives only its own slice of
        # the packed matrix (padding materialized per-shard), so host peak
        # memory is index.packed + ONE shard — never a second full padded
        # copy (~63 GB at 10M titles; memory math in ARCHITECTURE.md).
        if _device_arrays is not None:
            # mesh-built index (build_sharded_index): the packed shards and
            # per-title sums are already resident
            self.packed_d, self.sums_d = _device_arrays
        else:
            self._place_host_index(index, mesh, ntp_pad)
        self._init_common(index, mesh)
        self.folded = None
        if folded_wanted(self.cfg, index.num_titles, truth):
            self.folded = _MeshFolded(
                self.index, truth, self.mesh, self.cfg, self.ntp, self._rep,
                self.axis,
            )

    def _place_host_index(self, index, mesh, ntp_pad):
        """Ship a host-built packed index to the mesh shard-by-shard."""
        n_dev = mesh.devices.size

        def _shards(src, per, dtype):
            out = []
            for i, dev in enumerate(np.ravel(mesh.devices)):
                lo = i * per
                sl = src[..., lo : lo + per]
                if sl.shape[-1] < per:
                    pad_shape = sl.shape[:-1] + (per - sl.shape[-1],)
                    sl = np.concatenate(
                        [sl, np.zeros(pad_shape, dtype)], axis=-1
                    )
                out.append(jax.device_put(np.ascontiguousarray(sl), dev))
            return out

        self.packed_d = jax.make_array_from_single_device_arrays(
            (index.vocab_size, ntp_pad // 8),
            NamedSharding(mesh, P(None, self.axis)),
            _shards(index.packed, ntp_pad // n_dev // 8, np.uint8),
        )
        self.sums_d = jax.make_array_from_single_device_arrays(
            (ntp_pad,),
            NamedSharding(mesh, P(self.axis)),
            _shards(index.sums, ntp_pad // n_dev, np.float32),
        )

    def _init_common(self, index, mesh):
        # replicated-on-mesh sharding for small per-call inputs: every array
        # this scorer touches is explicitly placed on the mesh's devices, so
        # the scorer works regardless of the process default backend
        self._rep = NamedSharding(mesh, P())
        self.nt = jax.device_put(np.int32(index.num_titles), self._rep)
        # resident IDF tables for on-device weight reconstruction (multiblock)
        self.idf_d = jax.device_put(index.idf, self._rep)
        fb = np.where(index.df > 0, index.idf, np.float32(index.max_idf))
        self.fb_d = jax.device_put(fb.astype(np.float32), self._rep)
        self._zero1 = jax.device_put(np.zeros(1, np.int32), self._rep)
        self._mb_cache = {}

        axis = self.axis
        title_block = self.cfg.title_block
        score_dtype = self.cfg.score_dtype

        def _sharded(packed_l, sums_l, union_ids, w_pos, w_val, maxint, nt, *, k):
            idx = jax.lax.axis_index(axis)
            ntp_local = packed_l.shape[1] * 8
            weights = densify_weights(
                w_pos, w_val, union_ids.shape[0], jnp.dtype(score_dtype)
            )
            vals, pos = topk_over_blocks(
                packed_l[union_ids], sums_l, weights, maxint,
                idx.astype(jnp.int32) * ntp_local, nt,
                k=k, title_block=title_block, score_dtype=score_dtype,
            )
            # merge across shards: one all-gather of (k) candidates each
            all_vals = jax.lax.all_gather(vals, axis)       # (D, QB, k)
            all_pos = jax.lax.all_gather(pos, axis)
            D = all_vals.shape[0]
            qb = vals.shape[0]
            flat_v = jnp.transpose(all_vals, (1, 0, 2)).reshape(qb, D * k)
            flat_p = jnp.transpose(all_pos, (1, 0, 2)).reshape(qb, D * k)
            mv, sel = jax.lax.top_k(flat_v, k)
            mp = jnp.take_along_axis(flat_p, sel, axis=1)
            return mv, mp

        self._sharded = _sharded

    def topk_kernel(self, union_ids, w_pos, w_val, maxint, k: int):
        axis = self.axis
        # after the all-gather + merge the outputs are replicated, but the
        # checker cannot statically infer that — disable the check
        fn = shard_map(
            partial(self._sharded, k=k),
            mesh=self.mesh,
            in_specs=(P(None, axis), P(axis), P(), P(), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        # pin the small per-call inputs to the mesh devices (never the
        # process default backend)
        union_ids, w_pos, w_val, maxint = (
            jax.device_put(np.asarray(x), self._rep)
            for x in (union_ids, w_pos, w_val, maxint)
        )
        return jax.jit(fn)(
            self.packed_d, self.sums_d, union_ids, w_pos, w_val, maxint, self.nt
        )

    def _multiblock_fn(self, u: int, qb: int, lq: int, k: int, probe: bool):
        """shard_map'd scan over G query blocks: per-device local scoring +
        local top-k, ONE all-gather for the whole group, replicated merge.
        Mirrors jaccard._topk_multiblock with the title axis sharded.
        Jitted once per (u, qb, lq, k, probe) — cached on the instance."""
        key = (u, qb, lq, k, probe)
        cached = self._mb_cache.get(key)
        if cached is not None:
            return cached
        axis = self.axis
        title_block = self.cfg.title_block
        score_dtype = self.cfg.score_dtype

        def fn(packed_l, sums_l, idf_tbl, fb_tbl, buf, nt, t_len, t_wlen):
            dtype = jnp.dtype(score_dtype)
            idx = jax.lax.axis_index(axis)
            offset = idx.astype(jnp.int32) * packed_l.shape[1] * 8
            G = buf.shape[0] // (u + qb * lq)
            flat = buf.reshape(G, u + qb * lq)
            unions = flat[:, :u]
            w_pos = flat[:, u:].reshape(G, qb, lq)

            def step(_, x):
                union_ids, wp = x
                w_val, maxint, wp_c = union_weights(idf_tbl, fb_tbl,
                                                    union_ids, wp, u)
                w = densify_weights(wp_c, w_val, u, dtype)
                vals, pos = topk_over_blocks(
                    packed_l[union_ids], sums_l, w, maxint, offset, nt,
                    k=k, title_block=title_block, score_dtype=score_dtype,
                )
                return None, (vals, pos)

            _, (vals, pos) = jax.lax.scan(step, None, (unions, w_pos))
            # merge across shards: ONE all-gather for the whole group
            all_vals = jax.lax.all_gather(vals, axis)      # (D, G, QB, k)
            all_pos = jax.lax.all_gather(pos, axis)
            D = all_vals.shape[0]
            flat_v = jnp.transpose(all_vals, (1, 2, 0, 3)).reshape(G, qb, D * k)
            flat_p = jnp.transpose(all_pos, (1, 2, 0, 3)).reshape(G, qb, D * k)
            mv, sel = jax.lax.top_k(flat_v, k)
            mp = jnp.take_along_axis(flat_p, sel, axis=2)
            if probe:
                tl = t_len[mp].max(axis=2)                  # (G, QB)
                wl = t_wlen[mp].max(axis=2)
                return mv, mp, jnp.stack([tl, wl], axis=1)  # (G, 2, QB)
            return mv, mp

        out_specs = (P(), P(), P()) if probe else (P(), P())
        jitted = jax.jit(shard_map(
            fn,
            mesh=self.mesh,
            in_specs=(P(None, axis), P(axis), P(), P(), P(), P(), P(), P()),
            out_specs=out_specs,
            check_vma=False,
        ))
        self._mb_cache[key] = jitted
        return jitted

    def _folded_multiblock_fn(self, qb: int, lq: int, k: int, probe: bool):
        """shard_map'd folded retrieval over G query blocks: per-shard coarse
        upper-bound pass over the resident local Mc, per-shard EXACT rescore
        of the local coarse top-k' against the local TL rows, local top-k,
        ONE all-gather merge.  Mirrors fold._folded_multiblock_impl with the
        title axis sharded; per-shard rescore depth k' matches the
        single-device depth, so mesh recall is ≥ single-device recall (the union
        of per-shard coarse top-k' contains the global coarse top-k')."""
        key = ("folded", qb, lq, k, probe)
        cached = self._mb_cache.get(key)
        if cached is not None:
            return cached
        from doppelspeller.ops.fold import (
            _rescore_exact,
            coarse_candidates,
            coarse_window,
            fold_group_weights,
        )

        st = self.folded
        axis = self.axis
        D = self.mesh.devices.size
        ntp_local = self.ntp // D
        if ntp_local < k:
            raise ValueError(
                f"per-shard padded titles {ntp_local} < k={k}; use fewer "
                "devices or a larger title_block"
            )
        kprime = min(max(st.kprime, k), ntp_local) if st.kprime > 0 else k
        statics = dict(
            kprime=kprime, folds=st.folds, title_block=self.cfg.title_block,
            score_dtype=self.cfg.score_dtype, route=st.route,
            window=coarse_window(self.cfg),
        )
        rescore = st.tl_d is not None

        def fn(mc_l, tl_l, sums_l, idf_ext, fb_ext, fold_ext, buf, nt,
               t_len, t_wlen):
            idx = jax.lax.axis_index(axis)
            offset = idx.astype(jnp.int32) * ntp_local
            nt_local = jnp.clip(nt - offset, 0, ntp_local)
            G = buf.shape[0] // (qb * lq)
            flat = buf.reshape(G, qb, lq).astype(jnp.int32)
            # group-hoisted weight fold (mirrors fold._folded_multiblock_impl)
            wfold_all, wval_all, maxint_all = fold_group_weights(
                flat, idf_ext, fb_ext, fold_ext, C=st.C, folds=st.folds,
                dtype=jnp.dtype(self.cfg.score_dtype),
            )

            def step(_, blk):
                ids, wfold, w_val, maxint = blk
                vals_c, pos_c = coarse_candidates(
                    mc_l, sums_l, wfold, maxint, nt_local, **statics)
                if rescore:
                    vals, pos = _rescore_exact(
                        tl_l, sums_l, ids, w_val, maxint, vals_c, pos_c,
                        nt_local, k,
                    )
                else:
                    vals, pos = vals_c[:, :k], pos_c[:, :k]
                pos = pos + offset
                return None, (vals, pos)

            _, (vals, pos) = jax.lax.scan(
                step, None, (flat, wfold_all, wval_all, maxint_all))
            # merge across shards: ONE all-gather for the whole group
            all_vals = jax.lax.all_gather(vals, axis)      # (D, G, QB, k)
            all_pos = jax.lax.all_gather(pos, axis)
            Dg = all_vals.shape[0]
            flat_v = jnp.transpose(all_vals, (1, 2, 0, 3)).reshape(-1, qb, Dg * k)
            flat_p = jnp.transpose(all_pos, (1, 2, 0, 3)).reshape(-1, qb, Dg * k)
            mv, sel = jax.lax.top_k(flat_v, k)
            mp = jnp.take_along_axis(flat_p, sel, axis=2)
            if probe:
                tl = t_len[mp].max(axis=2)                  # (G, QB)
                wl = t_wlen[mp].max(axis=2)
                return mv, mp, jnp.stack([tl, wl], axis=1)  # (G, 2, QB)
            return mv, mp

        out_specs = (P(), P(), P()) if probe else (P(), P())
        tl_arr_spec = P(axis, None) if rescore else P(axis)
        jitted = jax.jit(shard_map(
            fn,
            mesh=self.mesh,
            in_specs=(P(None, axis), tl_arr_spec, P(axis),
                      P(), P(), P(), P(), P(), P(), P()),
            out_specs=out_specs,
            check_vma=False,
        ))
        self._mb_cache[key] = jitted
        return jitted

    def _topk_device_folded(self, queries, k: int, rows, probe_tables):
        """Folded-path twin of topk_device (mirrors JaccardScorer's folded
        dispatch: the host ships ONLY uint16 trigram ids per group)."""
        from doppelspeller.ops.fold import V as _V, plan_id_blocks

        st = self.folded
        plans = plan_id_blocks(queries, self.cfg, rows=rows)
        if not plans:
            return [], plans
        qb, lq = plans[0].ids.shape
        g = max(1, self.cfg.dispatch_blocks * self.cfg.query_block // qb)
        probe = probe_tables is not None
        if probe:
            t_len_d, t_wlen_d = probe_tables
        else:
            t_len_d = t_wlen_d = self._zero1
        # the rescore-disabled config passes the (unused) sums as the TL
        # operand so the shard_map signature stays fixed
        tl_arg = st.tl_d if st.tl_d is not None else self.sums_d
        fn = self._folded_multiblock_fn(qb, lq, k, probe)
        pending = []
        for s in range(0, len(plans), g):
            chunk = plans[s : s + g]
            buf = np.full((g, qb, lq), _V, dtype=np.uint16)
            for j, p in enumerate(chunk):
                buf[j] = p.ids
            out = fn(
                st.mc_d, tl_arg, self.sums_d,
                st.idf_ext_d, st.fb_ext_d, st.fold_ext_d,
                jax.device_put(buf.reshape(-1), self._rep), self.nt,
                t_len_d, t_wlen_d,
            )
            pending.append((chunk,) + tuple(out))
        return pending, plans

    def topk_device(self, queries, k: Optional[int] = None, rows=None,
                    probe_tables=None):
        """Same contract as JaccardScorer.topk_device (results stay on the
        mesh, replicated): returns (pending, plans)."""
        from doppelspeller.ops.jaccard import group_plan_buffers
        from doppelspeller.ops.ngram_index import plan_query_blocks

        k = k or self.cfg.top_n_predicting
        if self.folded is not None:
            return self._topk_device_folded(queries, k, rows, probe_tables)
        plans = plan_query_blocks(queries, self.index, self.cfg, rows=rows)
        if not plans:
            return [], plans
        g = max(1, self.cfg.dispatch_blocks)
        groups, qb, lq = group_plan_buffers(plans, g)
        probe = probe_tables is not None
        if probe:
            t_len_d, t_wlen_d = probe_tables
        else:
            t_len_d = t_wlen_d = self._zero1
        pending = []
        for chunk, buf, u in groups:
            fn = self._multiblock_fn(u, qb, lq, k, probe)
            out = fn(
                self.packed_d, self.sums_d, self.idf_d, self.fb_d,
                jax.device_put(buf, self._rep), self.nt, t_len_d, t_wlen_d,
            )
            pending.append((chunk,) + tuple(out))
        return pending, plans

    def topk(self, queries, k: Optional[int] = None, rows=None):
        """Same contract as JaccardScorer.topk, over the sharded index."""
        k = k or self.cfg.top_n_predicting
        pending, plans = self.topk_device(queries, k=k, rows=rows)
        # outputs are replicated on the mesh; one batched fetch
        return collect_topk(pending, plans, len(queries), rows, k)

    def topk_title_ids(self, queries, k: Optional[int] = None, rows=None):
        """Like :meth:`topk` but mapping positions to external title ids
        (same contract as JaccardScorer.topk_title_ids)."""
        scores, pos = self.topk(queries, k=k, rows=rows)
        return scores, self.index.title_ids[pos]

    # ------------------------------------------------- checkpoint / resume

    def save(self, path: str) -> None:
        """Checkpoint a mesh-built index shard-by-shard (``TruthIndex.save``
        cannot see the device shards, so the scorer owns mesh
        checkpointing).

        Each device's packed shard is fetched and written to the archive one
        at a time — host peak memory stays ≈ one shard, never the full
        matrix (the point of the mesh build at 10M-title scale).  The file
        is a plain npz-compatible zip: metadata entries mirror
        ``TruthIndex.save`` plus ``packed_shard_{i}`` (flat ``(V, nb_i)``
        uint8 byte-column slices) and ``shard_cols`` (int64[D+1] byte-column
        offsets), so ``TruthIndex.load`` can also concatenate it into a
        single-chip index."""
        import zipfile

        idx = self.index
        t0 = __import__("time").time()
        by_dev = {s.device: s for s in self.packed_d.addressable_shards}
        devices = list(np.ravel(self.mesh.devices))
        cols = [0]
        if not path.endswith(".npz"):
            path += ".npz"                               # np.savez parity
        with zipfile.ZipFile(
            path, "w", zipfile.ZIP_DEFLATED, compresslevel=1, allowZip64=True,
        ) as zf:
            meta = {
                "idf": idx.idf,
                "df": idx.df,
                "sums": idx.sums,
                "title_ids": idx.title_ids,
                "num_titles": np.int64(idx.num_titles),
                "padded_titles": np.int64(idx.padded_titles),
                "max_idf": np.float32(idx.max_idf),
                "content_hash": np.str_(idx.content_hash),
                "shard_format": np.int64(1),
            }
            for name, arr in meta.items():
                _write_npy(zf, name, np.asarray(arr))
            for i, dev in enumerate(devices):
                arr = np.asarray(by_dev[dev].data)       # ONE shard on host
                _write_npy(zf, f"packed_shard_{i}", arr)
                cols.append(cols[-1] + arr.shape[1])
            _write_npy(zf, "shard_cols", np.asarray(cols, np.int64))
        LOGGER.info(
            "[ShardedJaccardScorer] checkpointed %d shards (%.2f GB logical) "
            "in %.1fs", len(devices), idx.vocab_size * cols[-1] / 1e9,
            __import__("time").time() - t0,
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh,
             config: Optional[Config] = None,
             truth=None) -> "ShardedJaccardScorer":
        """Load a checkpoint ONTO a mesh, placing the packed matrix
        shard-by-shard (host peak ≈ one saved + one target shard).

        Accepts both the sharded format written by :meth:`save` (re-chunking
        byte columns if the target mesh size differs from the saved one) and
        a single-chip ``TruthIndex.save`` npz (sliced column-wise).
        ``truth`` (the encodings) lets ``retrieval_mode`` engage the folded
        engine on the loaded index — folded state is derived, never
        checkpointed."""
        from doppelspeller.ops.ngram_index import TruthIndex

        cfg = config or get_config()
        z = np.load(path)                                # lazy zip members
        sharded = "shard_format" in z.files
        index = TruthIndex(
            packed=np.empty((int(z["idf"].shape[0]), 0), np.uint8),
            idf=z["idf"],
            df=z["df"],
            sums=z["sums"],
            title_ids=z["title_ids"],
            num_titles=int(z["num_titles"]),
            padded_titles=int(z["padded_titles"]),
            max_idf=float(z["max_idf"]),
            content_hash=str(z["content_hash"]),
        )
        V = index.vocab_size
        axis = mesh.axis_names[0]
        D = mesh.devices.size
        tb = cfg.title_block
        chunk = D * tb
        ntp_pad = ((index.padded_titles + chunk - 1) // chunk) * chunk
        nb_local = ntp_pad // D // 8
        ntp_local = ntp_pad // D

        if sharded:
            cols = z["shard_cols"]
            loaded_j = -1
            src = None
        else:
            cols = np.asarray([0, z["packed"].shape[1]], np.int64)
            loaded_j = 0
            src = z["packed"]

        sums = index.sums
        devices = list(np.ravel(mesh.devices))
        shards, sums_shards = [], []
        t0 = __import__("time").time()
        for i, dev in enumerate(devices):
            lo, hi = i * nb_local, (i + 1) * nb_local
            tgt = np.zeros((V, nb_local), np.uint8)
            for j in range(len(cols) - 1):
                s_lo, s_hi = int(cols[j]), int(cols[j + 1])
                if s_hi <= lo or s_lo >= hi:
                    continue
                if j != loaded_j:                         # ONE saved shard live
                    src = z[f"packed_shard_{j}"]
                    loaded_j = j
                a, b = max(lo, s_lo), min(hi, s_hi)
                tgt[:, a - lo : b - lo] = src[:, a - s_lo : b - s_lo]
            shards.append(jax.device_put(tgt, dev))
            s_loc = np.zeros(ntp_local, np.float32)
            s_lo = min(i * ntp_local, len(sums))
            s_hi = min((i + 1) * ntp_local, len(sums))
            s_loc[: s_hi - s_lo] = sums[s_lo:s_hi]
            sums_shards.append(jax.device_put(s_loc, dev))
        packed_d = jax.make_array_from_single_device_arrays(
            (V, ntp_pad // 8), NamedSharding(mesh, P(None, axis)), shards
        )
        sums_d = jax.make_array_from_single_device_arrays(
            (ntp_pad,), NamedSharding(mesh, P(axis)), sums_shards
        )
        LOGGER.info(
            "[ShardedJaccardScorer] loaded checkpoint %s onto %d devices "
            "in %.1fs", path, D, __import__("time").time() - t0,
        )
        return cls(index, mesh, cfg,
                   _device_arrays=(packed_d, sums_d),
                   truth=truth)

    @staticmethod
    def checkpoint_matches(path: str, truth) -> bool:
        """Cheap metadata check (no packed shards touched): does the
        checkpoint at ``path`` describe exactly this truth set?"""
        from doppelspeller.ops.ngram_index import title_content_hash

        try:
            z = np.load(path)
            return (
                int(z["num_titles"]) == len(truth)
                and np.array_equal(z["title_ids"], truth.ids)
                and str(z["content_hash"])
                == title_content_hash(truth.encoded, truth.lengths)
            )
        except Exception as exc:
            LOGGER.warning("index checkpoint at %s unreadable (%s)", path, exc)
            return False


def _write_npy(zf, name: str, arr: np.ndarray) -> None:
    """Stream one array into an open zip as an npz member (np.load-able)."""
    from numpy.lib import format as npf

    arr = np.asarray(arr)
    if arr.ndim:                # ascontiguousarray would promote 0-d to 1-d
        arr = np.ascontiguousarray(arr)
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        npf.write_array(f, arr, allow_pickle=False)


def build_sharded_index(truth, mesh: Mesh,
                        config: Optional[Config] = None) -> ShardedJaccardScorer:
    """Build the truth index directly ON the mesh and return a ready scorer.

    Each device constructs its own title-column shard of the packed matrix
    from its local slice of the encoded titles
    (index_device.shard_build_fn); document frequencies are psum-ed across
    devices.  Only the encodings cross host→device (~256 B/title), and no full
    packed matrix ever exists on the host or on any single device — at the
    10M-title stretch the ~63 GB matrix exists only as D shards of 63/D GB
    (ARCHITECTURE.md memory math).

    The returned scorer's ``.index`` is a host TruthIndex carrying the
    planner tables (idf/df/sums/ids) with an EMPTY placeholder ``packed``.
    """
    from doppelspeller.config import TRIGRAM_VOCAB_SIZE
    from doppelspeller.ops.index_device import shard_build_fn, shard_sums_fn
    from doppelspeller.ops.ngram_index import title_content_hash
    from doppelspeller.utils import text as T

    cfg = config or get_config()
    axis = mesh.axis_names[0]
    D = mesh.devices.size
    nt = len(truth)
    tb = cfg.title_block
    ntp_meta = ((max(nt, tb) + tb - 1) // tb) * tb          # host-index parity
    chunk = D * tb
    ntp_pad = ((ntp_meta + chunk - 1) // chunk) * chunk
    ntp_local = ntp_pad // D
    nb_local = ntp_local // 8
    Vv = TRIGRAM_VOCAB_SIZE
    L = truth.encoded.shape[1]
    import time as _time

    t0 = _time.time()

    # ship each device its own slice of the encodings (host peak: +1 shard)
    enc_shards, len_shards = [], []
    for i, dev in enumerate(np.ravel(mesh.devices)):
        lo = i * ntp_local
        enc = np.zeros((ntp_local, L), np.uint8)
        lens = np.zeros((ntp_local,), np.int32)
        real = min(nt - lo, ntp_local) if lo < nt else 0
        if real > 0:
            enc[:real] = truth.encoded[lo : lo + real]
            lens[:real] = truth.lengths[lo : lo + real]
        enc_shards.append(jax.device_put(enc, dev))
        len_shards.append(jax.device_put(lens, dev))
    enc_d = jax.make_array_from_single_device_arrays(
        (ntp_pad, L), NamedSharding(mesh, P(axis, None)), enc_shards
    )
    len_d = jax.make_array_from_single_device_arrays(
        (ntp_pad,), NamedSharding(mesh, P(axis)), len_shards
    )

    TB = 8192 if ntp_local % 8192 == 0 else tb               # divides ntp_local
    build = jax.jit(shard_map(
        shard_build_fn(TB, axis), mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(None, axis), P()),
        check_vma=False,
    ))
    packed_d, df_d = build(enc_d, len_d)
    df = np.asarray(df_d)
    idf = T.idf_table_from_df(df, nt)
    max_idf = float(idf.max()) if nt > 0 else 0.0

    sums_fn = jax.jit(shard_map(
        shard_sums_fn(), mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    ))
    idf_rep = jax.device_put(idf, NamedSharding(mesh, P()))
    sums_d = sums_fn(idf_rep, enc_d, len_d)
    sums_host = np.asarray(sums_d)[:ntp_meta].copy()

    index = TruthIndex(
        packed=np.empty((Vv, 0), np.uint8),   # placeholder: shards only
        idf=idf,
        df=df,
        sums=sums_host,
        title_ids=truth.ids.copy(),
        num_titles=nt,
        padded_titles=ntp_meta,
        max_idf=max_idf,
        content_hash=title_content_hash(truth.encoded, truth.lengths),
    )
    LOGGER.info(
        "[build_sharded_index] %d titles (padded %d) on %d devices in %.1fs",
        nt, ntp_pad, D, _time.time() - t0,
    )
    return ShardedJaccardScorer(
        index, mesh, cfg, _device_arrays=(packed_d, sums_d),
        truth=truth,
    )


# ------------------------------------------------------- data-parallel GBT

def dp_boost_round(
    mesh: Mesh,
    bins_sharded: jnp.ndarray,   # uint8[N, F] sharded over rows
    y_sharded: jnp.ndarray,      # float32[N] sharded over rows
    margins_sharded: jnp.ndarray,
    *,
    depth: int,
    eta: float,
    beta: float,
    lambda_: float = 1.0,
    min_child_weight: float = 1.0,
    axis: Optional[str] = None,
):
    """One data-parallel boosting round under shard_map.

    Returns (new margins [sharded like inputs], tree arrays [replicated]).
    Histograms are psum-ed inside build_tree_kernel; every device grows the
    identical tree and routes only its local samples.
    """
    axis = axis or mesh.axis_names[0]

    def step(bins_l, y_l, m_l):
        g, h = margin_grad_hess(m_l, y_l, beta)
        feat, split_bin, missing_left, value, is_leaf = build_tree_kernel(
            bins_l, g, h,
            depth=depth, n_features=bins_l.shape[1],
            lambda_=lambda_, min_child_weight=min_child_weight,
            axis_name=axis,
        )
        value = value * eta
        m_l = m_l + predict_tree_binned(
            bins_l, feat, split_bin, missing_left, value, is_leaf, depth=depth
        )
        return m_l, (feat, split_bin, missing_left, value, is_leaf)

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), (P(), P(), P(), P(), P())),
    )
    return jax.jit(fn)(bins_sharded, y_sharded, margins_sharded)
