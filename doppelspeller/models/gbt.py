"""Gradient-boosted trees, trained on-device with JAX.

Replacement for the reference's XGBoost 0.90 dependency
(train.py:85-137 for training, predict.py:229-234 for inference):

* histogram ("hist") tree growth, level-wise, depth 5, 256 bins, with
  XGBoost's missing-value handling — NaN features go to a learned default
  direction chosen by trying both sides at every split;
* the reference's *custom* objective and metric (train.py:17-47):
  weighted log loss  g = p(β + y − βy) − y,  h = p(1−p)(β + y − βy)  with
  β = FALSE_POSITIVE_PENALTY_FACTOR.  XGBoost 0.90's Booster.update feeds
  the custom objective `predict(dtrain)` WITHOUT output_margin, so with
  'objective': 'reg:logistic' the reference's p is sigmoid(margin) — i.e.
  these formulas are exactly the margin-space grad/hess of β-weighted
  logistic loss.  We therefore boost on margins (init logit(base_score)=0)
  and apply the sigmoid for every prediction/metric, like the reference;
* early stopping on eval custom-error with best_ntree_limit semantics;
* AUC on the watchlist for logging (train.py:104).

Note: the reference also sets scale_pos_weight (train.py:94), but XGBoost
ignores it when a custom objective is supplied — we replicate that (the knob
exists but is unused by the custom objective).

Histograms are built with ONE matrix product per level — a multi-hot bins
matrix (N, F·NB) bf16 against node-masked grad/hess columns — or, where the
backend prefers it (backend.histogram_route), with segment sums; sample
routing is one-hot matmul table lookups.  Per-level split finding is a cumulative-sum scan over bins
vectorized across all (node, feature) pairs — no per-node loops.  The
boosting loop routes train AND eval rows through the same tree-growth
pass and updates margins from the routing's leaf values, so there is no
per-round inference walk at all.  Standalone inference is a
level-synchronous tensorized forest walk batched over samples.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from doppelspeller.config import Config

LOGGER = logging.getLogger(__name__)

NB = 256          # bins per feature (255 = missing)
MISSING_BIN = 255
N_EDGES = NB - 2  # 254 cut points -> value bins 0..254


@dataclass
class GBTParams:
    depth: int = 5
    eta: float = 0.1
    lambda_: float = 1.0
    min_child_weight: float = 1.0
    num_boost_round: int = 1000
    early_stopping_rounds: int = 50
    beta: float = 5.0                     # false-positive penalty factor
    threshold: float = 0.9                # custom-error probability threshold
    base_score: float = 0.5
    seed: int = 0

    @classmethod
    def from_config(cls, cfg: Config) -> "GBTParams":
        return cls(
            depth=cfg.gbt_max_depth,
            eta=cfg.gbt_eta,
            lambda_=cfg.gbt_lambda,
            min_child_weight=cfg.gbt_min_child_weight,
            num_boost_round=cfg.gbt_num_boost_round,
            early_stopping_rounds=cfg.gbt_early_stopping_rounds,
            beta=cfg.false_positive_penalty_factor,
            threshold=cfg.prediction_probability_threshold,
            seed=cfg.seed,
        )


# ----------------------------------------------------------------- objective

def weighted_log_loss_grad_hess(pred: jnp.ndarray, y: jnp.ndarray, beta: float):
    """Reference train.py:32-39 (closed form).  ``pred`` is a probability
    (sigmoid of the margin), exactly what XGBoost hands the custom obj."""
    w = beta + y - beta * y
    g = pred * w - y
    h = pred * (1.0 - pred) * w
    return g, h


def margin_grad_hess(margin: jnp.ndarray, y: jnp.ndarray, beta: float):
    """grad/hess w.r.t. the raw margin: p = sigmoid(margin)."""
    p = jax.nn.sigmoid(margin)
    return weighted_log_loss_grad_hess(p, y, beta)


def custom_error(pred: np.ndarray, y: np.ndarray, beta: float, threshold: float) -> float:
    """Reference train.py:17-29: FN + beta*FP at the probability threshold."""
    pos = pred > threshold
    fn = float(y[~pos].sum())
    fp = float((y[pos] == 0).sum()) * beta
    return fn + fp


def auc_score(pred: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(pred, kind="stable")
    ranks = np.empty(len(pred), dtype=np.float64)
    ranks[order] = np.arange(1, len(pred) + 1)
    # average ranks over ties
    sorted_pred = pred[order]
    uniq, inv, cnt = np.unique(sorted_pred, return_inverse=True, return_counts=True)
    csum = np.cumsum(cnt)
    avg_rank = (csum - (cnt - 1) / 2.0).astype(np.float64)
    ranks[order] = avg_rank[inv]
    n_pos = float(y.sum())
    n_neg = float(len(y) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return (ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


# ------------------------------------------------------------------- binning

def compute_bin_edges(X: np.ndarray) -> np.ndarray:
    """float32[F, N_EDGES] quantile cut points per feature (NaN-aware)."""
    F = X.shape[1]
    edges = np.zeros((F, N_EDGES), dtype=np.float32)
    qs = np.linspace(0.0, 1.0, NB)[1:-1]  # 254 interior quantiles
    for f in range(F):
        col = X[:, f]
        col = col[~np.isnan(col)]
        if len(col) == 0:
            edges[f] = np.arange(N_EDGES, dtype=np.float32)
            continue
        e = np.quantile(col, qs).astype(np.float32)
        edges[f] = e
    return edges


def bin_features(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """uint8[N, F] bin codes; NaN → MISSING_BIN.  bin = Σ_j (x > e_j)."""
    N, F = X.shape
    out = np.zeros((N, F), dtype=np.uint8)
    for f in range(F):
        col = X[:, f]
        nan = np.isnan(col)
        b = np.searchsorted(edges[f], col, side="left")
        b = np.clip(b, 0, N_EDGES)  # values above the last edge → bin 254
        b[nan] = MISSING_BIN
        out[:, f] = b.astype(np.uint8)
    return out


# ------------------------------------------------------------ tree builder

@partial(jax.jit, static_argnames=("depth", "n_features", "axis_name",
                                   "return_routing", "hist_impl"))
def build_tree_kernel(
    bins: jnp.ndarray,   # uint8[N, F]
    g: jnp.ndarray,      # float32[N]
    h: jnp.ndarray,      # float32[N]
    *,
    depth: int,
    n_features: int,
    lambda_: float,
    min_child_weight: float,
    axis_name: Optional[str] = None,
    return_routing: bool = False,
    hist_impl: str = "matmul",
):
    """Grow one depth-`depth` tree level-wise.  Returns heap arrays of size
    2^(depth+1) − 1: (feat int32, split_bin int32, missing_left bool,
    value float32, is_leaf bool)[, contrib float32[N] with return_routing].

    Per-level (node, feature, bin) histograms are ONE matrix product — a
    multi-hot bins matrix (N, F·NB) bf16 (exact {0, 1}) against the
    node-masked grad/hess matrix (N, 2·n_nodes) — and sample routing is
    one-hot matmul table lookups instead of per-row gathers.
    ``hist_impl='scatter'`` takes the segment-sum path instead (the CPU's
    choice, and the fallback where the multi-hot matrix would not fit;
    train_gbt picks via histogram_impl).

    With ``return_routing`` the kernel also returns each sample's leaf value
    (``contrib``, unscaled by eta) accumulated during routing — the boosting
    loop adds ``eta * contrib`` to its margins and needs no separate
    tree-walk inference pass.  Rows with g = h = 0 (eval rows, shard
    padding) are routed but contribute nothing to any histogram.

    With ``axis_name`` set (inside shard_map/pmap), histograms are psum-ed
    over the data-parallel axis: every device grows the identical tree from
    its local sample shard — the equivalent of distributed XGBoost
    histogram aggregation (a capability the reference lacks)."""
    N, F = bins.shape
    n_heap = 2 ** (depth + 1) - 1
    bins_i = bins.astype(jnp.int32)
    bins_f = bins_i.astype(jnp.float32)
    if hist_impl == "matmul":
        # multi-hot (N, F·NB): exact {0,1} in bf16; built once per tree,
        # read once per level by the histogram matmul
        M = (
            bins_i[:, :, None] == jnp.arange(NB, dtype=jnp.int32)[None, None, :]
        ).reshape(N, F * NB).astype(jnp.bfloat16)
    g_b = g.astype(jnp.bfloat16)
    h_b = h.astype(jnp.bfloat16)

    feat = jnp.full((n_heap,), -1, jnp.int32)
    split_bin = jnp.zeros((n_heap,), jnp.int32)
    missing_left = jnp.zeros((n_heap,), jnp.bool_)
    value = jnp.zeros((n_heap,), jnp.float32)
    is_leaf = jnp.zeros((n_heap,), jnp.bool_)

    node = jnp.zeros((N,), jnp.int32)          # heap position per sample
    done = jnp.zeros((N,), jnp.bool_)          # sample sits at a final leaf
    contrib = jnp.zeros((N,), jnp.float32)     # leaf value reached per sample

    f_iota = jnp.arange(F, dtype=jnp.int32)

    for level in range(depth):
        n_nodes = 2 ** level
        offset = n_nodes - 1
        local = node - offset
        # one-hot node assignment, masked to active rows (done rows and
        # rows routed to dead subtrees have no live local id)
        onl_b = (
            (local[:, None] == jnp.arange(n_nodes, dtype=jnp.int32)[None, :])
            & (~done)[:, None]
        ).astype(jnp.bfloat16)                                   # (N, n)

        if hist_impl == "matmul":
            A = jnp.concatenate(
                [onl_b * g_b[:, None], onl_b * h_b[:, None]], axis=1
            )                                                    # (N, 2n)
            GH = jax.lax.dot_general(
                M, A,
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).reshape(F, NB, 2, n_nodes)                         # Σ over N
            G = jnp.transpose(GH[:, :, 0, :], (2, 0, 1))         # (n, F, NB)
            H = jnp.transpose(GH[:, :, 1, :], (2, 0, 1))
        else:
            S = n_nodes * F * NB
            key = local[:, None] * (F * NB) + f_iota[None, :] * NB + bins_i
            key = jnp.where(done[:, None], S, key)
            flat = key.reshape(-1)
            G = jax.ops.segment_sum(
                jnp.broadcast_to(g[:, None], (N, F)).reshape(-1), flat,
                num_segments=S + 1,
            )[:S].reshape(n_nodes, F, NB)
            H = jax.ops.segment_sum(
                jnp.broadcast_to(h[:, None], (N, F)).reshape(-1), flat,
                num_segments=S + 1,
            )[:S].reshape(n_nodes, F, NB)
        if axis_name is not None:
            G = jax.lax.psum(G, axis_name)
            H = jax.lax.psum(H, axis_name)

        Gm = G[..., MISSING_BIN]
        Hm = H[..., MISSING_BIN]
        Gv = G[..., :MISSING_BIN]
        Hv = H[..., :MISSING_BIN]
        Gtot = Gv.sum(axis=2) + Gm               # (nodes, F) — same for all f
        Htot = Hv.sum(axis=2) + Hm
        GL = jnp.cumsum(Gv, axis=2)[..., :N_EDGES]   # split at k: bins ≤ k left
        HL = jnp.cumsum(Hv, axis=2)[..., :N_EDGES]

        def gain_of(GLx, HLx):
            GRx = Gtot[..., None] - GLx
            HRx = Htot[..., None] - HLx
            ok = (HLx >= min_child_weight) & (HRx >= min_child_weight)
            gn = (
                GLx * GLx / (HLx + lambda_)
                + GRx * GRx / (HRx + lambda_)
                - (Gtot * Gtot / (Htot + lambda_))[..., None]
            )
            return jnp.where(ok, gn, -jnp.inf)

        gain_ml = gain_of(GL + Gm[..., None], HL + Hm[..., None])  # missing left
        gain_mr = gain_of(GL, HL)                                   # missing right
        gain2 = jnp.stack([gain_ml, gain_mr], axis=-1)              # (n, F, K, 2)
        gflat = gain2.reshape(n_nodes, -1)
        best = jnp.argmax(gflat, axis=1)
        best_gain = jnp.take_along_axis(gflat, best[:, None], axis=1)[:, 0]
        best_f = (best // (N_EDGES * 2)).astype(jnp.int32)
        best_k = ((best // 2) % N_EDGES).astype(jnp.int32)
        best_ml = (best % 2) == 0

        parent_score = Gtot[:, 0] * Gtot[:, 0] / (Htot[:, 0] + lambda_)
        node_value = -Gtot[:, 0] / (Htot[:, 0] + lambda_)
        # leaf if no valid positive-gain split or the node is empty
        leaf_now = (best_gain <= 1e-10) | (Htot[:, 0] <= 0.0)
        del parent_score

        feat = jax.lax.dynamic_update_slice(
            feat, jnp.where(leaf_now, -1, best_f), (offset,)
        )
        split_bin = jax.lax.dynamic_update_slice(split_bin, best_k, (offset,))
        missing_left = jax.lax.dynamic_update_slice(missing_left, best_ml, (offset,))
        value = jax.lax.dynamic_update_slice(value, node_value, (offset,))
        is_leaf = jax.lax.dynamic_update_slice(is_leaf, leaf_now, (offset,))

        # route samples: one-hot matmul table lookups, no per-row gathers.
        # bf16 {0,1} selectors and integer tables ≤ 255 are exact in bf16;
        # node_value is selected with a separate HIGHEST-precision f32 dot.
        route_tbl = jnp.stack(
            [best_k.astype(jnp.float32), best_ml.astype(jnp.float32),
             leaf_now.astype(jnp.float32)], axis=1,
        )                                                        # (n, 3)
        sel = jax.lax.dot_general(
            onl_b, route_tbl.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )                                                        # (N, 3)
        s_k, s_ml, s_leaf = sel[:, 0], sel[:, 1] > 0.5, sel[:, 2] > 0.5
        fsel = jax.lax.dot_general(
            onl_b,
            (jnp.maximum(best_f, 0)[:, None] == f_iota[None, :]).astype(jnp.bfloat16),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )                                                        # (N, F) {0,1}
        b = (fsel * bins_f).sum(axis=1)                          # exact int
        s_val = jax.lax.dot_general(
            onl_b.astype(jnp.float32), node_value[:, None],
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )[:, 0]                                                  # (N,)
        go_left = jnp.where(b == MISSING_BIN, s_ml, b <= s_k)
        newly_done = (~done) & s_leaf
        contrib = contrib + jnp.where(newly_done, s_val, 0.0)
        done = done | s_leaf
        node = jnp.where(done, node, 2 * node + 1 + (1 - go_left.astype(jnp.int32)))
        node = jnp.where(newly_done, offset + local, node)

    # final level: everything still active becomes a leaf
    n_nodes = 2 ** depth
    offset = n_nodes - 1
    local = node - offset
    onl_b = (
        (local[:, None] == jnp.arange(n_nodes, dtype=jnp.int32)[None, :])
        & (~done)[:, None]
    ).astype(jnp.bfloat16)                                       # (N, n)
    GHn = jax.lax.dot_general(
        onl_b, jnp.stack([g_b, h_b], axis=1),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )                                                            # (n, 2)
    Gn, Hn = GHn[:, 0], GHn[:, 1]
    if axis_name is not None:
        Gn = jax.lax.psum(Gn, axis_name)
        Hn = jax.lax.psum(Hn, axis_name)
    leaf_val = -Gn / (Hn + lambda_)
    contrib = contrib + jax.lax.dot_general(
        onl_b.astype(jnp.float32), leaf_val[:, None],
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )[:, 0]
    value = jax.lax.dynamic_update_slice(value, leaf_val, (offset,))
    is_leaf = jax.lax.dynamic_update_slice(
        is_leaf, jnp.ones((n_nodes,), jnp.bool_), (offset,)
    )
    if return_routing:
        return feat, split_bin, missing_left, value, is_leaf, contrib
    return feat, split_bin, missing_left, value, is_leaf


@partial(jax.jit, static_argnames=("depth",))
def predict_tree_binned(
    bins: jnp.ndarray, feat: jnp.ndarray, split_bin: jnp.ndarray,
    missing_left: jnp.ndarray, value: jnp.ndarray, is_leaf: jnp.ndarray,
    *, depth: int,
) -> jnp.ndarray:
    """Leaf value per sample for one tree over binned features."""
    N = bins.shape[0]
    bins_i = bins.astype(jnp.int32)
    node = jnp.zeros((N,), jnp.int32)
    for _ in range(depth):
        f = feat[node]
        k = split_bin[node]
        ml = missing_left[node]
        leaf = is_leaf[node] | (f < 0)
        b = jnp.take_along_axis(bins_i, jnp.maximum(f, 0)[:, None], axis=1)[:, 0]
        go_left = jnp.where(b == MISSING_BIN, ml, b <= k)
        nxt = 2 * node + 1 + (1 - go_left.astype(jnp.int32))
        node = jnp.where(leaf, node, nxt)
    return value[node]


# -------------------------------------------------------------------- model

@dataclass
class GBTModel:
    feat: np.ndarray          # int32[T, n_heap]
    threshold: np.ndarray     # float32[T, n_heap] raw-value split thresholds
    split_bin: np.ndarray     # int32[T, n_heap]
    missing_left: np.ndarray  # bool[T, n_heap]
    value: np.ndarray         # float32[T, n_heap] (already eta-scaled)
    is_leaf: np.ndarray       # bool[T, n_heap]
    edges: np.ndarray         # float32[F, N_EDGES]
    base_score: float
    best_ntree_limit: int
    depth: int
    history: dict = field(default_factory=dict)

    @property
    def num_trees(self) -> int:
        return self.feat.shape[0]

    def predict(self, X: np.ndarray, ntree_limit: Optional[int] = None,
                batch: int = 262144) -> np.ndarray:
        """Probability predictions = sigmoid(margin), matching the
        reference's reg:logistic predict output (predict.py:234,248)."""
        nt = ntree_limit or self.best_ntree_limit or self.num_trees
        nt = min(nt, self.num_trees)
        out = np.zeros(len(X), dtype=np.float32)
        for s in range(0, len(X), batch):
            xb = X[s : s + batch]
            out[s : s + len(xb)] = np.asarray(
                _predict_raw_kernel(
                    jnp.asarray(xb),
                    jnp.asarray(self.feat[:nt]),
                    jnp.asarray(self.threshold[:nt]),
                    jnp.asarray(self.missing_left[:nt]),
                    jnp.asarray(self.value[:nt]),
                    jnp.asarray(self.is_leaf[:nt]),
                    depth=self.depth,
                    base_score=self.base_score,
                )
            )
        return out

    def feature_importance(self) -> np.ndarray:
        """Split counts per feature, normalized — parity with the reference's
        get_fscore-based importance (train.py:50-60)."""
        nt = self.best_ntree_limit or self.num_trees
        used = self.feat[:nt]
        counts = np.zeros(self.edges.shape[0], dtype=np.float64)
        valid = (used >= 0) & ~self.is_leaf[:nt]
        np.add.at(counts, used[valid], 1.0)
        total = counts.sum()
        return counts / total if total > 0 else counts

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            feat=self.feat, threshold=self.threshold, split_bin=self.split_bin,
            missing_left=self.missing_left, value=self.value, is_leaf=self.is_leaf,
            edges=self.edges,
            base_score=np.float32(self.base_score),
            best_ntree_limit=np.int64(self.best_ntree_limit),
            depth=np.int64(self.depth),
        )

    @classmethod
    def load(cls, path: str) -> "GBTModel":
        z = np.load(path)
        return cls(
            feat=z["feat"], threshold=z["threshold"], split_bin=z["split_bin"],
            missing_left=z["missing_left"], value=z["value"], is_leaf=z["is_leaf"],
            edges=z["edges"], base_score=float(z["base_score"]),
            best_ntree_limit=int(z["best_ntree_limit"]), depth=int(z["depth"]),
        )


def _logit(p: float) -> float:
    return float(np.log(p / (1.0 - p)))


def predict_forest_margin(
    X: jnp.ndarray,            # float32[B, F] (NaN = missing)
    feat: jnp.ndarray,         # int32[T, n_heap]
    thr: jnp.ndarray,          # float32[T, n_heap]
    missing_left: jnp.ndarray, # bool[T, n_heap]
    value: jnp.ndarray,        # float32[T, n_heap]
    is_leaf: jnp.ndarray,      # bool[T, n_heap]
    depth: int,
    base_margin: float,
) -> jnp.ndarray:
    """Margins for the whole forest, level-synchronous across ALL trees.

    Instead of scanning trees (thousands of tiny gathers), every internal
    node's comparison is evaluated up-front with one feature gather, the
    next-node table is built with broadcasts, and the walk needs only
    ``depth`` take_along_axis calls on (B, T) tensors.
    """
    B = X.shape[0]
    T, n_heap = feat.shape
    n_internal = 2 ** depth - 1
    F = X.shape[1]

    f_int = feat[:, :n_internal]                       # (T, I)
    # feature gather as a one-hot matmul: the (F, T·I) selector is built from
    # loop-invariant tree arrays (hoisted out of any enclosing scan).  NaN
    # (missing) rides through as a sentinel the matmul preserves exactly
    # (one-hot rows have a single 1.0).
    onehot_f = (
        jnp.maximum(f_int, 0).reshape(-1)[None, :]
        == jnp.arange(F, dtype=jnp.int32)[:, None]
    ).astype(X.dtype)                                  # (F, T·I)
    # Missing values ride through the matmul as a -1e30 sentinel (the one-hot
    # rows have a single 1.0, so Precision.HIGHEST preserves it bit-exactly).
    # Finite features are clipped to ±1e18 first so no legitimate value can
    # ever cross the -1e20 detection threshold below (the 66 reference
    # features are ratios/lengths/IDFs, all << 1e18, so the clip is a no-op
    # in practice — it just makes the sentinel invariant explicit).
    x_clean = jnp.where(
        jnp.isnan(X), jnp.float32(-1e30), jnp.clip(X, -1e18, 1e18)
    )
    x_sel = jax.lax.dot_general(
        x_clean, onehot_f,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(B, T, n_internal)
    thr_b = thr[:, :n_internal][None]
    ml_b = missing_left[:, :n_internal][None]
    go_left = jnp.where(x_sel < -1e20, ml_b, x_sel <= thr_b)  # (B, T, I)
    alive = ~(is_leaf[:, :n_internal] | (f_int < 0))          # (T, I)

    # branch-free reached-mass propagation over the heap: r[i] ∈ {0, 1} is
    # whether the sample reaches node i; a node that stops early contributes
    # value[i] directly.  No gathers and no per-level node walk.
    gl = go_left.astype(jnp.float32)
    al = alive.astype(jnp.float32)[None]                      # (1, T, I)
    va = value.astype(jnp.float32)                            # (T, n_heap)
    r = [None] * n_heap
    r[0] = jnp.ones((B, T), jnp.float32)
    margin = jnp.zeros((B, T), jnp.float32)
    for i in range(n_internal):
        stop = r[i] * (1.0 - al[:, :, i])                     # early leaf at i
        margin = margin + stop * va[None, :, i]
        cont = r[i] * al[:, :, i]
        r[2 * i + 1] = cont * gl[:, :, i]
        r[2 * i + 2] = cont * (1.0 - gl[:, :, i])
    for j in range(n_internal, n_heap):
        margin = margin + r[j] * va[None, :, j]
    return base_margin + margin.sum(axis=1)


@partial(jax.jit, static_argnames=("depth", "base_score"))
def _predict_raw_kernel(X, feat, thr, missing_left, value, is_leaf, *, depth, base_score):
    base_margin = float(np.log(base_score / (1.0 - base_score)))
    return jax.nn.sigmoid(
        predict_forest_margin(
            X, feat, thr, missing_left, value, is_leaf, depth, base_margin
        )
    )


# ------------------------------------------------------------------ training

def _boost_scan_body(
    bins: jnp.ndarray, y: jnp.ndarray, w_hist: jnp.ndarray,
    w_tr: jnp.ndarray, w_ev: jnp.ndarray, m0: jnp.ndarray,
    *, depth: int, n_rounds: int, eta: float, beta: float, threshold: float,
    lambda_: float, min_child_weight: float, base_margin: float,
    axis_name: Optional[str] = None, hist_impl: str = "matmul",
):
    """A segment of the boosting loop as ONE device program: no host
    round-trip per round.

    Train and eval rows share one concatenated sample axis; {0, 1} masks
    pick each population: ``w_hist`` weights the histograms (0 for eval and
    shard-padding rows), ``w_tr``/``w_ev`` weight the two custom-error sums.
    Every row is *routed* through the tree it had no part in growing, and
    its margin is updated from the routing's leaf value (`contrib`) — there
    is no per-round tree-walk inference pass at all.  With ``axis_name``
    set (under shard_map) the histograms are psum-ed inside
    build_tree_kernel and the error sums here, so every device grows the
    identical tree from its local sample shard.

    Returns stacked tree arrays, per-round train/eval custom-error
    histories, and the final margins (to chain segments)."""
    N, F = bins.shape

    def round_step(margins, _):
        g, h = margin_grad_hess(margins, y, beta)
        feat, split_bin, missing_left, value, is_leaf, contrib = build_tree_kernel(
            bins, g * w_hist, h * w_hist, depth=depth, n_features=F,
            lambda_=lambda_, min_child_weight=min_child_weight,
            axis_name=axis_name, return_routing=True, hist_impl=hist_impl,
        )
        value = value * eta
        margins = margins + eta * contrib

        def dev_err(ww):
            pred = jax.nn.sigmoid(margins)
            pos = pred > threshold
            fn = jnp.sum(ww * y * (~pos))
            fp = jnp.sum(ww * (1.0 - y) * pos) * beta
            err = fn + fp
            if axis_name is not None:
                err = jax.lax.psum(err, axis_name)
            return err

        out = (feat, split_bin, missing_left, value, is_leaf,
               dev_err(w_tr), dev_err(w_ev))
        return margins, out

    margins, outs = jax.lax.scan(round_step, m0, None, length=n_rounds)
    return outs + (margins,)


_boost_scan = partial(jax.jit, static_argnames=(
    "depth", "n_rounds", "eta", "beta", "threshold",
    "lambda_", "min_child_weight", "base_margin", "hist_impl",
))(_boost_scan_body)


def _boost_scan_sharded(mesh, **static):
    """shard_map'd boosting segment: samples (train AND eval) sharded over
    the mesh's first axis, histograms/errors psum-ed, identical (replicated)
    trees grown on every device — the equivalent of distributed XGBoost
    histogram aggregation (SURVEY.md §2.4)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    fn = shard_map(
        partial(_boost_scan_body, axis_name=axis, **static),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P(), P(), P(), P(), P(), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


def histogram_impl(n_rows: int, n_features: int, device) -> str:
    """'matmul' or 'scatter' for a tree build over ``n_rows`` samples per
    device.  The matmul path holds an (N, F·NB) bf16 multi-hot matrix, so it
    is taken only where backend.histogram_route prefers it and that matrix
    fits in a quarter of the device's memory limit."""
    from doppelspeller.backend import histogram_route

    if histogram_route(device) != "matmul":
        return "scatter"
    limit = (device.memory_stats() or {}).get("bytes_limit", 0)
    return "matmul" if n_rows * n_features * NB * 2 <= limit // 4 else "scatter"


def train_gbt(
    X: np.ndarray, y: np.ndarray,
    X_eval: np.ndarray, y_eval: np.ndarray,
    params: Optional[GBTParams] = None,
    verbose_every: int = 25,
    mesh=None,
) -> GBTModel:
    """Boosting (reference train.py:85-137 semantics).

    Rounds run on-device in jitted scan segments of ``scan_chunk`` rounds
    (one device program per segment, no per-round host round-trip).  Early
    stopping is applied with XGBoost
    semantics at segment granularity — training stops after the first
    segment whose best round is ≥ early_stopping_rounds old, trees beyond
    the stop point are discarded, best_ntree_limit = best_round + 1.

    ``mesh``: an optional 1-D jax.sharding.Mesh — samples are sharded over
    the mesh axis (rows padded with weight-0 entries to a device multiple),
    per-shard histograms are psum-ed inside the tree builder, and
    every device grows the identical tree (data-parallel training, a
    capability the single-node reference lacks)."""
    p = params or GBTParams()
    N, F = X.shape
    edges = compute_bin_edges(X)
    y_eval_np = y_eval.astype(np.float32)
    Ne = len(X_eval)
    # ONE concatenated sample axis: train rows then eval rows; masks pick
    # each population (eval rows ride through tree growth with histogram
    # weight 0 and get their margins from the same routing pass)
    Xall = np.concatenate([bin_features(X, edges), bin_features(X_eval, edges)])
    y_all = np.concatenate([y.astype(np.float32), y_eval_np])
    w_hist = np.concatenate([np.ones(N, np.float32), np.zeros(Ne, np.float32)])
    w_ev = np.concatenate([np.zeros(N, np.float32), np.ones(Ne, np.float32)])

    scan_chunk = min(50, p.num_boost_round)
    base_margin = _logit(p.base_score)
    device = mesh.devices.flat[0] if mesh is not None else jax.devices()[0]
    n_dev = int(mesh.devices.size) if mesh is not None else 1
    hist_impl = histogram_impl(len(Xall) // n_dev, F, device)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        def _pad_rows(a, n_to, fill=0):
            if len(a) == n_to:
                return a
            pad_shape = (n_to - len(a),) + a.shape[1:]
            return np.concatenate([a, np.full(pad_shape, fill, a.dtype)])

        Np = ((len(Xall) + n_dev - 1) // n_dev) * n_dev
        Xall = _pad_rows(Xall, Np)
        y_all = _pad_rows(y_all, Np)
        w_hist = _pad_rows(w_hist, Np)
        w_ev = _pad_rows(w_ev, Np)
        sh = NamedSharding(mesh, P(mesh.axis_names[0]))
        put = lambda a: jax.device_put(a, sh)  # noqa: E731
        scan_cache = {}

        def get_scan(n_rounds, **static):
            key = n_rounds
            if key not in scan_cache:
                scan_cache[key] = _boost_scan_sharded(
                    mesh, n_rounds=n_rounds, **static
                )
            return scan_cache[key]
    else:
        put = jnp.asarray
        get_scan = None
    bins_d = put(Xall)
    y_d = put(y_all)
    w_hist_d = put(w_hist)
    w_tr_d = w_hist_d          # train rows weight both histograms and error
    w_ev_d = put(w_ev)
    m = put(np.full((len(Xall),), base_margin, np.float32))

    chunks = []
    err_train_l: List[np.ndarray] = []
    err_eval_l: List[np.ndarray] = []
    best_round = 0
    best_err = np.inf
    rounds_done = 0
    while rounds_done < p.num_boost_round:
        n_rounds = min(scan_chunk, p.num_boost_round - rounds_done)
        static = dict(
            depth=p.depth, n_rounds=n_rounds, eta=p.eta, beta=p.beta,
            threshold=p.threshold, lambda_=p.lambda_,
            min_child_weight=p.min_child_weight, base_margin=base_margin,
            hist_impl=hist_impl,
        )
        if mesh is not None:
            outs = get_scan(**static)(bins_d, y_d, w_hist_d, w_tr_d, w_ev_d, m)
        else:
            outs = _boost_scan(bins_d, y_d, w_hist_d, w_tr_d, w_ev_d, m, **static)
        chunk_arrays = tuple(np.asarray(o) for o in outs[:5])
        e_tr, e_ev = np.asarray(outs[5]), np.asarray(outs[6])
        m = outs[7]
        chunks.append(chunk_arrays)
        err_train_l.append(e_tr)
        err_eval_l.append(e_ev)
        for i, err in enumerate(e_ev):
            rnd = rounds_done + i
            if err < best_err:
                best_err = float(err)
                best_round = rnd
        rounds_done += n_rounds
        if verbose_every:
            LOGGER.info("[%d] train-error:%.0f eval-error:%.0f (best %d: %.0f)",
                        rounds_done - 1, e_tr[-1], e_ev[-1], best_round, best_err)
        if rounds_done - 1 - best_round >= p.early_stopping_rounds:
            LOGGER.info("early stopping at round %d (best %d, eval-error %.0f)",
                        rounds_done - 1, best_round, best_err)
            break

    err_train = np.concatenate(err_train_l)
    err_eval = np.concatenate(err_eval_l)
    # truncate with XGBoost stop semantics
    stop = min(best_round + p.early_stopping_rounds, rounds_done - 1)
    T = stop + 1
    feat_a, split_a, ml_a, val_a, leaf_a = (
        np.concatenate([c[j] for c in chunks])[:T] for j in range(5)
    )

    m_host = np.asarray(m)
    pt = 1.0 / (1.0 + np.exp(-m_host[:N]))          # trim shard padding
    pe = 1.0 / (1.0 + np.exp(-m_host[N : N + Ne]))
    history = {
        "train_error": err_train[:T].tolist(),
        "eval_error": err_eval[:T].tolist(),
        "final_train_auc": auc_score(pt, y.astype(np.float32)),
        "final_eval_auc": auc_score(pe, y_eval_np),
    }
    if verbose_every:
        LOGGER.info(
            "final(%d rounds run) train-auc:%.6f eval-auc:%.6f | best round %d eval-error %.0f",
            rounds_done, history["final_train_auc"],
            history["final_eval_auc"], best_round, best_err,
        )

    n_heap = 2 ** (p.depth + 1) - 1
    # raw-value thresholds: thr = edges[f, k]
    thr_a = np.zeros((T, n_heap), dtype=np.float32)
    for t in range(T):
        f = np.maximum(feat_a[t], 0)
        thr_a[t] = edges[f, np.clip(split_a[t], 0, N_EDGES - 1)]

    model = GBTModel(
        feat=feat_a, threshold=thr_a, split_bin=split_a, missing_left=ml_a,
        value=val_a, is_leaf=leaf_a, edges=edges,
        base_score=p.base_score,
        best_ntree_limit=best_round + 1,
        depth=p.depth,
        history=history,
    )
    return model
