"""GBT model tests: learning behaviour, missing-value routing, predict parity."""

import numpy as np

from doppelspeller.models.gbt import (
    GBTModel,
    GBTParams,
    auc_score,
    bin_features,
    compute_bin_edges,
    custom_error,
    train_gbt,
    weighted_log_loss_grad_hess,
)


def _make_data(n=2000, seed=0, with_nan=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    logits = 2.0 * X[:, 0] - 1.5 * X[:, 2] + 0.5 * X[:, 4]
    y = (logits + 0.3 * rng.randn(n) > 0).astype(np.float32)
    if with_nan:
        nan_mask = rng.rand(n) < 0.3
        # informative missingness: feature 1 missing mostly for positives
        X[nan_mask & (y == 1), 1] = np.nan
    return X, y


def test_grad_hess_formula():
    import jax.numpy as jnp

    pred = jnp.asarray(np.array([0.2, 0.8, 0.5], np.float32))
    y = jnp.asarray(np.array([1.0, 0.0, 1.0], np.float32))
    g, h = weighted_log_loss_grad_hess(pred, y, beta=5.0)
    # g = p(beta + y - beta*y) - y ; y=1 → p−1 ; y=0 → 5p
    np.testing.assert_allclose(np.asarray(g), [0.2 - 1.0, 5 * 0.8, 0.5 - 1.0], rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(h), [0.2 * 0.8 * 1, 0.8 * 0.2 * 5, 0.5 * 0.5 * 1], rtol=1e-6
    )


def test_custom_error_counts():
    pred = np.array([0.95, 0.5, 0.99, 0.1], np.float32)
    y = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    # FN: sample1 (pos, pred<=0.9) → 1 ; FP: sample2 (neg, pred>0.9) → 5
    assert custom_error(pred, y, beta=5.0, threshold=0.9) == 6.0


def test_binning_roundtrip():
    X, _ = _make_data(500)
    X[0, 0] = np.nan
    edges = compute_bin_edges(X)
    b = bin_features(X, edges)
    assert b[0, 0] == 255
    assert b.max() <= 255
    # monotone: larger value → larger-or-equal bin
    col = X[:, 2]
    order = np.argsort(col)
    assert (np.diff(b[order, 2].astype(int)) >= 0).all()


def test_training_learns():
    X, y = _make_data(3000, seed=1)
    Xe, ye = _make_data(800, seed=2)
    params = GBTParams(num_boost_round=60, early_stopping_rounds=60, depth=4)
    model = train_gbt(X, y, Xe, ye, params, verbose_every=0)
    pred = model.predict(Xe)
    assert auc_score(pred, ye) > 0.97
    err_final = custom_error(pred, ye, 5.0, 0.9)
    err_start = custom_error(np.full(len(ye), 0.5, np.float32), ye, 5.0, 0.9)
    assert err_final < err_start * 0.5


def test_missing_values_learned_direction():
    X, y = _make_data(3000, seed=3, with_nan=True)
    Xe, ye = _make_data(800, seed=4, with_nan=True)
    params = GBTParams(num_boost_round=40, early_stopping_rounds=40, depth=4)
    model = train_gbt(X, y, Xe, ye, params, verbose_every=0)
    pred = model.predict(Xe)
    assert auc_score(pred, ye) > 0.95
    # the model must produce different predictions for NaN vs non-NaN feature 1
    x_probe = np.zeros((2, 6), np.float32)
    x_probe[1, 1] = np.nan
    p = model.predict(x_probe, ntree_limit=model.num_trees)
    assert np.isfinite(p).all()


def test_predict_raw_matches_binned_semantics():
    # raw-value thresholds must route identically to bin comparisons
    X, y = _make_data(1500, seed=5)
    Xe, ye = _make_data(300, seed=6)
    params = GBTParams(num_boost_round=10, early_stopping_rounds=10, depth=3)
    model = train_gbt(X, y, Xe, ye, params, verbose_every=0)

    import jax.numpy as jnp
    from doppelspeller.models.gbt import predict_tree_binned

    Xb = bin_features(Xe, model.edges)
    base_margin = np.log(model.base_score / (1 - model.base_score))
    total = np.full(len(Xe), base_margin, np.float32)
    nt = model.best_ntree_limit
    for t in range(nt):
        total += np.asarray(
            predict_tree_binned(
                jnp.asarray(Xb),
                jnp.asarray(model.feat[t]),
                jnp.asarray(model.split_bin[t]),
                jnp.asarray(model.missing_left[t]),
                jnp.asarray(model.value[t]),
                jnp.asarray(model.is_leaf[t]),
                depth=model.depth,
            )
        )
    raw = model.predict(Xe)
    prob = 1.0 / (1.0 + np.exp(-total))
    np.testing.assert_allclose(raw, prob, rtol=1e-5, atol=1e-6)


def test_early_stopping_and_best_limit():
    X, y = _make_data(1000, seed=7)
    Xe, ye = _make_data(300, seed=8)
    params = GBTParams(num_boost_round=500, early_stopping_rounds=10, depth=3)
    model = train_gbt(X, y, Xe, ye, params, verbose_every=0)
    assert model.num_trees < 500  # stopped early
    assert 1 <= model.best_ntree_limit <= model.num_trees


def test_save_load_roundtrip(tmp_path):
    X, y = _make_data(500, seed=9)
    params = GBTParams(num_boost_round=5, early_stopping_rounds=5, depth=3)
    model = train_gbt(X, y, X[:100], y[:100], params, verbose_every=0)
    path = str(tmp_path / "model.npz")
    model.save(path)
    loaded = GBTModel.load(path)
    np.testing.assert_allclose(model.predict(X), loaded.predict(X), rtol=1e-6)
    imp = loaded.feature_importance()
    assert imp.shape == (6,)
    assert abs(imp.sum() - 1.0) < 1e-6
