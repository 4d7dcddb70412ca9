"""Reporting & attribution tests. TreeSHAP is validated by its additivity
property (Σφ + E[f] = f(x)) — the exact-algorithm invariant."""

import os

import numpy as np
import pytest

rng = np.random.default_rng(3)


class TestMetricsIO:
    def test_csv_roundtrip(self, tmp_path):
        from bbbp.reporting.metrics_io import write_metrics_csv, read_metrics_csv

        rep = {"rf": {"accuracy": 0.91, "f1": 0.9},
               "knn": {"accuracy": 0.85, "f1": 0.84}}
        p = str(tmp_path / "m.csv")
        write_metrics_csv(p, rep)
        back = read_metrics_csv(p)
        assert abs(back["rf"]["accuracy"] - 0.91) < 1e-9

    def test_jsonl(self, tmp_path):
        from bbbp.reporting.metrics_io import append_jsonl
        import json

        p = str(tmp_path / "log.jsonl")
        append_jsonl(p, {"step": 1, "loss": 0.5})
        append_jsonl(p, {"step": 2, "loss": 0.4})
        rows = [json.loads(l) for l in open(p)]
        assert rows[1]["step"] == 2 and "t" in rows[0]


class TestPlots:
    def test_all_plots_render(self, tmp_path):
        from bbbp.reporting import plots

        y = rng.integers(0, 2, 100)
        p = (y + rng.random(100) > 0.9).astype(int)
        score = rng.random(100)
        assert os.path.exists(plots.confusion_matrix_plot(y, p, str(tmp_path / "cm.png")))
        rep = {"rf": {"accuracy": .9, "precision": .9, "recall": .9, "f1": .9,
                      "roc_auc": .95}}
        assert os.path.exists(plots.performance_bar_plot(rep, str(tmp_path / "bar.png")))
        assert os.path.exists(plots.learning_curve_plot(
            [10, 50, 100], np.random.rand(3, 4), np.random.rand(3, 4),
            str(tmp_path / "lc.png")))
        assert os.path.exists(plots.loss_curve_plot(
            np.random.rand(5, 20), str(tmp_path / "loss.png")))
        yt = rng.standard_normal(80)
        assert os.path.exists(plots.pred_vs_actual_plot(
            yt, yt + 0.2 * rng.standard_normal(80), str(tmp_path / "pa.png"),
            r2=0.8, mse=0.1))
        assert os.path.exists(plots.distribution_plot(
            yt, yt + 0.1, str(tmp_path / "dist.png")))
        assert os.path.exists(plots.feature_importance_plot(
            rng.random(30), str(tmp_path / "fi.png")))
        res = [{"lr": 0.1, "depth": 3, "trees": 10, "score": 0.8},
               {"lr": 0.01, "depth": 5, "trees": 50, "score": 0.9}]
        assert os.path.exists(plots.hyperparam_scatter_plot(
            res, "lr", "depth", "score", str(tmp_path / "hp2.png")))
        assert os.path.exists(plots.hyperparam_scatter_plot(
            res, "lr", "depth", "score", str(tmp_path / "hp3.png"), z_key="trees"))
        assert os.path.exists(plots.pca_space_plot(
            rng.standard_normal((50, 2)), rng.integers(0, 2, 50),
            str(tmp_path / "pca.png")))
        assert os.path.exists(plots.shap_summary_plot(
            rng.standard_normal((50, 10)), rng.standard_normal((50, 10)),
            str(tmp_path / "shap.png")))


class TestTreeSHAP:
    def test_additivity_gbdt(self):
        from bbbp.ops.forest import GBDTRegressor
        from bbbp.reporting.attribution import forest_shap_values

        X = rng.standard_normal((200, 6)).astype(np.float32)
        y = (X[:, 0] * 2 + X[:, 1] ** 2).astype(np.float32)
        m = GBDTRegressor(n_estimators=20, max_depth=3).fit(X, y)
        xs = X[:20]
        phi = forest_shap_values(m, xs, max_samples=None)
        pred = m.predict(xs)
        # base value = prediction mean over training distribution per tree:
        # base_score + tree_scale * sum of tree expectations
        base = m.ensemble_.base_score + m.ensemble_.tree_scale * sum(
            float((t.value * t.cover)[t.feature < 0].sum() / t.cover[0])
            for t in m._host_trees)
        np.testing.assert_allclose(base + phi.sum(1), pred, rtol=1e-3, atol=1e-3)

    def test_irrelevant_feature_gets_zero(self):
        from bbbp.ops.forest import GBDTRegressor
        from bbbp.reporting.attribution import forest_shap_values

        X = rng.standard_normal((300, 4)).astype(np.float32)
        y = X[:, 0].astype(np.float32)      # only feature 0 matters
        m = GBDTRegressor(n_estimators=10, max_depth=3).fit(X, y)
        phi = forest_shap_values(m, X[:30], max_samples=None)
        assert np.abs(phi[:, 0]).mean() > 10 * max(np.abs(phi[:, 1:]).mean(), 1e-9)

    def test_vectorized_matches_scalar_oracle(self):
        # the batched tree_shap_values must be numerically identical to the
        # literal per-sample Lundberg Algorithm 2 (_tree_shap_values_scalar)
        from bbbp.ops.forest import GBDTRegressor
        from bbbp.reporting.attribution import (
            _tree_shap_values_scalar, tree_shap_values)

        X = rng.standard_normal((400, 8)).astype(np.float32)
        y = (X[:, 0] * 2 - X[:, 3] ** 2 + X[:, 0] * X[:, 5]).astype(np.float32)
        # depth 6 stresses repeated-feature unwind paths
        m = GBDTRegressor(n_estimators=6, max_depth=6).fit(X, y)
        xs = X[:17]
        for t in m._host_trees:
            np.testing.assert_allclose(
                tree_shap_values(t, xs), _tree_shap_values_scalar(t, xs),
                rtol=1e-9, atol=1e-12)

    def test_feature_importance(self):
        from bbbp.ops.forest import GBDTRegressor
        from bbbp.reporting.attribution import forest_feature_importance

        X = rng.standard_normal((300, 5)).astype(np.float32)
        y = X[:, 2].astype(np.float32)
        m = GBDTRegressor(n_estimators=10, max_depth=3).fit(X, y)
        imp = forest_feature_importance(m)
        assert imp.argmax() == 2


class TestIntegratedGradients:
    def test_linear_model_exact(self):
        import jax.numpy as jnp
        from bbbp.reporting.attribution import integrated_gradients

        w = jnp.asarray(rng.standard_normal(5).astype(np.float32))

        def f(x):
            return x @ w

        x = jnp.asarray(rng.standard_normal((4, 5)).astype(np.float32))
        attr = integrated_gradients(f, x)
        # for a linear model IG = x_i * w_i exactly
        np.testing.assert_allclose(np.asarray(attr), np.asarray(x) * np.asarray(w),
                                   rtol=1e-3, atol=1e-4)

    def test_completeness(self):
        import jax.numpy as jnp
        from bbbp.reporting.attribution import integrated_gradients

        def f(x):
            return jnp.tanh(x).sum(axis=-1)

        x = jnp.asarray(rng.standard_normal((3, 4)).astype(np.float32))
        attr = integrated_gradients(f, x, steps=256)
        np.testing.assert_allclose(
            np.asarray(attr).sum(-1), np.asarray(f(x)) - 0.0, atol=5e-3)
