"""Round-4 additions: pooled graph descriptors feeding the classification
side (reference Descriptors/create_descriptors_gpu.py:26-51 +
Descriptors/model_train_gpu.py:127-137 — the A2/A3 graph-feature variant)."""

import os

import numpy as np

from bbbp.chem.graph_features import N_ATOM_FEATURES, graph_features, \
    pooled_graph_features


class TestMatmulHistogramEngine:
    """hist='matmul' is the scatter-free matmul histogram path (forest_device);
    it must reproduce the scatter engine's forests."""

    def _data(self, n=400, f=12, seed=0):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(n, f)).astype(np.float32)
        y_reg = (x[:, 0] * 2 - x[:, 1] + 0.1 * rng.normal(size=n)
                 ).astype(np.float32)
        y_cls = (y_reg > 0).astype(np.float32)
        return x, y_reg, y_cls

    def test_gbdt_matmul_matches_scatter(self):
        import jax
        import jax.numpy as jnp
        from bbbp.ops.forest import BinMapper, MAX_BINS
        from bbbp.ops.forest_device import (DenseTreeEnsemble,
                                            fit_forest_launched)

        x, y_reg, _ = self._data()
        mapper = BinMapper().fit(x)
        xb = jnp.asarray(mapper.transform(x))
        edge_vals = np.full((x.shape[1], MAX_BINS), np.inf, np.float32)
        for f_i, e in enumerate(mapper.edges_):
            edge_vals[f_i, : len(e)] = e
        out = {}
        for mode in ("scatter", "matmul"):
            feats, thrs, leaves = fit_forest_launched(
                xb, jnp.asarray(edge_vals), jnp.asarray(y_reg),
                jnp.float32(0.1), jnp.float32(1.0), jnp.float32(1.0),
                jnp.float32(1.0), jnp.float32(1.0),
                jnp.float32(float(y_reg.mean())), jax.random.PRNGKey(0),
                task="reg", n_trees=20, depth=4, oblivious=False, rf=False,
                hist=mode)
            ens = DenseTreeEnsemble(feats, thrs, leaves, 4,
                                    float(y_reg.mean()), 0.1)
            out[mode] = (np.asarray(feats), np.asarray(thrs),
                         np.asarray(ens.raw_predict(jnp.asarray(x))))
        # early trees (large, well-separated gains) split identically; late
        # trees fit near-zero residuals where f32 summation-order ties can
        # flip an argmax (observed first at tree 13 on this data) — so
        # require structural equality early and prediction-level agreement
        # end to end
        np.testing.assert_array_equal(out["scatter"][0][:8],
                                      out["matmul"][0][:8])
        np.testing.assert_allclose(out["scatter"][1][:8],
                                   out["matmul"][1][:8])
        np.testing.assert_allclose(out["scatter"][2], out["matmul"][2],
                                   atol=0.05)

    def test_vmapped_forest_search_matches_sequential(self):
        from bbbp.train.batched_search import (_forest_cv,
                                               _forest_cv_vmapped)
        from bbbp.train.search import stratified_kfold_indices

        x, _, y_cls = self._data(n=300)
        folds = stratified_kfold_indices(y_cls, 3, 7)
        params = [
            {"n_estimators": 30, "max_depth": 4, "learning_rate": 0.1,
             "subsample": 1.0},
            {"n_estimators": 30, "max_depth": 4, "learning_rate": 0.05,
             "subsample": 1.0},
            {"rf": True, "n_estimators": 30, "max_depth": 4,
             "colsample": 1.0, "reg_lambda": 1e-6},
            {"oblivious": True, "n_estimators": 30, "max_depth": 4,
             "learning_rate": 0.1, "reg_lambda": 1.0},
        ]
        a_s, p_s, f_s = _forest_cv(x, y_cls, folds, params, classify=True)
        a_v, p_v, f_v = _forest_cv_vmapped(x, y_cls, folds, params,
                                           classify=True)
        # the vmapped path derives lane keys exactly as the sequential path
        # (fold_in(fold_in(key0, t*131+k), launch=0) — single-launch matmul
        # engine), so both engines grow the same trees and the residual
        # difference is histogram summation order occasionally flipping a
        # near-tie split (a handful of samples out of 300)
        np.testing.assert_allclose(a_s, a_v, atol=0.01)
        np.testing.assert_allclose(f_s, f_v, atol=0.01)

    def test_rf_prediction_accumulation(self):
        # rf mode now accumulates leaf margins into preds (vmapped search
        # reads OOF predictions straight from the fit); mean must track y
        import jax
        import jax.numpy as jnp
        from bbbp.ops.forest import BinMapper, MAX_BINS
        from bbbp.ops.forest_device import _fit_forest_jit

        x, y_reg, _ = self._data(n=256)
        mapper = BinMapper().fit(x)
        xb = jnp.asarray(mapper.transform(x))
        edge_vals = np.full((x.shape[1], MAX_BINS), np.inf, np.float32)
        for f_i, e in enumerate(mapper.edges_):
            edge_vals[f_i, : len(e)] = e
        n_trees = 25
        preds, _, _, _ = _fit_forest_jit(
            xb, jnp.asarray(edge_vals), jnp.asarray(y_reg), jnp.float32(1.0),
            jnp.float32(1e-6), jnp.float32(1.0), jnp.float32(1.0),
            jnp.float32(1.0), jnp.float32(0.0), jax.random.PRNGKey(0),
            None, None, task="reg", n_trees=n_trees, depth=4,
            oblivious=False, rf=True, hist="matmul")
        pred = np.asarray(preds) / n_trees
        r2 = 1 - ((pred - y_reg) ** 2).sum() / ((y_reg - y_reg.mean()) ** 2).sum()
        assert r2 > 0.7


class TestScreenPipelineErrors:
    def test_producer_error_propagates_without_hang(self, tmp_path):
        import pytest
        from bbbp.pipelines.screen import ScreeningModel, screen

        labels = np.array([1, 0, 1, 0] * 8, np.float32)
        model = ScreeningModel.train(["CCO", "CCN", "c1ccccc1", "CCS"] * 8,
                                     labels, pca_dim=4, n_estimators=10)

        def bad_stream():
            yield ("CCO", "A1")
            yield ("CCN", "A2")
            raise RuntimeError("stream died")

        with pytest.raises(RuntimeError, match="stream died"):
            screen(model, bad_stream(), out_csv=str(tmp_path / "out.csv"),
                   chunk_size=8)


class TestReferenceStackMeta:
    def test_refstack_memorizes_in_sample(self):
        """The reference's meta (forest stack over the OOF matrix, predicted
        in-sample, Models/...20250113.py:394-403) must beat the linear
        in-sample meta — that memorization is exactly what it reproduces."""
        from bbbp.ops.linear import LinearRegression
        from bbbp.train.regression import _reference_stack_meta

        rng = np.random.default_rng(0)
        n = 200
        y = rng.normal(size=n).astype(np.float32)
        # three "leg OOF columns": y + independent noise
        stack_x = np.stack([y + 0.8 * rng.normal(size=n) for _ in range(3)],
                           axis=1).astype(np.float32)

        def r2(p):
            return 1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum()

        lin = LinearRegression().fit(stack_x, y).predict(stack_x)
        rs = _reference_stack_meta(stack_x, y, seed=0, n_estimators=40,
                                   depth=6, cv=3)
        assert r2(rs) > r2(lin) + 0.05


class TestRepeatedCVSelection:
    def test_repeats_average_and_report_spread(self):
        from bbbp.train.batched_search import batched_random_search

        rng = np.random.default_rng(0)
        x = rng.normal(size=(160, 8)).astype(np.float32)
        y = (x[:, 0] + 0.3 * rng.normal(size=160) > 0).astype(np.float32)
        res1 = batched_random_search(
            "logreg", x, y, {"l2": {"low": 1e-2, "high": 10.0, "log": True}},
            n_iter=4, cv=3, seed=7, extra_trials=[{"l2": 1.0}], n_repeats=1)
        res3 = batched_random_search(
            "logreg", x, y, {"l2": {"low": 1e-2, "high": 10.0, "log": True}},
            n_iter=4, cv=3, seed=7, extra_trials=[{"l2": 1.0}], n_repeats=3)
        # same trial set either way (sampling is repeat-independent)
        assert [t["l2"] for t in res1.trials] == [t["l2"] for t in res3.trials]
        assert "repeat_std" not in res1.trials[0]
        assert all("repeat_std" in t and t["repeat_std"] >= 0.0
                   for t in res3.trials)
        assert 0.5 <= res3.best_score <= 1.0
        # the seeded default is a trial, so the winner is never mean-CV-worse
        default = next(t for t in res3.trials if t["l2"] == 1.0)
        assert res3.best_score >= default["mean_accuracy"]


class TestPooledGraphFeatures:
    def test_shape_and_pools_match_manual(self):
        smiles = ["CCO", "c1ccccc1", "CC(=O)O"]
        pooled, bad = pooled_graph_features(smiles, max_atoms=16)
        assert pooled.shape == (3, 3 * N_ATOM_FEATURES + 2)
        assert bad == []
        feats, adj, mask, _ = graph_features(smiles, max_atoms=16)
        f = N_ATOM_FEATURES
        for i, s in enumerate(smiles):
            n = int(mask[i].sum())
            ref_sum = feats[i, :n].sum(axis=0)
            np.testing.assert_allclose(pooled[i, :f], ref_sum, rtol=1e-5)
            np.testing.assert_allclose(pooled[i, f:2 * f], ref_sum / n,
                                       rtol=1e-5)
            np.testing.assert_allclose(pooled[i, 2 * f:3 * f],
                                       feats[i, :n].max(axis=0), rtol=1e-5)
            assert pooled[i, 3 * f] == n  # atom count
        # bond counts: ethanol 2, benzene 6, acetic acid 3
        np.testing.assert_allclose(pooled[:, 3 * f + 1], [2.0, 6.0, 3.0])

    def test_invalid_smiles_quarantined_row_zero(self):
        pooled, bad = pooled_graph_features(["CCO", "not_a_smiles("],
                                            max_atoms=16)
        assert bad == [1]
        # quarantined row must be finite (max pool over empty mask -> 0)
        assert np.isfinite(pooled[1]).all()
        assert pooled[1, :].sum() == 0.0

    def test_featurize_graph_writes_gpu_features_contract(self, tmp_path,
                                                         b3db):
        from bbbp.pipelines.featurize import featurize_graph_b3db

        out = featurize_graph_b3db("classification", str(tmp_path), limit=20)
        assert os.path.basename(out["npy"]) == "gpu_features.npy"
        arr = np.load(out["npy"])
        # row-aligned contract: one row per INPUT molecule; invalid SMILES
        # become zero rows listed in bad_indices (they are not dropped)
        assert arr.shape[0] == 20
        assert arr.shape[1] == 3 * N_ATOM_FEATURES + 2
        assert np.isfinite(arr).all()
        for i in out["bad_indices"]:
            assert arr[i].sum() == 0.0

    def test_baseline_runs_on_graph_features(self, b3db):
        from bbbp.train.baseline import BaselineConfig, run_baseline

        # limit=400 keeps both classes present (the TSV is label-ordered:
        # the first ~250 rows are all BBB-)
        rep = run_baseline(BaselineConfig(
            fp_kind="graph", limit=400, pca_dim=20, tune=False,
            with_learning_curves=False, models=("knn", "logreg")),
            verbose=False)
        assert set(rep) == {"knn", "logreg", "_best"}
        for m in ("knn", "logreg"):
            assert 0.0 <= rep[m]["accuracy"] <= 1.0
            assert rep[m]["roc_auc"] > 0.5  # pooled features are informative
