"""Device forest trainer tests (runs on the CPU backend in CI; the same jit
path runs on the GPU)."""

import numpy as np
import pytest

rng = np.random.default_rng(11)


class TestTPUForest:
    def setup_method(self):
        self.X = rng.standard_normal((500, 16)).astype(np.float32)
        self.y = (np.sin(self.X[:, 0] * 2) + self.X[:, 1] * self.X[:, 2]).astype(np.float32)
        self.Xt = rng.standard_normal((250, 16)).astype(np.float32)
        self.yt = (np.sin(self.Xt[:, 0] * 2) + self.Xt[:, 1] * self.Xt[:, 2]).astype(np.float32)

    def _r2(self, p):
        return 1 - ((self.yt - p) ** 2).sum() / ((self.yt - self.yt.mean()) ** 2).sum()

    def test_gbdt_learns(self):
        from bbbp.ops.forest_device import DeviceGBDTRegressor

        m = DeviceGBDTRegressor(n_estimators=60, max_depth=4).fit(self.X, self.y)
        assert self._r2(m.predict(self.Xt)) > 0.35

    def test_oblivious_learns(self):
        from bbbp.ops.forest_device import DeviceGBDTRegressor

        m = DeviceGBDTRegressor(n_estimators=60, max_depth=5,
                             oblivious=True).fit(self.X, self.y)
        assert self._r2(m.predict(self.Xt)) > 0.25

    def test_rf_learns(self):
        from bbbp.ops.forest_device import DeviceRandomForestRegressor

        m = DeviceRandomForestRegressor(n_estimators=40, max_depth=8).fit(self.X, self.y)
        assert self._r2(m.predict(self.Xt)) > 0.25

    def test_classifier(self):
        from bbbp.ops.forest_device import DeviceGBDTClassifier

        yc = (self.y > 0).astype(np.float32)
        yct = (self.yt > 0)
        m = DeviceGBDTClassifier(n_estimators=60, max_depth=4).fit(self.X, yc)
        assert (m.predict(self.Xt) == yct).mean() > 0.75
        p = m.predict_proba(self.Xt)
        np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-5)

    def test_train_pred_consistency(self):
        """Training-time leaf assignment must equal inference traversal."""
        from bbbp.ops.forest_device import DeviceGBDTRegressor

        m = DeviceGBDTRegressor(n_estimators=1, max_depth=3, learning_rate=1.0,
                             reg_lambda=1e-9).fit(self.X, self.y)
        pred_train = m.predict(self.X)
        # single tree, lr=1: prediction = base + leaf mean of region;
        # residuals within each leaf must average ~0
        resid = self.y - pred_train
        assert abs(resid.mean()) < 1e-3

    def test_deterministic_given_seed(self):
        from bbbp.ops.forest_device import DeviceGBDTRegressor

        a = DeviceGBDTRegressor(n_estimators=10, max_depth=3, subsample=0.8,
                             seed=5).fit(self.X, self.y).predict(self.Xt)
        b = DeviceGBDTRegressor(n_estimators=10, max_depth=3, subsample=0.8,
                             seed=5).fit(self.X, self.y).predict(self.Xt)
        np.testing.assert_array_equal(a, b)

    def test_colsample_restricts_features(self):
        from bbbp.ops.forest_device import DeviceGBDTRegressor

        m = DeviceGBDTRegressor(n_estimators=5, max_depth=3,
                             colsample=0.25, seed=3).fit(self.X, self.y)
        assert np.isfinite(m.predict(self.Xt)).all()


class TestScreeningModelRoundtrip:
    def test_save_load_predict(self, tmp_path):
        from bbbp.pipelines.screen import ScreeningModel, _make_device_fn

        smiles = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "c1ccncc1", "CCCC",
                  "CC(C)O", "c1ccccc1O", "CCOC", "CCS"] * 6
        labels = np.array(([1, 0] * 30)[:60])
        m = ScreeningModel.train(smiles, labels, pca_dim=8, n_estimators=10,
                                 workers=1)
        p = str(tmp_path / "model.pkl")
        m.save(p)
        m2 = ScreeningModel.load(p)
        import jax.numpy as jnp
        from bbbp.chem.featurize import fingerprints

        fp = fingerprints(["CCO", "c1ccccc1"], workers=1).features
        p1 = np.asarray(_make_device_fn(m)(jnp.asarray(fp)))
        p2 = np.asarray(_make_device_fn(m2)(jnp.asarray(fp)))
        np.testing.assert_allclose(p1, p2, atol=1e-6)


class TestScreeningEndToEnd:
    def test_screen_writes_csv(self, tmp_path):
        from bbbp.pipelines.screen import ScreeningModel, screen
        from bbbp.data.zinc import synthetic_smiles

        train = synthetic_smiles(40, seed=1)
        labels = rng.integers(0, 2, 40)
        model = ScreeningModel.train(train, labels, pca_dim=8, n_estimators=5,
                                     workers=1)
        mols = [(s, f"ID{i}") for i, s in enumerate(synthetic_smiles(50, seed=2))]
        mols.append(("NOT_A_SMILES((", "BADID"))
        out = str(tmp_path / "results.csv")
        stats = screen(model, iter(mols), out_csv=out, chunk_size=16, workers=1)
        assert stats.n_molecules == 51
        assert stats.n_invalid == 1
        import csv

        rows = list(csv.reader(open(out)))
        assert rows[0] == ["ID", "SMILES", "Prediction", "Probability"]
        assert len(rows) == 52
        bad_rows = [r for r in rows if r[2] == "invalid"]
        assert len(bad_rows) == 1 and bad_rows[0][0] == "BADID"


class TestSampleWeight:
    def test_row_bucketing_matches_exact_fit(self, monkeypatch):
        """fits pad rows to a power-of-2 bucket with weight-0 rows so nearby
        train sizes share one compiled program; the deterministic GBDT path
        (subsample=1, no rf) must match the exact-shape fit bit-for-bit."""
        from bbbp.ops import forest_device as ft

        rng = np.random.default_rng(9)
        x = rng.normal(size=(300, 5)).astype(np.float32)   # buckets to 512
        y = (x[:, 0] + 0.5 * x[:, 2]).astype(np.float32)
        q = rng.normal(size=(40, 5)).astype(np.float32)
        kw = dict(n_estimators=20, max_depth=3, learning_rate=0.3, seed=2,
                  subsample=1.0, colsample=1.0)
        p_bucketed = ft.DeviceGBDTRegressor(**kw).fit(x, y).predict(q)
        monkeypatch.setattr(ft, "ROW_BUCKETING", False)
        p_exact = ft.DeviceGBDTRegressor(**kw).fit(x, y).predict(q)
        np.testing.assert_allclose(p_bucketed, p_exact, rtol=1e-5, atol=1e-6)
        # classifier path too (sigmoid gradients, padded rows weight-0)
        yc = (y > 0).astype(np.float32)
        monkeypatch.setattr(ft, "ROW_BUCKETING", True)
        pc_b = ft.DeviceGBDTClassifier(**kw).fit(x, yc).predict_proba(q)
        monkeypatch.setattr(ft, "ROW_BUCKETING", False)
        pc_e = ft.DeviceGBDTClassifier(**kw).fit(x, yc).predict_proba(q)
        np.testing.assert_allclose(pc_b, pc_e, rtol=1e-5, atol=1e-6)

    def test_zero_weight_rows_are_ignored(self):
        """fit(sample_weight=mask) on the full matrix must equal fit() on the
        subset — the mechanism that lets holdout fits reuse the full-shape
        compiled program (train.transfer)."""
        from bbbp.ops.forest_device import DeviceGBDTRegressor

        rng = np.random.default_rng(3)
        x = rng.normal(size=(120, 6)).astype(np.float32)
        y = (x[:, 0] - 2 * x[:, 1]).astype(np.float32)
        w = np.ones(120, np.float32)
        w[80:] = 0.0
        kw = dict(n_estimators=30, max_depth=3, learning_rate=0.3, seed=5,
                  subsample=1.0)
        m_w = DeviceGBDTRegressor(**kw).fit(x, y, sample_weight=w)
        q = rng.normal(size=(20, 6)).astype(np.float32)
        p_w = m_w.predict(q)
        # weighted-out rows with wild labels must not change predictions
        y2 = y.copy()
        y2[80:] = 100.0
        p_w2 = DeviceGBDTRegressor(**kw).fit(x, y2, sample_weight=w).predict(q)
        np.testing.assert_allclose(p_w, p_w2, rtol=1e-5, atol=1e-5)
        # and a no-weight fit DOES see them
        p_all = DeviceGBDTRegressor(**kw).fit(x, y2).predict(q)
        assert np.abs(p_all - p_w).max() > 1.0
