"""Ops-layer tests: parity vs sklearn where sklearn exists, behavioral
contracts elsewhere (SURVEY.md §4 'numerics tests vs reference' strategy)."""

import numpy as np
import pytest

rng = np.random.default_rng(42)


class TestScalerPCA:
    def test_standard_scaler_matches_sklearn(self):
        from sklearn.preprocessing import StandardScaler as SkScaler
        from bbbp.ops import StandardScaler

        x = rng.standard_normal((200, 17)).astype(np.float32) * 3 + 1
        ours = np.asarray(StandardScaler().fit_transform(x))
        theirs = SkScaler().fit_transform(x)
        np.testing.assert_allclose(ours, theirs, atol=1e-4)

    def test_pca_matches_sklearn(self):
        from sklearn.decomposition import PCA as SkPCA
        from bbbp.ops import PCA

        # distinct variance spectrum so components are unique up to sign
        x = rng.standard_normal((300, 40)).astype(np.float32)
        x *= np.linspace(1.0, 8.0, 40, dtype=np.float32)
        p = PCA(8).fit(x)
        ours = np.asarray(p.transform(x))
        theirs = SkPCA(8).fit(x)
        sk_proj = theirs.transform(x)
        # per-component projections must match up to sign (float32 eigh vs SVD)
        for k in range(8):
            c = abs(np.corrcoef(ours[:, k], sk_proj[:, k])[0, 1])
            assert c > 0.999, f"component {k} corr {c}"
        np.testing.assert_allclose(
            np.asarray(p.explained_variance_ratio_),
            theirs.explained_variance_ratio_, atol=1e-3,
        )

    def test_pca_variance_fraction_mode(self):
        from bbbp.ops import PCA

        x = rng.standard_normal((100, 20)).astype(np.float32)
        p = PCA(0.95).fit(x)
        assert 1 <= p.components_.shape[0] <= 20
        assert float(np.sum(np.asarray(p.explained_variance_ratio_))) >= 0.95

    def test_per_batch_compat_modes(self):
        from bbbp.ops.scaler import standardize_per_batch
        from bbbp.ops.pca import pca_per_batch

        x = rng.standard_normal((250, 12)).astype(np.float32)
        s = standardize_per_batch(x, batch_size=100)
        # each 100-block standardized independently
        np.testing.assert_allclose(s[:100].mean(0), 0.0, atol=1e-5)
        np.testing.assert_allclose(s[100:200].mean(0), 0.0, atol=1e-5)
        z = pca_per_batch(x, n_components=5, batch_size=100)
        assert z.shape == (250, 5)

    def test_interactions_match_sklearn(self):
        from sklearn.preprocessing import PolynomialFeatures
        from bbbp.ops import interaction_features

        x = rng.standard_normal((50, 7)).astype(np.float32)
        ours = np.asarray(interaction_features(x))
        theirs = PolynomialFeatures(
            degree=2, interaction_only=True, include_bias=False
        ).fit_transform(x)
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


class TestMetrics:
    def test_classification_metrics_match_sklearn(self):
        import sklearn.metrics as skm
        from bbbp.ops import metrics as m

        y = rng.integers(0, 2, 500)
        score = rng.random(500) * 0.5 + y * 0.3
        pred = (score > 0.5).astype(int)
        assert abs(float(m.accuracy(y, pred)) - skm.accuracy_score(y, pred)) < 1e-6
        assert abs(float(m.f1_score(y, pred)) - skm.f1_score(y, pred)) < 1e-5
        assert abs(float(m.mcc(y, pred)) - skm.matthews_corrcoef(y, pred)) < 1e-5
        assert abs(float(m.cohen_kappa(y, pred)) - skm.cohen_kappa_score(y, pred)) < 1e-5
        assert abs(float(m.balanced_accuracy(y, pred))
                   - skm.balanced_accuracy_score(y, pred)) < 1e-5
        assert abs(float(m.roc_auc(y, score)) - skm.roc_auc_score(y, score)) < 1e-4

    def test_roc_auc_with_ties(self):
        import sklearn.metrics as skm
        from bbbp.ops import metrics as m

        y = rng.integers(0, 2, 300)
        score = np.round(rng.random(300), 1)  # heavy ties
        assert abs(float(m.roc_auc(y, score)) - skm.roc_auc_score(y, score)) < 1e-4

    def test_regression_metrics(self):
        import sklearn.metrics as skm
        from bbbp.ops import metrics as m

        y = rng.standard_normal(200)
        p = y + 0.3 * rng.standard_normal(200)
        assert abs(float(m.r2_score(y, p)) - skm.r2_score(y, p)) < 1e-5
        assert abs(float(m.mse(y, p)) - skm.mean_squared_error(y, p)) < 1e-5


class TestOutliersResample:
    def test_isolation_forest_finds_planted_outliers(self):
        from bbbp.ops.outliers import IsolationForest

        x = rng.standard_normal((400, 8)).astype(np.float32)
        x[:20] += 8.0  # planted outliers
        labels = IsolationForest(contamination=0.05, seed=0).fit_predict(x)
        assert set(np.unique(labels)) <= {-1, 1}
        # most flagged outliers are the planted ones
        flagged = np.nonzero(labels == -1)[0]
        assert len(flagged) > 0
        assert (flagged < 20).mean() > 0.8

    def test_smote_balances_classes(self):
        from bbbp.ops.resample import smote

        x = rng.standard_normal((120, 10)).astype(np.float32)
        y = np.array([0] * 100 + [1] * 20)
        xs, ys = smote(x, y, seed=0)
        assert (ys == 0).sum() == (ys == 1).sum() == 100
        # synthetic points lie within the minority bounding box (convex comb.)
        mins, maxs = x[y == 1].min(0) - 1e-5, x[y == 1].max(0) + 1e-5
        synth = xs[120:]
        assert ((synth >= mins) & (synth <= maxs)).all()

    def test_smote_tomek_runs(self):
        from bbbp.ops.resample import smote_tomek

        x = rng.standard_normal((150, 6)).astype(np.float32)
        y = (x[:, 0] + 0.5 * rng.standard_normal(150) > 0.8).astype(int)
        xs, ys = smote_tomek(x, y, seed=1)
        counts = np.bincount(ys)
        assert abs(counts[0] - counts[1]) < 0.2 * counts.max()


class TestForest:
    def setup_method(self):
        self.X = rng.standard_normal((600, 20)).astype(np.float32)
        self.y = (np.sin(self.X[:, 0] * 2) + self.X[:, 1] * self.X[:, 2]).astype(np.float32)
        self.Xt = rng.standard_normal((300, 20)).astype(np.float32)
        self.yt = (np.sin(self.Xt[:, 0] * 2) + self.Xt[:, 1] * self.Xt[:, 2]).astype(np.float32)

    def _r2(self, p):
        return 1 - ((self.yt - p) ** 2).sum() / ((self.yt - self.yt.mean()) ** 2).sum()

    def test_gbdt_regressor_learns(self):
        from bbbp.ops.forest import GBDTRegressor

        m = GBDTRegressor(n_estimators=60, max_depth=4).fit(self.X, self.y)
        assert self._r2(m.predict(self.Xt)) > 0.3

    def test_rf_regressor_learns(self):
        from bbbp.ops.forest import RandomForestRegressor

        m = RandomForestRegressor(n_estimators=30, max_depth=10).fit(self.X, self.y)
        assert self._r2(m.predict(self.Xt)) > 0.2

    def test_oblivious_gbdt_learns(self):
        from bbbp.ops.forest import GBDTRegressor

        m = GBDTRegressor(n_estimators=60, max_depth=5, oblivious=True).fit(self.X, self.y)
        assert self._r2(m.predict(self.Xt)) > 0.2

    def test_gbdt_classifier(self):
        from bbbp.ops.forest import GBDTClassifier

        yc = (self.y > 0).astype(np.int32)
        yct = (self.yt > 0).astype(np.int32)
        m = GBDTClassifier(n_estimators=60, max_depth=4).fit(self.X, yc)
        assert (m.predict(self.Xt) == yct).mean() > 0.75
        proba = m.predict_proba(self.Xt)
        np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-5)

    def test_jax_predict_matches_host_traversal(self):
        from bbbp.ops.forest import GBDTRegressor, _numpy_tree_predict

        m = GBDTRegressor(n_estimators=10, max_depth=4).fit(self.X, self.y)
        jax_pred = m.predict(self.Xt)
        host = m.ensemble_.base_score + m.ensemble_.tree_scale * sum(
            _numpy_tree_predict(t, self.Xt) for t in m._host_trees
        )
        np.testing.assert_allclose(jax_pred, host, rtol=1e-4, atol=1e-4)


class TestLinearZoo:
    def test_linreg_matches_sklearn(self):
        from sklearn.linear_model import LinearRegression as SkLR
        from bbbp.ops.linear import LinearRegression

        x = rng.standard_normal((200, 10)).astype(np.float32)
        y = x @ rng.standard_normal(10) + 0.5
        ours = LinearRegression().fit(x, y)
        theirs = SkLR().fit(x, y)
        np.testing.assert_allclose(np.asarray(ours.coef_), theirs.coef_, atol=1e-3)
        assert abs(ours.intercept_ - theirs.intercept_) < 1e-3

    def test_logreg_close_to_sklearn(self):
        from sklearn.linear_model import LogisticRegression as SkLogit
        from bbbp.ops.linear import LogisticRegression

        x = rng.standard_normal((400, 8)).astype(np.float32)
        y = (x[:, 0] - x[:, 1] + 0.3 * rng.standard_normal(400) > 0).astype(int)
        ours = LogisticRegression(C=1.0).fit(x, y)
        theirs = SkLogit(C=1.0).fit(x, y)
        agree = (ours.predict(x) == theirs.predict(x)).mean()
        assert agree > 0.98

    def test_svm_separates(self):
        from bbbp.ops.linear import LinearSVC

        x = rng.standard_normal((300, 5)).astype(np.float32)
        y = (x[:, 0] + x[:, 1] > 0).astype(int)
        m = LinearSVC().fit(x, y)
        assert (m.predict(x) == y).mean() > 0.9
        proba = m.predict_proba(x)
        assert proba.shape == (300, 2)

    def test_naive_bayes(self):
        from sklearn.naive_bayes import GaussianNB as SkGNB, BernoulliNB as SkBNB
        from bbbp.ops.linear import GaussianNB, BernoulliNB

        x = rng.standard_normal((300, 6)).astype(np.float32)
        y = (x[:, 0] > 0).astype(int)
        agree_g = (GaussianNB().fit(x, y).predict(x) == SkGNB().fit(x, y).predict(x)).mean()
        assert agree_g > 0.98
        agree_b = (BernoulliNB().fit(x, y).predict(x) == SkBNB().fit(x, y).predict(x)).mean()
        assert agree_b > 0.95

    def test_knn_matches_sklearn(self):
        from sklearn.neighbors import KNeighborsClassifier as SkKNN
        from bbbp.ops.linear import KNeighborsClassifier

        x = rng.standard_normal((200, 4)).astype(np.float32)
        y = (x[:, 0] > 0).astype(int)
        xt = rng.standard_normal((80, 4)).astype(np.float32)
        ours = KNeighborsClassifier(5).fit(x, y).predict(xt)
        theirs = SkKNN(5).fit(x, y).predict(xt)
        assert (ours == theirs).mean() > 0.95

    def test_mlp_learns(self):
        from bbbp.ops.linear import MLPClassifier

        x = rng.standard_normal((400, 6)).astype(np.float32)
        y = ((x[:, 0] * x[:, 1]) > 0).astype(int)  # XOR-ish, needs hidden layer
        m = MLPClassifier(hidden=(64,), n_steps=800).fit(x, y)
        assert (m.predict(x) == y).mean() > 0.85
