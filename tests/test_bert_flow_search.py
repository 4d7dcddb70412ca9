"""SMILES-BERT, Flow classifier, and hyperparameter-search tests (CPU mesh)."""

import numpy as np
import pytest

rng = np.random.default_rng(5)


def _toy_smiles_task(n=60):
    """Aromatic vs aliphatic — separable from tokens."""
    arom = ["c1ccccc1", "c1ccncc1", "Cc1ccccc1", "c1ccccc1O", "c1ccsc1",
            "c1ccoc1"]
    ali = ["CCO", "CCCC", "CC(C)O", "CCNC", "CCCCCC", "CC(=O)O"]
    smiles, y = [], []
    for i in range(n):
        if i % 2 == 0:
            smiles.append(arom[i % len(arom)])
            y.append(1)
        else:
            smiles.append(ali[i % len(ali)])
            y.append(0)
    return np.asarray(smiles, dtype=object), np.asarray(y)


class TestTokenizer:
    def test_smiles_tokens(self):
        from bbbp.models.bert import SmilesTokenizer

        tok = SmilesTokenizer(max_len=16).fit(["CCO", "c1cc(Cl)ccc1[NH3+]"])
        ids = tok.encode("c1cc(Cl)ccc1")
        assert ids.shape == (16,)
        assert ids[0] == 1  # CLS
        # Cl must be one token, not C+l
        assert "Cl" in tok.vocab and "[NH3+]" in tok.vocab

    def test_roundtrip_json(self):
        from bbbp.models.bert import SmilesTokenizer

        tok = SmilesTokenizer(max_len=8).fit(["CCO"])
        tok2 = SmilesTokenizer.from_json(tok.to_json())
        assert np.array_equal(tok.encode("CCO"), tok2.encode("CCO"))

    def test_number_tokenizer(self):
        from bbbp.models.bert import NumberStringTokenizer

        tok = NumberStringTokenizer(max_len=32).fit(["[ 1.25 -3.5  0.1 ]"])
        assert "1.25" in tok.vocab and "-3.5" in tok.vocab


class TestBert:
    def test_learns_and_roundtrips(self, tmp_path):
        from bbbp.models.bert import BertClassifier

        x, y = _toy_smiles_task(60)
        clf = BertClassifier(epochs=8, batch_size=16, lr=1e-3, n_layers=2,
                             d_model=64, max_len=24, seed=0).fit(x, y)
        acc = clf.score(x, y)
        assert acc > 0.9, acc
        rep = clf.evaluate(x, y)
        assert "roc_auc" in rep and rep["accuracy"] > 0.9
        p = str(tmp_path / "bert")
        clf.save(p)
        clf2 = BertClassifier.load(p)
        np.testing.assert_array_equal(clf.predict(x), clf2.predict(x))

    def test_compat_vector_mode(self):
        from bbbp.models.bert import BertClassifier

        xv = rng.standard_normal((40, 5)).astype(np.float32)
        yv = (xv[:, 0] > 0).astype(int)
        clf = BertClassifier(epochs=2, batch_size=16, n_layers=1, d_model=32,
                             max_len=24, input_mode="compat_vector").fit(xv, yv)
        assert clf.predict(xv).shape == (40,)


class TestFlow:
    def test_flow_classifier_learns(self, tmp_path):
        from bbbp.train.flow_pipeline import FlowClassifier

        x = rng.standard_normal((200, 10)).astype(np.float32)
        y = (x[:, 0] + x[:, 1] > 0).astype(int)
        clf = FlowClassifier(hidden_dim=32, n_layers=2, epochs=30,
                             batch_size=32, lr=3e-3).fit(x, y)
        assert (clf.predict(x) == y).mean() > 0.85
        p = str(tmp_path / "flow.pkl")
        clf.save(p)
        clf2 = FlowClassifier.load(p)
        np.testing.assert_array_equal(clf.predict(x), clf2.predict(x))


class TestSearch:
    def test_stratified_folds_preserve_ratio(self):
        from bbbp.train.search import stratified_kfold_indices

        y = np.array([0] * 80 + [1] * 20)
        folds = stratified_kfold_indices(y, 5, seed=0)
        assert sum(len(f) for f in folds) == 100
        for f in folds:
            assert 2 <= y[f].sum() <= 6  # ~4 positives per fold

    def test_random_search_finds_better_params(self):
        from bbbp.ops.linear import LogisticRegression
        from bbbp.train.search import RandomizedSearchCV

        x = rng.standard_normal((300, 6)).astype(np.float32)
        y = (x[:, 0] - x[:, 1] > 0).astype(int)
        search = RandomizedSearchCV(
            LogisticRegression, {"C": {"low": 0.01, "high": 10.0, "log": True}},
            n_iter=4, cv=3, scoring=["accuracy", "precision"],
            refit="accuracy", seed=0)
        res = search.fit(x, y)
        assert res.best_score > 0.9
        assert len(res.trials) == 4
        assert "mean_accuracy" in res.trials[0]

    def test_grid_search_enumerates(self):
        from bbbp.ops.forest_device import DeviceGBDTClassifier
        from bbbp.train.search import GridSearchCV

        x = rng.standard_normal((150, 5)).astype(np.float32)
        y = (x[:, 0] > 0).astype(int)
        gs = GridSearchCV(DeviceGBDTClassifier,
                          {"n_estimators": [5, 10], "max_depth": [2, 3]},
                          cv=2, scoring=["accuracy"])
        res = gs.fit(x, y)
        assert len(res.trials) == 4
        assert res.best_estimator.predict(x).shape == (150,)
