"""Round-2 feature tests: Crippen descriptors, count fingerprints, batched
hyperparameter search, early stopping, strict protocol, wide-feature forest
regression test, MLM pretraining round-trip, mesh-sharded screening."""

import numpy as np
import pytest


class TestCrippen:
    def test_known_logp_values(self):
        """Exact matches against published Wildman–Crippen results."""
        from bbbp.chem.crippen import crippen_logp_mr
        from bbbp.chem.smiles import MolFromSmiles

        cases = {
            "c1ccccc1": 1.6866,                   # benzene
            "CCO": -0.0014,                       # ethanol
            "CC(=O)Oc1ccccc1C(=O)O": 1.3101,      # aspirin
            "CC(C)Cc1ccc(cc1)C(C)C(=O)O": 3.0732,  # ibuprofen
            "Oc1ccccc1": 1.3922,                  # phenol
        }
        for smi, ref in cases.items():
            lp, mr = crippen_logp_mr(MolFromSmiles(smi))
            assert lp == pytest.approx(ref, abs=1e-3), smi
            assert mr > 0

    def test_descriptor_matrix_has_crippen(self):
        from bbbp.chem.descriptors import (
            DESCRIPTOR_NAMES, compute_descriptors)
        from bbbp.chem.smiles import MolFromSmiles

        d = dict(zip(DESCRIPTOR_NAMES,
                     compute_descriptors(MolFromSmiles("NCCc1ccccc1C(=O)O"))))
        assert "cmr" in d and d["cmr"] > 0
        assert d["n_basic_n"] == 1          # the primary amine, not the amide-free N
        assert d["n_acidic"] == 1           # COOH


class TestCountFingerprints:
    def test_counts_vs_bits(self):
        from bbbp.chem.fingerprints import (
            morgan_count_fingerprint, morgan_fingerprint)
        from bbbp.chem.smiles import MolFromSmiles

        mol = MolFromSmiles("CCCCCCCC")      # repeated CH2 environments
        bits = morgan_fingerprint(mol)
        counts = morgan_count_fingerprint(mol)
        assert np.all((counts > 0) == (bits > 0))
        assert counts.max() > 1              # repeats counted
        assert counts.sum() > bits.sum()

    def test_featurize_kind(self):
        from bbbp.chem.featurize import fingerprints

        res = fingerprints(["CCO", "not_a_smiles("], kind="morgan_counts",
                           workers=1)
        assert res.features.shape == (2, 2048)
        assert list(res.bad_indices) == [1]


class TestBatchedSearch:
    def _data(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(300, 8)).astype(np.float32)
        y = ((x[:, 0] + 0.5 * x[:, 1]) > 0).astype(np.int32)
        return x, y

    def test_logreg_and_knn(self):
        from bbbp.train.batched_search import batched_random_search

        x, y = self._data()
        r = batched_random_search(
            "logreg", x, y, {"l2": {"low": 1e-3, "high": 10.0, "log": True}},
            n_iter=5, cv=3, seed=0)
        assert r.best_score > 0.85
        assert len(r.trials) == 5
        r2 = batched_random_search(
            "knn", x, y, {"n_neighbors": {"low": 3, "high": 15, "int": True}},
            n_iter=4, cv=3, seed=0)
        assert r2.best_score > 0.8

    def test_forest_group_batched(self):
        from bbbp.train.batched_search import batched_random_search

        x, y = self._data()
        r = batched_random_search(
            "xgb", x, y,
            {"n_estimators": [40], "max_depth": [3],
             "learning_rate": {"low": 0.05, "high": 0.3, "log": True}},
            n_iter=4, cv=3, seed=0)
        assert r.best_score > 0.85
        accs = [t["mean_accuracy"] for t in r.trials]
        assert len(set(round(a, 6) for a in accs)) > 1   # lr actually varies


class TestEarlyStopping:
    def test_patience_stops_and_restores_best(self):
        import jax.numpy as jnp
        from flax import linen as nn
        from bbbp.train.loop import train_cv

        class Tiny(nn.Module):
            @nn.compact
            def __call__(self, x, train: bool = False):
                h = nn.Dense(16)(x)
                h = nn.relu(h)
                return nn.Dense(1)(h)[..., 0]

        rng = np.random.default_rng(0)
        x = rng.normal(size=(200, 6)).astype(np.float32)
        y = (x[:, 0] * 2.0 + 0.05 * rng.normal(size=200)).astype(np.float32)
        res = train_cv(Tiny(), (x,), y, n_folds=3, epochs=40, batch_size=16,
                       lr=5e-3, patience=4, snapshot_from=None, seed=0)
        # must converge to a reasonable fit despite early stopping
        mse = float(np.mean((res.oof_pred - y) ** 2))
        assert mse < np.var(y) * 0.5

    def test_fold_affine_applies(self):
        from flax import linen as nn
        from bbbp.train.loop import train_cv

        class Linear1(nn.Module):
            @nn.compact
            def __call__(self, x, train: bool = False):
                return nn.Dense(1, use_bias=True)(x)[..., 0]

        rng = np.random.default_rng(0)
        x_raw = (rng.normal(size=(150, 4)) * 50 + 100).astype(np.float32)
        w = np.array([1.0, -2.0, 0.5, 0.0], np.float32)
        xs = (x_raw - x_raw.mean(0)) / x_raw.std(0)
        y = (xs @ w).astype(np.float32)
        k = 3
        aff = ((np.tile(x_raw.mean(0), (k, 1)).astype(np.float32),
                np.tile(1.0 / x_raw.std(0), (k, 1)).astype(np.float32)),)
        res = train_cv(Linear1(), (x_raw,), y, n_folds=k, epochs=60,
                       batch_size=25, lr=3e-2, seed=0, snapshot_from=None,
                       fold_affine=aff)
        mse = float(np.mean((res.oof_pred - y) ** 2))
        # unnormalized 100-scale inputs would not converge at this lr/epochs
        assert mse < np.var(y) * 0.2


class TestWideForest:
    def test_wide_feature_fit_and_next_program(self):
        """Regression test for the scatter-budget fault: a >2.1k-feature fit
        must leave the backend able to run more programs and fetch results."""
        import jax
        import jax.numpy as jnp
        from bbbp.ops.forest_device import DeviceGBDTRegressor

        rng = np.random.default_rng(0)
        x = rng.normal(size=(220, 2600)).astype(np.float32)
        y = (x[:, :4].sum(1)).astype(np.float32)
        m = DeviceGBDTRegressor(n_estimators=30, learning_rate=0.2, max_depth=4,
                             seed=0).fit(x, y)
        p = m.predict(x)
        assert 1 - np.mean((p - y) ** 2) / np.var(y) > 0.7
        assert float(jnp.sum(jnp.ones((64, 64)))) == 4096.0

    def test_launch_split_matches_single_launch(self):
        """Multi-launch boosting must equal one launch (same keys per chunk
        aren't required — but the ensemble quality must hold)."""
        import bbbp.ops.forest_device as ft

        rng = np.random.default_rng(1)
        x = rng.normal(size=(200, 16)).astype(np.float32)
        y = (x[:, 0] - x[:, 1]).astype(np.float32)
        old = ft.SCATTER_SEGMENT_BUDGET
        try:
            ft.SCATTER_SEGMENT_BUDGET = ft._tree_scan_segments(200, 16, 4) * 10
            m = ft.DeviceGBDTRegressor(n_estimators=35, learning_rate=0.2,
                                    max_depth=4, seed=0).fit(x, y)
            assert m.ensemble_.feat.shape[0] == 35   # all trees present
            p = m.predict(x)
            assert 1 - np.mean((p - y) ** 2) / np.var(y) > 0.9
        finally:
            ft.SCATTER_SEGMENT_BUDGET = old


class TestBertPretrain:
    def test_mlm_pretrain_finetune_roundtrip(self, tmp_path):
        from bbbp.models.bert import BertClassifier
        from bbbp.train.bert_pretrain import MLMPretrainConfig, pretrain

        corpus = ["CCO", "CCN", "c1ccccc1", "CC(=O)O", "CCOC", "CCCl",
                  "c1ccncc1", "CCS", "CC(C)O", "C1CCCCC1"] * 20
        out = pretrain(MLMPretrainConfig(
            corpus_size=0, include_b3db=False, epochs=2, batch_size=16,
            n_layers=1, d_model=32, n_heads=2, max_len=24,
            out_dir=str(tmp_path / "pre")), corpus=corpus, verbose=False)
        smiles = ["CCO", "CCN", "c1ccccc1", "CC(=O)O", "CCCl", "CCS"] * 10
        y = np.array([0, 0, 1, 0, 1, 1] * 10)
        clf = BertClassifier(epochs=2, batch_size=8, d_model=64,
                             pretrained_dir=out).fit(smiles, y)
        # architecture adopted from the pretrained config, not the ctor arg
        assert clf.d_model == 32
        assert clf.predict(smiles).shape == (60,)
        # tokenizer came from the pretrained dir (MASK present)
        assert "[MASK]" in clf.tokenizer.vocab


class TestMeshScreen:
    def test_sharded_matches_unsharded(self, tmp_path):
        import jax
        from jax.sharding import Mesh
        from bbbp.pipelines.screen import ScreeningModel, screen

        rng = np.random.default_rng(0)
        smiles_pool = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "CCN",
                       "C1CCCCC1", "c1ccncc1", "CCOC(=O)C", "CC(C)(C)O"]
        train_smiles = [smiles_pool[i % len(smiles_pool)] for i in range(64)]
        labels = np.array([i % 2 for i in range(64)])
        model = ScreeningModel.train(train_smiles, labels, pca_dim=8,
                                     n_estimators=20, workers=1)
        stream = [(s, f"M{i}") for i, s in
                  enumerate(smiles_pool * 16)]           # 128 molecules
        mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("data",))
        out1 = str(tmp_path / "plain.csv")
        out2 = str(tmp_path / "mesh.csv")
        screen(model, iter(stream), out_csv=out1, chunk_size=32, workers=1)
        screen(model, iter(stream), out_csv=out2, chunk_size=32, workers=1,
               mesh=mesh)
        assert open(out1).read() == open(out2).read()

    def test_device_fn_actually_shards(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from bbbp.pipelines.screen import ScreeningModel, _make_device_fn

        model = ScreeningModel.train(["CCO", "CCN", "c1ccccc1", "CCS"] * 8,
                                     np.array([0, 1, 0, 1] * 8), pca_dim=4,
                                     n_estimators=10, workers=1)
        mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("data",))
        run = _make_device_fn(model, mesh)
        x = jnp.zeros((64, model.n_bits), jnp.float32)
        xs = jax.device_put(x, NamedSharding(mesh, P("data")))
        out = run(xs)
        assert not out.sharding.is_fully_replicated
        assert len(out.sharding.device_set) == 8


class TestKernelShap:
    def test_linear_model_recovers_exact_shapley(self):
        """For f(x)=w·x the Shapley values are w_i (x_i - E[bg_i]) exactly."""
        from bbbp.reporting.attribution import kernel_shap

        rng = np.random.default_rng(0)
        d = 6
        w = rng.normal(size=d).astype(np.float32)
        bg = rng.normal(size=(50, d)).astype(np.float32)
        x = rng.normal(size=(4, d)).astype(np.float32)
        phi = kernel_shap(lambda a: np.asarray(a) @ w, x, bg,
                          n_samples=400, n_background=50, seed=1)
        expected = w[None, :] * (x - bg.mean(0)[None, :])
        assert np.allclose(phi, expected, atol=0.08), (
            np.abs(phi - expected).max())

    def test_dependence_plot_writes(self, tmp_path):
        from bbbp.reporting.plots import shap_dependence_plot

        rng = np.random.default_rng(0)
        x = rng.normal(size=(80, 5)).astype(np.float32)
        sv = x * 0.3 + 0.05 * rng.normal(size=(80, 5)).astype(np.float32)
        p = shap_dependence_plot(sv, x, 2, str(tmp_path / "dep.png"))
        import os
        assert os.path.exists(p)
