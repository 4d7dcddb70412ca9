"""Cross-task transfer features (train.transfer) + Tanimoto kernel ridge."""

import numpy as np

from bbbp.train.transfer import (TransferConfig, _auc,
                                 transfer_features)


def _aux(n_rep=4):
    # polar (BBB-, label by construction here 1) vs apolar molecules
    s = ["CCO", "CCN", "CCC", "CCCC", "CCOC", "CC(=O)O", "c1ccccc1",
         "c1ccccc1C", "CCCCO", "NCCN", "OCCO", "CCCCC", "c1ccncc1",
         "CC(C)C", "CCS", "CCCl"] * n_rep
    y = np.array([1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 1, 0, 0, 0] * n_rep,
                 np.float32)
    return s, y


class TestTransferFeatures:
    def test_auc_rank_statistic(self):
        y = np.array([0, 0, 1, 1])
        s = np.array([0.1, 0.4, 0.35, 0.8])
        assert abs(_auc(y, s) - 0.75) < 1e-9
        # ties averaged
        assert abs(_auc(np.array([0, 1]), np.array([0.5, 0.5])) - 0.5) < 1e-9

    def test_features_learn_polarity_and_shapes(self):
        s, y = _aux()
        cfg = TransferConfig(models=("gbdt", "tknn"), trees=24, depth=3,
                             morgan_pca_dim=8, holdout_frac=0.2, tknn_k=5)
        res = transfer_features(["CCO", "NCCO", "CCCC", "CCCCCC"], cfg,
                                aux_data=(s, y), verbose=False)
        assert res.features.shape == (4, 2)
        assert res.names == ["transfer_gbdt", "transfer_tknn"]
        assert set(res.holdout_auc) == {"gbdt", "tknn"}
        # polar queries score higher P(label=1) than apolar ones
        assert res.features[:2].mean() > res.features[2:].mean()
        assert np.all(res.features >= 0) and np.all(res.features <= 1)

    def test_cache_roundtrip(self, tmp_path):
        s, y = _aux(2)
        cfg = TransferConfig(models=("tknn",), morgan_pca_dim=4,
                             holdout_frac=0.0, tknn_k=3,
                             cache_dir=str(tmp_path))
        q = ["CCO", "CCCC"]
        r1 = transfer_features(q, cfg, aux_data=(s, y), verbose=False)
        # poison the aux labels: a cache hit must ignore them
        r2 = transfer_features(q, cfg, aux_data=(s, 1 - y), verbose=False)
        np.testing.assert_array_equal(r1.features, r2.features)

    def test_aux_exclusion_drops_regression_rows(self, b3db):
        from bbbp.data.b3db import (load_b3db_classification,
                                    load_b3db_regression)
        from bbbp.train.transfer import aux_classification_set

        smiles, labels, n_excl = aux_classification_set()
        n_cls = len(load_b3db_classification().smiles)
        n_reg = len(load_b3db_regression().smiles)
        # every regression molecule that appears in the classification set
        # must be gone; B3DB derives ~one classification row per regression
        # row, so the exclusion count is at least ~95% of the regression set
        assert n_excl >= int(0.95 * n_reg)
        assert len(smiles) == n_cls - n_excl
        assert len(labels) == len(smiles)


class TestTanimotoKernelRidge:
    def test_interpolates_cluster_targets(self):
        from bbbp.ops.similarity import TanimotoKernelRidge

        rng = np.random.default_rng(1)
        a = (rng.random((40, 32)) < 0.5).astype(np.float32)
        a[:, :16] = 0.0
        b = (rng.random((40, 32)) < 0.5).astype(np.float32)
        b[:, 16:] = 0.0
        x = np.concatenate([a, b])
        y = np.concatenate([np.full(40, 1.0), np.full(40, -1.0)]).astype(
            np.float32)
        m = TanimotoKernelRidge(0.05).fit(x, y)
        pred = m.predict(np.concatenate([a[:5], b[:5]]))
        assert np.all(pred[:5] > 0.5) and np.all(pred[5:] < -0.5)

    def test_matches_numpy_closed_form(self):
        from bbbp.ops.similarity import TanimotoKernelRidge

        rng = np.random.default_rng(2)
        x = (rng.random((30, 24)) < 0.4).astype(np.float32)
        y = rng.standard_normal(30).astype(np.float32)
        lam = 0.3
        inter = x @ x.T
        union = x.sum(1)[:, None] + x.sum(1)[None] - inter
        K = inter / np.maximum(union, 1e-9)
        alpha = np.linalg.solve(K + lam * np.eye(30), y - y.mean())
        ref = K @ alpha + y.mean()
        got = TanimotoKernelRidge(lam).fit(x, y).predict(x)
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


class TestChemKernelRidge:
    def test_minmax_matches_numpy(self):
        from bbbp.ops.similarity import minmax_matrix

        rng = np.random.default_rng(0)
        a = rng.integers(0, 6, (20, 40)).astype(np.float32)
        b = rng.integers(0, 6, (15, 40)).astype(np.float32)
        got = np.asarray(minmax_matrix(a, b, 16))
        for i in (0, 7, 19):
            for j in (0, 5, 14):
                ref = (np.minimum(a[i], b[j]).sum()
                       / np.maximum(a[i], b[j]).sum())
                assert abs(got[i, j] - ref) < 1e-5

    def test_minmax_clips_consistently(self):
        from bbbp.ops.similarity import minmax_matrix

        a = np.array([[40.0, 1.0]])
        b = np.array([[40.0, 1.0]])
        # identical rows => similarity 1 even with counts above the clip
        assert abs(float(minmax_matrix(a, b, 8)[0, 0]) - 1.0) < 1e-6

    def test_weighted_kernels_match_numpy(self):
        from bbbp.ops.similarity import (minmax_matrix_w,
                                         tanimoto_matrix_w)

        rng = np.random.default_rng(3)
        a = (rng.random((12, 30)) < 0.3).astype(np.float32)
        b = (rng.random((9, 30)) < 0.3).astype(np.float32)
        w = rng.uniform(0.1, 3.0, 30).astype(np.float32)
        got = np.asarray(tanimoto_matrix_w(a, b, w))
        for i in (0, 11):
            for j in (0, 8):
                num = (w * a[i] * b[j]).sum()
                den = (w * a[i]).sum() + (w * b[j]).sum() - num
                assert abs(got[i, j] - num / max(den, 1e-9)) < 1e-5
        ca = rng.integers(0, 6, (10, 30)).astype(np.float32)
        cb = rng.integers(0, 6, (8, 30)).astype(np.float32)
        got = np.asarray(minmax_matrix_w(ca, cb, w, 16))
        for i in (0, 9):
            for j in (0, 7):
                num = (w * np.minimum(ca[i], cb[j])).sum()
                den = (w * np.maximum(ca[i], cb[j])).sum()
                assert abs(got[i, j] - num / den) < 1e-5
        # unit weights reproduce the unweighted kernels
        from bbbp.ops.similarity import minmax_matrix, tanimoto_matrix
        ones = np.ones(30, np.float32)
        np.testing.assert_allclose(np.asarray(tanimoto_matrix_w(a, b, ones)),
                                   np.asarray(tanimoto_matrix(a, b)),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(minmax_matrix_w(ca, cb, ones)),
                                   np.asarray(minmax_matrix(ca, cb)),
                                   atol=1e-6)

    def test_idf_weighted_ckrr_runs(self):
        from bbbp.ops.similarity import ChemKernelRidge

        rng = np.random.default_rng(5)
        maccs = (rng.random((60, 40)) < 0.25).astype(np.float32)
        counts = rng.integers(0, 5, (60, 50)).astype(np.float32)
        desc = rng.normal(size=(60, 8)).astype(np.float32)
        y = (desc[:, 0] + counts[:, :3].sum(1) * 0.1).astype(np.float32)
        bw = ChemKernelRidge.idf_weights(maccs, counts)
        assert bw[0].shape == (40,) and bw[1].shape == (50,)
        assert np.all(bw[0] >= 0) and np.all(np.isfinite(bw[1]))
        m = ChemKernelRidge(0.06, bit_weights=bw).fit(
            maccs[:45], counts[:45], desc[:45], y[:45])
        pred = m.predict(maccs[45:], counts[45:], desc[45:])
        assert pred.shape == (15,) and np.all(np.isfinite(pred))
        g = ChemKernelRidge(0.06, bit_weights=bw).full_gram(
            maccs, counts, desc)
        assert g.shape == (60, 60) and np.all(np.isfinite(g))
        np.testing.assert_allclose(g, g.T, atol=1e-5)

    def test_combined_kernel_ridge_predicts(self):
        from bbbp.ops.similarity import ChemKernelRidge

        rng = np.random.default_rng(1)
        maccs = (rng.random((80, 50)) < 0.3).astype(np.float32)
        counts = rng.integers(0, 5, (80, 64)).astype(np.float32)
        desc = rng.normal(size=(80, 10)).astype(np.float32)
        y = (desc[:, 0] + counts[:, :3].sum(1) * 0.1).astype(np.float32)
        m = ChemKernelRidge(0.06).fit(maccs[:60], counts[:60], desc[:60],
                                      y[:60])
        pred = m.predict(maccs[60:], counts[60:], desc[60:])
        assert np.corrcoef(pred, y[60:])[0, 1] > 0.7


class TestAuxPretrain:
    def test_drop_output_dense(self):
        from bbbp.train.aux_pretrain import drop_output_dense

        p = {"Dense_0": 1, "Dense_2": 2, "Dense_10": 3, "LayerNorm_0": 4,
             "enc0": {"Dense_5": 5}}
        out = drop_output_dense(p)
        assert "Dense_10" not in out and "Dense_2" in out
        assert out["enc0"] == {"Dense_5": 5}      # only top level considered

    def test_mpnn_pretrain_and_warm_start(self, tmp_path, monkeypatch):
        import bbbp.train.aux_pretrain as ap
        from bbbp.train.aux_pretrain import (AuxPretrainConfig,
                                             load_warm_start,
                                             pretrain_aux)

        aux_s = ["CCO", "CCN", "CCC", "CCCC", "CCOC", "CC(=O)O", "c1ccccc1",
                 "c1ccccc1C", "CCCCO", "NCCN", "OCCO", "CCCCC"] * 6
        aux_y = np.array([1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0] * 6, np.float32)
        monkeypatch.setattr(ap, "aux_classification_set",
                            lambda verbose=False: (aux_s, aux_y, 0))
        cfg = AuxPretrainConfig(kind="graph", epochs=3, batch_size=16,
                                max_atoms=16, graph_hidden=8, graph_layers=2,
                                cache_dir=str(tmp_path))
        path = pretrain_aux(cfg, verbose=False)
        params, auc = load_warm_start(path)
        assert 0.0 <= auc <= 1.0
        # output head dropped; trunk layers present
        import re
        dense = sorted(int(re.match(r"Dense_(\d+)", k).group(1))
                       for k in params if k.startswith("Dense_"))
        assert dense, "trunk Dense layers expected"
        # warm-starting the regression fold trainer must accept the pytree
        from bbbp.chem.graph_features import graph_features
        from bbbp.models.gnn import MPNNRegressor
        from bbbp.train.loop import train_cv

        feats, _, adj_t, mask, _ = graph_features(aux_s[:24], max_atoms=16,
                                                  edge_types=True)
        yv = np.linspace(-1, 1, 24).astype(np.float32)
        res = train_cv(MPNNRegressor(hidden=8, n_layers=2),
                       (feats, adj_t, mask), yv, n_folds=2, epochs=1,
                       batch_size=8, warm_start=params)
        assert res.oof_pred.shape == (24,)
