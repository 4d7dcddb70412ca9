"""Descriptor, graph-featurizer, learning-curve, and profiling tests."""

import numpy as np
import pytest


class TestDescriptors:
    def test_known_values(self):
        from bbbp.chem.descriptors import compute_descriptors, DESCRIPTOR_NAMES
        from bbbp.chem.smiles import MolFromSmiles

        d = dict(zip(DESCRIPTOR_NAMES,
                     compute_descriptors(MolFromSmiles("CC(=O)Oc1ccccc1C(=O)O"))))
        assert abs(d["mw"] - 180.16) < 0.5          # aspirin MW
        assert d["heavy_atoms"] == 13
        assert d["n_rings"] == 1 and d["n_aromatic_rings"] == 1
        assert d["hbd"] == 1                        # COOH
        assert d["hba"] == 4
        assert 55 < d["tpsa"] < 75                  # aspirin TPSA = 63.6
        assert d["rotatable_bonds"] == 2 or d["rotatable_bonds"] == 3

    def test_ethanol(self):
        from bbbp.chem.descriptors import compute_descriptors, DESCRIPTOR_NAMES
        from bbbp.chem.smiles import MolFromSmiles

        d = dict(zip(DESCRIPTOR_NAMES, compute_descriptors(MolFromSmiles("CCO"))))
        assert abs(d["mw"] - 46.07) < 0.2
        assert d["tpsa"] == pytest.approx(20.23, abs=0.1)
        assert d["hbd"] == 1 and d["hba"] == 1

    def test_batch_quarantine(self):
        from bbbp.chem.descriptors import descriptor_matrix, N_DESCRIPTORS

        X, bad = descriptor_matrix(["CCO", "((bad", "c1ccccc1"])
        assert X.shape == (3, N_DESCRIPTORS)
        assert bad == [1]
        assert X[1].sum() == 0

    def test_lipophilicity_ordering(self):
        from bbbp.chem.descriptors import compute_descriptors, DESCRIPTOR_NAMES
        from bbbp.chem.smiles import MolFromSmiles

        i = DESCRIPTOR_NAMES.index("logp")
        hexane = compute_descriptors(MolFromSmiles("CCCCCC"))[i]
        glycerol = compute_descriptors(MolFromSmiles("OCC(O)CO"))[i]
        assert hexane > glycerol


class TestGraphFeatures:
    def test_shapes_and_adjacency(self):
        from bbbp.chem.graph_features import graph_features, N_ATOM_FEATURES

        feats, adj, mask, bad = graph_features(["CCO", "c1ccccc1"], max_atoms=16)
        assert feats.shape == (2, 16, N_ATOM_FEATURES)
        assert adj.shape == (2, 16, 16)
        assert mask[0].sum() == 3 and mask[1].sum() == 6
        # ethanol adjacency: C-C, C-O + self loops
        assert adj[0, 0, 1] == 1 and adj[0, 1, 2] == 1 and adj[0, 0, 2] == 0
        assert adj[0, 0, 0] == 1
        assert bad == []

    def test_onehots_valid(self):
        from bbbp.chem.graph_features import graph_features

        feats, _, mask, _ = graph_features(["CC(=O)Oc1ccccc1C(=O)O"], max_atoms=32)
        active = feats[0][mask[0] > 0]
        # element one-hot sums to 1 per atom
        assert np.allclose(active[:, :13].sum(1), 1.0)


class TestLearningCurve:
    def test_curve_shapes_and_trend(self, tmp_path):
        from bbbp.ops.linear import LogisticRegression
        from bbbp.train.learning_curve import learning_curve, save_learning_scores_csv

        rng = np.random.default_rng(0)
        x = rng.standard_normal((300, 5)).astype(np.float32)
        y = (x[:, 0] > 0).astype(int)
        sizes, tr, va = learning_curve(LogisticRegression, x, y,
                                       train_sizes=(0.2, 1.0), cv=3)
        assert tr.shape == (2, 3) and va.shape == (2, 3)
        assert va[1].mean() > 0.8
        p = str(tmp_path / "scores.csv")
        save_learning_scores_csv(p, sizes, tr, va)
        assert open(p).read().count("\n") == 3


class TestProfiling:
    def test_step_timer(self, tmp_path):
        import jax.numpy as jnp
        from bbbp.utils.profiling import StepTimer, debug_nans

        t = StepTimer(str(tmp_path / "steps.jsonl"))
        with t.step("host_work"):
            _ = sum(range(1000))
        out = t.timed("device_work", lambda x: jnp.sum(x * 2), jnp.ones(128))
        assert float(out) == 256.0
        assert set(t.summary()) == {"host_work", "device_work"}
        with debug_nans(False):
            pass

    def test_weighted_ensemble_metric(self):
        from bbbp.train.weighted_ensemble import rounding_accuracy

        y = np.array([0.123, 0.456])
        assert rounding_accuracy(y, y + 0.001) == 1.0   # same at 2 decimals
        assert rounding_accuracy(y, y + 0.01) == 0.0    # shifted off
