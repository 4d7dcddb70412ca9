"""Curation + standardization tests (D4-D10 equivalents)."""

import numpy as np
import pandas as pd
import pytest


class TestStandardize:
    def test_salt_stripping(self):
        from bbbp.chem.standardize import standardize_smiles

        out = standardize_smiles("CC(=O)O.[Na+]")
        # sodium dropped, acid kept (neutral already)
        assert out is not None and "Na" not in out
        assert "C" in out

    def test_neutralize_ammonium(self):
        from bbbp.chem.standardize import standardize_smiles
        from bbbp.chem.smiles import MolFromSmiles

        out = standardize_smiles("CC[NH3+].[Cl-]")
        m = MolFromSmiles(out)
        assert all(a.charge == 0 for a in m.atoms)
        n = next(a for a in m.atoms if a.z == 7)
        assert m.total_h(n.idx) == 2  # ethylamine NH2

    def test_neutralize_carboxylate(self):
        from bbbp.chem.standardize import standardize_smiles
        from bbbp.chem.smiles import MolFromSmiles

        out = standardize_smiles("CC(=O)[O-].[Na+]")
        m = MolFromSmiles(out)
        assert all(a.charge == 0 for a in m.atoms)

    def test_restricted_atoms_rejected(self):
        from bbbp.chem.standardize import standardize_smiles

        assert standardize_smiles("CC[Hg]CC") is None
        assert standardize_smiles("c1ccccc1") is not None

    def test_quaternary_n_kept_charged(self):
        from bbbp.chem.standardize import standardize_smiles
        from bbbp.chem.smiles import MolFromSmiles

        out = standardize_smiles("C[N+](C)(C)C.[Cl-]")
        m = MolFromSmiles(out)
        n = next(a for a in m.atoms if a.z == 7)
        assert n.charge == 1  # no H to remove; stays quaternary


class TestCuration:
    def test_combine_and_split(self):
        from bbbp.data.curation import combine_tables, split_regression_classification

        t1 = pd.DataFrame({"SMILES": ["CCO", "c1ccccc1"], "logBB": [0.1, None],
                           "BBB+/BBB-": [None, "BBB+"]})
        t2 = pd.DataFrame({"SMILES": ["OCC", "bad(((", None],
                           "logBB": [0.2, 1.0, 3.0],
                           "BBB+/BBB-": [None, None, None]})
        df = combine_tables([t1, t2])
        assert len(df) == 3  # bad and None dropped
        # CCO and OCC share a canonical key
        assert df["canonical_smiles"].nunique() == 2
        reg, cls = split_regression_classification(df)
        assert len(reg) == 2 and len(cls) == 1

    def test_regression_reconciliation_groups(self):
        from bbbp.data.curation import reconcile_regression_labels

        df = pd.DataFrame({
            "canonical_smiles": ["a", "b", "b", "c", "c", "d", "d"],
            "logBB": [0.5, 0.1, 0.2, 0.0, 0.9, 0.0, 2.0],
        })
        out = reconcile_regression_labels(df, tolerance=0.3, max_range=1.0)
        got = {r.canonical_smiles: (round(r.logBB, 3), r.group)
               for r in out.itertuples()}
        assert got["a"] == (0.5, "A")
        assert got["b"] == (pytest.approx(0.15, abs=1e-6), "B")
        assert got["c"] == (0.45, "C")
        assert "d" not in got  # range 2.0 > 1.0 → dropped

    def test_classification_voting(self):
        from bbbp.data.curation import reconcile_classification_labels

        df = pd.DataFrame({
            "canonical_smiles": ["a", "a", "b", "b", "b", "c", "c"],
            "BBB+/BBB-": ["BBB+", "BBB+", "BBB+", "BBB-", "BBB+", "BBB+", "BBB-"],
        })
        out = reconcile_classification_labels(df)
        got = {r.canonical_smiles: (r._2, r.group) for r in out.itertuples()}
        assert got["a"] == ("BBB+", "A")
        assert got["b"] == ("BBB+", "B")
        assert "c" not in got  # tie → dropped

    def test_pubchem_urls(self):
        from bbbp.data.curation import PubChemClient

        c = PubChemClient()
        assert "compound/name/aspirin/cids" in c.url_name_to_cid("aspirin")
        assert "/compound/cid/2244/property/" in c.url_cid_to_smiles(2244)
        assert "compound/smiles/" in c.url_smiles_to_cid("CCO")


class TestHighlights:
    def test_three_renderings(self, tmp_path):
        from bbbp.chem.highlight import draw_fingerprint_highlights

        imgs = draw_fingerprint_highlights("CC(=O)Oc1ccccc1C(=O)O", size=96)
        assert set(imgs) == {"morgan", "structural", "rings"}
        for arr in imgs.values():
            assert arr.shape == (96, 96, 3)
        # ring highlight must add red-ish pixels vs base structural difference
        assert not np.array_equal(imgs["rings"], imgs["morgan"])


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        import jax.numpy as jnp
        from bbbp.utils.checkpoint import save_checkpoint, restore_checkpoint, latest_step

        state = {"params": {"w": jnp.ones((3, 3)), "b": jnp.zeros(3)},
                 "step": jnp.asarray(7)}
        p = save_checkpoint(str(tmp_path / "ckpt"), state, step=7)
        back = restore_checkpoint(p)
        np.testing.assert_allclose(np.asarray(back["params"]["w"]), 1.0)
        assert int(back["step"]) == 7
        assert latest_step(str(tmp_path / "ckpt")) == 7
