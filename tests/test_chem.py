"""Chemistry-core tests: parser semantics, fingerprint invariance, depiction.

Golden expectations derive from standard SMILES semantics (the reference gets
these from RDKit; see SURVEY.md §2.2) — not from RDKit bit layouts, which are
not reproducible without RDKit in the image.
"""

import numpy as np
import pytest

from bbbp.chem import (
    MolFromSmiles,
    morgan_fingerprint,
    maccs_fingerprint,
    path_fingerprint,
)
from bbbp.chem.fingerprints import morgan_bits, path_bits
from bbbp.chem.smiles import mol_from_smiles_strict


class TestParser:
    def test_ethanol_implicit_h(self):
        m = mol_from_smiles_strict("CCO")
        assert [m.total_h(i) for i in range(3)] == [3, 2, 1]

    def test_benzene_aromatic_perception(self):
        kekule = mol_from_smiles_strict("C1=CC=CC=C1")
        assert all(a.aromatic for a in kekule.atoms)
        assert [kekule.total_h(i) for i in range(6)] == [1] * 6

    def test_charges(self):
        m = mol_from_smiles_strict("[NH4+].[Cl-]")
        assert m.atoms[0].charge == 1 and m.atoms[0].n_h == 4
        assert m.atoms[1].charge == -1
        m2 = mol_from_smiles_strict("[O-]C(=O)C")
        assert m2.atoms[0].charge == -1

    def test_multi_digit_charge_and_isotope(self):
        m = mol_from_smiles_strict("[13CH4]")
        assert m.atoms[0].isotope == 13 and m.atoms[0].n_h == 4
        m = mol_from_smiles_strict("[Fe+3]")
        assert m.atoms[0].charge == 3
        m = mol_from_smiles_strict("[O--]")
        assert m.atoms[0].charge == -2

    def test_ring_closures(self):
        m = mol_from_smiles_strict("C1CC1")
        assert m.num_bonds == 3 and len(m.rings) == 1
        m = mol_from_smiles_strict("C%10CC%10")
        assert m.num_bonds == 3

    def test_stereo_markers_parse(self):
        m = mol_from_smiles_strict(r"C/C=C\C")
        assert m.num_atoms == 4
        m = mol_from_smiles_strict("N[C@@H](C)C(=O)O")  # alanine
        assert m.atoms[1].chirality == 2

    def test_fused_rings(self):
        naphthalene = mol_from_smiles_strict("c1ccc2ccccc2c1")
        assert len(naphthalene.rings) == 2
        assert all(a.aromatic for a in naphthalene.atoms)

    def test_nitro_pentavalent_n(self):
        m = mol_from_smiles_strict("C[N+](=O)[O-]")
        assert m.num_atoms == 4
        m2 = mol_from_smiles_strict("CN(=O)=O")  # pentavalent form
        assert m2.atoms[1].n_h == 0

    def test_invalid_smiles_return_none(self):
        assert MolFromSmiles("") is None
        assert MolFromSmiles("C1CC") is None           # unclosed ring
        assert MolFromSmiles("C(C") is None            # unclosed branch
        assert MolFromSmiles("[Qz]") is None           # unknown element
        assert MolFromSmiles("%%") is None

    def test_b3db_full_parse_coverage(self, b3db):
        from bbbp.data import load_b3db_regression, load_b3db_classification

        reg = load_b3db_regression()
        cls = load_b3db_classification()
        fails = [s for s in reg.smiles + cls.smiles if MolFromSmiles(s) is None]
        assert len(fails) == 0, f"{len(fails)} B3DB SMILES failed: {fails[:5]}"


class TestFingerprints:
    def test_kekule_aromatic_equivalence(self):
        pairs = [
            ("c1ccccc1", "C1=CC=CC=C1"),
            ("c1ccncc1", "C1=CC=NC=C1"),
            ("Cc1ccccc1", "CC1=CC=CC=C1"),
        ]
        for arom, kek in pairs:
            m1, m2 = MolFromSmiles(arom), MolFromSmiles(kek)
            assert morgan_bits(m1) == morgan_bits(m2), (arom, kek)

    def test_atom_order_invariance(self):
        t1, t2 = MolFromSmiles("Cc1ccccc1"), MolFromSmiles("c1ccccc1C")
        assert morgan_bits(t1) == morgan_bits(t2)
        assert path_bits(t1) == path_bits(t2)
        assert np.array_equal(
            maccs_fingerprint(t1), maccs_fingerprint(t2)
        )

    def test_different_molecules_differ(self):
        a = morgan_fingerprint(MolFromSmiles("CCO"))
        b = morgan_fingerprint(MolFromSmiles("CCN"))
        assert not np.array_equal(a, b)

    def test_shapes_and_dtypes(self):
        m = MolFromSmiles("CC(=O)Oc1ccccc1C(=O)O")
        assert morgan_fingerprint(m).shape == (2048,)
        assert maccs_fingerprint(m).shape == (167,)
        assert path_fingerprint(m).shape == (2048,)
        assert morgan_fingerprint(m).dtype == np.float32

    def test_maccs_bit0_unused(self):
        m = MolFromSmiles("CC(=O)Oc1ccccc1C(=O)O")
        assert maccs_fingerprint(m)[0] == 0.0

    def test_morgan_radius_monotone(self):
        m = MolFromSmiles("CC(=O)Oc1ccccc1C(=O)O")
        b0 = len(morgan_bits(m, radius=0))
        b2 = len(morgan_bits(m, radius=2))
        assert b2 > b0

    def test_substructure_shared_bits(self):
        # molecules sharing a phenyl should share radius<=1 bits
        b1 = morgan_bits(MolFromSmiles("c1ccccc1CCO"), radius=1)
        b2 = morgan_bits(MolFromSmiles("c1ccccc1CCN"), radius=1)
        assert len(b1 & b2) > 3


class TestDepiction:
    def test_image_shape_and_range(self):
        from bbbp.chem.depict import depict

        img = depict("CC(=O)Oc1ccccc1C(=O)O", size=128)
        assert img.shape == (128, 128, 3)
        assert img.min() >= 0.0 and img.max() <= 1.0
        # a drawn molecule must not be blank
        assert (img < 0.95).sum() > 50

    def test_deterministic(self):
        from bbbp.chem.depict import depict

        a = depict("c1ccccc1O", size=64)
        b = depict("c1ccccc1O", size=64)
        assert np.array_equal(a, b)

    def test_heteroatom_coloring(self):
        from bbbp.chem.depict import depict

        img = depict("CCCCO", size=64)
        # oxygen disk adds red-dominant pixels
        red_dominant = (img[..., 0] > 0.8) & (img[..., 1] < 0.4) & (img[..., 2] < 0.4)
        assert red_dominant.sum() > 3


class TestBatchFeaturize:
    def test_quarantine_bad_smiles(self):
        from bbbp.chem.featurize import fingerprints

        res = fingerprints(["CCO", "NOT_A_SMILES(((", "c1ccccc1"], workers=1,
                           use_native=False)
        assert res.features.shape == (3, 2048)
        assert list(res.bad_indices) == [1]
        assert res.features[1].sum() == 0.0
        assert res.features[0].sum() > 0

    def test_parallel_matches_serial(self, b3db):
        from bbbp.chem.featurize import fingerprints
        from bbbp.data import load_b3db_regression

        smiles = load_b3db_regression().smiles[:64]
        a = fingerprints(smiles, workers=1, use_native=False).features
        b = fingerprints(smiles, workers=4, use_native=False).features
        assert np.array_equal(a, b)


class TestAtomPairs:
    def test_shape_and_invariance(self):
        from bbbp.chem.fingerprints import atom_pair_fingerprint, atom_pair_bits

        m1 = MolFromSmiles("Cc1ccccc1O")
        m2 = MolFromSmiles("Oc1ccccc1C")
        assert atom_pair_bits(m1) == atom_pair_bits(m2)
        fp = atom_pair_fingerprint(m1)
        assert fp.shape == (2048,) and fp.sum() > 5

    def test_distance_sensitivity(self):
        from bbbp.chem.fingerprints import atom_pair_bits

        # para vs ortho dichlorobenzene differ only in Cl-Cl topological distance
        para = MolFromSmiles("Clc1ccc(Cl)cc1")
        ortho = MolFromSmiles("Clc1ccccc1Cl")
        assert atom_pair_bits(para) != atom_pair_bits(ortho)

    def test_single_atom(self):
        from bbbp.chem.fingerprints import atom_pair_fingerprint

        assert atom_pair_fingerprint(MolFromSmiles("C")).sum() == 0
