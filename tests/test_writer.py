"""SMILES writer / canonicalization / kekulization tests."""

import numpy as np
import pytest

from bbbp.chem.smiles import MolFromSmiles
from bbbp.chem.writer import MolToSmiles, canonical_ranks
from bbbp.chem.fingerprints import morgan_bits


CASES = [
    "CCO", "c1ccccc1", "C1=CC=CC=C1", "CC(=O)Oc1ccccc1C(=O)O",
    "[NH4+].[Cl-]", "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "C1CC1",
    "N[C@@H](C)C(=O)O", "c1cc[nH]c1", "c1ccc2ccccc2c1", "O=c1cc[nH]c(=O)[nH]1",
    "c1ccncc1", "CC(C)(C)c1ccc(O)cc1", "C1=CC2=NC=CN2C=C1",
]


class TestRoundtrip:
    @pytest.mark.parametrize("smiles", CASES)
    def test_fingerprint_preserving(self, smiles):
        m = MolFromSmiles(smiles)
        out = MolToSmiles(m)
        m2 = MolFromSmiles(out)
        assert m2 is not None, out
        assert morgan_bits(m) == morgan_bits(m2), (smiles, out)

    def test_b3db_roundtrip_rate(self, b3db):
        from bbbp.data import load_b3db_regression

        smiles = load_b3db_regression().smiles
        fails = 0
        for s in smiles:
            m = MolFromSmiles(s)
            m2 = MolFromSmiles(MolToSmiles(m))
            if m2 is None or morgan_bits(m) != morgan_bits(m2):
                fails += 1
        assert fails / len(smiles) < 0.03, f"{fails}/{len(smiles)}"


class TestCanonical:
    def test_equivalent_forms_same_canonical(self):
        pairs = [
            ("c1ccccc1", "C1=CC=CC=C1"),
            ("Cc1ccccc1", "c1ccccc1C"),
            ("CCO", "OCC"),
            ("c1ccncc1", "C1=CC=NC=C1"),
            ("CC(=O)O", "OC(C)=O"),
        ]
        for a, b in pairs:
            ca = MolToSmiles(MolFromSmiles(a))
            cb = MolToSmiles(MolFromSmiles(b))
            assert ca == cb, (a, b, ca, cb)

    def test_fixed_point(self):
        for s in CASES:
            c1 = MolToSmiles(MolFromSmiles(s))
            c2 = MolToSmiles(MolFromSmiles(c1))
            assert c1 == c2, (s, c1, c2)

    def test_ranks_permutation_invariant(self):
        a = MolFromSmiles("CC(=O)Oc1ccccc1C(=O)O")
        b = MolFromSmiles("O=C(O)c1ccccc1OC(C)=O")
        ra = sorted(canonical_ranks(a))
        rb = sorted(canonical_ranks(b))
        assert ra == rb


class TestKekulize:
    def test_benzene(self):
        from bbbp.chem.kekulize import kekulize
        from bbbp.chem.mol import BOND_DOUBLE

        m = MolFromSmiles("c1ccccc1")
        kmap = kekulize(m)
        assert kmap is not None
        doubles = sum(1 for v in kmap.values() if v == BOND_DOUBLE)
        assert doubles == 3

    def test_pyrrole_no_double_on_nh(self):
        from bbbp.chem.kekulize import kekulize
        from bbbp.chem.mol import BOND_DOUBLE

        m = MolFromSmiles("c1cc[nH]c1")
        kmap = kekulize(m)
        assert kmap is not None
        n_idx = next(a.idx for a in m.atoms if a.z == 7)
        for bi in m.neighbors[n_idx]:
            if bi in kmap:
                assert kmap[bi] != BOND_DOUBLE

    def test_fused(self):
        from bbbp.chem.kekulize import kekulize
        from bbbp.chem.mol import BOND_DOUBLE

        m = MolFromSmiles("c1ccc2ccccc2c1")
        kmap = kekulize(m)
        assert kmap is not None
        assert sum(1 for v in kmap.values() if v == BOND_DOUBLE) == 5


class TestSanitization:
    def test_biaryl_single_not_aromatic(self):
        from bbbp.chem.mol import BOND_AROMATIC

        m = MolFromSmiles("c1ccccc1c1ccccc1")  # biphenyl without '-'
        non_ring_arom = [b for b in m.bonds
                         if b.order == BOND_AROMATIC and not b.in_ring]
        assert non_ring_arom == []

    def test_kekule_pyrrole_nh(self):
        m = MolFromSmiles("C1=CC=CN1")  # kekulé pyrrole
        n = next(a for a in m.atoms if a.z == 7)
        assert m.total_h(n.idx) == 1
        assert n.aromatic

    def test_fused_union_aromatization(self):
        # quinoxaline-style alt resonance: union must aromatize
        m = MolFromSmiles("C1=CC2=NC=CN2C=C1")
        assert m is not None
        m2 = MolFromSmiles(MolToSmiles(m))
        assert morgan_bits(m) == morgan_bits(m2)
