"""Packed-bit ops and ZINC data-layer tests."""

import os

import numpy as np
import pytest

rng = np.random.default_rng(9)


class TestBitops:
    def test_pack_unpack_roundtrip(self):
        import jax.numpy as jnp
        from bbbp.ops.bitops import pack_bits, unpack_bits_jnp

        dense = (rng.random((50, 2048)) < 0.05).astype(np.float32)
        packed = pack_bits(dense)
        assert packed.shape == (50, 64) and packed.dtype == np.uint32
        back = np.asarray(unpack_bits_jnp(jnp.asarray(packed), 2048))
        assert np.array_equal(back, dense)

    def test_projection_matches_dense_pipeline(self):
        import jax.numpy as jnp
        from bbbp.ops.bitops import pack_bits, packed_project, project_weights

        dense = (rng.random((40, 256)) < 0.1).astype(np.float32)
        sm = rng.random(256).astype(np.float32)
        ss = rng.random(256).astype(np.float32) + 0.5
        pm = rng.random(256).astype(np.float32)
        C = rng.standard_normal((8, 256)).astype(np.float32)
        w, c0 = project_weights(sm, ss, pm, C)
        ref = ((dense - sm) / ss - pm) @ C.T
        out = np.asarray(packed_project(jnp.asarray(pack_bits(dense)),
                                        jnp.asarray(w), jnp.asarray(c0)))
        np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)

    def test_projection_at_screening_width_matches_dense_highest(self):
        """2048 bits → 30 PCA scores, the shipped screening shape, against
        the dense f32 product at HIGHEST precision."""
        import jax
        import jax.numpy as jnp
        from bbbp.ops.bitops import pack_bits, packed_project

        dense = (rng.random((300, 2048)) < 0.03).astype(np.float32)
        w = (rng.standard_normal((2048, 30)) / 8).astype(np.float32)
        c0 = rng.standard_normal(30).astype(np.float32)
        ref = np.asarray(jnp.matmul(jnp.asarray(dense), jnp.asarray(w),
                                    precision=jax.lax.Precision.HIGHEST)
                         + c0)
        out = np.asarray(packed_project(jnp.asarray(pack_bits(dense)),
                                        jnp.asarray(w), jnp.asarray(c0)))
        assert out.shape == (300, 30)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)

    def test_native_packed_matches_dense(self):
        from bbbp.native import bindings as nb
        from bbbp.ops.bitops import pack_bits

        if not nb.available():
            pytest.skip("native lib not built")
        smiles = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "BAD((("]
        dense, bad_d = nb.fingerprints(smiles, "morgan")
        packed, bad_p = nb.fingerprints_packed(smiles, "morgan")
        assert bad_d == bad_p == [3]
        assert np.array_equal(packed, pack_bits(dense))


class TestZinc:
    def test_smi_file_and_dir(self, tmp_path):
        from bbbp.data.zinc import iter_smi_file, iter_smi_dir, chunked

        p = tmp_path / "a.smi"
        p.write_text("smiles zinc_id\nCCO ZINC01\nc1ccccc1 ZINC02\n")
        rows = list(iter_smi_file(str(p)))
        assert rows == [("CCO", "ZINC01"), ("c1ccccc1", "ZINC02")]
        (tmp_path / "sub").mkdir()
        (tmp_path / "sub" / "b.smi").write_text("CCN ZINC03\n")
        allrows = list(iter_smi_dir(str(tmp_path)))
        assert len(allrows) == 3
        assert list(chunked(iter(range(5)), 2)) == [[0, 1], [2, 3], [4]]

    def test_wget_parser(self, tmp_path):
        from bbbp.data.zinc import parse_wget_list

        p = tmp_path / "dl.wget"
        p.write_text('wget http://files.docking.org/2D/FE/FEAA.smi -O FEAA.smi\n'
                     'wget "https://files.docking.org/2D/FE/FEAB.smi"\n')
        urls = parse_wget_list(str(p))
        assert len(urls) == 2 and urls[0].endswith("FEAA.smi")

    def test_zinc_url_construction(self):
        from bbbp.data.zinc import zinc_substance_url

        assert zinc_substance_url("ZINC000000001", "smi").endswith(
            "substances/ZINC000000001.smi")
        assert "ZINC000000000042" in zinc_substance_url("42")

    def test_synthetic_smiles_all_parse(self):
        from bbbp.data.zinc import synthetic_smiles
        from bbbp.chem.smiles import MolFromSmiles

        mols = synthetic_smiles(100, seed=3)
        assert len(mols) == 100
        assert all(MolFromSmiles(s) is not None for s in mols)


class TestNativeMaccs:
    def test_native_maccs_matches_python(self):
        from bbbp.native import bindings as nb
        from bbbp.chem.featurize import fingerprints

        if not nb.available():
            pytest.skip("native lib not built")
        smiles = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O",
                  "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "C[N+](C)(C)C.[Cl-]"]
        py = fingerprints(smiles, kind="maccs", workers=1,
                          use_native=False).features
        nat, bad = nb.fingerprints(smiles, "maccs")
        assert np.array_equal(py, nat) and bad == []


class TestNativePathFallback:
    def test_path_fp_large_molecule_fallback_matches_python(self):
        # Molecules with >=255 bonds take the allocating std::set dedup path
        # in path_bits_dfs (the packed-uint64 key only fits <255 bond
        # indices); both branches must stay bit-exact with the Python
        # reference implementation.
        from bbbp.native import bindings as nb
        from bbbp.chem.featurize import fingerprints

        if not nb.available():
            pytest.skip("native lib not built")
        big = "C" * 300              # 299 bonds: fallback branch
        ring = "C1" + "C" * 280 + "CCC1"  # macrocycle, also >255 bonds
        small = "CC(=O)Oc1ccccc1C(=O)O"   # packed branch, same batch
        smiles = [big, ring, small]
        py = fingerprints(smiles, kind="rdkit", workers=1,
                          use_native=False).features
        nat, bad = nb.fingerprints(smiles, "rdkit")
        assert bad == []
        assert np.array_equal(py, nat)
