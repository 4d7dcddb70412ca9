"""chip_smoke.py phases at tiny sizes on the CPU backend, plus its refusal to
run without a GPU. The full-size run needs the card: ``python chip_smoke.py``."""

import csv

import jax
import numpy as np
import pytest

import chip_smoke as cs
from bbbp.native import bindings as nb
from bbbp.ops.forest_device import DenseTreeEnsemble

TINY = dict(n_estimators=10, pca_dim=4, n_holdout=120, min_auc=0.5)


@pytest.fixture(scope="module")
def tiny_model():
    if not nb.available():
        pytest.skip("native featurizer not built (no g++)")
    cpu = jax.devices("cpu")[0]
    return cs.phase_model(200, seed=5, gpu=cpu, cpu=cpu, **TINY)


@pytest.fixture
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; on the card run python chip_smoke.py")
    return dev


def test_phase_model_tiny_trains_same_auc_on_two_devices():
    if not nb.available():
        pytest.skip("native featurizer not built (no g++)")
    cpu0, cpu1 = jax.devices("cpu")[:2]
    model = cs.phase_model(160, seed=6, gpu=cpu0, cpu=cpu1, **TINY)
    assert model.pca_components.shape == (4, 2048)
    assert model.ensemble.feat.shape == (10, 63)


def test_phase_screen_tiny_writes_checked_csv(tiny_model, tmp_path):
    rate = cs.phase_screen(tiny_model, 300, seed=7, chunk=128,
                           out_dir=str(tmp_path))
    assert rate > 0
    with open(tmp_path / "screen.csv") as f:
        rows = list(csv.reader(f))[1:]
    assert len(rows) == 300 and rows[0][2] == "invalid"   # planted at row 0


def test_phase_reference_tiny_agrees(tiny_model):
    res = cs.phase_reference(tiny_model, 256, seed=8,
                             cpu=jax.devices("cpu")[0])
    assert res["z_err"] <= cs.Z_ATOL and res["label_agree"] == 1.0


def test_phase_mesh_on_four_virtual_devices(tiny_model, tmp_path):
    rate = cs.phase_mesh(cs._host_model(tiny_model), jax.devices()[:4],
                         rows_per_device=64, seed=9, out_dir=str(tmp_path),
                         n_timed=600)
    with open(tmp_path / "screen_mesh.csv") as f:
        assert len(list(csv.reader(f))) == 1 + 4 * 64
    assert rate["mesh"] > 0 and rate["one"] > 0


def test_reference_unpack_matches_pack_bits():
    from bbbp.ops.bitops import pack_bits

    dense = (np.random.default_rng(0).random((5, 96)) < 0.3).astype(
        np.float32)
    assert np.array_equal(cs._unpack(pack_bits(dense), 96), dense)


def test_threshold_distance_follows_the_visited_path():
    # depth 2, one tree: root splits f0 at 0.5; right child splits f1 at 2.0
    ens = DenseTreeEnsemble(feat=np.array([[0, 1, 1]]),
                            thr=np.array([[0.5, -9.0, 2.0]], np.float32),
                            leaf=np.zeros((1, 4), np.float32), depth=2,
                            base_score=0.0, tree_scale=1.0)
    z = np.array([0.7, 2.01], np.float32)
    # visits root (|0.7-0.5|) and the right child (|2.01-2.0|), not the left
    assert cs.threshold_distance(ens, z) == pytest.approx(0.01, abs=1e-6)


def test_main_exits_nonzero_without_gpu(capsys):
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_main_on_gpu(gpu_device, tmp_path):
    assert cs.main(["--out", str(tmp_path)]) == 0
