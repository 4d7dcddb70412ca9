"""bench.py pieces that run without a GPU: the peak table, the heavy-atom
summary, the trace reduction and the refusal to run on the CPU."""

import pytest

import bench
from bbbp.utils.profiling import busy_ns


def test_peak_table_has_h100_bf16_dense_peak():
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12


def test_peak_table_raises_for_unknown_kind():
    with pytest.raises(KeyError, match="no bf16 peak"):
        bench.peak_bf16_flops("cpu")


def test_heavy_atom_summary_counts_heavy_atoms_only():
    s = bench.heavy_atom_summary(["CCO", "c1ccccc1", "not_a_smiles("])
    assert s["n"] == 2
    assert s["min_p10_p50_p90_max"][0] == 3.0
    assert s["min_p10_p50_p90_max"][-1] == 6.0


@pytest.mark.parametrize("intervals,expected", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 10)], 15.0),          # overlap counted once
    ([(20, 5), (0, 10), (2, 3)], 15.0),  # nested and disjoint, unsorted
])
def test_busy_ns_is_the_union_of_intervals(intervals, expected):
    assert busy_ns(intervals) == expected


def test_bench_refuses_to_run_without_gpu():
    assert bench.main([]) != 0


def test_trace_screen_reports_shares_of_the_traced_wall(tmp_path,
                                                        monkeypatch):
    from bbbp.data.zinc import synthetic_smiles, tpsa_bbb_labels
    from bbbp.native import bindings as nb
    from bbbp.pipelines.screen import ScreeningModel
    from bbbp.utils import profiling

    if not nb.available():
        pytest.skip("native featurizer not built (no g++)")
    smiles = synthetic_smiles(300, seed=3)
    model = ScreeningModel.train(smiles[:150], tpsa_bbb_labels(smiles[:150]),
                                 pca_dim=4, n_estimators=5)
    seen = []

    def fake_summary(trace_dir):
        seen.append(trace_dir)
        return {"busy_ns": 1e6, "top_kernels_ns": []}

    monkeypatch.setattr(bench, "CHUNK", 64)
    monkeypatch.setattr(profiling, "summarize_device_trace", fake_summary)
    res = bench.trace_screen(model, smiles, str(tmp_path))
    assert seen == [str(tmp_path / "screen")]
    assert any((tmp_path / "screen").rglob("*.xplane.pb"))
    assert res["device_busy_s"] == pytest.approx(1e-3)
    assert res["device_busy_share"] == pytest.approx(1e-3 / res["traced_wall_s"])
    assert res["device_idle_share"] == pytest.approx(
        1.0 - res["device_busy_share"])
