"""Round-5 tests: screening-pipeline handling of a failed device fetch in
the drain loop, the multi-dispatcher device path (CSV order and results
independent of the dispatcher count), and resumable tree-stage checkpoints.
"""
import csv
import threading
import time

import numpy as np
import pytest

from bbbp.pipelines.screen import (ScreenBackendError, ScreeningModel,
                                   screen)


@pytest.fixture(scope="module")
def tiny_model():
    labels = np.array([1, 0, 1, 0] * 8, np.float32)
    return ScreeningModel.train(["CCO", "CCN", "c1ccccc1", "CCS"] * 8,
                                labels, pca_dim=4, n_estimators=10)


def _stream(n):
    mols = ["CCO", "CCN", "c1ccccc1", "CCS", "CC(C)O", "CCCl"]
    return iter((mols[i % len(mols)], f"M{i:04d}") for i in range(n))


class _BoomOnFetch:
    """A fake device future whose materialization raises like a failed
    device (jax surfaces XlaRuntimeError("FAILED_PRECONDITION: ...") from
    np.asarray on the buffer)."""

    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("FAILED_PRECONDITION: device error (injected)")


class TestDrainBackendDeath:
    def test_backend_death_raises_attributed_error_no_hang(
            self, tiny_model, monkeypatch):
        """Kill the fetch of chunk 1 only: screen() must raise
        ScreenBackendError carrying chunk_index=1 and leave no blocked
        pipeline threads behind."""
        import bbbp.pipelines.screen as scr

        calls = []

        def fake_factory(model, mesh=None):
            def run(arr):
                seq = len(calls)
                calls.append(seq)
                if seq == 1:
                    return _BoomOnFetch()
                return np.zeros(arr.shape[0], np.float32)
            return run

        monkeypatch.setattr(scr, "_make_device_fn", fake_factory)
        monkeypatch.setattr(scr, "_make_packed_device_fn", fake_factory)
        before = threading.active_count()
        # dispatch_workers=1 -> device calls happen in sequence order, so
        # the injected death maps deterministically to chunk 1
        with pytest.raises(ScreenBackendError) as ei:
            screen(tiny_model, _stream(48), out_csv=None, chunk_size=8,
                   dispatch_workers=1)
        assert ei.value.chunk_index == 1
        assert "FAILED_PRECONDITION" in str(ei.value)
        # every pipeline thread must unwind (drain_all_ends unblocked them)
        deadline = time.time() + 10
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before

    def test_backend_death_with_concurrent_dispatchers_no_hang(
            self, tiny_model, monkeypatch):
        """All fetches die: with several dispatchers in flight the error
        still surfaces as ScreenBackendError and nothing deadlocks."""
        import bbbp.pipelines.screen as scr

        def fake_factory(model, mesh=None):
            return lambda arr: _BoomOnFetch()

        monkeypatch.setattr(scr, "_make_device_fn", fake_factory)
        monkeypatch.setattr(scr, "_make_packed_device_fn", fake_factory)
        before = threading.active_count()
        with pytest.raises(ScreenBackendError):
            screen(tiny_model, _stream(64), out_csv=None, chunk_size=8,
                   dispatch_workers=3)
        deadline = time.time() + 10
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before


class TestMultiDispatcher:
    def test_csv_order_preserved_with_concurrent_dispatchers(
            self, tiny_model, tmp_path):
        """Chunks dispatched by 3 concurrent threads must still write the
        CSV in input order (sequence-number reordering in the drain)."""
        out = tmp_path / "screen.csv"
        n = 100
        stats = screen(tiny_model, _stream(n), out_csv=str(out),
                       chunk_size=16, dispatch_workers=3)
        assert stats.n_molecules == n
        with open(out) as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["ID", "SMILES", "Prediction", "Probability"]
        ids = [r[0] for r in rows[1:]]
        assert ids == [f"M{i:04d}" for i in range(n)]

    def test_dispatcher_counts_match_single_dispatcher_results(
            self, tiny_model, tmp_path):
        """Same molecules, 1 vs 3 dispatchers: identical probabilities row
        by row (the device fn is deterministic; only scheduling differs)."""
        out1, out3 = tmp_path / "d1.csv", tmp_path / "d3.csv"
        screen(tiny_model, _stream(60), out_csv=str(out1), chunk_size=16,
               dispatch_workers=1)
        screen(tiny_model, _stream(60), out_csv=str(out3), chunk_size=16,
               dispatch_workers=3)
        with open(out1) as f1, open(out3) as f3:
            assert f1.read() == f3.read()


class TestTreeStageCheckpoint:
    def test_interrupted_tree_stage_resumes_bit_identical(self, tmp_path,
                                                          monkeypatch):
        """Kill the tree stage mid-fold (the round-5 wedge pattern), rerun,
        and require bit-identical OOF columns vs an uninterrupted run."""
        import numpy as np
        from tests.test_round3 import _tiny_processed
        from bbbp.train import regression as R

        common = dict(
            protocol="honest", n_folds=3, epochs=2, nn_seeds=1,
            graph_leg=False, bert_leg=False, tree_seeds=1, snapshot_from=None,
            rf_trees=8, gbdt_trees=8, cat_trees=8, image_size=8,
            split_repeats=2)
        d = _tiny_processed()
        ref = R.run_regression(
            R.RegressionTrainConfig(out_dir=str(tmp_path / "ref"), **common),
            data=d, verbose=False)

        # interrupted run: blow up on the 3rd tree fold cell
        calls = {"n": 0}
        orig = R.GBDTRegressor.fit

        def dying_fit(self, *a, **kw):
            calls["n"] += 1
            if calls["n"] > 4:
                raise RuntimeError("injected worker wedge")
            return orig(self, *a, **kw)

        out = str(tmp_path / "resume")
        monkeypatch.setattr(R.GBDTRegressor, "fit", dying_fit)
        import pytest as _pt
        with _pt.raises(RuntimeError, match="injected"):
            R.run_regression(
                R.RegressionTrainConfig(out_dir=out, **common),
                data=d, verbose=False)
        monkeypatch.setattr(R.GBDTRegressor, "fit", orig)
        import os
        assert os.path.exists(os.path.join(out, "tree_ckpt.pkl"))

        res = R.run_regression(
            R.RegressionTrainConfig(out_dir=out, **common),
            data=d, verbose=True)
        for m in ("rf", "gbdt", "cat", "knn", "ridge", "tknn"):
            np.testing.assert_array_equal(res.oof[m], ref.oof[m], err_msg=m)
        # ckpt removed after the stage completes
        assert not os.path.exists(os.path.join(out, "tree_ckpt.pkl"))

    def test_deep_leg_restored_from_checkpoint(self, tmp_path, monkeypatch):
        """A retry after a tree-stage wedge must NOT retrain the deep legs:
        the graph column is restored from the ckpt (poisoned MPNN proves the
        training path is skipped) and matches the uninterrupted run."""
        import os
        import numpy as np
        from tests.test_round3 import _tiny_processed
        from bbbp.train import regression as R
        import bbbp.models.gnn as gnn

        common = dict(
            protocol="honest", n_folds=3, epochs=2, nn_seeds=1,
            graph_leg=True, graph_epochs=2, graph_hidden=8, graph_layers=1,
            graph_seeds=1, max_atoms=16,
            bert_leg=False, tree_seeds=1, snapshot_from=None,
            rf_trees=8, gbdt_trees=8, cat_trees=8, image_size=8)
        d = _tiny_processed()
        ref = R.run_regression(
            R.RegressionTrainConfig(out_dir=str(tmp_path / "ref"), **common),
            data=d, verbose=False)

        calls = {"n": 0}
        orig = R.GBDTRegressor.fit

        def dying_fit(self, *a, **kw):
            calls["n"] += 1
            if calls["n"] > 2:
                raise RuntimeError("injected worker wedge")
            return orig(self, *a, **kw)

        out = str(tmp_path / "resume")
        monkeypatch.setattr(R.GBDTRegressor, "fit", dying_fit)
        import pytest as _pt
        with _pt.raises(RuntimeError, match="injected"):
            R.run_regression(
                R.RegressionTrainConfig(out_dir=out, **common),
                data=d, verbose=False)
        monkeypatch.setattr(R.GBDTRegressor, "fit", orig)
        assert os.path.exists(os.path.join(out, "tree_ckpt.pkl"))

        def poisoned_init(self, *a, **kw):  # noqa: ARG001
            raise AssertionError("graph leg retrained despite ckpt")

        monkeypatch.setattr(gnn.MPNNRegressor, "__init__", poisoned_init)
        res = R.run_regression(
            R.RegressionTrainConfig(out_dir=out, **common),
            data=d, verbose=False)
        np.testing.assert_array_equal(res.oof["graph"], ref.oof["graph"])
        np.testing.assert_array_equal(res.oof["rf"], ref.oof["rf"])

    def test_stale_checkpoint_key_ignored(self, tmp_path):
        """A ckpt written by a DIFFERENT config must be ignored, not merged."""
        import os
        import pickle
        import numpy as np
        from tests.test_round3 import _tiny_processed
        from bbbp.train import regression as R

        common = dict(
            protocol="honest", n_folds=3, epochs=2, nn_seeds=1,
            graph_leg=False, bert_leg=False, tree_seeds=1, snapshot_from=None,
            rf_trees=8, gbdt_trees=8, cat_trees=8, image_size=8)
        d = _tiny_processed()
        out = str(tmp_path / "run")
        os.makedirs(out)
        with open(os.path.join(out, "tree_ckpt.pkl"), "wb") as f:
            pickle.dump({"key": "bogus", "state": {
                "cells": {(0, 0)}, "oof_r": {}, "rep_acc": {},
                "tree_seed_acc": {}, "reps_done": set()}}, f)
        ref = R.run_regression(
            R.RegressionTrainConfig(out_dir=str(tmp_path / "ref"), **common),
            data=d, verbose=False)
        res = R.run_regression(
            R.RegressionTrainConfig(out_dir=out, **common),
            data=d, verbose=False)
        np.testing.assert_array_equal(res.oof["rf"], ref.oof["rf"])
