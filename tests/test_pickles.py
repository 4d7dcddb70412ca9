"""Estimator pickles across the package's renames: the committed result
pickles name only present modules and classes, pickles under the former
names load through ``bbbp.utils.pickles``, and a saved screening model names
no module of the package at all."""

import glob
import importlib
import io
import os
import pickle
import pickletools
import sys
import types

import numpy as np
import pytest

from bbbp.ops.forest_device import DeviceGBDTClassifier
from bbbp.ops.linear import LogisticRegression
from bbbp.utils import pickles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT_PICKLES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "results", "**", "*.pkl"),
                       recursive=True))


def _globals(data: bytes):
    """(module, name) of every class a pickle names, without unpickling."""
    strings, out = [], set()
    for op, arg, _ in pickletools.genops(data):
        if op.name == "GLOBAL":
            out.add(tuple(arg.split(" ", 1)))
        elif op.name == "STACK_GLOBAL":
            out.add((strings[-2], strings[-1]))
        if isinstance(arg, str):
            strings.append(arg)
    return out


def test_result_pickles_are_committed():
    assert len(RESULT_PICKLES) == 26


@pytest.mark.parametrize("path", RESULT_PICKLES)
def test_result_pickle_names_present_classes(path):
    with open(os.path.join(REPO, path), "rb") as f:
        names = _globals(f.read())
    for module, name in names:
        if module.split(".")[0] == "bbbp":
            assert hasattr(importlib.import_module(module), name), (module,
                                                                    name)
        else:
            assert not module.startswith("bbbp"), module


def _former_package(monkeypatch):
    """Modules under former names, holding look-alikes of two estimators."""
    mods = {}
    for name in ("bbbp_old", "bbbp_old.ops", "bbbp_old.ops.forest_old",
                 "bbbp_old.ops.linear"):
        mods[name] = types.ModuleType(name)
        monkeypatch.setitem(sys.modules, name, mods[name])

    def make(module, cls_name):
        cls = type(cls_name, (), {"__module__": module})
        cls.__qualname__ = cls_name
        setattr(mods[module], cls_name, cls)
        return cls

    return (make("bbbp_old.ops.forest_old", "OldGBDTClassifier"),
            make("bbbp_old.ops.linear", "LogisticRegression"))


def test_load_maps_former_module_and_class_names(monkeypatch):
    forest_cls, linear_cls = _former_package(monkeypatch)
    forest, linear = forest_cls(), linear_cls()
    forest.n_estimators, forest.leaf_ = 3, np.arange(4, dtype=np.float32)
    linear.coef_ = np.ones(5)
    data = pickle.dumps({"gb": forest, "logreg": linear}, protocol=4)
    for name in list(sys.modules):
        if name.startswith("bbbp_old"):
            monkeypatch.delitem(sys.modules, name)

    with pytest.raises(ModuleNotFoundError):
        pickle.loads(data)
    got = pickles.load(io.BytesIO(data))
    assert type(got["gb"]) is DeviceGBDTClassifier
    assert type(got["logreg"]) is LogisticRegression
    assert got["gb"].n_estimators == 3
    np.testing.assert_array_equal(got["gb"].leaf_, forest.leaf_)
    np.testing.assert_array_equal(got["logreg"].coef_, linear.coef_)


@pytest.mark.parametrize("former,present", [
    ("bbbp_old.ops.linear", "bbbp.ops.linear"),
    ("bbbp_old.ops.forest_old", "bbbp.ops.forest_device"),
    ("bbbp_old.ops.forest", "bbbp.ops.forest"),
    ("bbbp.ops.forest_device", "bbbp.ops.forest_device"),
    ("numpy.core.multiarray", "numpy.core.multiarray"),
])
def test_present_module(former, present):
    assert pickles.present_module(former) == present


def test_present_class_refuses_a_class_it_cannot_map():
    assert pickles.present_class("bbbp.ops.linear", "BernoulliNB") == \
        "BernoulliNB"
    with pytest.raises(pickle.UnpicklingError, match="no single present"):
        pickles.present_class("bbbp.ops.linear", "Unheard")


def test_rewrite_keeps_protocol_and_content(tmp_path, monkeypatch):
    forest_cls, _ = _former_package(monkeypatch)
    obj = forest_cls()
    obj.depth = 6
    path = tmp_path / "model.pkl"
    path.write_bytes(pickle.dumps(obj, protocol=3))
    pickles.rewrite(str(path))
    data = path.read_bytes()
    assert next(pickletools.genops(data))[1] == 3
    assert _globals(data) == {("bbbp.ops.forest_device",
                               "DeviceGBDTClassifier")}
    assert pickle.loads(data).depth == 6


def test_screening_model_pickle_names_no_package_module(tmp_path):
    from bbbp.ops.forest_device import DenseTreeEnsemble
    from bbbp.pipelines.screen import ScreeningModel

    ens = DenseTreeEnsemble(feat=np.zeros((2, 3), np.int32),
                            thr=np.zeros((2, 3), np.float32),
                            leaf=np.zeros((2, 4), np.float32), depth=2,
                            base_score=0.0, tree_scale=1.0)
    model = ScreeningModel(np.zeros(64), np.ones(64), np.zeros(2),
                           np.zeros((2, 64)), ens, "morgan", 64, 0.5)
    path = str(tmp_path / "screen.pkl")
    model.save(path)
    with open(path, "rb") as f:
        assert not {m for m, _ in _globals(f.read()) if m.startswith("bbbp")}
    assert ScreeningModel.load(path).n_bits == 64
