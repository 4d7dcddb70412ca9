"""Load estimator pickles written under the package's former module names.

Earlier builds published this package as ``bbbp_`` plus a suffix, kept the
on-device forest estimators in ``ops/forest_`` plus another suffix, and gave
those estimator classes a prefix where they now carry ``Device``. A pickle
names every class by module and name, so pickles of those builds (the
baseline and classification ``*_model.pkl`` / ``fitted_models.pkl``) do not
unpickle with plain ``pickle``. ``load`` maps the former names:

- a top-level ``bbbp_*`` package → ``bbbp``;
- a ``bbbp.ops.forest_*`` module that no longer exists → ``bbbp.ops.forest_device``;
- a class its module no longer has → the one ``Device*`` class of that module
  whose name, less ``Device``, ends the former name.

Everything else unpickles as usual. Run as a module to rewrite pickles in
place under the present names, keeping each file's pickle protocol:

    python -m bbbp.utils.pickles results/*/fitted_models.pkl
"""

from __future__ import annotations

import importlib
import importlib.util
import pickle
import pickletools
import sys
from typing import Any, BinaryIO

PACKAGE = "bbbp"
FOREST_MODULE = "bbbp.ops.forest_device"
CLASS_PREFIX = "Device"


def present_module(module: str) -> str:
    top, dot, rest = module.partition(".")
    if top.startswith(PACKAGE + "_"):
        module = PACKAGE + dot + rest
    parent, _, leaf = module.rpartition(".")
    if (parent == "bbbp.ops" and leaf.startswith("forest_")
            and importlib.util.find_spec(module) is None):
        module = FOREST_MODULE
    return module


def present_class(module: str, name: str) -> str:
    mod = importlib.import_module(module)
    if hasattr(mod, name):
        return name
    matches = [c for c in vars(mod) if c.startswith(CLASS_PREFIX)
               and len(c) > len(CLASS_PREFIX)
               and name.endswith(c[len(CLASS_PREFIX):])]
    if len(matches) != 1:
        raise pickle.UnpicklingError(
            f"{module}.{name}: no single present class to map it to "
            f"(candidates {matches})")
    return matches[0]


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if module.split(".")[0].startswith(PACKAGE):
            module = present_module(module)
            name = present_class(module, name)
        return super().find_class(module, name)


def load(f: BinaryIO) -> Any:
    """``pickle.load`` that maps the package's former module and class
    names to the present ones."""
    return _Unpickler(f).load()


def rewrite(path: str) -> None:
    """Re-pickle ``path`` in place under the present names, in its own
    protocol."""
    with open(path, "rb") as f:
        data = f.read()
    op, arg, _ = next(pickletools.genops(data))
    protocol = arg if op.name == "PROTO" else 0
    with open(path, "rb") as f:
        obj = load(f)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=protocol)


if __name__ == "__main__":
    for p in sys.argv[1:]:
        rewrite(p)
        print(p)
