"""ctypes bindings for libbbbpchem.so (built by bbbp/native/build.py).

The binary is NOT committed to version control: ``_load`` builds it from
``bbbpchem.cpp`` on demand and verifies a source hash recorded at build time
(``libbbbpchem.src.sha256``), so a stale or tampered .so can never silently
shadow the reviewed source — it is rebuilt instead. All call sites fall back
to the pure-Python featurizers when no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import List, Sequence, Tuple

import numpy as np

_LIB = None
_HERE = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_HERE, "libbbbpchem.so")
_SRC_PATH = os.path.join(_HERE, "bbbpchem.cpp")
_HASH_PATH = os.path.join(_HERE, "libbbbpchem.src.sha256")


def _src_hash() -> str:
    with open(_SRC_PATH, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _ensure_built() -> bool:
    """Build (or rebuild on source change) the shared library; returns
    whether a current binary exists."""
    want = _src_hash()
    if os.path.exists(_LIB_PATH) and os.path.exists(_HASH_PATH):
        with open(_HASH_PATH) as f:
            if f.read().strip() == want:
                return True
    try:
        from bbbp.native.build import build

        build(verbose=False)
        with open(_HASH_PATH, "w") as f:
            f.write(want + "\n")
        return True
    except Exception:
        return False


def _load():
    global _LIB
    if _LIB is None and _ensure_built():
        lib = ctypes.CDLL(_LIB_PATH)
        lib.bbbp_fingerprints_packed.restype = ctypes.c_int
        lib.bbbp_fingerprints_packed.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.bbbp_fingerprints.restype = ctypes.c_int
        lib.bbbp_fingerprints.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # smiles array
            ctypes.c_int,                     # n molecules
            ctypes.c_int,                     # kind: 0 morgan, 1 maccs, 2 path
            ctypes.c_int,                     # n_bits
            ctypes.c_int,                     # radius
            ctypes.POINTER(ctypes.c_float),   # out [n, dim]
            ctypes.POINTER(ctypes.c_int32),   # bad flags [n]
            ctypes.c_int,                     # n threads (0 = auto)
        ]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def fingerprints(smiles: Sequence[str], kind: str, n_bits: int = 2048,
                 radius: int = 2, threads: int = 0) -> Tuple[np.ndarray, List[int]]:
    lib = _load()
    if lib is None:
        raise ImportError("libbbbpchem.so not built")
    kind_code = {"morgan": 0, "maccs": 1, "rdkit": 2}[kind]
    dim = 167 if kind == "maccs" else n_bits
    n = len(smiles)
    out = np.zeros((n, dim), dtype=np.float32)
    bad = np.zeros(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[s.encode("utf-8") for s in smiles])
    rc = lib.bbbp_fingerprints(
        arr, n, kind_code, n_bits, radius,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bad.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    if rc != 0:
        raise RuntimeError(f"bbbp_fingerprints failed: rc={rc}")
    return out, list(np.nonzero(bad)[0])


def fingerprints_packed(smiles: Sequence[str], kind: str = "morgan",
                        n_bits: int = 2048, radius: int = 2,
                        threads: int = 0) -> Tuple[np.ndarray, List[int]]:
    """Packed uint32 fingerprints [N, n_bits/32] direct from C++ (no dense
    intermediate) — the screening fast path."""
    lib = _load()
    if lib is None:
        raise ImportError("libbbbpchem.so not built")
    kind_code = {"morgan": 0, "rdkit": 2}[kind]
    n = len(smiles)
    words = n_bits // 32
    out = np.zeros((n, words), dtype=np.uint32)
    bad = np.zeros(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[s.encode("utf-8") for s in smiles])
    rc = lib.bbbp_fingerprints_packed(
        arr, n, kind_code, n_bits, radius,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        bad.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    if rc != 0:
        raise RuntimeError(f"bbbp_fingerprints_packed failed: rc={rc}")
    return out, list(np.nonzero(bad)[0])
