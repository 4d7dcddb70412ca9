"""Batch featurization: SMILES lists → fingerprint matrices / image tensors.

High-level equivalent of the reference's featurization scripts
(reference: Descriptors/create_descriptors.py:13-58 generate_all_fingerprints;
Descriptors/create_descriptors_zinc.py:34-71 batch ZINC fingerprinting).
Invalid SMILES are quarantined exactly like the reference (zero-vector +
reported indices, reference: Descriptors/multi_input_data_preprocess_maccs_opt_IsolationForest_fixed_1.py:39-53).

Uses the C++ fast path (bbbp.native) when built, else a Python process
pool. Both produce identical bits.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

FP_KINDS = ("morgan", "maccs", "rdkit", "pairs", "morgan_counts", "avalon")
FP_SIZES = {"morgan": 2048, "maccs": 167, "rdkit": 2048, "pairs": 2048,
            "morgan_counts": 2048}


def _featurize_chunk(args) -> Tuple[np.ndarray, List[int]]:
    smiles_chunk, kind, n_bits, radius = args
    from bbbp.chem.smiles import MolFromSmiles
    from bbbp.chem.fingerprints import (
        avalon_fingerprint,
        morgan_fingerprint,
        morgan_count_fingerprint,
        maccs_fingerprint,
        path_fingerprint,
        atom_pair_fingerprint,
    )

    dim = {"maccs": 167, "avalon": 512}.get(kind, n_bits)
    out = np.zeros((len(smiles_chunk), dim), dtype=np.float32)
    bad: List[int] = []
    for i, s in enumerate(smiles_chunk):
        mol = MolFromSmiles(s)
        if mol is None:
            bad.append(i)
            continue
        if kind == "morgan":
            out[i] = morgan_fingerprint(mol, radius=radius, n_bits=n_bits)
        elif kind == "morgan_counts":
            out[i] = morgan_count_fingerprint(mol, radius=radius, n_bits=n_bits)
        elif kind == "maccs":
            out[i] = maccs_fingerprint(mol)
        elif kind == "rdkit":
            out[i] = path_fingerprint(mol, n_bits=n_bits)
        elif kind == "pairs":
            out[i] = atom_pair_fingerprint(mol, n_bits=n_bits)
        elif kind == "avalon":
            out[i] = avalon_fingerprint(mol)
        else:
            raise ValueError(f"unknown fingerprint kind {kind!r}")
    return out, bad


def _depict_chunk(args) -> Tuple[np.ndarray, List[int]]:
    smiles_chunk, size = args
    from bbbp.chem.depict import depict

    out = np.zeros((len(smiles_chunk), size, size, 3), dtype=np.float32)
    bad: List[int] = []
    for i, s in enumerate(smiles_chunk):
        img = depict(s, size=size)
        if img is None:
            bad.append(i)
        else:
            out[i] = img
    return out, bad


@dataclass
class FeaturizeResult:
    features: np.ndarray
    bad_indices: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))

    @property
    def ok_mask(self) -> np.ndarray:
        mask = np.ones(len(self.features), dtype=bool)
        mask[self.bad_indices] = False
        return mask


def _pool_map(fn, jobs, workers: Optional[int]) -> List:
    workers = workers if workers is not None else min(os.cpu_count() or 1, 32)
    if workers <= 1 or len(jobs) == 1:
        return [fn(j) for j in jobs]
    with ProcessPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, jobs))


def fingerprints(smiles: Sequence[str], kind: str = "morgan", n_bits: int = 2048,
                 radius: int = 2, workers: Optional[int] = None,
                 use_native: bool = True) -> FeaturizeResult:
    """Featurize a SMILES batch → [N, dim] float32 + quarantined indices."""
    if kind not in FP_KINDS:
        raise ValueError(f"kind must be one of {FP_KINDS}")
    smiles = list(smiles)
    if not smiles:
        dim = {"maccs": 167, "avalon": 512}.get(kind, n_bits)
        return FeaturizeResult(np.zeros((0, dim), dtype=np.float32))
    if use_native and kind in ("morgan", "rdkit", "maccs"):
        try:
            from bbbp.native import bindings as nb

            if nb.available():
                feats, bad = nb.fingerprints(smiles, kind, n_bits, radius)
                return FeaturizeResult(feats, np.asarray(bad, dtype=np.int64))
        except (ImportError, RuntimeError):
            pass
    chunk = max(64, (len(smiles) + 127) // 128)
    jobs = []
    offsets = []
    for start in range(0, len(smiles), chunk):
        jobs.append((smiles[start : start + chunk], kind, n_bits, radius))
        offsets.append(start)
    results = _pool_map(_featurize_chunk, jobs, workers)
    feats = np.concatenate([r[0] for r in results], axis=0)
    bad = np.asarray(
        [off + i for off, r in zip(offsets, results) for i in r[1]], dtype=np.int64
    )
    return FeaturizeResult(feats, bad)


def images(smiles: Sequence[str], size: int = 128,
           workers: Optional[int] = None) -> FeaturizeResult:
    """Render a SMILES batch → [N, size, size, 3] float32 images."""
    smiles = list(smiles)
    if not smiles:
        return FeaturizeResult(np.zeros((0, size, size, 3), dtype=np.float32))
    chunk = max(16, (len(smiles) + 127) // 128)
    jobs, offsets = [], []
    for start in range(0, len(smiles), chunk):
        jobs.append((smiles[start : start + chunk], size))
        offsets.append(start)
    results = _pool_map(_depict_chunk, jobs, workers)
    feats = np.concatenate([r[0] for r in results], axis=0)
    bad = np.asarray(
        [off + i for off, r in zip(offsets, results) for i in r[1]], dtype=np.int64
    )
    return FeaturizeResult(feats, bad)
