"""Regression preprocessing pipeline (L3): featurize → standardize → PCA →
interactions → isolation forest → logBB filter.

Reproduces the reference's final preprocessors P6-P8
(reference: Descriptors/multi_input_data_preprocess_maccs_opt_IsolationForest_fixed_1.py:86-141):
standardize fp+image jointly, PCA(30) per modality on the normalized blocks,
degree-2 interaction-only features of the two PCA blocks, IsolationForest(0.05)
labels on the PCA blocks (stored, not filtered on), drop logBB < −2.0.

Differences, deliberate (SURVEY.md §2.3 quirks): the reference fits the scaler
(and in P7/P8 even the PCA) per consecutive 100-row batch; default here is a
global fit, with ``compat_batch=100`` reproducing the quirk exactly.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from bbbp.chem.featurize import fingerprints, images
from bbbp.data import load_b3db_regression
from bbbp.ops import PCA, StandardScaler, interaction_features
from bbbp.ops.outliers import IsolationForest
from bbbp.ops.scaler import standardize_per_batch
from bbbp.ops.pca import pca_per_batch


@dataclass
class PreprocessConfig:
    fp_kind: str = "maccs"            # morgan | maccs | rdkit
    image_size: int = 128
    pca_dim: int = 30
    contamination: float = 0.05
    logbb_min: Optional[float] = -2.0
    compat_batch: Optional[int] = None  # 100 → reference per-batch quirk
    compat_batch_pca: bool = False      # P7/P8 also refit PCA per batch
    workers: Optional[int] = None
    seed: int = 42
    tsv_path: Optional[str] = None
    # beyond-parity enrichment: physchem descriptors + the other two
    # fingerprint kinds PCA-compressed (SURVEY §7 "don't stop at parity")
    enrich: bool = True
    aux_pca_dim: int = 100
    # strict leak-free protocol support: also keep the UNnormalized feature
    # blocks so the trainer can fit scaler/PCA per CV fold (train rows only)
    keep_raw: bool = False
    # per-sample scaler quirk of the P1 base variant (reference:
    # Descriptors/multi_input_data_preprocess.py:68-73 fits a StandardScaler
    # per ROW, i.e. normalizes each sample over its own feature values)
    compat_per_sample: bool = False


@dataclass
class ProcessedData:
    smiles: list
    y: np.ndarray               # logBB after filtering
    fp_norm: np.ndarray         # [N, d_fp] standardized fingerprints
    img_norm: np.ndarray        # [N, H*W*3] standardized flat images
    fp_pca: np.ndarray          # [N, pca_dim]
    img_pca: np.ndarray         # [N, pca_dim]
    interactions: np.ndarray    # [N, 2d + C(2d,2)]
    outliers: np.ndarray        # [N] +1/-1
    numbers: np.ndarray
    config: PreprocessConfig
    desc_norm: Optional[np.ndarray] = None   # [N, 24] physchem descriptors
    aux_fp_pca: Optional[np.ndarray] = None  # [N, 2*aux_pca_dim] other fps
    # raw (pre-normalization) blocks for the strict per-fold protocol
    fp_raw: Optional[np.ndarray] = None
    img_raw: Optional[np.ndarray] = None
    desc_raw: Optional[np.ndarray] = None
    aux_fp_raw: Optional[Dict] = None        # kind -> [N, n_bits]

    def tree_features(self) -> np.ndarray:
        """Enriched tree-leg matrix: descriptors + fp + aux-fp PCA + img PCA."""
        blocks = [self.fp_norm, self.fp_pca, self.img_pca]
        if self.desc_norm is not None:
            blocks.insert(0, self.desc_norm)
        if self.aux_fp_pca is not None:
            blocks.append(self.aux_fp_pca)
        return np.concatenate(blocks, axis=1).astype(np.float32)

    def nn_fp_features(self) -> np.ndarray:
        """NN fingerprint-branch input: fp + descriptors when enriched."""
        if self.desc_norm is not None:
            return np.concatenate([self.fp_norm, self.desc_norm], axis=1
                                  ).astype(np.float32)
        return self.fp_norm

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "ProcessedData":
        with open(path, "rb") as f:
            return pickle.load(f)


def preprocess_regression(cfg: PreprocessConfig = PreprocessConfig(),
                          cache_dir: Optional[str] = None) -> ProcessedData:
    """``cache_dir``: optional directory to memoize the full ProcessedData
    (pickle keyed by the config fields). Featurization + depiction of the
    B3DB set runs minutes on the single host core; experiment sweeps that
    reuse one preprocessing config should pass a cache_dir (also via env
    BBBP_PREPROCESS_CACHE)."""
    import hashlib

    cache_dir = cache_dir or os.environ.get("BBBP_PREPROCESS_CACHE")
    cpath = None
    if cache_dir:
        key = hashlib.sha1(repr(sorted(cfg.__dict__.items())).encode()
                           ).hexdigest()[:16]
        cpath = os.path.join(cache_dir, f"preproc_reg_{key}.pkl")
        if os.path.exists(cpath):
            with open(cpath, "rb") as f:
                return pickle.load(f)
    data = load_b3db_regression(cfg.tsv_path)
    fp_res = fingerprints(data.smiles, kind=cfg.fp_kind, workers=cfg.workers)
    img_res = images(data.smiles, size=cfg.image_size, workers=cfg.workers)
    ok = fp_res.ok_mask & img_res.ok_mask
    fp = fp_res.features[ok]
    img = img_res.features[ok].reshape(ok.sum(), -1)
    y = data.logbb[ok]
    numbers = data.numbers[ok]
    smiles = [s for s, m in zip(data.smiles, ok) if m]

    # joint standardization of [fp | image] like the reference (:86-103)
    joint = np.concatenate([fp, img], axis=1)
    if cfg.compat_per_sample:
        # P1 quirk: StandardScaler fit per SAMPLE — each row normalized over
        # its own feature values (multi_input_data_preprocess.py:68-73)
        mu = joint.mean(axis=1, keepdims=True)
        sd = joint.std(axis=1, keepdims=True)
        joint_n = (joint - mu) / np.maximum(sd, 1e-8)
    elif cfg.compat_batch:
        joint_n = standardize_per_batch(joint, cfg.compat_batch)
    else:
        joint_n = np.asarray(StandardScaler().fit_transform(joint))
    d_fp = fp.shape[1]
    fp_n, img_n = joint_n[:, :d_fp], joint_n[:, d_fp:]

    if cfg.compat_batch and cfg.compat_batch_pca:
        fp_p = pca_per_batch(fp_n, cfg.pca_dim, cfg.compat_batch)
        img_p = pca_per_batch(img_n, cfg.pca_dim, cfg.compat_batch)
    else:
        fp_p = np.asarray(PCA(cfg.pca_dim).fit_transform(fp_n))
        img_p = np.asarray(PCA(cfg.pca_dim).fit_transform(img_n))

    inter = np.asarray(interaction_features(
        np.concatenate([fp_p, img_p], axis=1)))
    outl = IsolationForest(contamination=cfg.contamination,
                           seed=cfg.seed).fit_predict(
        np.concatenate([fp_p, img_p], axis=1))

    desc_n = None
    desc_raw = None
    aux = None
    aux_raw: Optional[Dict] = None
    if cfg.enrich:
        from bbbp.chem.descriptors import descriptor_matrix

        desc_raw, _ = descriptor_matrix(smiles)
        desc_n = np.asarray(StandardScaler().fit_transform(desc_raw))
        aux_blocks = []
        aux_raw = {}
        for kind in ("morgan_counts", "rdkit"):
            if kind == cfg.fp_kind:
                continue
            res = fingerprints(smiles, kind=kind, workers=cfg.workers)
            aux_raw[kind] = res.features.astype(np.float32)
            xn = np.asarray(StandardScaler().fit_transform(res.features))
            k = min(cfg.aux_pca_dim, xn.shape[0], xn.shape[1])
            aux_blocks.append(np.asarray(PCA(k).fit_transform(xn)))
        if aux_blocks:
            aux = np.concatenate(aux_blocks, axis=1)

    if cfg.logbb_min is not None:
        keep = y >= cfg.logbb_min
    else:
        keep = np.ones(len(y), dtype=bool)
    out = ProcessedData(
        smiles=[s for s, m in zip(smiles, keep) if m],
        y=y[keep].astype(np.float32),
        fp_norm=fp_n[keep],
        img_norm=img_n[keep],
        fp_pca=fp_p[keep],
        img_pca=img_p[keep],
        interactions=inter[keep],
        outliers=outl[keep],
        numbers=numbers[keep],
        config=cfg,
        desc_norm=desc_n[keep] if desc_n is not None else None,
        aux_fp_pca=aux[keep] if aux is not None else None,
        fp_raw=fp[keep].astype(np.float32) if cfg.keep_raw else None,
        img_raw=img[keep].astype(np.float32) if cfg.keep_raw else None,
        desc_raw=(desc_raw[keep].astype(np.float32)
                  if cfg.keep_raw and desc_raw is not None else None),
        aux_fp_raw=({k: v[keep] for k, v in aux_raw.items()}
                    if cfg.keep_raw and aux_raw else None),
    )
    if cpath:
        os.makedirs(cache_dir, exist_ok=True)
        with open(cpath, "wb") as f:
            pickle.dump(out, f)
    return out


def main():
    ap = argparse.ArgumentParser(description="B3DB regression preprocessing")
    ap.add_argument("--fp-kind", default="maccs", choices=["morgan", "maccs", "rdkit"])
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--pca-dim", type=int, default=30)
    ap.add_argument("--logbb-min", type=float, default=-2.0)
    ap.add_argument("--compat-batch", type=int, default=None)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--output", default="processed_regression.pkl")
    args = ap.parse_args()
    cfg = PreprocessConfig(
        fp_kind=args.fp_kind, image_size=args.image_size, pca_dim=args.pca_dim,
        logbb_min=args.logbb_min, compat_batch=args.compat_batch,
        workers=args.workers,
    )
    out = preprocess_regression(cfg)
    out.save(args.output)
    print(f"saved {len(out.y)} molecules to {args.output} "
          f"(fp={out.fp_norm.shape}, img={out.img_norm.shape})")


if __name__ == "__main__":
    main()
