"""Chemical-space PCA visualization (F6/F7).

Reference: ``Descriptors/create_descriptors_PCA_classification.py:14-94``
(fingerprints all three kinds for the classification set, 2-D PCA scatter by
BBB label) and ``create_descriptors_PCA_regression_{1,2,3}.py`` (regression
set: fingerprint / image / interaction feature spaces, per fp kind).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from bbbp.chem.featurize import FP_KINDS, fingerprints
from bbbp.data import load_b3db_classification, load_b3db_regression
from bbbp.ops import PCA, StandardScaler
from bbbp.reporting.plots import pca_space_plot


def classification_space(out_dir: str = ".", kinds=FP_KINDS,
                         workers: Optional[int] = None) -> dict:
    data = load_b3db_classification()
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for kind in kinds:
        res = fingerprints(data.smiles, kind=kind, workers=workers)
        x = res.features[res.ok_mask]
        y = data.labels[res.ok_mask]
        z = np.asarray(PCA(2).fit_transform(
            np.asarray(StandardScaler().fit_transform(x))))
        path = os.path.join(out_dir, f"pca_space_classification_{kind}.png")
        pca_space_plot(z, y, path)
        out[kind] = path
        print(f"saved {path}")
    return out


def regression_space(out_dir: str = ".", kind: str = "maccs",
                     workers: Optional[int] = None) -> dict:
    """Fingerprint / image / interaction spaces colored by logBB sign."""
    from bbbp.pipelines.preprocess import PreprocessConfig, preprocess_regression

    d = preprocess_regression(PreprocessConfig(fp_kind=kind, workers=workers))
    labels = (d.y > 0).astype(int)      # BBB+ proxy: logBB > 0
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name, feats in (("fingerprint", d.fp_norm), ("image", d.img_pca),
                        ("interaction", d.interactions)):
        z = np.asarray(PCA(2).fit_transform(feats))
        path = os.path.join(out_dir, f"pca_space_regression_{kind}_{name}.png")
        pca_space_plot(z, labels, path, label_names=("logBB<=0", "logBB>0"))
        out[name] = path
        print(f"saved {path}")
    return out


def main():
    ap = argparse.ArgumentParser(description="PCA chemical-space plots (F6/F7)")
    ap.add_argument("--mode", default="classification",
                    choices=["classification", "regression"])
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--fp-kind", default="maccs")
    ap.add_argument("--workers", type=int, default=None)
    args = ap.parse_args()
    if args.mode == "classification":
        classification_space(args.out_dir, workers=args.workers)
    else:
        regression_space(args.out_dir, kind=args.fp_kind, workers=args.workers)


if __name__ == "__main__":
    main()
