"""Weighted-ensemble regression variants (families B2/B4).

Reference: ``Models/multi_input_data_regression_opt.py:140-156`` — final
prediction 0.7·NN + 0.1·RF + 0.2·XGB over 5-fold CV — and the B4 variant
(``Models/multi_input_data_regression_opt_round_2.py:97-98,170-193``) with
weights 0.4/0.3/0.3 and a 'rounding accuracy' metric (prediction counted
correct when it matches the label rounded to 2 decimals).
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from bbbp.models.mlp import DualBranchMLP
from bbbp.ops import metrics
from bbbp.ops.forest_device import DeviceGBDTRegressor, DeviceRandomForestRegressor
from bbbp.pipelines.preprocess import PreprocessConfig, ProcessedData, preprocess_regression
from bbbp.train.loop import train_multimodal_cv


def rounding_accuracy(y_true, y_pred, decimals: int = 2) -> float:
    """The B4 'accuracy' quirk: exact match after rounding
    (reference: ..._round_2.py:97-98)."""
    return float(np.mean(np.round(y_pred, decimals) == np.round(y_true, decimals)))


@dataclass
class WeightedEnsembleConfig:
    weights: Tuple[float, float, float] = (0.7, 0.1, 0.2)   # NN, RF, XGB (B2)
    n_folds: int = 5
    epochs: int = 40
    lr: float = 3e-4
    fp_kind: str = "maccs"
    image_size: int = 128
    seed: int = 42
    workers: Optional[int] = None


def run_weighted_ensemble(cfg: WeightedEnsembleConfig = WeightedEnsembleConfig(),
                          data: Optional[ProcessedData] = None,
                          verbose: bool = True) -> Dict[str, Dict[str, float]]:
    if data is None:
        data = preprocess_regression(PreprocessConfig(
            fp_kind=cfg.fp_kind, image_size=cfg.image_size,
            workers=cfg.workers, seed=cfg.seed))
    n = len(data.y)
    y = data.y
    img_flat = data.img_norm
    model = DualBranchMLP()
    nn_res = train_multimodal_cv(model, data.fp_norm, img_flat, y,
                                 n_folds=cfg.n_folds, epochs=cfg.epochs,
                                 batch_size=32, lr=cfg.lr, seed=cfg.seed)
    folds = nn_res.fold_test_idx
    xt = np.concatenate([data.fp_norm, data.fp_pca, data.img_pca], 1).astype(np.float32)
    rf_oof = np.zeros(n, np.float32)
    xgb_oof = np.zeros(n, np.float32)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        rf_oof[te] = DeviceRandomForestRegressor(
            n_estimators=200, max_depth=10, seed=cfg.seed + i
        ).fit(xt[tr], y[tr]).predict(xt[te])
        xgb_oof[te] = DeviceGBDTRegressor(
            n_estimators=300, learning_rate=0.03, max_depth=6, subsample=0.8,
            seed=cfg.seed + i
        ).fit(xt[tr], y[tr]).predict(xt[te])
    w = cfg.weights
    blend = w[0] * nn_res.oof_pred + w[1] * rf_oof + w[2] * xgb_oof
    report = {
        "nn": metrics.regression_report(y, nn_res.oof_pred),
        "rf": metrics.regression_report(y, rf_oof),
        "xgb": metrics.regression_report(y, xgb_oof),
        "ensemble": {**metrics.regression_report(y, blend),
                     "rounding_accuracy": rounding_accuracy(y, blend)},
    }
    if verbose:
        for k, r in report.items():
            print(f"[weighted] {k:9s} " + " ".join(f"{kk}={vv:.4f}" for kk, vv in r.items()))
    return report


def main():
    ap = argparse.ArgumentParser(description="Weighted ensemble regression (B2/B4)")
    ap.add_argument("--weights", nargs=3, type=float, default=[0.7, 0.1, 0.2])
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rep = run_weighted_ensemble(WeightedEnsembleConfig(
        weights=tuple(args.weights), n_folds=args.folds, epochs=args.epochs))
    print(json.dumps(rep, indent=2))
    if args.out:
        json.dump(rep, open(args.out, "w"), indent=2)


if __name__ == "__main__":
    main()
