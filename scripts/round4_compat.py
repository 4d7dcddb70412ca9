"""Round-4 compat rerun with the full 13-leg stack (VERDICT r3 item 3).

The committed compat artifact (regression_maccs_compat_enriched.json,
round 1) predates seven legs' worth of round-2/3 improvements: it has only
nn/rf/gbdt/cat/knn/ridge and reached 0.8373 vs the reference's best
same-protocol artifact 0.8645
(/root/reference/Models/stacked_predict_processed_data_maccs_opt_lso_fixed_1_0.8645_0.0715.png).
This run applies the full honest-push lever set on the compat protocol
(per-100-row scaler quirk, in-sample meta fit — the reference's published
pipeline family): 13 legs, split_repeats=2, nn_split_mix, kernel ~LOO,
IDF chem kernels, morgan-bit GBDT, transfer columns.

Run: python -u scripts/round4_compat.py
"""
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

T0 = time.time()
OUT = "/root/repo/results"
TUNED = os.path.join(OUT, "regression_tuned_params.json")
PRE_DIR = "/root/repo/.bench_cache/bert_pretrained"
CACHE = "/root/repo/.bench_cache"


def log(msg):
    print(f"[r4cp +{time.time()-T0:7.0f}s] {msg}", flush=True)


import jax
import jax.numpy as jnp

assert float(jnp.ones((64, 64)).sum()) == 4096.0
log(f"devices: {jax.devices()}")

from bbbp.pipelines.preprocess import (PreprocessConfig, ProcessedData,
                                       preprocess_regression)
from bbbp.train.regression import RegressionTrainConfig, run_regression

# compat preprocess (per-100-row scaler on the label-correlated row order)
pp_path = os.path.join(CACHE, "pp_maccs_compat100.pkl")
if os.path.exists(pp_path):
    data = ProcessedData.load(pp_path)
    log(f"compat preprocess cached: N={len(data.y)}")
else:
    t0 = time.time()
    data = preprocess_regression(PreprocessConfig(
        fp_kind="maccs", compat_batch=100, workers=1))
    data.save(pp_path)
    log(f"compat preprocess: N={len(data.y)} ({time.time()-t0:.0f}s)")

best = {}
if os.path.exists(TUNED):
    with open(TUNED) as f:
        best = json.load(f)

cfg = RegressionTrainConfig(
    protocol="compat", compat_batch=100, graph_leg=True, bert_leg=True,
    bert_pretrained_dir=PRE_DIR,
    nn_seeds=4, graph_seeds=3, bert_seeds=3, tree_seeds=3,
    split_repeats=2, nn_split_mix=True, kernel_n_folds=50,
    meta="linear", transfer_leg=True, transfer_models=("tknn",),
    fp_tree_legs=("morgan",), ckrr_idf=True,
    out_dir=f"{OUT}/reg_maccs_compat_r4")
if "nn" in best:
    cfg.lr = float(best["nn"]["learning_rate"])
    cfg.n_layers = int(best["nn"].get("n_layers", 4))
if "graph" in best:
    cfg.graph_lr = float(best["graph"]["learning_rate"])
    cfg.graph_hidden = int(best["graph"].get("hidden", 192))
if "smiles" in best:
    cfg.bert_lr = float(best["smiles"]["learning_rate"])
if "gbdt" in best:
    cfg.gbdt_lr = float(best["gbdt"]["learning_rate"])
    cfg.gbdt_subsample = float(best["gbdt"].get("subsample", 0.8))
    cfg.gbdt_colsample = float(best["gbdt"].get("colsample", 1.0))
    cfg.gbdt_lambda = float(best["gbdt"].get("reg_lambda", 1.0))
aux = best.get("aux_pretrain", {})
if aux.get("graph", {}).get("use"):
    cfg.graph_pretrained = aux["graph"]["path"]
if aux.get("multimodal", {}).get("use"):
    cfg.nn_pretrained = aux["multimodal"]["path"]

log("compat full-leg run starting")
res = run_regression(cfg, data=data, verbose=True)
with open(f"{OUT}/regression_maccs_compat_full.json", "w") as f:
    json.dump(res.report, f, indent=1)
log(f"compat done (stacked R2={res.report['stacked']['r2']:.4f} vs "
    f"reference artifact 0.8645)")
