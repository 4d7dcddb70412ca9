"""Round-4 strict rerun with the FULL final leg set (VERDICT r3 item 1).

The committed regression_maccs_strict_full.json had 9 legs — the honest
push's four strongest legs (ckrr / tkrr / morgan-bit GBDT / transfer) were
absent, so the honest-vs-strict comparison overstated the leak price. This
run mirrors scripts/round3_final_push.py's honest config lever-for-lever
wherever the strict protocol permits:

- kernel_n_folds is IGNORED under strict as of round 5 (ADVICE r4 medium:
  a non-nested 50-fold kernel split fed the cross-fitted meta train-row
  predictions from models that saw that meta-fold's test labels). The
  kernel legs fit on the MAIN folds — every fitted statistic (descriptor
  scaler, RBF bandwidth, IDF bit weights, the kernel solve) from that
  fold's train rows only, fully aligned with the meta's cross-fitting.
  Round-5 rerun of this script supersedes the round-4 artifact (preserved
  as regression_maccs_strict_r4_misaligned.json).
- ckrr_idf=True with per-fold IDF.
- fp_tree_legs=("morgan",) and the transfer leg use transform-free,
  leak-screened features that are strict-valid by construction.
- aux-pretrained warm starts train on the leak-screened classification set
  (no regression molecule is ever seen; train.aux_pretrain doc).
- split_repeats / nn_split_mix stay OFF: the strict per-fold tree features
  are built for the primary split only (disclosed in RESULTS.md).

Run: python -u scripts/round4_strict.py
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


def log(msg):
    print(f"[r4st +{time.time()-T0:7.0f}s] {msg}", flush=True)


import jax
import jax.numpy as jnp

assert float(jnp.ones((64, 64)).sum()) == 4096.0
log(f"devices: {jax.devices()}")

from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.regression import RegressionTrainConfig, run_regression

best = {}
if os.path.exists(TUNED):
    with open(TUNED) as f:
        best = json.load(f)

cfg = RegressionTrainConfig(
    protocol="strict", graph_leg=True, bert_leg=True,
    bert_pretrained_dir=PRE_DIR,
    nn_seeds=4, graph_seeds=3, bert_seeds=3, tree_seeds=3,
    kernel_n_folds=50, ckrr_idf=True,
    meta="linear", transfer_leg=True, transfer_models=("tknn",),
    fp_tree_legs=("morgan",),
    out_dir=f"{OUT}/reg_maccs_strict_r4")
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

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw1.pkl")
log("strict full-leg run starting")
res = run_regression(cfg, data=data, verbose=True)
# keep the 9-leg round-3 artifact for provenance; the full-leg run becomes
# the canonical strict file
old = f"{OUT}/regression_maccs_strict_full.json"
if os.path.exists(old):
    with open(old) as f:
        prev = json.load(f)
    if "ckrr" not in prev:
        with open(f"{OUT}/regression_maccs_strict_r3_9leg.json", "w") as f:
            json.dump(prev, f, indent=1)
    else:
        # round-4 full-leg artifact used the misaligned fine-kernel split
        # (ADVICE r4 medium) — keep it for the before/after comparison
        mis = f"{OUT}/regression_maccs_strict_r4_misaligned.json"
        if not os.path.exists(mis):
            with open(mis, "w") as f:
                json.dump(prev, f, indent=1)
with open(old, "w") as f:
    json.dump(res.report, f, indent=1)
log(f"strict done -> {old} (stacked R2={res.report['stacked']['r2']:.4f})")
