"""Round-3 split-seed variance runs: the EXACT final-push honest config at a
different fold-split seed (``sys.argv[1]``, e.g. 43). The driver north star
(R² ≈ 0.70) is a single-split reference artifact; running the identical
honest pipeline at several split seeds turns our headline into a
distribution (results/regression_maccs_honest_seed<N>.json) instead of one
draw. CPU proxy of the same question: scripts/estimate_split_variance.py.

Run: python -u scripts/round3_split_seeds.py 43
"""
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

SEED = int(sys.argv[1]) if len(sys.argv) > 1 else 43
T0 = time.time()
OUT = "/root/repo/results"
TUNED = os.path.join(OUT, "regression_tuned_params.json")
PRE_DIR = "/root/repo/.bench_cache/bert_pretrained"


def log(msg):
    print(f"[r3sv{SEED} +{time.time()-T0:7.0f}s] {msg}", flush=True)


target = f"{OUT}/regression_maccs_honest_seed{SEED}.json"
if os.path.exists(target):
    log(f"{target} already exists; skipping")
    sys.exit(0)

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

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")

cfg = RegressionTrainConfig(
    protocol="honest", graph_leg=True, bert_leg=True,
    bert_pretrained_dir=PRE_DIR,
    nn_seeds=4, graph_seeds=3, bert_seeds=3, tree_seeds=3,
    split_repeats=2, nn_split_mix=True, kernel_n_folds=50,
    meta="linear", transfer_leg=True, transfer_models=("tknn",),
    fp_tree_legs=("morgan",), ckrr_idf=True,
    seed=SEED,
    out_dir=f"{OUT}/reg_maccs_honest_seed{SEED}")
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

log(f"honest push config at split seed {SEED} starting")
res = run_regression(cfg, data=data, verbose=True)
with open(target, "w") as f:
    json.dump(res.report, f, indent=1)
log(f"seed {SEED} done: stacked R2={res.report['stacked']['r2']:.4f} -> {target}")
