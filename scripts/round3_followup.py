"""Round-3 follow-up: the flagship-NN hyperparameter search (chunked under
the replica HBM cap after the 40-replica OOM), then — only if the search
beats the hand-set default meaningfully — re-run the honest/strict finals
with the tuned NN and out_dir artifacts (OOF pickle for later re-stacking).

Run: python -u scripts/round3_followup.py
"""
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np

T0 = time.time()
OUT = "/root/repo/results"
TUNED = os.path.join(OUT, "regression_tuned_params.json")
PRE_DIR = "/root/repo/.bench_cache/bert_pretrained"


def log(msg):
    print(f"[r3fu +{time.time()-T0:7.0f}s] {msg}", flush=True)


import jax
import jax.numpy as jnp

assert float(jnp.ones((64, 64)).sum()) == 4096.0
log(f"devices: {jax.devices()}")

from bbbp.models.transformer_cnn import MultiModalRegressor
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.nn_search import search_nn_cv
from bbbp.train.regression import RegressionTrainConfig, run_regression

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = data.y
n = len(y)
nn_fp = data.nn_fp_features()
img = data.img_norm.reshape(n, 128, 128, 3)

best = {}
if os.path.exists(TUNED):
    with open(TUNED) as f:
        best = json.load(f)

res = search_nn_cv(
    lambda n_layers=4: MultiModalRegressor(
        fp_dim=nn_fp.shape[1], n_layers=n_layers, fusion="multihead",
        fp_tokens=1),
    (nn_fp, img), y,
    space={"learning_rate": {"low": 1.2e-4, "high": 1.2e-3, "log": True},
           "weight_decay": {"low": 1e-6, "high": 3e-4, "log": True},
           "n_layers": [4, 5]},
    n_iter=12, n_folds=5, epochs=40, snapshot_from=33, batch_size=32,
    seed=11, max_replicas=15,
    extra_trials=[{"learning_rate": 3e-4, "weight_decay": 1e-5,
                   "n_layers": 4}],          # trial 0 = hand-set default
    verbose=True)
best["nn"] = {**res.best_params, "search_r2": res.best_score}
with open(TUNED, "w") as f:
    json.dump(best, f, indent=1)
log(f"nn search best: {best['nn']}")

# the honest final reruns unconditionally: it uses the search winner (which
# is the default config unless a trial beat it on the same split — trial 0
# IS the default) and, unlike the campaign final, writes the out_dir OOF
# artifacts for offline re-stacking
default_r2 = res.trials[0]["oof_r2"]
log(f"nn best {res.best_score:.4f} vs default {default_r2:.4f} "
    f"on the shared 5-fold split")
rerun = True

if rerun:
    # honest only: the campaign's strict final already demonstrates the
    # fixed per-fold affine; the honest number is the north-star metric
    for protocol in ("honest",):
        d = (data if protocol == "honest" else
             ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw1.pkl"))
        cfg = RegressionTrainConfig(
            protocol=protocol, graph_leg=True, bert_leg=True,
            bert_pretrained_dir=PRE_DIR,
            nn_seeds=4, graph_seeds=3, bert_seeds=3, tree_seeds=3,
            meta="nnls",
            lr=float(best["nn"]["learning_rate"]),
            n_layers=int(best["nn"].get("n_layers", 4)),
            out_dir=f"{OUT}/reg_maccs_{protocol}_r3")
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
        log(f"final {protocol} run (tuned NN) starting")
        r = run_regression(cfg, data=d, verbose=True)
        out = f"{OUT}/regression_maccs_{protocol}_full.json"
        with open(out, "w") as f:
            json.dump(r.report, f, indent=1)
        log(f"{protocol} done -> {out} "
            f"(stacked R2={r.report['stacked']['r2']:.4f})")
log("FOLLOWUP DONE")
