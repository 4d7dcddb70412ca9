"""Round-3 transfer campaign — the north-star push (honest stacked R2>=0.70).

Stages (ONE process so compiled programs amortize):
  1. aux-pretrain the MPNN trunk on the 6.4k leak-screened classification
     molecules (train.aux_pretrain, kind=graph) — holdout AUC reported
  2. aux-pretrain the multimodal Transformer+CNN trunk (kind=multimodal)
  3. A/B check each warm start on a quick 5-fold CV (same jit for warm and
     cold — only the initial params differ); keep a warm start only if it
     does not hurt
  4. final honest run: every leg (incl. the new ckrr combined-kernel and
     tkrr legs), split_repeats=2, warm starts per the A/B, linear meta,
     out_dir artifacts
  5. final strict run: same minus split_repeats
"""
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import numpy as np

T0 = time.time()
OUT = "/root/repo/results"
TUNED = os.path.join(OUT, "regression_tuned_params.json")
PRE_DIR = "/root/repo/.bench_cache/bert_pretrained"


def log(msg):
    print(f"[r3tc +{time.time()-T0:7.0f}s] {msg}", flush=True)


import jax
import jax.numpy as jnp

assert float(jnp.ones((64, 64)).sum()) == 4096.0
log(f"devices: {jax.devices()}")

from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.aux_pretrain import (AuxPretrainConfig, load_warm_start,
                                     pretrain_aux)
from bbbp.train.regression import RegressionTrainConfig, run_regression
from bbbp.train.loop import train_cv

best = {}
if os.path.exists(TUNED):
    with open(TUNED) as f:
        best = json.load(f)

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = data.y
n = len(y)

# tuned flagship-NN shape/lr (round3_followup search) — the pretrain
# architecture must match the final's or the warm start won't broadcast
NN_LAYERS = int(best.get("nn", {}).get("n_layers", 4))
NN_LR = float(best.get("nn", {}).get("learning_rate", 3e-4))

# ---- stage 1+2: aux pretraining -------------------------------------------
paths = {}
for kind, cfg_p in (
    ("graph", AuxPretrainConfig(kind="graph", epochs=30, graph_hidden=192,
                                graph_layers=5)),
    ("multimodal", AuxPretrainConfig(kind="multimodal", epochs=25,
                                     nn_layers=NN_LAYERS)),
):
    try:
        t0 = time.time()
        paths[kind] = pretrain_aux(cfg_p, verbose=True)
        _, auc = load_warm_start(paths[kind])
        log(f"aux pretrain {kind}: AUC={auc:.4f} ({time.time()-t0:.0f}s) "
            f"-> {paths[kind]}")
    except Exception as e:  # noqa: BLE001
        log(f"aux pretrain {kind} FAILED ({type(e).__name__}: {e})")

# ---- stage 3: A/B warm-vs-cold quick checks --------------------------------
use_warm = {}


def quick_r2(oof):
    return 1 - ((y - oof) ** 2).sum() / ((y - y.mean()) ** 2).sum()


if "graph" in paths:
    from bbbp.chem.graph_features import graph_features
    from bbbp.models.gnn import MPNNRegressor

    feats, _, adj_t, mask, _ = graph_features(data.smiles, max_atoms=128,
                                              edge_types=True)
    gmodel = MPNNRegressor(hidden=192, n_layers=5)
    g_lr = float(best.get("graph", {}).get("learning_rate", 7e-4))
    warm_params, _ = load_warm_start(paths["graph"])
    scores = {}
    for name, ws in (("cold", None), ("warm", warm_params)):
        res = train_cv(gmodel, (feats, adj_t, mask), y, n_folds=5,
                       epochs=60, batch_size=32, lr=g_lr, seed=4242,
                       split_seed=4242, snapshot_from=48, warm_start=ws)
        scores[name] = quick_r2(res.oof_pred)
        log(f"graph A/B {name}: 5-fold oof R2={scores[name]:.4f}")
    use_warm["graph"] = scores["warm"] >= scores["cold"] - 0.005
    log(f"graph warm start: {'KEEP' if use_warm['graph'] else 'DROP'}")

if "multimodal" in paths:
    from bbbp.models.transformer_cnn import MultiModalRegressor

    nn_fp = data.nn_fp_features()
    img = data.img_norm.reshape(n, 128, 128, 3)
    nmodel = MultiModalRegressor(fp_dim=nn_fp.shape[1], n_layers=NN_LAYERS,
                                 fusion="multihead", fp_tokens=1)
    warm_params, _ = load_warm_start(paths["multimodal"])
    scores = {}
    for name, ws in (("cold", None), ("warm", warm_params)):
        res = train_cv(nmodel, (nn_fp, img), y, n_folds=5,
                       epochs=40, batch_size=32, lr=NN_LR, seed=4242,
                       split_seed=4242, snapshot_from=33, warm_start=ws)
        scores[name] = quick_r2(res.oof_pred)
        log(f"nn A/B {name}: 5-fold oof R2={scores[name]:.4f}")
    use_warm["nn"] = scores["warm"] >= scores["cold"] - 0.005
    log(f"nn warm start: {'KEEP' if use_warm['nn'] else 'DROP'}")

state = dict(best)
state["aux_pretrain"] = {k: {"path": p, "use": bool(use_warm.get(
    "nn" if k == "multimodal" else k, False))} for k, p in paths.items()}
with open(TUNED, "w") as f:
    json.dump(state, f, indent=1)

# ---- stage 4+5: final runs -------------------------------------------------
def final_cfg(protocol):
    cfg = RegressionTrainConfig(
        protocol=protocol, graph_leg=True, bert_leg=True,
        bert_pretrained_dir=PRE_DIR,
        nn_seeds=4, graph_seeds=3, bert_seeds=3, tree_seeds=3,
        split_repeats=2 if protocol == "honest" else 1,
        meta="linear", transfer_leg=True, transfer_models=("tknn",),
        out_dir=f"{OUT}/reg_maccs_{protocol}_r3")
    if "nn" in best:
        cfg.lr = NN_LR
        cfg.n_layers = NN_LAYERS
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
    if use_warm.get("graph"):
        cfg.graph_pretrained = paths["graph"]
    if use_warm.get("nn"):
        cfg.nn_pretrained = paths["multimodal"]
    return cfg


for protocol in ("honest", "strict"):
    d = (data if protocol == "honest"
         else ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw1.pkl"))
    log(f"final {protocol} run starting")
    res = run_regression(final_cfg(protocol), data=d, verbose=True)
    out = f"{OUT}/regression_maccs_{protocol}_full.json"
    with open(out, "w") as f:
        json.dump(res.report, f, indent=1)
    log(f"{protocol} done -> {out} "
        f"(stacked R2={res.report['stacked']['r2']:.4f})")
log("ALL DONE")
