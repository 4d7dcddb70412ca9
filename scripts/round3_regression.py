"""Round-3 regression campaign (VERDICT r2 items #1/#2): ONE process so every
compiled program (forest statics, NN epoch fns) is paid once.

Stages (each writes its artifact immediately; later stages survive earlier
failures by falling back to round-2 defaults):
  0. device check
  1. forest-leg hyperparameter search, (trial x fold) on the honest features
     (train.batched_search._forest_cv, classify=False, R2 scoring)
  2. NN-leg search: traced lr/weight-decay trials on the seed-replica axis
     (train.nn_search), flagship Transformer+CNN
  3. MPNN-leg search, same mechanism
  4. SMILES-leg (pretrained) lr search
  5. final honest run: tuned params, widened seed ensembles, all meta
     variants reported
  6. final strict run (leak-free) with the fixed per-fold affine
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
    print(f"[r3reg +{time.time()-T0:7.0f}s] {msg}", flush=True)


def save_stage(name, obj):
    state = {}
    if os.path.exists(TUNED):
        with open(TUNED) as f:
            state = json.load(f)
    state[name] = obj
    with open(TUNED, "w") as f:
        json.dump(state, f, indent=1)


# ---- stage 0: first-op check ----------------------------------------------
import jax
import jax.numpy as jnp

assert float(jnp.ones((64, 64)).sum()) == 4096.0
log(f"devices: {jax.devices()}")

from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.regression import (RegressionTrainConfig,
                                   _tree_features_global, run_regression)

data = ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw0.pkl")
y = data.y
n = len(y)
log(f"honest data N={n} desc={data.desc_norm.shape}")

best = {}

# ---- stage 1: forest search ------------------------------------------------
try:
    from bbbp.train.batched_search import _forest_cv
    from bbbp.train.loop import kfold_indices
    from bbbp.train.search import _sample_params

    xt = _tree_features_global(data)
    folds5 = kfold_indices(n, 5, 42)
    rng = np.random.default_rng(7)

    def forest_search(name, statics, dists, n_iter):
        params = []
        for _ in range(n_iter):
            p = dict(statics)
            p.update(_sample_params(dists, rng))
            params.append(p)
        t0 = time.time()
        r2s = _forest_cv(xt, y, folds5, params, classify=False,
                         verbose=True)[0]
        b = int(np.argmax(r2s))
        log(f"{name}: best r2={r2s[b]:.4f} {params[b]} "
            f"({time.time()-t0:.0f}s for {n_iter} trials)")
        return {**params[b], "search_r2": float(r2s[b])}

    # statics match the final-run shapes exactly -> compiles amortize.
    # NOTE (run 1, live): a 14-trial gbdt search measured the landscape FLAT
    # (cv r2 0.601-0.611 across lr 0.032-0.083, lambda 1.4-7.0, wide
    # sub/colsample) at ~2.5 min/trial — forest searches are low-ROI here,
    # so only a small gbdt sweep runs and cat/rf keep the round-2 tuned
    # defaults; the device budget goes to the NN-leg searches instead.
    if os.environ.get("R3_FOREST_SEARCH", "small") != "off":
        best["gbdt"] = forest_search(
            "gbdt", {"n_estimators": 400, "max_depth": 6},
            {"learning_rate": {"low": 0.02, "high": 0.12, "log": True},
             "reg_lambda": {"low": 0.3, "high": 10.0, "log": True},
             "subsample": {"low": 0.6, "high": 1.0},
             "colsample": {"low": 0.5, "high": 1.0}}, 6)
        save_stage("gbdt", best["gbdt"])
except Exception as e:  # noqa: BLE001
    log(f"forest search FAILED ({type(e).__name__}: {e}); using defaults")

# ---- stage 2: NN search ----------------------------------------------------
from bbbp.models.transformer_cnn import MultiModalRegressor
from bbbp.train.nn_search import search_nn_cv

nn_fp = data.nn_fp_features()
img = data.img_norm.reshape(n, 128, 128, 3)
try:
    res = search_nn_cv(
        lambda n_layers=4: MultiModalRegressor(
            fp_dim=nn_fp.shape[1], n_layers=n_layers, fusion="multihead",
            fp_tokens=1),
        (nn_fp, img), y,
        space={"learning_rate": {"low": 1.2e-4, "high": 1.2e-3, "log": True},
               "weight_decay": {"low": 1e-6, "high": 3e-4, "log": True},
               "n_layers": [4, 5]},
        n_iter=16, n_folds=5, epochs=40, snapshot_from=33, batch_size=32,
        seed=11, verbose=True)
    best["nn"] = {**res.best_params, "search_r2": res.best_score}
    save_stage("nn", best["nn"])
    log(f"nn search best: {best['nn']}")
except Exception as e:  # noqa: BLE001
    log(f"nn search FAILED ({type(e).__name__}: {e}); using defaults")

# ---- stage 3: MPNN search --------------------------------------------------
try:
    from bbbp.chem.graph_features import graph_features
    from bbbp.models.gnn import MPNNRegressor

    feats, _, adj_t, mask, _ = graph_features(data.smiles, max_atoms=128,
                                              edge_types=True)
    res = search_nn_cv(
        lambda hidden=192, n_layers=5: MPNNRegressor(hidden=hidden,
                                                     n_layers=n_layers),
        (feats, adj_t, mask), y,
        space={"learning_rate": {"low": 3e-4, "high": 2e-3, "log": True},
               "weight_decay": {"low": 1e-6, "high": 1e-4, "log": True},
               "hidden": [192, 256]},
        n_iter=10, n_folds=5, epochs=60, snapshot_from=48, batch_size=32,
        seed=12, verbose=True)
    best["graph"] = {**res.best_params, "search_r2": res.best_score}
    save_stage("graph", best["graph"])
    log(f"graph search best: {best['graph']}")
except Exception as e:  # noqa: BLE001
    log(f"graph search FAILED ({type(e).__name__}: {e}); using defaults")

# ---- stage 4: SMILES-leg lr search -----------------------------------------
try:
    import pickle

    from bbbp.models.bert import BertRegressor, SmilesTokenizer

    with open(os.path.join(PRE_DIR, "tokenizer.json")) as f:
        tok = SmilesTokenizer.from_json(f.read())
    with open(os.path.join(PRE_DIR, "config.json")) as f:
        pcfg = json.load(f)
    with open(os.path.join(PRE_DIR, "params.pkl"), "rb") as f:
        warm = {"enc": pickle.load(f)}
    ids = tok.encode_batch(data.smiles)
    bmodel = BertRegressor(vocab_size=tok.vocab_size,
                           n_layers=pcfg["n_layers"],
                           d_model=pcfg["d_model"], max_len=pcfg["max_len"])
    res = search_nn_cv(
        lambda: bmodel, (ids,), y,
        space={"learning_rate": {"low": 5e-5, "high": 6e-4, "log": True},
               "weight_decay": {"low": 1e-6, "high": 1e-4, "log": True}},
        n_iter=8, n_folds=5, epochs=40, snapshot_from=32, batch_size=32,
        seed=13, warm_start=warm, verbose=True)
    best["smiles"] = {**res.best_params, "search_r2": res.best_score}
    save_stage("smiles", best["smiles"])
    log(f"smiles search best: {best['smiles']}")
except Exception as e:  # noqa: BLE001
    log(f"smiles search FAILED ({type(e).__name__}: {e}); using defaults")

# ---- stage 5+6: final runs -------------------------------------------------
with open(TUNED) as f:
    best = json.load(f)


def tuned_cfg(protocol):
    cfg = RegressionTrainConfig(
        protocol=protocol, graph_leg=True, bert_leg=True,
        bert_pretrained_dir=PRE_DIR,
        nn_seeds=4, graph_seeds=3, bert_seeds=3, tree_seeds=3,
        meta="nnls")
    if "nn" in best:
        cfg.lr = float(best["nn"]["learning_rate"])
        cfg.n_layers = int(best["nn"].get("n_layers", 4))
        cfg.fp_tokens = int(best["nn"].get("fp_tokens", 1))
    if "graph" in best:
        cfg.graph_lr = float(best["graph"]["learning_rate"])
        cfg.graph_hidden = int(best["graph"].get("hidden", 192))
    if "smiles" in best:
        cfg.bert_lr = float(best["smiles"]["learning_rate"])
    for leg in ("gbdt", "cat"):
        if leg in best:
            p = best[leg]
            setattr(cfg, f"{leg}_trees", int(p["n_estimators"]))
            setattr(cfg, f"{leg}_lr", float(p["learning_rate"]))
            setattr(cfg, f"{leg}_depth", int(p["max_depth"]))
            setattr(cfg, f"{leg}_subsample", float(p.get("subsample", 0.8)))
            setattr(cfg, f"{leg}_colsample", float(p.get("colsample", 1.0)))
            setattr(cfg, f"{leg}_lambda", float(p.get("reg_lambda", 1.0)))
    if "rf" in best:
        cfg.rf_trees = int(best["rf"]["n_estimators"])
        cfg.rf_depth = int(best["rf"]["max_depth"])
        cfg.rf_colsample = float(best["rf"].get("colsample", 1.0))
        cfg.rf_lambda = float(best["rf"].get("reg_lambda", 1e-6))
    return cfg


for protocol in ("honest", "strict"):
    d = (data if protocol == "honest"
         else ProcessedData.load("/root/repo/.bench_cache/pp_maccs_raw1.pkl"))
    cfg = tuned_cfg(protocol)
    log(f"final {protocol} run starting")
    res = run_regression(cfg, data=d, verbose=True)
    out = f"{OUT}/regression_maccs_{protocol}_full.json"
    with open(out, "w") as f:
        json.dump(res.report, f, indent=1)
    log(f"{protocol} done -> {out} "
        f"(stacked R2={res.report['stacked']['r2']:.4f})")
log("ALL DONE")
