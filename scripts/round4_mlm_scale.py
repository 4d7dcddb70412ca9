"""Estimate: does a 3x MLM pretraining corpus lift the SMILES-encoder leg?
(VERDICT r3 item 10 — estimate-gated; adopt only on measured gain.)

The SMILES leg is the weakest deep leg (honest OOF R2 0.456) and its MLM
corpus is 120k generated molecules (no offline ZINC tranches exist in this
image — data.zinc.synthetic_smiles is the only scalable source, plus the
8.8k real B3DB molecules). This measures a 360k-corpus MLM against the
cached 120k one on the leg itself and on the stack (swap the smiles column
in the saved honest OOF matrix, refit the linear meta — the ESTIMATES.md
methodology). Adoption bar: leg R2 >= ~0.50 and stack moves.

Run: python -u scripts/round4_mlm_scale.py
"""
import json
import os
import pickle
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

import numpy as np

T0 = time.time()
CACHE = "/root/repo/.bench_cache"
DIR_120 = os.path.join(CACHE, "bert_pretrained")
DIR_360 = os.path.join(CACHE, "bert_pretrained_360k")


def log(m):
    print(f"[r4mlm +{time.time()-T0:6.0f}s] {m}", flush=True)


import jax
import jax.numpy as jnp

assert float(jnp.ones((64, 64)).sum()) == 4096.0
log(f"devices: {jax.devices()}")

from bbbp.models.bert import BertRegressor, SmilesTokenizer
from bbbp.pipelines.preprocess import ProcessedData
from bbbp.train.bert_pretrain import MLMPretrainConfig, pretrain
from bbbp.train.loop import train_cv

# ---- 3x-corpus MLM (cached across retries) --------------------------------
if not os.path.exists(os.path.join(DIR_360, "params.pkl")):
    t0 = time.time()
    pretrain(MLMPretrainConfig(corpus_size=360_000, epochs=2, batch_size=256,
                               out_dir=DIR_360), verbose=True)
    log(f"360k MLM pretrain done ({time.time()-t0:.0f}s)")
else:
    log("360k MLM cached")

data = ProcessedData.load(os.path.join(CACHE, "pp_maccs_raw0.pkl"))
y = data.y
best = {}
tuned_path = "/root/repo/results/regression_tuned_params.json"
if os.path.exists(tuned_path):
    with open(tuned_path) as f:
        best = json.load(f)
bert_lr = float(best.get("smiles", {}).get("learning_rate", 2e-4))


def smiles_leg_oof(pre_dir, seeds=2):
    """The honest run's SMILES leg, verbatim (train.regression bert block)."""
    with open(os.path.join(pre_dir, "tokenizer.json")) as f:
        tok = SmilesTokenizer.from_json(f.read())
    with open(os.path.join(pre_dir, "config.json")) as f:
        pcfg = json.load(f)
    with open(os.path.join(pre_dir, "params.pkl"), "rb") as f:
        warm = {"enc": pickle.load(f)}
    ids = tok.encode_batch(data.smiles)
    bmodel = BertRegressor(vocab_size=tok.vocab_size,
                           n_layers=pcfg["n_layers"],
                           d_model=pcfg["d_model"], max_len=pcfg["max_len"])
    acc = None
    for r in range(seeds):
        res = train_cv(bmodel, (ids,), y, n_folds=10, epochs=40,
                       batch_size=32, lr=bert_lr, seed=42 + 3000 + 1000 * r,
                       split_seed=42, warm_start=warm, snapshot_from=30,
                       log_every=0)
        acc = res.oof_pred if acc is None else acc + res.oof_pred
    return np.asarray(acc) / seeds


def r2(p):
    return float(1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum())


with open("/root/repo/results/reg_maccs_honest_r3/oof_predictions.pkl",
          "rb") as f:
    saved = pickle.load(f)
legs = {k: (v / 3.0 if k in ("rf", "gbdt", "cat") else v)
        for k, v in saved.items() if k not in ("y", "stacked")}


def stack_r2(smiles_col):
    from sklearn.linear_model import LinearRegression

    cols = dict(legs)
    cols["smiles"] = smiles_col
    X = np.stack(list(cols.values()), 1)
    p = LinearRegression().fit(X, y).predict(X)
    return r2(p)


out = {}
for name, d in (("120k", DIR_120), ("360k", DIR_360)):
    t0 = time.time()
    col = smiles_leg_oof(d)
    out[name] = {"leg_r2": r2(col), "stack_r2": stack_r2(col),
                 "wall_s": time.time() - t0}
    log(f"{name}: leg R2={out[name]['leg_r2']:.4f} "
        f"stack R2={out[name]['stack_r2']:.4f} "
        f"({out[name]['wall_s']:.0f}s)")

with open("/root/repo/results/estimate_mlm_scale.json", "w") as f:
    json.dump(out, f, indent=1)
log(f"DONE delta_leg={out['360k']['leg_r2']-out['120k']['leg_r2']:+.4f} "
    f"delta_stack={out['360k']['stack_r2']-out['120k']['stack_r2']:+.4f}")
