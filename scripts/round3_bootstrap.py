"""Rebuild the gitignored .bench_cache prerequisites after a container
restart wiped them (preprocess pickles, MLM-pretrained SMILES encoder, the
aux-pretrained MPNN trunk), so the queued round-3 stages
(round3_final_push / round3_classification / bench / round3_strict_only)
can run unchanged.

Idempotent: every stage skips if its artifact already exists. The aux-graph
stage re-keys ``regression_tuned_params.json``'s aux_pretrain.graph.path to
the regenerated pickle (the content-hash cache name depends only on the
AuxPretrainConfig, which is reproduced verbatim from
scripts/round3_transfer_campaign.py, so the trunk matches the A/B "KEEP"
decision already recorded there).

Run: python -u scripts/round3_bootstrap.py
"""
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")
os.environ.setdefault("BBBP_TRANSFER_CACHE", "/root/repo/.bench_cache")

T0 = time.time()
CACHE = "/root/repo/.bench_cache"
TUNED = "/root/repo/results/regression_tuned_params.json"
PRE_DIR = os.path.join(CACHE, "bert_pretrained")
os.makedirs(CACHE, exist_ok=True)


def log(msg):
    print(f"[r3boot +{time.time()-T0:7.0f}s] {msg}", flush=True)


import jax
import jax.numpy as jnp

assert float(jnp.ones((64, 64)).sum()) == 4096.0
log(f"devices: {jax.devices()}")

# ---- stage 1: preprocess caches (host-side, C++ featurizer) ----------------
from bbbp.pipelines.preprocess import (PreprocessConfig, ProcessedData,
                                       preprocess_regression)

for keep_raw in (False, True):
    path = os.path.join(CACHE, f"pp_maccs_raw{int(keep_raw)}.pkl")
    if os.path.exists(path):
        log(f"{path} cached")
        continue
    t0 = time.time()
    d = preprocess_regression(PreprocessConfig(fp_kind="maccs",
                                               keep_raw=keep_raw, workers=1))
    d.save(path)
    log(f"preprocess keep_raw={keep_raw}: N={len(d.y)} "
        f"desc={None if d.desc_norm is None else d.desc_norm.shape} "
        f"({time.time()-t0:.0f}s) -> {path}")

# ---- stage 2: MLM pretraining (device) -------------------------------------
if not os.path.exists(os.path.join(PRE_DIR, "params.pkl")):
    from bbbp.train.bert_pretrain import MLMPretrainConfig, pretrain

    log("MLM pretraining (120k corpus, 2 epochs)...")
    t0 = time.time()
    pretrain(MLMPretrainConfig(corpus_size=120_000, epochs=2, batch_size=256,
                               out_dir=PRE_DIR))
    log(f"MLM pretrain done ({time.time()-t0:.0f}s)")
else:
    log("MLM pretrained dir cached")

# ---- stage 3: aux-graph pretraining (device) -------------------------------
# Same config as round3_transfer_campaign.py stage 1 (the A/B test KEPT the
# graph warm start and DROPPED the multimodal one, so only graph is rebuilt).
from bbbp.train.aux_pretrain import (AuxPretrainConfig, load_warm_start,
                                     pretrain_aux)

cfg_p = AuxPretrainConfig(kind="graph", epochs=30, graph_hidden=192,
                          graph_layers=5)
t0 = time.time()
path = pretrain_aux(cfg_p, verbose=True)          # cache-keyed; skips if hit
_, auc = load_warm_start(path)
log(f"aux graph pretrain: AUC={auc:.4f} ({time.time()-t0:.0f}s) -> {path}")

# ---- stage 4: cached screening model (bench.py + chunk probe need it) ------
sm_path = os.path.join(CACHE, "screening_model.pkl")
if not os.path.exists(sm_path):
    from bbbp.pipelines.screen import train_default_model

    t0 = time.time()
    train_default_model(workers=1).save(sm_path)
    log(f"screening model trained ({time.time()-t0:.0f}s) -> {sm_path}")
else:
    log("screening model cached")

state = {}
if os.path.exists(TUNED):
    with open(TUNED) as f:
        state = json.load(f)
aux = state.setdefault("aux_pretrain", {})
aux["graph"] = {"path": path, "use": True}
aux.setdefault("multimodal", {"path": "", "use": False})
with open(TUNED, "w") as f:
    json.dump(state, f, indent=1)
log(f"updated {TUNED} aux_pretrain.graph.path")
log("BOOTSTRAP DONE")
