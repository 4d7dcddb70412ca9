"""One-process round-2 flagship run: MLM pretrain -> honest regression with
all legs -> strict regression (same process reuses every compile)."""
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np

T0 = time.time()


def log(msg):
    print(f"[full +{time.time()-T0:7.0f}s] {msg}", flush=True)


# ---- stage 1: MLM pretraining (skip if artifact exists) --------------------
PRE_DIR = "/root/repo/.bench_cache/bert_pretrained"
if not os.path.exists(os.path.join(PRE_DIR, "params.pkl")):
    from bbbp.train.bert_pretrain import MLMPretrainConfig, pretrain

    log("MLM pretraining...")
    pretrain(MLMPretrainConfig(corpus_size=120_000, epochs=2, batch_size=256,
                               out_dir=PRE_DIR))
    log("pretrain done")
else:
    log("pretrained dir cached")

# ---- stage 2: honest regression, all legs ---------------------------------
from bbbp.pipelines.preprocess import PreprocessConfig, ProcessedData, preprocess_regression
from bbbp.train.regression import RegressionTrainConfig, run_regression


def load_data(keep_raw):
    cache = f"/root/repo/.bench_cache/pp_maccs_raw{int(keep_raw)}.pkl"
    if os.path.exists(cache):
        return ProcessedData.load(cache)
    d = preprocess_regression(PreprocessConfig(fp_kind="maccs",
                                               keep_raw=keep_raw, workers=1))
    d.save(cache)
    return d


for protocol in ("honest", "strict"):
    data = load_data(protocol == "strict")
    # refresh descriptors if the cached preprocess predates the chi upgrade
    if data.desc_norm is not None and data.desc_norm.shape[1] < 31:
        from bbbp.chem.descriptors import descriptor_matrix
        from bbbp.ops import StandardScaler

        log(f"refreshing descriptors for {protocol} cache...")
        desc, _ = descriptor_matrix(data.smiles)
        data.desc_norm = np.asarray(StandardScaler().fit_transform(desc))
        if data.fp_raw is not None:
            data.desc_raw = desc.astype(np.float32)
        data.save(f"/root/repo/.bench_cache/pp_maccs_raw{int(protocol=='strict')}.pkl")
    log(f"{protocol} regression starting (N={len(data.y)}, "
        f"desc={None if data.desc_norm is None else data.desc_norm.shape})")
    cfg = RegressionTrainConfig(
        protocol=protocol, graph_leg=True, bert_leg=True,
        bert_pretrained_dir=PRE_DIR, nn_seeds=3, graph_seeds=2, bert_seeds=2,
        tree_seeds=3)
    res = run_regression(cfg, data=data, verbose=True)
    out = f"/root/repo/results/regression_maccs_{protocol}_full.json"
    with open(out, "w") as f:
        json.dump(res.report, f, indent=1)
    log(f"{protocol} done -> {out} "
        f"(stacked R2={res.report['stacked']['r2']:.4f})")
log("ALL DONE")
