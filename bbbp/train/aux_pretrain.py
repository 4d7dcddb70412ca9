"""Supervised pretraining of the regression NN legs on the aux
classification set (representation transfer).

Output-level transfer (train.transfer P(BBB+) columns) measures weak on the
regression task — the binary boundary saturates away the logBB magnitude.
Representation transfer goes deeper: train the SAME architectures used by the
regression legs (models.gnn.MPNNRegressor, models.transformer_cnn.
MultiModalRegressor) as binary BBB+/- classifiers on the 6.4k leak-screened
aux molecules (train.transfer.aux_classification_set — no regression molecule
is ever seen), then warm-start the regression fold training from the learned
trunk (train.loop.train_cv ``warm_start`` broadcasts matching leaves; the
output head is dropped so each fold keeps its random regression head).

This is the same mechanism as the MLM-pretrained SMILES leg
(train.bert_pretrain), applied to the graph and multimodal legs with real
supervision instead of masking. A validation holdout AUC is reported so the
pretraining quality is measured, not asserted.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import re
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from bbbp.train.transfer import aux_classification_set


@dataclass
class AuxPretrainConfig:
    kind: str = "graph"             # graph | multimodal
    epochs: int = 30
    batch_size: int = 64
    lr: float = 5e-4
    weight_decay: float = 1e-5
    val_frac: float = 0.1
    seed: int = 17
    # graph leg shape (must match RegressionTrainConfig.graph_*)
    max_atoms: int = 128
    graph_hidden: int = 192
    graph_layers: int = 5
    # multimodal leg shape (must match the regression NN config)
    fp_dim: int = 198               # maccs 167 + 31 descriptors
    nn_layers: int = 4
    fusion: str = "multihead"
    fp_tokens: int = 1
    image_size: int = 128
    cache_dir: Optional[str] = None  # also via BBBP_TRANSFER_CACHE


def _cache_path(cfg: AuxPretrainConfig) -> Optional[str]:
    d = cfg.cache_dir or os.environ.get("BBBP_TRANSFER_CACHE")
    if not d:
        return None
    key = hashlib.sha1(repr(sorted(dataclasses.asdict(cfg).items())
                            ).encode()).hexdigest()[:16]
    return os.path.join(d, f"aux_pretrained_{cfg.kind}_{key}.pkl")


def drop_output_dense(params: dict) -> dict:
    """Remove the highest-numbered top-level anonymous ``Dense_k`` (the
    output layer in both MPNNRegressor and MultiModalRegressor) so the
    warm-started regression folds keep their random regression head."""
    dense = [(int(m.group(1)), k) for k in params
             for m in [re.match(r"Dense_(\d+)$", k)] if m]
    if not dense:
        return params
    _, drop = max(dense)
    return {k: v for k, v in params.items() if k != drop}


def _fit_binary(model, inputs, y, cfg: AuxPretrainConfig, verbose: bool):
    """Fit ONE flax model with sigmoid BCE on (inputs, y); returns
    (numpy params, holdout AUC). Whole dataset device-resident; minibatch
    row gathers inside the jitted step (bert_pretrain's loop pattern)."""
    import jax
    import jax.numpy as jnp
    import optax

    from bbbp.train.transfer import _auc

    n = len(y)
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(n)
    n_val = int(round(cfg.val_frac * n))
    val_idx, tr_idx = perm[:n_val], perm[n_val:]

    def dtype_of(a):
        if np.issubdtype(np.asarray(a).dtype, np.integer):
            return jnp.int32
        return jnp.bfloat16 if np.asarray(a).ndim >= 3 else jnp.float32

    inputs_d = tuple(jnp.asarray(a, dtype_of(a)) for a in inputs)
    y_d = jnp.asarray(y, jnp.float32)
    bs = min(cfg.batch_size, len(tr_idx))
    steps = max(1, len(tr_idx) // bs)
    total = cfg.epochs * steps
    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.lr, max(1, total // 20), max(2, total))
    tx = optax.adamw(sched, weight_decay=cfg.weight_decay)
    root = jax.random.PRNGKey(cfg.seed)

    @jax.jit
    def init_fn(key):
        samples = tuple(a[:2] for a in inputs_d)
        v = model.init({"params": key, "dropout": key}, *samples, train=True)
        return v["params"], tx.init(v["params"])

    params, opt_state = init_fn(root)

    # the full dataset rides as jit ARGUMENTS (device-resident, gathered by
    # idx inside the program) — closing over it would embed hundreds of MB
    # of constants into the serialized computation (a compile request of
    # that size was refused at 6.4k graphs)
    @jax.jit
    def train_step(params, opt_state, data, y_all, idx, key):
        xb = tuple(a[idx] for a in data)
        yb = y_all[idx]

        def loss_fn(p):
            logits = model.apply({"params": p}, *xb, train=True,
                                 rngs={"dropout": key})
            return optax.sigmoid_binary_cross_entropy(logits, yb).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def predict(params, data, idx):
        xb = tuple(a[idx] for a in data)
        return model.apply({"params": params}, *xb, train=False)

    key = root
    loss = np.nan
    for epoch in range(cfg.epochs):
        ep_perm = rng.permutation(len(tr_idx))[: steps * bs]
        order = tr_idx[ep_perm].reshape(steps, bs)
        t_ep = time.time()
        for s in range(steps):
            key, sub = jax.random.split(key)
            params, opt_state, loss = train_step(
                params, opt_state, inputs_d, y_d, jnp.asarray(order[s]), sub)
        if verbose and ((epoch + 1) % 5 == 0 or epoch == cfg.epochs - 1):
            print(f"[aux-pretrain] epoch {epoch+1}/{cfg.epochs} "
                  f"bce={float(loss):.4f} ({time.time()-t_ep:.1f}s)",
                  flush=True)
    # pad the val set to the train batch granularity-free full predict
    logits_val = np.asarray(predict(params, inputs_d, jnp.asarray(val_idx)))
    auc = _auc(np.asarray(y)[val_idx], logits_val)
    if verbose:
        print(f"[aux-pretrain] holdout AUC={auc:.4f} ({n_val} molecules)")
    return jax.tree.map(np.asarray, params), float(auc)


def _aux_images(smiles, size, cache_dir):
    from bbbp.chem.featurize import images

    cpath = None
    if cache_dir:
        key = hashlib.sha1(("img%d\n" % size + "\n".join(smiles)).encode()
                           ).hexdigest()[:16]
        cpath = os.path.join(cache_dir, f"auximg_{key}.npz")
        if os.path.exists(cpath):
            z = np.load(cpath)
            return z["img"], z["ok"]
    res = images(smiles, size=size)
    img = res.features.astype(np.float32)
    ok = res.ok_mask
    if cpath:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(cpath, img=img, ok=ok)
    return img, ok


def pretrain_aux(cfg: AuxPretrainConfig = AuxPretrainConfig(),
                 verbose: bool = True) -> str:
    """Pretrain on the aux set; returns the saved artifact path (pickle with
    {"params", "auc", "config"}). Cached by config hash."""
    cpath = _cache_path(cfg)
    if cpath and os.path.exists(cpath):
        return cpath
    t0 = time.time()
    cache_dir = cfg.cache_dir or os.environ.get("BBBP_TRANSFER_CACHE")
    aux_smiles, aux_y, _ = aux_classification_set(verbose=verbose)
    if cfg.kind == "graph":
        from bbbp.chem.graph_features import graph_features
        from bbbp.models.gnn import MPNNRegressor

        feats, _, adj_t, mask, bad = graph_features(
            aux_smiles, max_atoms=cfg.max_atoms, edge_types=True)
        ok = np.ones(len(aux_smiles), bool)
        ok[list(bad)] = False
        inputs = (feats[ok], adj_t[ok], mask[ok])
        yv = aux_y[ok]
        model = MPNNRegressor(hidden=cfg.graph_hidden,
                              n_layers=cfg.graph_layers)
    elif cfg.kind == "multimodal":
        from bbbp.chem.descriptors import descriptor_matrix
        from bbbp.models.transformer_cnn import MultiModalRegressor
        from bbbp.ops import StandardScaler
        from bbbp.train.transfer import raw_transfer_features

        desc, maccs, _ = raw_transfer_features(aux_smiles, cache_dir=cache_dir)
        img, ok = _aux_images(aux_smiles, cfg.image_size, cache_dir)
        fp = np.concatenate([maccs.astype(np.float32), desc], axis=1)
        if fp.shape[1] != cfg.fp_dim:
            raise ValueError(f"aux fp dim {fp.shape[1]} != cfg.fp_dim "
                             f"{cfg.fp_dim} (regression leg shape mismatch)")
        fp = np.asarray(StandardScaler().fit_transform(fp[ok]),
                        np.float32)
        img_n = np.asarray(StandardScaler().fit_transform(
            img[ok].reshape(ok.sum(), -1)), np.float32).reshape(
            ok.sum(), cfg.image_size, cfg.image_size, 3)
        inputs = (fp, img_n)
        yv = aux_y[ok]
        model = MultiModalRegressor(fp_dim=cfg.fp_dim, n_layers=cfg.nn_layers,
                                    fusion=cfg.fusion,
                                    fp_tokens=cfg.fp_tokens)
    else:
        raise ValueError(f"unknown kind {cfg.kind!r}")
    if verbose:
        print(f"[aux-pretrain] {cfg.kind}: {len(yv)} molecules "
              f"({time.time()-t0:.0f}s featurize)", flush=True)
    params, auc = _fit_binary(model, inputs, yv, cfg, verbose)
    out = cpath or os.path.join("/tmp", f"aux_pretrained_{cfg.kind}.pkl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump({"params": params, "auc": auc,
                     "config": dataclasses.asdict(cfg)}, f)
    if verbose:
        print(f"[aux-pretrain] saved {out} ({time.time()-t0:.0f}s total)")
    return out


def load_warm_start(path: str, drop_output: bool = True) -> Tuple[dict, float]:
    """(warm-start params pytree, pretraining holdout AUC)."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    params = dict(d["params"])
    if drop_output:
        params = drop_output_dense(params)
    return params, float(d.get("auc", float("nan")))
