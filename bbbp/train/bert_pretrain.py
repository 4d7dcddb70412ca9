"""SMILES-BERT masked-language-model pretraining (family C, pretrained-encoder
story).

The reference fine-tunes pretrained ``bert-base-uncased`` and persists HF
directories (reference: Models/model_train_bert.py:57-94). Equivalent
here: MLM-pretrain this framework's flax encoder on a large SMILES
corpus — generated drug-like molecules (data.zinc.synthetic_smiles) plus the
B3DB sets — then fine-tune via ``BertClassifier(pretrained_dir=...)``. The
saved directory (tokenizer.json / config.json / params.pkl) is the
``save_pretrained``-style artifact contract.

BERT-style masking (80% [MASK] / 10% random / 10% keep on 15% of non-special
tokens) happens INSIDE the jitted step from the PRNG key — no host-side mask
materialization; one fused program per step.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from bbbp.models.bert import (
    CLS,
    MASK,
    PAD,
    BertEncoder,
    SmilesTokenizer,
)


@dataclass
class MLMPretrainConfig:
    corpus_size: int = 200_000        # generated molecules
    include_b3db: bool = True
    epochs: int = 3
    batch_size: int = 256
    lr: float = 3e-4
    n_layers: int = 4
    d_model: int = 128
    n_heads: int = 4
    max_len: int = 128
    mask_prob: float = 0.15
    seed: int = 0
    out_dir: str = "bert_pretrained"


def build_corpus(cfg: MLMPretrainConfig) -> List[str]:
    from bbbp.data.zinc import synthetic_smiles

    corpus = synthetic_smiles(cfg.corpus_size, seed=cfg.seed)
    if cfg.include_b3db:
        try:
            from bbbp.data import (
                load_b3db_classification,
                load_b3db_regression,
            )

            corpus += list(load_b3db_classification().smiles)
            corpus += list(load_b3db_regression().smiles)
        except Exception:
            pass
    return corpus


def pretrain(cfg: MLMPretrainConfig = MLMPretrainConfig(),
             corpus: Optional[List[str]] = None,
             verbose: bool = True) -> str:
    """Run MLM pretraining; returns the saved pretrained-directory path."""
    import jax
    import jax.numpy as jnp
    import optax

    t0 = time.time()
    if corpus is None:
        corpus = build_corpus(cfg)
    tok = SmilesTokenizer(cfg.max_len).fit(corpus)
    ids = tok.encode_batch(corpus)
    if verbose:
        print(f"[pretrain] corpus={len(corpus)} vocab={tok.vocab_size} "
              f"tokenized in {time.time()-t0:.1f}s")

    model = BertEncoder(vocab_size=tok.vocab_size, n_layers=cfg.n_layers,
                        d_model=cfg.d_model, n_heads=cfg.n_heads,
                        d_ff=4 * cfg.d_model, max_len=cfg.max_len)
    n = len(ids)
    bs = min(cfg.batch_size, n)
    steps_per_epoch = max(1, n // bs)
    total = cfg.epochs * steps_per_epoch
    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.lr, max(1, total // 20), max(2, total))
    tx = optax.adamw(sched, weight_decay=0.01)
    root = jax.random.PRNGKey(cfg.seed)
    vocab_size = tok.vocab_size
    mask_prob = cfg.mask_prob

    @jax.jit
    def init_fn(key, sample):
        v = model.init({"params": key, "dropout": key}, sample, train=True,
                       mlm=True)
        return v["params"], tx.init(v["params"])

    params, opt_state = init_fn(root, jnp.asarray(ids[:2]))

    @jax.jit
    def train_step(params, opt_state, ids_b, rng):
        k_sel, k_mode, k_rand, k_drop = jax.random.split(rng, 4)
        special = (ids_b == PAD) | (ids_b == CLS)
        sel = (jax.random.uniform(k_sel, ids_b.shape) < mask_prob) & ~special
        mode = jax.random.uniform(k_mode, ids_b.shape)
        rand_tok = jax.random.randint(k_rand, ids_b.shape, 4, vocab_size)
        masked = jnp.where(mode < 0.8, MASK,
                           jnp.where(mode < 0.9, rand_tok, ids_b))
        inp = jnp.where(sel, masked, ids_b)

        def loss_fn(p):
            logits = model.apply({"params": p}, inp, train=True, mlm=True,
                                 rngs={"dropout": k_drop})
            logp = jax.nn.log_softmax(logits)
            ll = jnp.take_along_axis(logp, ids_b[..., None], axis=-1)[..., 0]
            m = sel.astype(jnp.float32)
            return -(ll * m).sum() / jnp.maximum(m.sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    host_rng = np.random.default_rng(cfg.seed)
    ids_d = jnp.asarray(ids)
    key = root
    for epoch in range(cfg.epochs):
        perm = host_rng.permutation(n)[: steps_per_epoch * bs]
        perm = perm.reshape(steps_per_epoch, bs)
        ep_loss, t_ep = 0.0, time.time()
        for s in range(steps_per_epoch):
            key, sub = jax.random.split(key)
            params, opt_state, loss = train_step(
                params, opt_state, ids_d[jnp.asarray(perm[s])], sub)
            if s % 50 == 0:
                ep_loss = float(loss)
        if verbose:
            print(f"[pretrain] epoch {epoch+1}/{cfg.epochs} "
                  f"mlm_loss={float(loss):.4f} ({time.time()-t_ep:.1f}s)")

    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, "tokenizer.json"), "w") as f:
        f.write(tok.to_json())
    with open(os.path.join(cfg.out_dir, "config.json"), "w") as f:
        json.dump({"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "n_heads": cfg.n_heads, "max_len": cfg.max_len,
                   "vocab_size": tok.vocab_size, "corpus_size": len(corpus),
                   "epochs": cfg.epochs, "final_mlm_loss": float(loss)}, f)
    with open(os.path.join(cfg.out_dir, "params.pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    if verbose:
        print(f"[pretrain] saved {cfg.out_dir} ({time.time()-t0:.1f}s total)")
    return cfg.out_dir


def main():
    ap = argparse.ArgumentParser(description="SMILES-BERT MLM pretraining")
    ap.add_argument("--corpus-size", type=int, default=200_000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--out-dir", default="bert_pretrained")
    args = ap.parse_args()
    pretrain(MLMPretrainConfig(
        corpus_size=args.corpus_size, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, n_layers=args.n_layers,
        d_model=args.d_model, out_dir=args.out_dir))


if __name__ == "__main__":
    main()
