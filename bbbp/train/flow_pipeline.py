"""Flow-MLP classifier pipeline (family D, FL1-FL2).

Reference (Descriptors/model_train_flow.py:108-302): sklearn-compatible
``FlowClassifier`` (fit/predict/evaluate/save/load/get_params/set_params)
around the FlowModel, trained via GridSearchCV over
{hidden_dim, n_layers, epochs, batch, lr}; ``do_flow_train`` driver:
fingerprints → scaler → PCA(100) → split → search → metrics CSV.
"""

from __future__ import annotations

import argparse
import json
import pickle
import time
from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from bbbp.models.flow import FlowModel
from bbbp.ops import PCA, StandardScaler


class FlowClassifier:
    """fit/predict wrapper over models.flow.FlowModel (reference FL2)."""

    def __init__(self, hidden_dim: int = 128, n_layers: int = 3,
                 epochs: int = 20, batch_size: int = 64, lr: float = 1e-3,
                 dropout: float = 0.1, seed: int = 0):
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.dropout = dropout
        self.seed = seed
        self.params_ = None
        self.model: Optional[FlowModel] = None

    def get_params(self, deep=True):
        return {k: getattr(self, k) for k in
                ("hidden_dim", "n_layers", "epochs", "batch_size", "lr",
                 "dropout", "seed")}

    def set_params(self, **p):
        for k, v in p.items():
            setattr(self, k, v)
        return self

    def fit(self, x, y) -> "FlowClassifier":
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.int32)
        n_classes = int(y.max()) + 1
        self.model = FlowModel(hidden_dim=self.hidden_dim,
                               n_layers=self.n_layers,
                               n_classes=max(2, n_classes),
                               dropout=self.dropout)
        model = self.model
        tx = optax.adam(self.lr)
        root = jax.random.PRNGKey(self.seed)

        @jax.jit
        def init_fn(key, sample):
            v = model.init({"params": key, "dropout": key}, sample, train=True)
            return v["params"], tx.init(v["params"])

        params, opt_state = init_fn(root, jnp.asarray(x[:2]))

        @jax.jit
        def step(params, opt_state, xb, yb, rng):
            def loss_fn(p):
                logits = model.apply({"params": p}, xb, train=True,
                                     rngs={"dropout": rng})
                onehot = jax.nn.one_hot(yb, logits.shape[-1])
                return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        n = len(y)
        bs = min(self.batch_size, n)
        steps = max(1, n // bs)
        host_rng = np.random.default_rng(self.seed)
        xd, yd = jnp.asarray(x), jnp.asarray(y)
        key = root
        for _ in range(self.epochs):
            perm = host_rng.permutation(n)[: steps * bs].reshape(steps, bs)
            for s in range(steps):
                key, sub = jax.random.split(key)
                b = jnp.asarray(perm[s])
                params, opt_state, _ = step(params, opt_state, xd[b], yd[b], sub)
        self.params_ = params
        return self

    def _logits(self, x) -> np.ndarray:
        model = self.model

        @jax.jit
        def fwd(p, xb):
            return model.apply({"params": p}, xb, train=False)

        return np.asarray(fwd(self.params_, jnp.asarray(np.asarray(x, np.float32))))

    def predict_proba(self, x) -> np.ndarray:
        z = self._logits(x)
        e = np.exp(z - z.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    def predict(self, x) -> np.ndarray:
        return self._logits(x).argmax(1)

    def evaluate(self, x, y) -> Dict[str, float]:
        from bbbp.ops import metrics

        proba = self.predict_proba(x)[:, 1]
        pred = self.predict(x)
        return metrics.classification_report(np.asarray(y), pred, proba)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"config": self.get_params(),
                         "params": jax.tree.map(np.asarray, self.params_)}, f)

    @staticmethod
    def load(path: str) -> "FlowClassifier":
        with open(path, "rb") as f:
            d = pickle.load(f)
        clf = FlowClassifier(**d["config"])
        clf.params_ = d["params"]
        clf.model = FlowModel(hidden_dim=clf.hidden_dim, n_layers=clf.n_layers,
                              n_classes=2, dropout=clf.dropout)
        return clf


@dataclass
class FlowTrainConfig:
    fp_kind: str = "morgan"
    pca_dim: int = 100
    test_size: float = 0.2
    grid: Optional[Dict] = None
    cv: int = 3
    seed: int = 42
    workers: Optional[int] = None
    limit: Optional[int] = None


def do_flow_train(cfg: FlowTrainConfig = FlowTrainConfig(), verbose: bool = True):
    """Driver equivalent to the reference's do_flow_train (:225-302)."""
    from bbbp.chem.featurize import fingerprints
    from bbbp.data import load_b3db_classification
    from bbbp.train.search import GridSearchCV

    t0 = time.time()
    data = load_b3db_classification()
    smiles, y = data.smiles, data.labels
    if cfg.limit:
        smiles, y = smiles[: cfg.limit], y[: cfg.limit]
    fp = fingerprints(smiles, kind=cfg.fp_kind, workers=cfg.workers)
    x = np.asarray(StandardScaler().fit_transform(fp.features[fp.ok_mask]))
    x = np.asarray(PCA(min(cfg.pca_dim, x.shape[0], x.shape[1])).fit_transform(x))
    y = y[fp.ok_mask]
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(y))
    n_test = int(len(y) * cfg.test_size)
    te, tr = perm[:n_test], perm[n_test:]
    if cfg.grid:
        search = GridSearchCV(FlowClassifier, cfg.grid, cv=cfg.cv,
                              scoring=["accuracy"], seed=cfg.seed,
                              verbose=verbose)
        res = search.fit(x[tr], y[tr])
        clf = res.best_estimator
    else:
        clf = FlowClassifier().fit(x[tr], y[tr])
    report = clf.evaluate(x[te], y[te])
    if verbose:
        print("[flow] " + " ".join(f"{k}={v:.4f}" for k, v in report.items()))
    return clf, report, time.time() - t0


def main():
    ap = argparse.ArgumentParser(description="Flow-MLP classifier (FL1-FL2)")
    ap.add_argument("--fp-kind", default="morgan")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    _, report, _ = do_flow_train(FlowTrainConfig(fp_kind=args.fp_kind,
                                                 limit=args.limit))
    print(json.dumps(report, indent=2))
    if args.out:
        json.dump(report, open(args.out, "w"), indent=2)


if __name__ == "__main__":
    main()
