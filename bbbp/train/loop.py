"""K-fold neural-net training with the fold axis as a batched device dimension.

The reference trains 10 CV folds sequentially, each its own PyTorch loop
(reference: Models/multi_input_data_regression_opt_transformer_cnn_20250113.py:146-241).
Redesign (SURVEY.md §7 'batched orthogonal parallelism'): all folds
train **simultaneously** — parameters, optimizer state, and batches carry a
leading fold axis; one jitted epoch `lax.scan`s over steps and `vmap`s the
train step over folds. On a mesh the fold axis shards over 'data'
(embarrassingly parallel). Full feature/image tensors live in device memory
once; per-step batches are
device-side gathers — no per-batch H2D transfers (the reference pays one per
step, :184-186).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax.core import FrozenDict


@dataclass
class CVResult:
    oof_pred: np.ndarray          # [N] out-of-fold predictions
    fold_of: np.ndarray           # [N] fold id per sample
    params: Any                   # stacked params pytree (leading fold axis)
    batch_stats: Any
    train_losses: np.ndarray      # [K, epochs]
    fold_test_idx: list           # list of K index arrays
    oof_seeds: Optional[np.ndarray] = None   # [n_seeds, N] per-replica OOF
                                  # (the replica axis doubles as a TRIAL axis
                                  # for hyperparameter search — see
                                  # replica_hparams in train_cv)


def kfold_indices(n: int, k: int, seed: int = 42) -> list:
    """Shuffled K-fold split (reference: KFold(10, shuffle=True, random_state=42))."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [perm[i::k] for i in range(k)]


def _padded_train_sets(n: int, folds: list) -> Tuple[np.ndarray, int]:
    """[K, S] train-index matrix; folds padded to equal size by wrapping."""
    sets = []
    for i in range(len(folds)):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        sets.append(tr)
    s = max(len(t) for t in sets)
    out = np.stack([np.resize(t, s) for t in sets])
    return out, s


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-5,
                   warm_restart_period: int = 0) -> optax.GradientTransformation:
    """AdamW(1e-4, wd=1e-5) like the reference (:178), with optional cosine
    warm restarts (reference B1 uses CosineAnnealingWarmRestarts,
    Models/multi_input_data_regression_opt.py:109-124)."""
    if warm_restart_period > 0:
        sched = optax.join_schedules(
            [optax.cosine_decay_schedule(lr, warm_restart_period)
             for _ in range(64)],
            boundaries=[warm_restart_period * (i + 1) for i in range(63)],
        )
        return optax.adamw(sched, weight_decay=weight_decay)
    return optax.adamw(lr, weight_decay=weight_decay)


def train_cv(
    model,
    inputs,
    y: np.ndarray,
    n_folds: int = 10,
    epochs: int = 50,
    batch_size: int = 32,
    lr: float = 1e-4,
    weight_decay: float = 1e-5,
    seed: int = 42,
    mesh=None,
    log_every: int = 0,
    n_seeds: int = 1,
    snapshot_from: Optional[int] = None,
    split_seed: Optional[int] = None,
    patience: Optional[int] = None,
    val_frac: float = 0.1,
    fold_affine=None,
    warm_start=None,
    replica_hparams: Optional[Dict[str, np.ndarray]] = None,
) -> CVResult:
    """Train `model(*inputs, train=)` on all folds at once; return OOF preds.

    inputs: tuple of [N, ...] arrays (e.g. (fp, img) for the multimodal model,
    (feats, adj, mask) for the GCN); y: [N] float32.

    Extras over the reference's loop: ``n_seeds`` replicates every
    fold with independent inits on the same batched axis (K = folds × seeds in
    ONE jit; OOF = seed-average — a deep-ensemble at ~zero wall-clock cost),
    and ``snapshot_from`` additionally averages end-of-epoch prediction
    snapshots from that epoch onward (cheap SWA-style variance reduction).

    ``patience`` enables B3-parity early stopping (reference:
    Descriptors/multi_input_data_nn.py:39-143, patience-10 on validation
    loss), batched: each fold carves ``val_frac`` of ITS OWN train split as a
    validation set, per-fold best parameters are kept with masked tree-map
    updates, and training stops when every fold has gone ``patience`` epochs
    without improving. Final predictions use each fold's best-epoch params.

    ``fold_affine``: optional tuple of per-input, per-fold (shift [K, ...],
    scale [K, ...]) pairs (entries may be None); applied as (x - shift) *
    scale inside the step. This is how the strict leak-free protocol feeds
    per-fold standardization without materializing K copies of the data.

    ``warm_start``: optional params pytree WITHOUT a fold axis (e.g. an
    MLM-pretrained encoder trunk). Every leaf whose path+shape matches the
    freshly initialised per-fold params is broadcast across the fold axis;
    non-matching leaves (new heads) keep their per-fold random init.

    ``replica_hparams``: optional dict of per-replica optimizer
    hyperparameters (keys from optax.adamw's signature, e.g.
    ``learning_rate`` / ``weight_decay``), each a length-``n_seeds`` (or
    length-K) float array. The optimizer is built with
    ``optax.inject_hyperparams`` so the values live in (vmapped) optimizer
    STATE rather than the compiled program — every replica trains with its
    own lr/wd in the same jit. This turns the seed-replica axis into a
    batched hyperparameter TRIAL axis (read per-trial OOF from
    ``CVResult.oof_seeds``) at one compile for the whole search.
    """
    n = len(y)
    folds = kfold_indices(n, n_folds, split_seed if split_seed is not None else seed)
    base_train_idx, s0 = _padded_train_sets(n, folds)          # [F, S]
    val_idx = None
    if patience is not None:
        # carve a per-fold validation block from the END of each train set
        # (train sets are permutation-ordered, so this is a random subset)
        n_val = max(8, int(s0 * val_frac))
        val_idx = base_train_idx[:, s0 - n_val:]               # [F, n_val]
        base_train_idx = base_train_idx[:, : s0 - n_val]
        val_idx = np.concatenate([val_idx] * n_seeds, axis=0)  # [K, n_val]
    s = base_train_idx.shape[1]
    # replicate folds across seeds along the same batched axis
    train_idx = np.concatenate([base_train_idx] * n_seeds, axis=0)  # [K, S]
    k = n_folds * n_seeds
    steps = s // batch_size

    def _device_dtype(a):
        if np.issubdtype(np.asarray(a).dtype, np.integer):
            return jnp.int32                       # token ids etc.
        return jnp.bfloat16 if a.ndim >= 3 else jnp.float32

    inputs_d = tuple(jnp.asarray(a, _device_dtype(a)) for a in inputs)
    y_d = jnp.asarray(y, jnp.float32)
    if fold_affine is not None:
        fold_affine = tuple(
            None if fa is None else tuple(
                jnp.asarray(np.concatenate([np.asarray(v)] * n_seeds, axis=0),
                            inputs_d[i].dtype)
                for v in fa)
            for i, fa in enumerate(fold_affine))

    if replica_hparams:
        tx = optax.inject_hyperparams(optax.adamw)(
            learning_rate=lr, weight_decay=weight_decay)
    else:
        tx = make_optimizer(lr, weight_decay)
    root = jax.random.PRNGKey(seed)
    init_keys = jax.random.split(root, k)

    samples = tuple(a[:2] for a in inputs_d)

    def init_one(key):
        variables = model.init({"params": key, "dropout": key},
                               *samples, train=True)
        params = variables["params"]
        batch_stats = variables.get("batch_stats", FrozenDict({}))
        return params, batch_stats, tx.init(params)

    # jit the vmapped init: eager init dispatches hundreds of tiny ops
    # individually
    params, batch_stats, opt_state = jax.jit(jax.vmap(init_one))(init_keys)
    if replica_hparams:
        def _per_k(v):
            v = np.asarray(v, np.float32)
            if v.shape == (n_seeds,):                 # one value per replica
                v = np.repeat(v, n_folds)             # row s*n_folds+i layout
            assert v.shape == (k,), (v.shape, k)
            return jnp.asarray(v)
        hp = dict(opt_state.hyperparams)
        for name, v in replica_hparams.items():
            hp[name] = _per_k(v)
        opt_state = opt_state._replace(hyperparams=hp)
    if warm_start is not None:
        def merge(a, b):
            if isinstance(a, dict):
                return {kk: (merge(a[kk], b[kk])
                             if isinstance(b, dict) and kk in b else a[kk])
                        for kk in a}
            if (hasattr(b, "shape") and hasattr(a, "shape")
                    and a.shape[1:] == b.shape):
                return jnp.broadcast_to(jnp.asarray(b, a.dtype), a.shape)
            return a
        params = merge(dict(params), warm_start)

    # mesh mode: the fold×seed axis shards over 'data' — each device trains
    # its own folds; full feature tensors replicate (they're small); XLA
    # propagates the shardings through the vmapped epoch with zero collectives
    fold_sharding = None
    if mesh is not None and k % mesh.shape["data"] == 0:
        from jax.sharding import NamedSharding, PartitionSpec as P

        fold_sharding = NamedSharding(mesh, P("data"))
        repl = NamedSharding(mesh, P())

        def shard_leading(tree):
            return jax.tree.map(
                lambda l: jax.device_put(
                    l, NamedSharding(mesh, P("data", *([None] * (l.ndim - 1))))),
                tree)

        params = shard_leading(params)
        batch_stats = shard_leading(batch_stats)
        opt_state = jax.tree.map(
            lambda l: jax.device_put(
                l, NamedSharding(mesh, P("data", *([None] * (l.ndim - 1)))))
            if hasattr(l, "ndim") and l.ndim >= 1 and l.shape[0] == k
            else jax.device_put(l, repl),
            opt_state)
        inputs_d = tuple(jax.device_put(a, repl) for a in inputs_d)
        y_d = jax.device_put(y_d, repl)

    def _apply_affine(batch, aff):
        """(x - shift) * scale per input; aff entries may be None (static)."""
        if aff is None:
            return batch
        return tuple(
            b if a is None else (b - a[0]) * a[1]
            for b, a in zip(batch, aff))

    # remat the forward: with folds×seeds batched on one device the CNN
    # activations dominate HBM; recomputing them in the backward trades ~30%
    # FLOPs for ~2× peak-memory headroom (jax.checkpoint)
    @jax.checkpoint
    def _forward(p, bs, batch, rng):
        variables = {"params": p}
        if bs:
            variables["batch_stats"] = bs
            pred, updates = model.apply(variables, *batch, train=True,
                                        rngs={"dropout": rng},
                                        mutable=["batch_stats"])
            return pred, updates["batch_stats"]
        pred = model.apply(variables, *batch, train=True,
                           rngs={"dropout": rng})
        return pred, bs

    def loss_fn(p, bs, batch, y_b, rng):
        pred, new_bs = _forward(p, bs, batch, rng)
        return jnp.mean((pred - y_b) ** 2), new_bs

    def one_fold_step(carry, idx_b, rng, aff):
        p, bs, opt = carry
        batch = _apply_affine(tuple(a[idx_b] for a in inputs_d), aff)
        y_b = y_d[idx_b]
        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, bs, batch, y_b, rng)
        updates, new_opt = tx.update(grads, opt, p)
        new_p = optax.apply_updates(p, updates)
        return (new_p, new_bs, new_opt), loss

    @jax.jit
    def train_epoch(params, batch_stats, opt_state, idx_ksb, rngs_ks, affine):
        # vmap over folds, scan over steps
        def fold_epoch(p, bs, opt, idx_sb, rng_s, aff):
            def body(carry, xs):
                idx_b, rng = xs
                return one_fold_step(carry, idx_b, rng, aff)
            (p, bs, opt), losses = jax.lax.scan(body, (p, bs, opt),
                                                (idx_sb, rng_s))
            return p, bs, opt, losses.mean()

        return jax.vmap(fold_epoch)(params, batch_stats, opt_state,
                                    idx_ksb, rngs_ks, affine)

    @jax.jit
    def predict_chunk(params, batch_stats, affine, *chunk_inputs):
        def fold_pred(p, bs, aff):
            variables = {"params": p}
            if bs:
                variables["batch_stats"] = bs
            return model.apply(variables,
                               *_apply_affine(chunk_inputs, aff), train=False)
        return jax.vmap(fold_pred)(params, batch_stats, affine)  # [K, C]

    def predict_all(params, batch_stats, chunk: int = 0):
        """Chunked [K, N] prediction — bounds activation memory.
        Chunk adapts to the replica count so K×chunk work stays ~constant."""
        if chunk <= 0:
            chunk = max(32, 4096 // k)
        outs = []
        pad = (-n) % chunk
        padded = tuple(
            jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) for a in inputs_d)
        for start in range(0, n + pad, chunk):
            outs.append(predict_chunk(
                params, batch_stats, fold_affine,
                *(a[start:start + chunk] for a in padded)))
        return jnp.concatenate(outs, axis=1)[:, :n]

    # early stopping state: per-fold val gathers (device-resident once) +
    # masked best-parameter tracking
    if patience is not None:
        val_inputs = tuple(a[jnp.asarray(val_idx)] for a in inputs_d)  # [K,V,..]
        y_val = y_d[jnp.asarray(val_idx)]

        @jax.jit
        def val_losses(params, batch_stats, affine):
            def f(p, bs, aff, *ins):
                variables = {"params": p}
                if bs:
                    variables["batch_stats"] = bs
                pred = model.apply(variables, *_apply_affine(ins, aff),
                                   train=False)
                return pred
            pred = jax.vmap(f)(params, batch_stats, affine, *val_inputs)
            return jnp.mean((pred - y_val) ** 2, axis=1)       # [K]

        @jax.jit
        def keep_best(improved, best_tree, cur_tree):
            def upd(b, c):
                m = improved.reshape((-1,) + (1,) * (c.ndim - 1))
                return jnp.where(m, c, b)
            return jax.tree.map(upd, best_tree, cur_tree)

        best_val = np.full(k, np.inf, np.float32)
        since_best = np.zeros(k, np.int32)
        best_params, best_bs = params, batch_stats

    host_rng = np.random.default_rng(seed)
    losses_hist = np.zeros((k, epochs), dtype=np.float32)
    step_rng = root
    snap_sum = np.zeros((k, n), dtype=np.float32)
    snap_count = 0
    for epoch in range(epochs):
        perms = np.stack([
            host_rng.permutation(train_idx[i])[: steps * batch_size]
            for i in range(k)
        ]).reshape(k, steps, batch_size)
        step_rng, sub = jax.random.split(step_rng)
        rngs = jax.random.split(sub, k * steps).reshape(k, steps, -1)
        perms_d = jnp.asarray(perms)
        if fold_sharding is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            perms_d = jax.device_put(perms_d, NamedSharding(mesh, P("data", None, None)))
            rngs = jax.device_put(rngs, NamedSharding(mesh, P("data", None, None)))
        params, batch_stats, opt_state, mean_loss = train_epoch(
            params, batch_stats, opt_state, perms_d, rngs, fold_affine)
        losses_hist[:, epoch] = np.asarray(mean_loss)
        if patience is not None:
            vl = np.asarray(val_losses(params, batch_stats, fold_affine))
            improved = vl < best_val - 1e-5
            best_val = np.where(improved, vl, best_val)
            since_best = np.where(improved, 0, since_best + 1)
            imp_d = jnp.asarray(improved)
            best_params = keep_best(imp_d, best_params, params)
            if batch_stats:
                best_bs = keep_best(imp_d, best_bs, batch_stats)
            if np.all(since_best >= patience):
                if log_every:
                    print(f"early stop at epoch {epoch+1} "
                          f"(patience {patience}; val/fold "
                          f"{best_val.round(4).tolist()})")
                break
        if snapshot_from is not None and epoch + 1 >= snapshot_from:
            snap_sum += np.asarray(predict_all(params, batch_stats),
                                   dtype=np.float32)
            snap_count += 1
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch+1}/{epochs} loss/fold: "
                  f"{np.asarray(mean_loss).round(4).tolist()}")

    if patience is not None:
        params, batch_stats = best_params, best_bs
    if snap_count:
        preds_kn = snap_sum / snap_count
    else:
        preds_kn = np.asarray(predict_all(params, batch_stats), dtype=np.float32)
    # average over seed replicas: replica r of fold i sits at row r*n_folds+i
    preds_sn = preds_kn.reshape(n_seeds, n_folds, n)
    preds_fn = preds_sn.mean(axis=0)                                # [F, N]
    oof = np.zeros(n, dtype=np.float32)
    fold_of = np.zeros(n, dtype=np.int32)
    oof_seeds = np.zeros((n_seeds, n), dtype=np.float32)
    for i, te in enumerate(folds):
        oof[te] = preds_fn[i, te]
        oof_seeds[:, te] = preds_sn[:, i, te]
        fold_of[te] = i
    return CVResult(oof, fold_of, params, batch_stats, losses_hist, folds,
                    oof_seeds=oof_seeds)


def train_multimodal_cv(model, fp, img, y, **kw) -> CVResult:
    """Back-compat wrapper: the (fingerprint, image) special case of train_cv."""
    return train_cv(model, (fp, img), y, **kw)
