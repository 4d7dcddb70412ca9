"""Hyperparameter search for the CV-trained NN legs: trials ride the
seed-replica axis of train_cv.

The reference tunes only its classical models; its NN legs use hand-picked
optimizer settings (Models/multi_input_data_regression_opt_transformer_cnn_20250113.py:169-186).
Round-2 VERDICT item #1: apply the batched (trial x fold) device-axis design
to the regression NN legs too. Mechanism (SURVEY §7.5): train_cv already
batches folds x seed-replicas in ONE jit; ``replica_hparams`` (train.loop)
injects per-replica optimizer hyperparameters via optax.inject_hyperparams,
so the replica axis becomes a TRIAL axis — T trials x K folds train in one
compiled program, each trial scored by its own out-of-fold R².

Static architecture hyperparameters (layers/width/fusion) change the compiled
program, so trials are grouped by their static part — one compile per group,
traced lr/weight-decay trials free within a group (same grouping idea as the
mlp family in train.batched_search).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bbbp.ops import metrics
from bbbp.train.loop import train_cv
from bbbp.train.search import _sample_params

TRACED_KEYS = ("learning_rate", "weight_decay")


@dataclass
class NNSearchResult:
    best_params: Dict          # static + traced params of the best trial
    best_score: float          # out-of-fold R² of the best trial
    trials: List[Dict]         # every trial's params + oof_r2
    best_oof: np.ndarray       # [N] the best trial's OOF prediction


def search_nn_cv(model_ctor: Callable[..., object],
                 inputs: Sequence[np.ndarray],
                 y: np.ndarray,
                 space: Dict,
                 n_iter: int = 16,
                 n_folds: int = 5,
                 epochs: int = 30,
                 batch_size: int = 32,
                 snapshot_from: Optional[int] = None,
                 seed: int = 0,
                 fold_affine=None,
                 warm_start=None,
                 max_replicas: int = 16,
                 extra_trials: Optional[List[Dict]] = None,
                 verbose: bool = False) -> NNSearchResult:
    """Randomized search over ``space`` for a train_cv-trained model.

    ``space`` keys in TRACED_KEYS sample per-trial optimizer hyperparameters
    (batched on device); every other key is passed to ``model_ctor`` and
    defines a static group (one compile each). Scoring: per-trial OOF R²
    over the ``n_folds``-fold split (the pipeline's own metric, not a
    surrogate).

    ``max_replicas`` caps the folds×trials replica count per jit — device
    memory holds the whole batched state. The default was chosen on a
    16 GB accelerator of an earlier build (a 40-replica launch ran out of
    its memory) and has not been re-derived for the 80 GB H100. Trials chunk to
    ``max_replicas // n_folds`` per launch; chunks reuse the group's compile.
    """
    rng = np.random.default_rng(seed)
    params = list(extra_trials or []) + [
        _sample_params(space, rng) for _ in range(n_iter)]
    n_iter = len(params)
    groups: Dict[Tuple, List[int]] = {}
    for t, p in enumerate(params):
        static = tuple(sorted((k, v) for k, v in p.items()
                              if k not in TRACED_KEYS))
        groups.setdefault(static, []).append(t)

    per_launch = max(1, max_replicas // n_folds)
    scores = np.full(n_iter, -np.inf, np.float32)
    oofs: List[Optional[np.ndarray]] = [None] * n_iter
    for static, t_ids in groups.items():
        static_kw = dict(static)
        model = model_ctor(**static_kw)
        for c0 in range(0, len(t_ids), per_launch):
            chunk = t_ids[c0:c0 + per_launch]
            hp = {k: np.asarray([params[t].get(k, 0.0) for t in chunk],
                                np.float32)
                  for k in TRACED_KEYS
                  if any(k in params[t] for t in chunk)}
            lr0 = float(hp.get("learning_rate", [3e-4])[0])
            if verbose:
                print(f"[nn-search] group {static_kw} x {len(chunk)} trials "
                      f"({n_folds} folds, {epochs} epochs, one jit)",
                      flush=True)
            res = train_cv(model, tuple(inputs), y, n_folds=n_folds,
                           epochs=epochs, batch_size=batch_size, lr=lr0,
                           seed=seed, split_seed=seed, n_seeds=len(chunk),
                           snapshot_from=snapshot_from,
                           fold_affine=fold_affine, warm_start=warm_start,
                           replica_hparams=hp)
            for j, t in enumerate(chunk):
                oof_t = res.oof_seeds[j]
                scores[t] = metrics.regression_report(y, oof_t)["r2"]
                oofs[t] = oof_t
                if verbose:
                    print(f"[nn-search] trial {t}: r2={scores[t]:.4f} "
                          f"{params[t]}", flush=True)

    best = int(np.argmax(scores))
    trials = [{**p, "oof_r2": float(s)} for p, s in zip(params, scores)]
    return NNSearchResult(params[best], float(scores[best]), trials,
                          oofs[best])
