"""Virtual screening pipeline (L6): SMILES stream → fingerprints → scaler →
PCA → classifier → results CSV, streamed through one device program.

Reference: ``Descriptors/virtualscreening.py:1-19`` (Morgan fp → fitted
scaler.transform → pca.transform → rf_model.predict/predict_proba →
virtual_screening_results.csv), fed by zinc_download.py / create_descriptors_zinc.py.

Redesign (SURVEY.md §3.5 / §7 step 7): the C++ featurizer fingerprints
chunks on host threads while the previous chunk's scaler+PCA matmul and
forest traversal run on-device under one jit; a three-stage thread pipeline
(featurize → H2D+dispatch → drain) overlaps host and device work.
"""

from __future__ import annotations

import argparse
import csv
import functools
import pickle
import threading
import time
from dataclasses import dataclass
from queue import Queue
from typing import Iterable, Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bbbp.chem.featurize import fingerprints as featurize_fp
from bbbp.data.zinc import (chunked, iter_smi_dir, iter_smi_file,
                            synthetic_smiles, tpsa_bbb_labels)
from bbbp.ops import PCA, StandardScaler
from bbbp.ops.forest_device import DeviceGBDTClassifier as GBDTClassifier, DenseTreeEnsemble


@dataclass
class ScreeningModel:
    """Bundled scaler + PCA + classifier, the reference's (scaler, pca,
    rf_model) triple (virtualscreening.py:9-13)."""

    scaler_mean: np.ndarray
    scaler_scale: np.ndarray
    pca_mean: np.ndarray
    pca_components: np.ndarray        # [k, d]
    ensemble: DenseTreeEnsemble
    fp_kind: str = "morgan"
    n_bits: int = 2048
    threshold: float = 0.5

    @staticmethod
    def train(smiles: List[str], labels: np.ndarray, fp_kind: str = "morgan",
              n_bits: int = 2048, pca_dim: int = 30, n_estimators: int = 300,
              seed: int = 42, workers: Optional[int] = None) -> "ScreeningModel":
        fp = featurize_fp(smiles, kind=fp_kind, n_bits=n_bits, workers=workers)
        x = fp.features[fp.ok_mask]
        y = np.asarray(labels)[fp.ok_mask]
        scaler = StandardScaler().fit(x)
        xs = np.asarray(scaler.transform(x))
        pca = PCA(pca_dim).fit(xs)
        z = np.asarray(pca.transform(xs))
        clf = GBDTClassifier(n_estimators=n_estimators, learning_rate=0.1,
                             max_depth=6, subsample=0.8, seed=seed).fit(z, y)
        return ScreeningModel(
            scaler_mean=np.asarray(scaler.mean_),
            scaler_scale=np.asarray(scaler.scale_),
            pca_mean=np.asarray(pca.mean_),
            pca_components=np.asarray(pca.components_),
            ensemble=clf.ensemble_,
            fp_kind=fp_kind,
            n_bits=n_bits,
        )

    def save(self, path: str) -> None:
        state = {
            "scaler_mean": self.scaler_mean,
            "scaler_scale": self.scaler_scale,
            "pca_mean": self.pca_mean,
            "pca_components": self.pca_components,
            "fp_kind": self.fp_kind,
            "n_bits": self.n_bits,
            "threshold": self.threshold,
            "ensemble": {
                "feat": np.asarray(self.ensemble.feat),
                "thr": np.asarray(self.ensemble.thr),
                "leaf": np.asarray(self.ensemble.leaf),
                "depth": self.ensemble.depth,
                "base_score": self.ensemble.base_score,
                "tree_scale": self.ensemble.tree_scale,
            },
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    @staticmethod
    def load(path: str) -> "ScreeningModel":
        with open(path, "rb") as f:
            s = pickle.load(f)
        e = s["ensemble"]
        ens = DenseTreeEnsemble(
            feat=jnp.asarray(e["feat"]), thr=jnp.asarray(e["thr"]),
            leaf=jnp.asarray(e["leaf"]), depth=e["depth"],
            base_score=e["base_score"], tree_scale=e["tree_scale"])
        return ScreeningModel(
            s["scaler_mean"], s["scaler_scale"], s["pca_mean"],
            s["pca_components"], ens, s["fp_kind"], s["n_bits"], s["threshold"])


def _shard_over_data(fn, mesh):
    """Wrap a per-molecule device fn in shard_map over the mesh 'data' axis:
    each device runs the single-device program on its rows (the computation
    is embarrassingly molecule-parallel, so no collectives appear)."""
    from jax.sharding import PartitionSpec as P

    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("data"),
                                 out_specs=P("data")))


def _make_device_fn(model: ScreeningModel, mesh=None):
    """One jit: standardize → PCA project → forest margin → probability
    (dense-feature path, used when the native featurizer is unavailable)."""
    sm = jnp.asarray(model.scaler_mean)
    ss = jnp.asarray(model.scaler_scale)
    pm = jnp.asarray(model.pca_mean)
    pc = jnp.asarray(model.pca_components.T)          # [d, k]
    ens = model.ensemble

    def run(fp_chunk):
        x = (fp_chunk - sm) / ss
        z = jnp.matmul(x - pm, pc, precision=jax.lax.Precision.HIGHEST)
        margin = ens.raw_predict(z)
        return jax.nn.sigmoid(margin)

    return _shard_over_data(run, mesh) if mesh is not None else jax.jit(run)


def _make_packed_device_fn(model: ScreeningModel, mesh=None):
    """Packed-bit path: uint32 words in, unpack + folded projection matmul,
    forest margin, probability — 32× smaller H2D transfers."""
    from bbbp.ops.bitops import packed_project, project_weights

    w, c0 = project_weights(model.scaler_mean, model.scaler_scale,
                            model.pca_mean, model.pca_components)
    w_d, c0_d = jnp.asarray(w), jnp.asarray(c0)
    ens = model.ensemble

    def run(packed_chunk):
        z = packed_project(packed_chunk, w_d, c0_d)
        return jax.nn.sigmoid(ens.raw_predict(z))

    return _shard_over_data(run, mesh) if mesh is not None else jax.jit(run)


class ScreenBackendError(RuntimeError):
    """A chunk's result fetch failed on the device. Raised after every
    pipeline thread has been unblocked, and carries the failing chunk's
    index."""

    def __init__(self, chunk_index: int, cause: BaseException):
        super().__init__(
            f"backend died fetching screening chunk {chunk_index}: {cause!r}")
        self.chunk_index = chunk_index


@dataclass
class ScreenStats:
    n_molecules: int
    n_invalid: int
    wall_s: float
    featurize_s: float
    device_s: float

    @property
    def mol_per_s(self) -> float:
        return self.n_molecules / max(self.wall_s, 1e-9)


def screen(model: ScreeningModel, smiles_iter: Iterable[Tuple[str, str]],
           out_csv: Optional[str] = "virtual_screening_results.csv",
           chunk_size: int = 8192, workers: Optional[int] = None,
           verbose: bool = False, mesh=None,
           pipeline_depth: int = 3, dispatch_workers: int = 2) -> ScreenStats:
    """Stream screening as a three-stage thread pipeline: featurize (C++
    threads, GIL-released) → pad + H2D + async device dispatch → drain +
    CSV write. Each stage hands off through a ``pipeline_depth``-bounded
    queue, so the per-chunk transfer, dispatch and result fetch all overlap
    the host featurization instead of serializing with it in one thread.

    ``dispatch_workers``: number of concurrent pad+H2D+dispatch threads;
    with ≥2, chunk i+1's transfer overlaps chunk i's. Results re-order by
    sequence number in the drain, so the CSV stays in input order
    regardless.

    ``mesh``: optional jax.sharding.Mesh with a 'data' axis — each chunk's
    molecule axis shards across the mesh (weights replicate), so an
    n-device mesh screens n chunk-shards per dispatch
    (tests/test_round2.py::test_device_fn_actually_shards).

    Raises ScreenBackendError (with the failing chunk index) when a result
    fetch fails on the device, after unblocking every pipeline thread, so
    no blocked thread is left behind."""
    packed_mode = False
    if model.fp_kind in ("morgan", "rdkit"):
        try:
            from bbbp.native import bindings as nb

            packed_mode = nb.available()
        except ImportError:
            packed_mode = False
    run = (_make_packed_device_fn(model, mesh) if packed_mode
           else _make_device_fn(model, mesh))
    data_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        data_sharding = NamedSharding(mesh, P("data"))
        if chunk_size % mesh.shape["data"] != 0:
            raise ValueError("chunk_size must divide the mesh 'data' axis")
    t_start = time.time()
    feat_time = 0.0
    n_total = 0
    n_bad = 0
    n_disp = max(1, int(dispatch_workers))

    q_feat: Queue = Queue(maxsize=pipeline_depth)
    q_dev: Queue = Queue(maxsize=pipeline_depth + n_disp)
    _END = object()
    errors: List[BaseException] = []
    dev_times: List[float] = []        # per-thread accumulators (no data race)
    _time_lock = threading.Lock()

    def producer():
        nonlocal feat_time, n_bad
        try:
            for seq, chunk in enumerate(chunked(smiles_iter, chunk_size)):
                smiles = [c[0] for c in chunk]
                ids = [c[1] for c in chunk]
                t0 = time.time()
                if packed_mode:
                    from bbbp.native import bindings as nb

                    feats, bad_list = nb.fingerprints_packed(
                        smiles, model.fp_kind, model.n_bits)
                    bad_idx = np.asarray(bad_list, dtype=np.int64)
                else:
                    res = featurize_fp(smiles, kind=model.fp_kind,
                                       n_bits=model.n_bits, workers=workers)
                    feats, bad_idx = res.features, res.bad_indices
                feat_time += time.time() - t0
                n_bad += len(bad_idx)
                q_feat.put((seq, smiles, ids, feats, bad_idx))
        except BaseException as e:  # noqa: BLE001 — re-raised in main thread
            errors.append(e)
        finally:
            q_feat.put(_END)

    def dispatcher():
        """Pad → H2D → async dispatch, off the drain thread: the transfer
        overlaps featurization (GIL released in C++), the result fetches,
        and — with dispatch_workers > 1 — the sibling dispatchers'
        transfers."""
        dt = 0.0
        try:
            while True:
                item = q_feat.get()
                if item is _END:
                    q_feat.put(_END)   # wake the sibling dispatchers too
                    break
                seq, smiles, ids, feats, bad = item
                t0 = time.time()
                # pad to fixed chunk size: ONE compiled executable, all chunks
                n_real = len(feats)
                if n_real < chunk_size:
                    feats = np.concatenate(
                        [feats,
                         np.zeros((chunk_size - n_real,) + feats.shape[1:],
                                  feats.dtype)])
                arr = jnp.asarray(feats)
                if data_sharding is not None:
                    arr = jax.device_put(arr, data_sharding)
                fut = run(arr)   # async dispatch; never blocks on results
                # start the D2H copy now: by the time the drain fetches,
                # the bytes are already on host
                try:
                    fut.copy_to_host_async()
                except AttributeError:
                    pass
                dt += time.time() - t0
                q_dev.put((seq, smiles, ids, bad, fut))
        except BaseException as e:  # noqa: BLE001 — re-raised in main thread
            errors.append(e)
            # keep draining q_feat so the producer never deadlocks on a
            # full queue after this stage has died (siblings may also be
            # dead; the re-put _END keeps every consumer terminating)
            while True:
                item = q_feat.get()
                if item is _END:
                    q_feat.put(_END)
                    break
        finally:
            with _time_lock:
                dev_times.append(dt)
            q_dev.put(_END)

    threads = [threading.Thread(target=producer, daemon=True)]
    threads += [threading.Thread(target=dispatcher, daemon=True)
                for _ in range(n_disp)]
    for th in threads:
        th.start()

    writer = None
    fout = None
    if out_csv:
        fout = open(out_csv, "w", newline="")
        writer = csv.writer(fout)
        writer.writerow(["ID", "SMILES", "Prediction", "Probability"])

    def write_rows(smiles, ids, proba, bad):
        bad_set = set(int(b) for b in bad)
        writer.writerows(
            [sid, smi, "invalid", ""] if i in bad_set else
            [sid, smi, int(proba[i] > model.threshold), f"{proba[i]:.4f}"]
            for i, (sid, smi) in enumerate(zip(ids, smiles)))

    def drain_all_ends(ends_seen: int) -> None:
        """Unblock every dispatcher (and transitively the producer) so a
        drain failure can't leave blocked threads behind."""
        while ends_seen < n_disp:
            if q_dev.get() is _END:
                ends_seen += 1

    drain_time = 0.0
    ends = 0
    # re-order completed chunks by sequence number so the CSV matches the
    # input stream even with concurrent dispatchers
    pending = {}
    next_seq = 0
    try:
        while ends < n_disp:
            item = q_dev.get()
            if item is _END:
                ends += 1
                continue
            seq, smiles, ids, bad, fut = item
            t0 = time.time()
            try:
                proba = np.asarray(fut)
            except Exception as e:  # noqa: BLE001 — classify + attribute
                raise ScreenBackendError(seq, e) from e
            drain_time += time.time() - t0
            n_total += len(smiles)
            pending[seq] = (smiles, ids, proba, bad)
            while next_seq in pending:
                s_, i_, p_, b_ = pending.pop(next_seq)
                if writer is not None:
                    write_rows(s_, i_, p_, b_)
                next_seq += 1
    except BaseException:
        drain_all_ends(ends)
        raise
    for th in threads:
        th.join()
    if fout is not None:
        fout.close()
    if errors:
        raise errors[0]
    # device_s: dispatch/transfer wall is concurrent across dispatchers —
    # take the max lane (the critical path) plus the drain's fetch waits
    dev_time = (max(dev_times) if dev_times else 0.0) + drain_time
    return ScreenStats(n_total, n_bad, time.time() - t_start, feat_time, dev_time)


# size of the B3DB classification set the shipped model is trained on
B3DB_CLASSIFICATION_SIZE = 7809


def train_seeded_model(n: int = B3DB_CLASSIFICATION_SIZE, seed: int = 0,
                       workers: Optional[int] = None) -> ScreeningModel:
    """The shipped model's shape (Morgan 2048 → PCA 30 → 300-tree depth-6
    GBDT) trained on ``n`` seeded synthetic molecules labelled BBB+ iff
    TPSA < 90 Å² — needs no dataset. Trains on JAX's default device."""
    smiles = synthetic_smiles(n, seed=seed)
    return ScreeningModel.train(smiles, tpsa_bbb_labels(smiles),
                                workers=workers, seed=seed)


def train_default_model(workers: Optional[int] = None,
                        seed: int = 42) -> ScreeningModel:
    """Train the default screening classifier on B3DB classification data
    (BBB+ = 1), as the reference trains its RF on B3DB before screening ZINC."""
    from bbbp.data import load_b3db_classification

    data = load_b3db_classification()
    return ScreeningModel.train(data.smiles, data.labels, workers=workers,
                                seed=seed)


def main():
    ap = argparse.ArgumentParser(description="virtual screening")
    ap.add_argument("input", help=".smi file or directory of tranches")
    ap.add_argument("--model", default=None, help="ScreeningModel pickle; "
                    "trains a fresh B3DB model if omitted")
    ap.add_argument("--out", default="virtual_screening_results.csv")
    ap.add_argument("--chunk-size", type=int, default=8192)
    ap.add_argument("--workers", type=int, default=None)
    args = ap.parse_args()
    if args.model:
        model = ScreeningModel.load(args.model)
    else:
        print("training default B3DB screening model...")
        model = train_default_model(workers=args.workers)
    import os

    it = iter_smi_dir(args.input) if os.path.isdir(args.input) \
        else iter_smi_file(args.input)
    stats = screen(model, it, out_csv=args.out, chunk_size=args.chunk_size,
                   workers=args.workers, verbose=True)
    print(f"screened {stats.n_molecules} molecules "
          f"({stats.n_invalid} invalid) in {stats.wall_s:.1f}s "
          f"= {stats.mol_per_s:.0f} mol/s → {args.out}")


if __name__ == "__main__":
    main()
