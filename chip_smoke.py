"""Device smoke test: the screening path end to end on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py              # phases 1-3 on one GPU
    python chip_smoke.py --cards 4    # 4-GPU 'data' mesh screen vs. 1 GPU only

Phases (one process, no fallback):

1. seeded model — the shipped screening model's shape (Morgan 2048 bits →
   scaler+PCA 30 → 300-tree depth-6 GBDT) trained on 7,809 seeded synthetic
   molecules labelled BBB+ iff TPSA < 90 Å², once on the GPU and once on the
   host CPU backend. Both are scored on 2,000 held-out molecules of another
   seed: each AUC must reach 0.8 and the two must agree within 0.01 (GPU
   scatter-add order moves histogram sums in the last bits).
2. screening — ``screen()`` over 200,000 seeded molecules with unparseable
   SMILES planted at known rows, chunk 16,384, results CSV written; checks
   the row count, the invalid rows and that every probability is in [0, 1].
3. reference — one full chunk through the production device function
   against the plain float32 reference on the CPU backend: numpy unpack,
   the scaler and PCA applied as fitted, ((x − μ)/σ − μ_pca)·Cᵀ at HIGHEST
   (not the folded projection the device path uses), ``raw_predict_gather``.

``--cards N`` runs only the multi-device path: ``screen()`` over a 1-D
'data' mesh of N GPUs (N × 16,384 molecules per dispatch, 16,384 rows per
card) against the same stream on one GPU; labels must be identical and
|Δp| ≤ 1e-6. Both are then timed, compiled beforehand, over the 200,000
molecules of phase 2's size, and their molecules per second printed.

Exits non-zero, printing no result line, when JAX finds no GPU or any phase
fails. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from bbbp.data.zinc import synthetic_smiles, tpsa_bbb_labels
from bbbp.native import bindings as nb
from bbbp.ops.bitops import packed_project, project_weights
from bbbp.ops.forest_device import DenseTreeEnsemble
from bbbp.ops.metrics import roc_auc
from bbbp.pipelines.screen import (B3DB_CLASSIFICATION_SIZE, ScreeningModel,
                                   _make_packed_device_fn, screen,
                                   train_seeded_model)
from bbbp.utils.profiling import gpu_name_and_power_limit

CHUNK = 16_384
N_SCREEN = 200_000
BAD_SMILES = "C1CC(N"            # unclosed ring and branch: never parses
BAD_EVERY = 10_000               # plant one every BAD_EVERY rows
SEED_TRAIN, SEED_SCREEN, SEED_REF, SEED_MESH, SEED_HOLDOUT = 0, 1, 2, 3, 4
N_HOLDOUT = 2_000
AUC_TOL = 0.01
MIN_HOLDOUT_AUC = 0.8
Z_ATOL = 1e-4                    # f32 summation order over 2048 bits
P_ATOL = 1e-4
AGREE_FRAC = 0.999
MESH_P_ATOL = 1e-6


def _log(msg: str) -> None:
    print(msg, flush=True)


def _host_model(model: ScreeningModel) -> ScreeningModel:
    """The model with its forest arrays as host numpy, so it can run on any
    device (jit places uncommitted inputs on the default device)."""
    e = model.ensemble
    ens = DenseTreeEnsemble(np.asarray(e.feat), np.asarray(e.thr),
                            np.asarray(e.leaf), e.depth, e.base_score,
                            e.tree_scale)
    return ScreeningModel(model.scaler_mean, model.scaler_scale,
                          model.pca_mean, model.pca_components, ens,
                          model.fp_kind, model.n_bits, model.threshold)


def _unpack(packed: np.ndarray, n_bits: int) -> np.ndarray:
    """Reference unpack, numpy only: bit j of word w is feature 32·w + j."""
    bits = np.unpackbits(packed.view(np.uint8), axis=1, bitorder="little")
    return bits[:, :n_bits].astype(np.float32)


def reference_proba(model: ScreeningModel, packed: np.ndarray, cpu):
    """Plain float32 reference on the CPU backend: unpack, the scaler and
    PCA as fitted, ((x − μ)/σ − μ_pca)·Cᵀ at HIGHEST, gather traversal,
    sigmoid. Returns (z [N, k], p [N])."""
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))   # noqa: E731
    ens = _host_model(model).ensemble
    with jax.default_device(cpu):
        xs = ((f32(_unpack(packed, model.n_bits)) - f32(model.scaler_mean))
              / f32(model.scaler_scale))
        z = jnp.matmul(xs - f32(model.pca_mean), f32(model.pca_components).T,
                       precision=jax.lax.Precision.HIGHEST)
        p = jax.nn.sigmoid(ens.raw_predict_gather(z))
        return np.asarray(z), np.asarray(p)


def threshold_distance(ens: DenseTreeEnsemble, z: np.ndarray) -> float:
    """Smallest |z[f] − thr| over every node row ``z`` visits in the forest:
    how close the row is to flipping a split."""
    feat, thr = np.asarray(ens.feat), np.asarray(ens.thr)
    pos = np.zeros(feat.shape[0], np.int64)
    trees = np.arange(feat.shape[0])
    best = np.inf
    for level in range(ens.depth):
        node = (1 << level) - 1 + pos
        zv = z[feat[trees, node]]
        t = thr[trees, node]
        best = min(best, float(np.min(np.abs(zv - t))))
        pos = 2 * pos + (zv > t)
    return best


def _seeded_set(n: int, seed: int):
    """(SMILES, packed Morgan bits, TPSA labels) of ``n`` seeded
    molecules."""
    smiles = synthetic_smiles(n, seed=seed)
    packed, bad = nb.fingerprints_packed(smiles, "morgan", 2048)
    assert not len(bad), f"seeded molecules failed to featurize: {bad[:5]}"
    return smiles, packed, tpsa_bbb_labels(smiles)


def phase_model(n: int, seed: int, gpu, cpu, n_estimators: int = 300,
                pca_dim: int = 30, n_holdout: int = N_HOLDOUT,
                min_auc: float = MIN_HOLDOUT_AUC) -> ScreeningModel:
    """Phase 1: train the screening model on ``gpu`` and on ``cpu``. Scored
    by the CPU reference on ``n_holdout`` molecules of SEED_HOLDOUT, each
    reaches ``min_auc`` and the two agree within AUC_TOL. Returns the
    GPU-trained model."""
    smiles, packed, labels = _seeded_set(n, seed)
    _, packed_ho, labels_ho = _seeded_set(n_holdout, SEED_HOLDOUT)
    models, aucs, p_ho = {}, {}, {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        with jax.default_device(dev):
            models[name] = ScreeningModel.train(
                smiles, labels, pca_dim=pca_dim, n_estimators=n_estimators,
                seed=seed)
            jax.block_until_ready(models[name].ensemble.leaf)
        train_s = time.perf_counter() - t0
        _, p = reference_proba(models[name], packed, cpu)
        _, p_ho[name] = reference_proba(models[name], packed_ho, cpu)
        with jax.default_device(cpu):
            train_auc = float(roc_auc(labels, p))
            aucs[name] = float(roc_auc(labels_ho, p_ho[name]))
        _log(f"phase 1: trained on {name} ({dev.device_kind}) in "
             f"{train_s:.3f} s, train AUC {train_auc:.6f}, held-out AUC "
             f"{aucs[name]:.6f}")
    t = models["gpu"].threshold
    same = float(np.mean((p_ho["gpu"] > t) == (p_ho["cpu"] > t)))
    _log(f"phase 1: {n} molecules, BBB+ fraction {labels.mean():.4f}; "
         f"held out {n_holdout} (seed {SEED_HOLDOUT}), BBB+ fraction "
         f"{labels_ho.mean():.4f}: |AUC gpu - cpu| = "
         f"{abs(aucs['gpu'] - aucs['cpu']):.6f} (limit {AUC_TOL}), labels "
         f"agree {same:.6f}, max |Δp| "
         f"{float(np.max(np.abs(p_ho['gpu'] - p_ho['cpu']))):.3e}")
    assert min(aucs.values()) >= min_auc, aucs
    assert abs(aucs["gpu"] - aucs["cpu"]) <= AUC_TOL, aucs
    return models["gpu"]


def _planted_stream(n: int, seed: int):
    """(smiles, id) pairs of seeded molecules with BAD_SMILES planted at
    every BAD_EVERY-th row; returns (stream, planted ids)."""
    smiles = synthetic_smiles(n, seed=seed, validate=False)
    planted = set(range(0, n, BAD_EVERY))
    rows = [(BAD_SMILES if i in planted else s, f"SYN{i:09d}")
            for i, s in enumerate(smiles)]
    return rows, {f"SYN{i:09d}" for i in planted}


def _read_csv(path: str):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["ID", "SMILES", "Prediction", "Probability"], rows[0]
    return rows[1:]


def phase_screen(model: ScreeningModel, n: int, seed: int, chunk: int,
                 out_dir: str, card: str = "") -> float:
    """Phase 2: stream ``n`` molecules through ``screen()`` into a CSV and
    check it. Returns molecules per second, compilation excluded."""
    rows, planted = _planted_stream(n, seed)
    out_csv = os.path.join(out_dir, "screen.csv")
    screen(model, iter(rows[:chunk]), out_csv=None, chunk_size=chunk)
    stats = screen(model, iter(rows), out_csv=out_csv, chunk_size=chunk)
    got = _read_csv(out_csv)
    assert stats.n_molecules == n and len(got) == n, (stats.n_molecules,
                                                      len(got))
    assert [r[0] for r in got] == [r[1] for r in rows], "CSV out of order"
    invalid = {r[0] for r in got if r[2] == "invalid"}
    assert invalid == planted and stats.n_invalid == len(planted), (
        len(invalid), stats.n_invalid, len(planted))
    proba = np.array([float(r[3]) for r in got if r[2] != "invalid"])
    assert np.all((proba >= 0) & (proba <= 1)), "probability outside [0, 1]"
    labels = np.array([int(r[2]) for r in got if r[2] != "invalid"])
    _log(f"phase 2: screened {stats.n_molecules} molecules "
         f"({stats.n_invalid} invalid, BBB+ fraction {labels.mean():.4f}) "
         f"in {stats.wall_s:.3f} s: {stats.mol_per_s:.1f} mol/s "
         f"(featurize {stats.featurize_s:.3f} s, device path "
         f"{stats.device_s:.3f} s, chunk {chunk}) on {card} -> {out_csv}")
    return stats.mol_per_s


def phase_reference(model: ScreeningModel, n: int, seed: int, cpu) -> dict:
    """Phase 3: one chunk through the production device function (default
    device) against the CPU float32 reference."""
    smiles = synthetic_smiles(n, seed=seed, validate=False)
    packed, _ = nb.fingerprints_packed(smiles, model.fp_kind, model.n_bits)
    w, c0 = project_weights(model.scaler_mean, model.scaler_scale,
                            model.pca_mean, model.pca_components)
    z_dev = np.asarray(packed_project(jnp.asarray(packed), jnp.asarray(w),
                                      jnp.asarray(c0)))
    p_dev = np.asarray(_make_packed_device_fn(model)(jnp.asarray(packed)))
    z_ref, p_ref = reference_proba(model, packed, cpu)

    z_err = float(np.max(np.abs(z_dev - z_ref)))
    dp = np.abs(p_dev - p_ref)
    flip = (p_dev > model.threshold) != (p_ref > model.threshold)
    out = np.nonzero(flip | (dp > P_ATOL))[0]
    label_agree = 1.0 - flip.mean()
    p_agree = float((dp <= P_ATOL).mean())
    _log(f"phase 3: {n} rows, max |Δz| {z_err:.3e} (limit {Z_ATOL}), "
         f"labels agree {label_agree:.6f}, |Δp| ≤ {P_ATOL} on {p_agree:.6f} "
         f"(limit {AGREE_FRAC}), max |Δp| {float(dp.max()):.3e}")
    host = _host_model(model).ensemble
    dists = []
    for i in out:
        d = threshold_distance(host, z_ref[i])
        dists.append(d)
        _log(f"phase 3: row {i}: p_dev {p_dev[i]:.7f} p_ref {p_ref[i]:.7f} "
             f"threshold distance {d:.3e}")
    assert z_err <= Z_ATOL, z_err
    assert label_agree >= AGREE_FRAC and p_agree >= AGREE_FRAC
    assert all(d < Z_ATOL for d in dists), dists
    return {"z_err": z_err, "label_agree": label_agree, "p_agree": p_agree,
            "outliers": len(out)}


def phase_mesh(model: ScreeningModel, devices, rows_per_device: int,
               seed: int, out_dir: str, n_timed: int = N_SCREEN) -> dict:
    """--cards: one dispatch of len(devices) × rows_per_device molecules
    over a 1-D 'data' mesh against the same stream on devices[0], through
    ``screen()`` (CSV labels identical) and the device function itself
    (labels identical, |Δp| ≤ MESH_P_ATOL). Then both are timed over
    ``n_timed`` molecules with their executables already compiled.
    Returns molecules per second of each."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(devices), ("data",))
    n = rows_per_device * len(devices)
    rows, _ = _planted_stream(n, seed)
    paths = {k: os.path.join(out_dir, f"screen_{k}.csv")
             for k in ("mesh", "one")}
    with jax.default_device(devices[0]):
        s_mesh = screen(model, iter(rows), out_csv=paths["mesh"],
                        chunk_size=n, mesh=mesh)
        s_one = screen(model, iter(rows), out_csv=paths["one"],
                       chunk_size=rows_per_device)
    got = {k: _read_csv(p) for k, p in paths.items()}
    assert [r[2] for r in got["mesh"]] == [r[2] for r in got["one"]], \
        "mesh and single-device CSV labels differ"

    packed, _ = nb.fingerprints_packed([r[0] for r in rows], model.fp_kind,
                                       model.n_bits)
    p_mesh = np.asarray(_make_packed_device_fn(model, mesh)(
        jax.device_put(packed, NamedSharding(mesh, P("data")))))
    run_one = _make_packed_device_fn(model)
    with jax.default_device(devices[0]):
        p_one = np.concatenate([
            np.asarray(run_one(jnp.asarray(packed[i:i + rows_per_device])))
            for i in range(0, n, rows_per_device)])
    dp = float(np.max(np.abs(p_mesh - p_one)))
    same = bool(np.array_equal(p_mesh > model.threshold,
                               p_one > model.threshold))
    _log(f"mesh: {len(devices)} devices × {rows_per_device} rows vs 1 "
         f"device: labels identical {same}, max |Δp| {dp:.3e} (limit "
         f"{MESH_P_ATOL})")
    assert same and dp <= MESH_P_ATOL, (same, dp)

    # the screens above compiled both chunk shapes; these compile nothing
    timed, _ = _planted_stream(n_timed, seed + 1)
    rate = {}
    with jax.default_device(devices[0]):
        for name, kw in (("mesh", dict(chunk_size=n, mesh=mesh)),
                         ("one", dict(chunk_size=rows_per_device))):
            s = screen(model, iter(timed), out_csv=None, **kw)
            rate[name] = s.mol_per_s
            _log(f"mesh: timed {name}: {s.n_molecules} molecules in "
                 f"{s.wall_s:.3f} s, {s.mol_per_s:.1f} mol/s (featurize "
                 f"{s.featurize_s:.3f} s, device path {s.device_s:.3f} s, "
                 f"chunk {kw['chunk_size']})")
    _log(f"mesh: {len(devices)}-device mesh {rate['mesh']:.1f} mol/s vs 1 "
         f"device {rate['one']:.1f} mol/s (ratio "
         f"{rate['mesh'] / rate['one']:.3f})")
    return rate


def _peak(dev) -> str:
    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak} bytes"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=0,
                    help="run only the N-GPU 'data' mesh screen against "
                         "one GPU")
    ap.add_argument("--out", default=".smoke_out",
                    help="directory for the result CSVs")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{devices[0].platform} devices", file=sys.stderr)
        return 2
    need = max(args.cards, 1)
    if len(devices) < need:
        print(f"chip_smoke: --cards {args.cards} needs {need} GPUs; JAX "
              f"found {len(devices)}", file=sys.stderr)
        return 2
    if not nb.available():
        print("chip_smoke: the native featurizer did not build",
              file=sys.stderr)
        return 2
    import jaxlib

    # the float32 reference runs on JAX's CPU backend in this same process
    gpu, cpu = devices[0], jax.devices("cpu")[0]
    cards = gpu_name_and_power_limit()
    for line in cards:
        _log(line)
    _log(f"device_kind {gpu.device_kind}, {len(devices)} device(s); jax "
         f"{jax.__version__}, jaxlib {jaxlib.__version__}")
    os.makedirs(args.out, exist_ok=True)

    if args.cards:
        with jax.default_device(cpu):       # training is not under test here
            model = _host_model(train_seeded_model(seed=SEED_TRAIN))
        phase_mesh(model, devices[:args.cards], CHUNK, SEED_MESH, args.out)
        _log(f"mesh: peak_bytes_in_use {_peak(gpu)}")
    else:
        model = phase_model(B3DB_CLASSIFICATION_SIZE, SEED_TRAIN, gpu, cpu)
        _log(f"phase 1: peak_bytes_in_use {_peak(gpu)}")
        phase_screen(model, N_SCREEN, SEED_SCREEN, CHUNK, args.out, cards[0])
        _log(f"phase 2: peak_bytes_in_use {_peak(gpu)}")
        phase_reference(model, CHUNK, SEED_REF, cpu)
        _log(f"phase 3: peak_bytes_in_use {_peak(gpu)}")
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
