"""Benchmark: end-to-end virtual-screening throughput on an NVIDIA GPU.

Measures molecules/s/device through the full screening path — host C++
featurization (SMILES → packed Morgan bits) overlapped with on-device
scaler→PCA→forest inference, the reference's virtualscreening.py flow
(SURVEY.md §3.5) — over seeded synthetic drug-like molecules, scored by the
seeded model of the shipped shape (``train_seeded_model``: Morgan 2048 →
PCA 30 → 300-tree depth-6 GBDT). On several devices the molecule axis
shards over a 1-D 'data' mesh.

Beside it, an MFU probe of one batched-folds training step of the flagship
multimodal regressor: XLA cost_analysis FLOPs ÷ step time ÷ the device's
bf16 peak from ``PEAK_BF16_FLOPS``. The probe needs flax; without it the
probe reports "not measured".

    python bench.py               # screen + MFU probe; one JSON line last
    python bench.py --trace DIR   # profiler traces written under DIR: device
                                  # time per chunk of the screening program
                                  # and of its projection, and the device's
                                  # busy and idle shares of one whole screen

Needs a GPU: a run that finds none fails. Detail goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# Dense bf16 tensor-core peak FLOP/s per device, keyed by jax device_kind.
# Source: NVIDIA H100 Tensor Core GPU datasheet, SXM5 part, without sparsity.
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}

N_MOLS = 200_000
CHUNK = 16_384
DISPATCH_WORKERS = 2
SEED_MODEL, SEED_FEED = 0, 7


def peak_bf16_flops(device_kind: str) -> float:
    try:
        return PEAK_BF16_FLOPS[device_kind]
    except KeyError:
        raise KeyError(f"no bf16 peak on record for device kind "
                       f"{device_kind!r}; add it to PEAK_BF16_FLOPS with its "
                       f"source") from None


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def heavy_atom_summary(smiles, sample: int = 5000) -> dict:
    """Heavy-atom count distribution over the first ``sample`` molecules."""
    import numpy as np

    from bbbp.chem.smiles import MolFromSmiles

    counts = []
    for s in smiles[:sample]:
        mol = MolFromSmiles(s)
        if mol is not None:
            counts.append(sum(1 for a in mol.atoms if a.z > 1))
    q = np.percentile(counts, [0, 10, 50, 90, 100])
    return {"n": len(counts), "mean": float(np.mean(counts)),
            "min_p10_p50_p90_max": [float(v) for v in q]}


def _train_mfu_probe(peak: float, folds: int = 10, batch: int = 32) -> dict:
    """One batched-folds training step of the flagship model on bench-sized
    shapes: step time, XLA-estimated FLOPs, and MFU against ``peak``.
    ``folds`` is the vmapped batched axis."""
    import jax
    import jax.numpy as jnp
    import optax
    from bbbp.models.transformer_cnn import MultiModalRegressor

    fp_dim, side = 191, 128
    model = MultiModalRegressor(fp_dim=fp_dim, n_layers=4)
    tx = optax.adamw(3e-4)
    rng = jax.random.PRNGKey(0)

    def init_one(key):
        v = model.init({"params": key, "dropout": key},
                       jnp.ones((2, fp_dim)), jnp.ones((2, side, side, 3)),
                       train=True)
        return v["params"], v.get("batch_stats", {}), tx.init(v["params"])

    params, bs, opt = jax.jit(jax.vmap(init_one))(
        jax.random.split(rng, folds))

    def loss_fn(p, b, fp, img, y, key):
        variables = {"params": p}
        if b:
            variables["batch_stats"] = b
            pred, upd = model.apply(variables, fp, img, train=True,
                                    rngs={"dropout": key},
                                    mutable=["batch_stats"])
            return jnp.mean((pred - y) ** 2), upd["batch_stats"]
        pred = model.apply(variables, fp, img, train=True,
                           rngs={"dropout": key})
        return jnp.mean((pred - y) ** 2), b

    def fold_step(p, b, o, fp, img, y, key):
        (l, nb), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, b, fp, img, y, key)
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), nb, o, l

    step = jax.jit(jax.vmap(fold_step))
    fp = jnp.ones((folds, batch, fp_dim), jnp.float32)
    img = jnp.ones((folds, batch, side, side, 3), jnp.bfloat16)
    y = jnp.zeros((folds, batch), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), folds)

    compiled = step.lower(params, bs, opt, fp, img, y, keys).compile()
    flops = float(compiled.cost_analysis()["flops"])
    params, bs, opt, l = step(params, bs, opt, fp, img, y, keys)
    jax.block_until_ready(l)
    n_steps = 20
    t0 = time.perf_counter()
    for _ in range(n_steps):
        params, bs, opt, l = step(params, bs, opt, fp, img, y, keys)
    jax.block_until_ready(l)
    dt = (time.perf_counter() - t0) / n_steps
    return {"train_step_s": dt, "train_step_flops": flops,
            "train_mfu_vs_bf16_peak": flops / dt / peak,
            "train_folds_batched": folds, "train_batch_per_fold": batch}


def trace_chunk(model, out_dir: str, reps: int = 10) -> dict:
    """Device time of one CHUNK-row screening chunk, from profiler traces of
    the whole device program and of the projection compiled alone."""
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np

    from bbbp.ops.bitops import packed_project, project_weights
    from bbbp.pipelines.screen import _make_packed_device_fn
    from bbbp.utils.profiling import summarize_device_trace

    rng = np.random.default_rng(SEED_FEED)
    # AND of 5 random words: ~3% of bits set, about a Morgan fingerprint's
    words = rng.integers(0, 2 ** 32, (5, CHUNK, model.n_bits // 32),
                         dtype=np.uint32)
    packed = jnp.asarray(np.bitwise_and.reduce(words, axis=0))
    w, c0 = project_weights(model.scaler_mean, model.scaler_scale,
                            model.pca_mean, model.pca_components)
    w_d, c0_d = jnp.asarray(w), jnp.asarray(c0)
    programs = {"chunk": _make_packed_device_fn(model),
                "projection_alone": jax.jit(
                    lambda p: packed_project(p, w_d, c0_d))}
    out = {}
    for name, fn in programs.items():
        fn(packed).block_until_ready()                 # compile outside
        tdir = os.path.join(out_dir, name)
        with jax.profiler.trace(tdir):
            for _ in range(reps):
                fn(packed).block_until_ready()
        s = summarize_device_trace(tdir)
        out[name] = {
            "device_busy_us_per_chunk": s["busy_ns"] / reps / 1e3,
            "top_kernels_us_per_chunk": [
                (k, v / reps / 1e3) for k, v in s["top_kernels_ns"]]}
    out["projection_share_of_chunk"] = (
        out["projection_alone"]["device_busy_us_per_chunk"]
        / out["chunk"]["device_busy_us_per_chunk"])
    return out


def trace_screen(model, smiles, out_dir: str, mesh=None) -> dict:
    """Device busy and idle shares of one end-to-end screen (compiled
    beforehand), from a profiler trace of the whole run. Busy is the union
    of kernel and copy intervals on the device streams; the wall is the
    screen's own, which tracing lengthens."""
    import os

    import jax

    from bbbp.pipelines.screen import screen
    from bbbp.utils.profiling import summarize_device_trace

    kw = dict(out_csv=None, chunk_size=CHUNK, mesh=mesh,
              dispatch_workers=DISPATCH_WORKERS)
    screen(model, ((s, "w") for s in smiles[:CHUNK]), **kw)
    tdir = os.path.join(out_dir, "screen")
    with jax.profiler.trace(tdir):
        stats = screen(model, ((s, f"SYN{i:09d}") for i, s in
                               enumerate(smiles)), **kw)
    busy_s = summarize_device_trace(tdir)["busy_ns"] / 1e9
    return {"traced_wall_s": stats.wall_s, "device_busy_s": busy_s,
            "device_busy_share": busy_s / stats.wall_s,
            "device_idle_share": 1.0 - busy_s / stats.wall_s,
            "traced_molecules_per_s": stats.mol_per_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write profiler traces under DIR and report device "
                         "times from them instead of the timed screen")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _err(f"bench: needs an NVIDIA GPU; JAX found {dev.platform}")
        return 2
    from bbbp.data.zinc import synthetic_smiles
    from bbbp.native import bindings as nb
    from bbbp.pipelines.screen import screen, train_seeded_model
    from bbbp.utils.profiling import gpu_name_and_power_limit

    if not nb.available():
        _err("bench: the native featurizer did not build")
        return 2
    peak = peak_bf16_flops(dev.device_kind)
    n_dev = len(jax.devices())
    for line in gpu_name_and_power_limit():
        _err(f"# {line}")
    _err(f"# device_kind {dev.device_kind} x{n_dev}, jax {jax.__version__}")

    t0 = time.perf_counter()
    model = train_seeded_model(seed=SEED_MODEL)
    train_s = time.perf_counter() - t0
    smiles = synthetic_smiles(N_MOLS, seed=SEED_FEED, validate=False)
    _err(f"# feedstock: {N_MOLS} seeded synthetic molecules, heavy atoms "
         f"{json.dumps(heavy_atom_summary(smiles))}")

    mesh = None
    if n_dev > 1:
        import numpy as np
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()), ("data",))
    if args.trace:
        res = {**trace_chunk(model, args.trace),
               **trace_screen(model, smiles, args.trace, mesh)}
        _err(json.dumps(res, indent=1))
        print(json.dumps({
            "metric": "screening_chunk_device_us",
            "value": res["chunk"]["device_busy_us_per_chunk"],
            "unit": "us/chunk",
            "projection_share_of_chunk": res["projection_share_of_chunk"],
            "screen_device_idle_share": res["device_idle_share"],
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": n_dev}}))
        return 0
    # warm up at the same chunk size: one compiled executable serves every
    # chunk, so the timed run compiles nothing
    screen(model, ((s, "w") for s in smiles[:CHUNK]), out_csv=None,
           chunk_size=CHUNK, mesh=mesh, dispatch_workers=DISPATCH_WORKERS)
    stats = screen(model, ((s, f"SYN{i:09d}") for i, s in
                           enumerate(smiles)),
                   out_csv=None, chunk_size=CHUNK, mesh=mesh,
                   dispatch_workers=DISPATCH_WORKERS)
    per_dev = stats.mol_per_s / n_dev

    try:
        import flax  # noqa: F401
    except ImportError:
        mfu = {"train_mfu_vs_bf16_peak": "not measured: flax not installed"}
    else:
        mfu = _train_mfu_probe(peak)

    _err("# " + json.dumps({
        "molecules_per_s_per_device": per_dev,
        "n_molecules": stats.n_molecules, "n_invalid": stats.n_invalid,
        "wall_s": stats.wall_s, "featurize_s": stats.featurize_s,
        "device_path_s": stats.device_s,
        "screen_wall_over_featurize": stats.wall_s / max(stats.featurize_s,
                                                         1e-9),
        "model_train_s": train_s, "chunk_size": CHUNK,
        "dispatch_workers": DISPATCH_WORKERS, **mfu}))
    print(json.dumps({
        "metric": "screening_molecules_per_sec_per_device",
        "value": per_dev,
        "unit": "molecules/s/device",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_dev}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
