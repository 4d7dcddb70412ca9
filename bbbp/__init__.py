"""bbbp — JAX multi-modal deep-ensemble framework for BBBP prediction.

A ground-up JAX/XLA re-design of the capabilities of
FengDushuo/BBBP-Multi-Modal-Deep-Ensemble-Framework (see SURVEY.md):

- ``bbbp.chem``      SMILES parser, fingerprints (Morgan/path/MACCS-style),
                         2-D depiction — built from scratch (no RDKit in image),
                         with a threaded C++ fast path in ``bbbp.native``.
- ``bbbp.data``      B3DB dataset loaders, ZINC stream readers, seeded
                         synthetic feedstock.
- ``bbbp.ops``       XLA feature-engineering ops: scaler, PCA, interaction
                         features, isolation forest, SMOTE-Tomek, metrics,
                         tensorized decision-forest engine, packed-bit unpack.
- ``bbbp.models``    Flax model zoo: dual-branch MLP, Transformer+CNN with
                         attention fusion, SMILES-BERT, flow-MLP, linear zoo.
- ``bbbp.train``     jitted training loops, K-fold/ensemble mesh
                         parallelism, stacking + voting pipelines.
- ``bbbp.parallel``  mesh construction, sharding rules, host→device prefetch.
- ``bbbp.pipelines`` CLI entry points mirroring the reference's scripts
                         (featurize / preprocess / train-classify / train-regress /
                         train-bert / screen).
- ``bbbp.reporting`` metrics CSVs, plots, attribution (integrated gradients,
                         exact TreeSHAP on the JAX forests).
"""

import os

__version__ = "0.1.0"

# Persistent compile cache of device (non-CPU) processes: a fixed path in the
# checkout, since the path is part of what a later process looks up.
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_persistent_compile_cache() -> None:
    """Point JAX's persistent compilation cache at ``COMPILE_CACHE_DIR``.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing is set here. Processes pinned to the CPU backend (the tests)
    keep no cache: XLA:CPU executables are machine code for the host they
    were built on, and those compiles take seconds.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if os.environ.get("JAX_PLATFORMS", "").split(",")[0].strip() == "cpu":
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)


_enable_persistent_compile_cache()
