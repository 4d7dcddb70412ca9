"""Tuned A1 baseline on pooled graph descriptors (VERDICT r3 missing #2 /
item 6): the reference trains its 8-model GridSearchCV baseline on DeepChem
ConvMol atom features (Descriptors/model_train_gpu.py:127-137, features from
create_descriptors_gpu.py:26-51). Here the graph featurizer's atom-feature
matrix pools to one static-width row per molecule
(chem.graph_features.pooled_graph_features) and feeds the same grid-searched
zoo. Also writes the gpu_features.npy contract next to the run artifacts.

Run: python -u scripts/round4_graph_baseline.py
"""
import json
import sys
import time

sys.path.insert(0, "/root/repo")

T0 = time.time()


def log(msg):
    print(f"[r4gb +{time.time()-T0:7.0f}s] {msg}", flush=True)


import jax
import jax.numpy as jnp

assert float(jnp.ones((64, 64)).sum()) == 4096.0
log(f"devices: {jax.devices()}")

from bbbp.pipelines.featurize import featurize_graph_b3db
from bbbp.train.baseline import BaselineConfig, run_baseline

OUT = "/root/repo/results/baseline_graph_r4"
featurize_graph_b3db("classification", OUT)
rep = run_baseline(BaselineConfig(fp_kind="graph", tune=True, out_dir=OUT),
                   verbose=True)
with open("/root/repo/results/baseline_graph_tuned_r4.json", "w") as f:
    json.dump(rep, f, indent=1)
log(f"DONE best={rep['_best']}")
