"""What running on the GPU rests on, checked on the CPU: the screening
path's import closure, the compile-cache location, the seeded feedstock and
the multi-device dry run's refusal to fake devices."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **env_changes) -> str:
    env = dict(os.environ)
    for k, v in env_changes.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_screen_import_loads_no_pandas_or_flax():
    loaded = _run("import sys, bbbp.pipelines.screen; "
                  "print(sorted({m.split('.')[0] for m in sys.modules} "
                  "& {'pandas', 'flax', 'matplotlib', 'sklearn'}))")
    assert loaded == "[]"


@pytest.mark.parametrize("env,expected", [
    ({"JAX_COMPILATION_CACHE_DIR": None, "JAX_PLATFORMS": None},
     os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/tmp/jcc-x", "JAX_PLATFORMS": None},
     "/tmp/jcc-x"),
    ({"JAX_COMPILATION_CACHE_DIR": None, "JAX_PLATFORMS": "cpu"}, "None"),
])
def test_compile_cache_dir(env, expected):
    got = _run("import bbbp, jax; print(jax.config.jax_compilation_cache_dir)",
               **env)
    assert got == expected


def test_synthetic_smiles_is_deterministic_per_seed():
    from bbbp.data.zinc import synthetic_smiles

    a = synthetic_smiles(200, seed=11, validate=False)
    assert a == synthetic_smiles(200, seed=11, validate=False)
    assert a != synthetic_smiles(200, seed=12, validate=False)
    assert synthetic_smiles(50, seed=11) == a[:50]     # all valid: same draw


def test_tpsa_bbb_labels_follow_the_cutoff():
    from bbbp.data.zinc import tpsa_bbb_labels

    # benzene (TPSA 0), glycine-like acid+amine (TPSA ~63), a polar
    # tri-acid (TPSA > 90), and an unparseable string
    labels = tpsa_bbb_labels(["c1ccccc1", "NCC(=O)O",
                              "OC(=O)CC(O)(CC(=O)O)C(=O)O", "C1CC("])
    assert labels.tolist() == [1, 1, 0, 0]
    assert labels.dtype == np.int32


def test_dryrun_multichip_refuses_more_devices_than_it_has():
    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="needs 16 devices"):
        g.dryrun_multichip(16)
