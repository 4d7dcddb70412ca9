"""Model + training-loop tests on the virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

rng = np.random.default_rng(7)


class TestModels:
    def _shapes(self, model, fp_dim=32, img_side=32):
        fp = jnp.ones((4, fp_dim))
        img = jnp.ones((4, img_side, img_side, 3))
        v = model.init({"params": jax.random.PRNGKey(0),
                        "dropout": jax.random.PRNGKey(1)}, fp, img, train=True)
        out = model.apply(v, fp, img, train=False)
        return out

    def test_multimodal_fusion_variants(self):
        from bbbp.models import MultiModalRegressor

        for fusion in ("multihead", "gate", "crossmodal"):
            m = MultiModalRegressor(fp_dim=32, n_layers=2, emb_dim=32,
                                    fusion=fusion, head_dims=(32,))
            out = self._shapes(m)
            assert out.shape == (4,), fusion
            assert np.isfinite(np.asarray(out)).all()

    def test_fp_tokens_mode(self):
        from bbbp.models import MultiModalRegressor

        m = MultiModalRegressor(fp_dim=32, n_layers=2, emb_dim=32,
                                fp_tokens=4, head_dims=(32,))
        out = self._shapes(m)
        assert out.shape == (4,)

    def test_flat_image_input_reshaped(self):
        from bbbp.models import MultiModalRegressor

        m = MultiModalRegressor(fp_dim=16, n_layers=1, emb_dim=16, head_dims=(16,))
        fp = jnp.ones((2, 16))
        img_flat = jnp.ones((2, 32 * 32 * 3))
        v = m.init({"params": jax.random.PRNGKey(0)}, fp, img_flat, train=False)
        out = m.apply(v, fp, img_flat, train=False)
        assert out.shape == (2,)

    def test_dual_branch_mlp(self):
        from bbbp.models import DualBranchMLP

        m = DualBranchMLP(fp_dims=(32, 16), img_dims=(32, 16), head_dims=(16,))
        fp = jnp.ones((4, 24))
        img = jnp.ones((4, 300))
        v = m.init({"params": jax.random.PRNGKey(0),
                    "dropout": jax.random.PRNGKey(1)}, fp, img, train=True)
        out = m.apply(v, fp, img, train=False)
        assert out.shape == (4,)

    def test_flow_model_forward_and_reverse_layer(self):
        from bbbp.models.flow import FlowModel, FlowLayer

        m = FlowModel(hidden_dim=16, n_layers=2, n_classes=2)
        x = jnp.ones((4, 10))
        v = m.init({"params": jax.random.PRNGKey(0)}, x, train=False)
        logits = m.apply(v, x, train=False)
        assert logits.shape == (4, 2)
        layer = FlowLayer(dim=8)
        lv = layer.init({"params": jax.random.PRNGKey(0)}, jnp.ones((2, 8)))
        y = layer.apply(lv, jnp.ones((2, 8)))
        back = layer.apply(lv, y, reverse=True)
        assert back.shape == (2, 8)


class TestKFoldTrainer:
    def test_oof_covers_all_and_learns(self):
        from bbbp.models import MultiModalRegressor
        from bbbp.train.loop import train_multimodal_cv

        N = 90
        fp = rng.standard_normal((N, 16)).astype(np.float32)
        img = rng.standard_normal((N, 16, 16, 3)).astype(np.float32) * 0.1
        y = (fp[:, 0] + 0.1 * rng.standard_normal(N)).astype(np.float32)
        m = MultiModalRegressor(fp_dim=16, n_layers=1, emb_dim=16, head_dims=(16,))
        res = train_multimodal_cv(m, fp, img, y, n_folds=3, epochs=25,
                                  batch_size=16, lr=3e-3, seed=0)
        # every sample got exactly one OOF prediction
        assert set(np.concatenate(res.fold_test_idx).tolist()) == set(range(N))
        r2 = 1 - ((res.oof_pred - y) ** 2).mean() / y.var()
        assert r2 > 0.3
        # losses decrease
        assert res.train_losses[:, -1].mean() < res.train_losses[:, 0].mean()

    def test_kfold_indices_partition(self):
        from bbbp.train.loop import kfold_indices

        folds = kfold_indices(103, 5, seed=1)
        allidx = np.concatenate(folds)
        assert len(allidx) == 103 and len(set(allidx.tolist())) == 103


class TestMesh:
    def test_make_mesh_and_shard(self):
        from bbbp.parallel import make_mesh, batch_sharding

        mesh = make_mesh()
        assert mesh.shape["data"] == 8
        mesh2 = make_mesh(model_parallel=2)
        assert mesh2.shape == {"data": 4, "model": 2}
        x = np.ones((16, 4), np.float32)
        sharded = jax.device_put(x, batch_sharding(mesh, 2))
        assert sharded.sharding.num_devices == 8

    def test_prefetch_matches_plain(self):
        from bbbp.parallel import prefetch_to_device

        items = [np.full((4,), i, np.float32) for i in range(10)]
        out = list(prefetch_to_device(iter(items), depth=2))
        assert len(out) == 10
        for i, o in enumerate(out):
            assert float(np.asarray(o)[0]) == i


class TestGraftEntry:
    def test_entry_and_dryrun(self):
        import __graft_entry__ as g

        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert out.shape == (8,)
        g.dryrun_multichip(8)


class TestMeshTraining:
    def test_fold_axis_shards_over_mesh(self):
        from bbbp.models import MultiModalRegressor
        from bbbp.parallel import make_mesh
        from bbbp.train.loop import train_multimodal_cv

        mesh = make_mesh()  # 8 virtual CPU devices, data axis = 8
        N = 64
        fp = rng.standard_normal((N, 8)).astype(np.float32)
        img = rng.standard_normal((N, 8, 8, 3)).astype(np.float32)
        y = (fp[:, 0]).astype(np.float32)
        m = MultiModalRegressor(fp_dim=8, n_layers=1, emb_dim=8, head_dims=(8,))
        res = train_multimodal_cv(m, fp, img, y, n_folds=8, epochs=3,
                                  batch_size=8, lr=1e-3, seed=0, mesh=mesh)
        assert np.isfinite(res.oof_pred).all()
        # params actually distributed: one leaf spans all 8 devices
        leaf = jax.tree.leaves(res.params)[0]
        assert len(leaf.sharding.device_set) == 8


class TestGNN:
    def test_gcn_learns_ring_count(self):
        from bbbp.chem.graph_features import graph_features
        from bbbp.models.gnn import GCNRegressor
        import optax

        smiles = (["c1ccccc1", "CCCCCC", "c1ccncc1", "CCOCC", "c1ccc2ccccc2c1",
                   "CCCCCCCC", "c1ccoc1", "CCNCC"] * 8)
        y = np.array([1, 0, 1, 0, 2, 0, 1, 0] * 8, dtype=np.float32)
        feats, adj, mask, bad = graph_features(smiles, max_atoms=16)
        assert bad == []
        model = GCNRegressor(hidden=(32, 32), head=(32,))
        rngk = jax.random.PRNGKey(0)
        v = model.init({"params": rngk, "dropout": rngk},
                       feats[:2], adj[:2], mask[:2], train=True)
        tx = optax.adam(3e-3)
        opt = tx.init(v["params"])

        @jax.jit
        def step(p, opt, f, a, m, yy, key):
            def loss(p):
                pred = model.apply({"params": p}, f, a, m, train=True,
                                   rngs={"dropout": key})
                return jnp.mean((pred - yy) ** 2)
            l, g = jax.value_and_grad(loss)(p)
            up, opt = tx.update(g, opt)
            return optax.apply_updates(p, up), opt, l

        p = v["params"]
        key = rngk
        for i in range(150):
            key, sub = jax.random.split(key)
            p, opt, l = step(p, opt, jnp.asarray(feats), jnp.asarray(adj),
                             jnp.asarray(mask), jnp.asarray(y), sub)
        assert float(l) < 0.1, float(l)
