"""SMILES-BERT: a compact BERT-style encoder classifier in flax (family C).

The reference fine-tunes HF ``bert-base-uncased`` via a sklearn-compatible
wrapper (reference: Models/model_train_bert.py:18-158 — ReviewDataset,
SklearnBertClassifier with fit/predict/score/save/load/get_params). Its driver
has a notable quirk: it feeds **stringified PCA(100) fingerprint vectors**
through the wordpiece tokenizer rather than raw SMILES (:39, SURVEY.md §2.6 C3).

Redesign: a from-scratch flax encoder (learned positional embeddings,
pre-LN transformer blocks, CLS pooling) sized for the task; a regex SMILES
tokenizer with a vocabulary built from the training corpus (atom-level tokens);
``input_mode='compat_vector'`` reproduces the stringified-vector quirk by
tokenizing the number strings. bfloat16 compute, f32 softmax/loss.
"""

from __future__ import annotations

import functools
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

PAD, CLS, UNK, MASK = 0, 1, 2, 3
_SMILES_TOKEN_RE = re.compile(
    r"(\[[^\]]+\]|Br|Cl|Si|Se|se|@@|@|==|[BCNOPSFIbcnops]|\d|%\d\d|[=#$:\-+\\/().*~])"
)
_NUM_RE = re.compile(r"(-?\d+\.?\d*(?:e-?\d+)?|\S)")


class SmilesTokenizer:
    """Atom-level regex tokenizer with corpus-built vocabulary."""

    def __init__(self, max_len: int = 128):
        self.max_len = max_len
        self.vocab: Dict[str, int] = {"[PAD]": PAD, "[CLS]": CLS, "[UNK]": UNK,
                                      "[MASK]": MASK}

    def _split(self, text: str) -> List[str]:
        return _SMILES_TOKEN_RE.findall(text)

    def fit(self, texts: Sequence[str]) -> "SmilesTokenizer":
        for t in texts:
            for tok in self._split(t):
                if tok not in self.vocab:
                    self.vocab[tok] = len(self.vocab)
        return self

    def encode(self, text: str) -> np.ndarray:
        ids = [CLS] + [self.vocab.get(t, UNK) for t in self._split(text)]
        ids = ids[: self.max_len]
        out = np.full(self.max_len, PAD, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def to_json(self) -> str:
        return json.dumps({"max_len": self.max_len, "vocab": self.vocab})

    @staticmethod
    def from_json(s: str) -> "SmilesTokenizer":
        d = json.loads(s)
        tok = SmilesTokenizer(d["max_len"])
        tok.vocab = {k: int(v) for k, v in d["vocab"].items()}
        return tok


class NumberStringTokenizer(SmilesTokenizer):
    """compat_vector mode: tokenizes str(np.ndarray)-style number strings —
    the reference's stringified-PCA-vector quirk (model_train_bert.py:39)."""

    def _split(self, text: str) -> List[str]:
        return _NUM_RE.findall(text)


class BertEncoder(nn.Module):
    vocab_size: int
    n_layers: int = 4
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 512
    max_len: int = 128
    n_classes: int = 2
    dropout: float = 0.1
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, ids, train: bool = False, mlm: bool = False):
        """``mlm=False`` → [B, n_classes] classification logits from the CLS
        pooler; ``mlm=True`` → [B, L, vocab] per-position token logits (the
        masked-language-model pretraining head; the transformer trunk
        parameters are shared between the two heads by name, so a pretrained
        trunk drops straight into the classifier — train/bert_pretrain)."""
        mask = (ids != PAD)
        x = nn.Embed(self.vocab_size, self.d_model, dtype=self.dtype,
                     name="tok_emb")(ids)
        pos = self.param("pos_emb", nn.initializers.normal(0.02),
                         (1, self.max_len, self.d_model), jnp.float32)
        x = x + pos.astype(self.dtype)
        x = nn.Dropout(self.dropout, deterministic=not train)(x)
        attn_mask = mask[:, None, None, :] & mask[:, None, :, None]
        for i in range(self.n_layers):
            h = nn.LayerNorm(dtype=self.dtype, name=f"ln_a{i}")(x)
            a = nn.MultiHeadDotProductAttention(
                num_heads=self.n_heads, dtype=self.dtype,
                dropout_rate=self.dropout, deterministic=not train,
                name=f"attn{i}")(h, h, mask=attn_mask)
            x = x + a
            h = nn.LayerNorm(dtype=self.dtype, name=f"ln_f{i}")(x)
            f = nn.Dense(self.d_ff, dtype=self.dtype, name=f"ff{i}_1")(h)
            f = nn.gelu(f)
            f = nn.Dense(self.d_model, dtype=self.dtype, name=f"ff{i}_2")(f)
            f = nn.Dropout(self.dropout, deterministic=not train)(f)
            x = x + f
        x = nn.LayerNorm(dtype=self.dtype, name="ln_out")(x)
        if mlm:
            h = nn.Dense(self.d_model, dtype=self.dtype, name="mlm_dense")(x)
            h = nn.gelu(h)
            h = nn.LayerNorm(dtype=self.dtype, name="mlm_ln")(h)
            return nn.Dense(self.vocab_size, dtype=jnp.float32,
                            name="mlm_head")(h.astype(jnp.float32))
        cls = x[:, 0]
        pooled = jnp.tanh(nn.Dense(self.d_model, dtype=self.dtype,
                                   name="pooler")(cls))
        logits = nn.Dense(self.n_classes, dtype=jnp.float32, name="head")(
            pooled.astype(jnp.float32))
        return logits


class BertRegressor(nn.Module):
    """Scalar-output encoder for the regression stack's SMILES leg. The
    encoder submodule is named 'enc' so an MLM-pretrained trunk warm-starts
    via train_cv(warm_start={'enc': pretrained_params})."""

    vocab_size: int
    n_layers: int = 4
    d_model: int = 128
    n_heads: int = 4
    max_len: int = 128
    dropout: float = 0.1

    @nn.compact
    def __call__(self, ids, train: bool = False):
        z = BertEncoder(vocab_size=self.vocab_size, n_layers=self.n_layers,
                        d_model=self.d_model, n_heads=self.n_heads,
                        d_ff=4 * self.d_model, max_len=self.max_len,
                        n_classes=1, dropout=self.dropout,
                        name="enc")(ids, train=train)
        return z[..., 0]


def merge_pretrained(init_params, pretrained):
    """Copy every pretrained leaf whose path+shape matches into a freshly
    initialised tree (the trunk transfers; absent heads stay fresh)."""
    def merge(a, b):
        if isinstance(a, dict):
            return {k: (merge(a[k], b[k]) if isinstance(b, dict) and k in b
                        else a[k]) for k in a}
        if hasattr(a, "shape") and hasattr(b, "shape") and a.shape == b.shape:
            return b
        return a
    return merge(init_params, pretrained)


class BertClassifier:
    """sklearn-compatible wrapper (fit/predict/predict_proba/score/evaluate/
    save/load/get_params/set_params) — the SklearnBertClassifier equivalent
    (reference: Models/model_train_bert.py:57-158). ``pretrained_dir`` loads
    an MLM-pretrained encoder directory (train.bert_pretrain) and fine-tunes
    it — the equivalent here of the reference starting from pretrained
    ``bert-base-uncased`` (:57-94)."""

    def __init__(self, epochs: int = 3, batch_size: int = 32, lr: float = 2e-4,
                 n_layers: int = 4, d_model: int = 128, n_heads: int = 4,
                 max_len: int = 128, input_mode: str = "smiles",
                 warmup_frac: float = 0.1, seed: int = 0,
                 pretrained_dir: Optional[str] = None):
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.n_layers = n_layers
        self.d_model = d_model
        self.n_heads = n_heads
        self.max_len = max_len
        self.input_mode = input_mode     # smiles | compat_vector
        self.warmup_frac = warmup_frac
        self.seed = seed
        self.pretrained_dir = pretrained_dir
        self.tokenizer: Optional[SmilesTokenizer] = None
        self.params_ = None
        self.model: Optional[BertEncoder] = None

    # -- sklearn plumbing for grid search --
    def get_params(self, deep: bool = True):
        return {k: getattr(self, k) for k in
                ("epochs", "batch_size", "lr", "n_layers", "d_model",
                 "n_heads", "max_len", "input_mode", "warmup_frac", "seed",
                 "pretrained_dir")}

    def set_params(self, **p):
        for k, v in p.items():
            setattr(self, k, v)
        return self

    def _texts(self, x) -> List[str]:
        if self.input_mode == "compat_vector":
            # reproduce str(vector) feeding (reference :39)
            return [str(np.asarray(row)) for row in x]
        return list(x)

    def fit(self, x, y) -> "BertClassifier":
        import optax

        texts = self._texts(x)
        y = np.asarray(y, np.int32)
        pretrained_params = None
        if self.pretrained_dir:
            # fixed vocabulary + architecture from the pretrained directory
            import pickle

            with open(os.path.join(self.pretrained_dir, "config.json")) as f:
                pcfg = json.load(f)
            for k in ("n_layers", "d_model", "n_heads", "max_len"):
                setattr(self, k, pcfg[k])
            with open(os.path.join(self.pretrained_dir, "tokenizer.json")) as f:
                self.tokenizer = SmilesTokenizer.from_json(f.read())
            with open(os.path.join(self.pretrained_dir, "params.pkl"), "rb") as f:
                pretrained_params = pickle.load(f)
        else:
            tok_cls = (NumberStringTokenizer
                       if self.input_mode == "compat_vector" else SmilesTokenizer)
            self.tokenizer = tok_cls(self.max_len).fit(texts)
        ids = self.tokenizer.encode_batch(texts)
        self.model = BertEncoder(
            vocab_size=self.tokenizer.vocab_size, n_layers=self.n_layers,
            d_model=self.d_model, n_heads=self.n_heads,
            d_ff=4 * self.d_model, max_len=self.max_len)
        n = len(y)
        bs = min(self.batch_size, n)
        steps_per_epoch = max(1, n // bs)
        total_steps = self.epochs * steps_per_epoch
        sched = optax.warmup_cosine_decay_schedule(
            0.0, self.lr, max(1, int(self.warmup_frac * total_steps)),
            max(2, total_steps))
        tx = optax.adamw(sched, weight_decay=0.01)

        root = jax.random.PRNGKey(self.seed)
        model = self.model

        @jax.jit
        def init_fn(key, sample):
            variables = model.init({"params": key, "dropout": key},
                                   sample, train=True)
            return variables["params"], tx.init(variables["params"])

        params, opt_state = init_fn(root, jnp.asarray(ids[:2]))
        if pretrained_params is not None:
            params = jax.tree.map(jnp.asarray,
                                  merge_pretrained(
                                      jax.tree.map(np.asarray, params),
                                      pretrained_params))
            opt_state = tx.init(params)

        @jax.jit
        def train_step(params, opt_state, ids_b, y_b, rng):
            def loss_fn(p):
                logits = model.apply({"params": p}, ids_b, train=True,
                                     rngs={"dropout": rng})
                onehot = jax.nn.one_hot(y_b, logits.shape[-1])
                return -jnp.mean(jnp.sum(
                    onehot * jax.nn.log_softmax(logits), axis=-1))

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        host_rng = np.random.default_rng(self.seed)
        ids_d = jnp.asarray(ids)
        y_d = jnp.asarray(y)
        rng_key = root
        self.loss_history_ = []
        for epoch in range(self.epochs):
            perm = host_rng.permutation(n)[: steps_per_epoch * bs]
            perm = perm.reshape(steps_per_epoch, bs)
            ep_loss = 0.0
            for step in range(steps_per_epoch):
                rng_key, sub = jax.random.split(rng_key)
                b = jnp.asarray(perm[step])
                params, opt_state, loss = train_step(
                    params, opt_state, ids_d[b], y_d[b], sub)
                ep_loss += float(loss)
            self.loss_history_.append(ep_loss / steps_per_epoch)
        self.params_ = params
        return self

    def _logits(self, x) -> np.ndarray:
        texts = self._texts(x)
        ids = self.tokenizer.encode_batch(texts)
        model = self.model

        @jax.jit
        def fwd(params, ids_b):
            return model.apply({"params": params}, ids_b, train=False)

        outs = []
        for start in range(0, len(ids), 256):
            outs.append(np.asarray(fwd(self.params_,
                                       jnp.asarray(ids[start:start + 256]))))
        return np.concatenate(outs)

    def predict_proba(self, x) -> np.ndarray:
        z = self._logits(x)
        e = np.exp(z - z.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    def predict(self, x) -> np.ndarray:
        return self._logits(x).argmax(1)

    def score(self, x, y) -> float:
        return float((self.predict(x) == np.asarray(y)).mean())

    def evaluate(self, x, y) -> Dict[str, float]:
        from bbbp.ops import metrics

        proba = self.predict_proba(x)[:, 1]
        pred = (proba > 0.5).astype(int)
        return metrics.classification_report(np.asarray(y), pred, proba)

    def save(self, path: str) -> None:
        import pickle

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "tokenizer.json"), "w") as f:
            f.write(self.tokenizer.to_json())
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.get_params(), f)
        with open(os.path.join(path, "params.pkl"), "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, self.params_), f)

    @staticmethod
    def load(path: str) -> "BertClassifier":
        import pickle

        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        clf = BertClassifier(**cfg)
        with open(os.path.join(path, "tokenizer.json")) as f:
            tok_cls = NumberStringTokenizer if cfg["input_mode"] == "compat_vector" \
                else SmilesTokenizer
            clf.tokenizer = tok_cls.from_json(f.read())
        with open(os.path.join(path, "params.pkl"), "rb") as f:
            clf.params_ = pickle.load(f)
        clf.model = BertEncoder(
            vocab_size=clf.tokenizer.vocab_size, n_layers=clf.n_layers,
            d_model=clf.d_model, n_heads=clf.n_heads,
            d_ff=4 * clf.d_model, max_len=clf.max_len)
        return clf
