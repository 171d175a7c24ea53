"""bf16 gradients of the port against the reference (CPU).

The architecture of ``examples_torch/train_quantize_serve.py --preset
100m``: qwen1.5-0.5b's family (qkv bias, the embedding table tied to the
unembedding), here its smoke config with ``dtype=bfloat16`` (activations
bf16, params f32, as ``get_config`` computes). ``Model.loss`` gradients
(``loss.backward()``) are held against ``jax.grad`` of the reference's
``loss`` on the same params and batch:

* the loss within 5e-4 relative;
* every leaf within ``LEAF_TOL`` of that leaf's largest |g| (measured:
  at most 1.82e-2, the bias of ``wv`` on the second batch; bf16's unit
  roundoff is 2**-8 = 3.9e-3, and the two libraries sum the bf16
  products in different orders);
* every leaf no more than ``F32_RATIO`` times as far from the
  reference's f32 gradient (the same model with ``dtype=float32``) as
  the reference's own bf16 gradient is (measured: at most 1.28x,
  ``final_norm``): the port's bf16 rounding costs what the reference's
  does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import Model as JModel
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.models import Model as TModel

ARCH = "qwen1.5-0.5b"
B, S = 2, 24
LEAF_TOL = 3e-2
F32_RATIO = 2.0


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    batch["labels"][0, :3] = -1                 # masked positions
    return batch


@functools.lru_cache(maxsize=None)
def _params():
    jm = JModel(dataclasses.replace(j_smoke(ARCH), dtype=jnp.bfloat16))
    return jax.tree_util.tree_map(lambda p: p.astype(jnp.float32),
                                  jm.init(jax.random.PRNGKey(0)))


def _ref_grads(dtype, jp, batch):
    jm = JModel(dataclasses.replace(j_smoke(ARCH), dtype=dtype))
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: np.asarray(g, np.float32)
                         for k, g in _leaves(grads)}


def _port_grads(jp, batch):
    tm = TModel(dataclasses.replace(t_smoke(ARCH), dtype=torch.bfloat16))
    assert tm.cfg.tie_embeddings and tm.cfg.qkv_bias
    tp = from_reference(jp, "cpu")
    for _, t in _leaves(tp):
        t.requires_grad_(True)
    loss, _ = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {k: t.grad.float().numpy()
                                  for k, t in _leaves(tp)}


def _dist(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _grads(seed):
    """(reference bf16 (loss, grads), reference f32 grads, port bf16
    (loss, grads)) on batch ``seed``."""
    jp = _params()
    batch = _batch(j_smoke(ARCH).vocab_size, seed)
    return (_ref_grads(jnp.bfloat16, jp, batch),
            _ref_grads(jnp.float32, jp, batch)[1], _port_grads(jp, batch))


@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_gradients_match_jax_grad(seed):
    (j_loss, j_g), _, (t_loss, t_g) = _grads(seed)
    assert abs(t_loss - j_loss) <= 5e-4 * abs(j_loss)
    assert set(t_g) == set(j_g)
    assert all(np.abs(t_g[k]).max() > 0 for k in t_g)
    errs = {k: _dist(t_g[k], g) for k, g in j_g.items()}
    assert max(errs.values()) <= LEAF_TOL, errs


@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_gradients_as_close_to_f32_as_the_reference(seed):
    (_, j_bf16), j_f32, (_, t_g) = _grads(seed)
    for k, g in j_f32.items():
        ref = _dist(j_bf16[k], g)
        assert _dist(t_g[k], g) <= F32_RATIO * ref, (k, _dist(t_g[k], g),
                                                     ref)
