"""Shared set-up of ``tests/test_torch_families*.py``: the five model
families the paged engine serves, as smoke configs of both packages, with
the reference's params carried across to the port.

Vocabulary 64 keeps the engines' logits small. gemma2's 4096-token window
is replaced by 6 (a page and a half at page size 4), so the prompts here
run past it on its local layers; its other features (softcaps, post-norm,
head_dim from the smoke config, tied table) are kept. The reference inits
norms and qkv biases at 0: they are moved off 0 by seeded noise, so the
bias and both post-norms change the result.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy as JPolicy
from repro.core import pack_params as j_pack
from repro.core.policy import _path_str
from repro.core.quantize import quantize_blockwise
from repro.models import Model as JModel
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.models import Model as TModel

ARCHS = ["gemma2-2b", "qwen1.5-0.5b", "granite-3-2b", "granite-moe-3b-a800m",
         "arctic-480b"]
VOCAB = 64
WINDOW = 6
PS = 4


def configs(arch):
    """(reference config, port config) of ``arch``'s smoke model."""
    kw = dict(vocab_size=VOCAB, vocab_round=64)
    if j_smoke(arch).sliding_window:
        kw["sliding_window"] = WINDOW
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(t_smoke(arch), **kw))


def _perturb(tree, rng, path=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, f"{path}/{k}") for k, v in tree.items()}
    name = path.rsplit("/", 1)[-1]
    if name.startswith("norm") or name in ("final_norm", "bq", "bk", "bv"):
        noise = rng.standard_normal(tree.shape).astype(np.float32)
        return tree + jnp.asarray(0.1 * noise)
    return tree


POLICY = JPolicy(bits=4, block=64, solver="dp", min_size=1024)
_quantize_leaf = jax.jit(functools.partial(
    quantize_blockwise, bits=POLICY.bits, block=POLICY.block,
    solver=POLICY.solver, lam=POLICY.lam))


def _quantize(tree):
    """The reference's ``quantize_params(tree, POLICY)`` jitted leaf by
    leaf: the smoke configs share their widths, so each leaf shape
    compiles once for all of them."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: (_quantize_leaf(leaf) if POLICY.selects(
            _path_str(path), leaf) else leaf), tree)


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(jm, tm, {"plain" | "quantized" | "packed": (reference tree, port
    tree)}): seeded params, 4-bit block-64 DP (``_quantize``), and
    packed."""
    jcfg, tcfg = configs(arch)
    jm, tm = JModel(jcfg), TModel(tcfg)
    plain = _perturb(jm.init(jax.random.PRNGKey(0)),
                     np.random.default_rng(1))
    quant = _quantize(plain)
    packed, _ = j_pack(quant)
    trees = {"plain": plain, "quantized": quant, "packed": packed}
    return jm, tm, {k: (v, from_reference(v, "cpu"))
                    for k, v in trees.items()}


def requests():
    """Five prompts of 3-17 tokens (three past the window), 6-9 new
    tokens each; the first two share an 8-token prefix."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, VOCAB, 8)
    reqs = [(np.concatenate([shared, rng.integers(0, VOCAB, n)]).astype(
        np.int32), 8) for n in (3, 9)]
    reqs += [(rng.integers(0, VOCAB, n).astype(np.int32), m)
             for n, m in ((3, 6), (13, 9), (5, 7))]
    return reqs
