"""Training of the port against the JAX package on f32 smoke configs (CPU):

* gradients of ``Model.loss`` (``loss.backward()``: kernel D's plain
  version under its autograd Function, remat per period, block, CE
  chunk, scan chunk and capacity chunk) against ``jax.grad`` of the
  reference's ``loss`` for internlm2, gemma2, granite-moe, jamba, xlstm
  and whisper: the loss within 1e-5 relative, every leaf within 1e-4 of
  its largest |g|, none missing;
* three ``make_train_step`` steps from the same params and batches:
  loss and grad norm within 1e-4 relative each step; params within
  3 * 2 * lr absolute (an update whose near-zero gradient flips sign
  moves 2 lr the other way), and the elements past 1e-5 counted;
* ``launch/train.py --smoke --device cpu`` trains and checkpoints, and
  ``launch/serve.py --ckpt-dir`` restores that step and serves it."""
import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import Model as JModel
from repro.train import AdamW as JAdamW
from repro.train import OptConfig as JOptConfig
from repro.train import make_train_step as j_make_step
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import Model as TModel
from repro_torch.train import AdamW, OptConfig, make_train_step

GRAD_ARCHS = ["internlm2-1.8b", "gemma2-2b", "granite-moe-3b-a800m",
              "jamba-v0.1-52b", "xlstm-125m", "whisper-large-v3"]
B, S, S_ENC = 2, 24, 10


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, S_ENC, cfg.d_model)).astype(np.float32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)
    batch["labels"][0, :3] = -1                 # masked positions
    return batch


@functools.lru_cache(maxsize=None)
def _models(arch):
    jm, tm = JModel(j_smoke(arch)), TModel(t_smoke(arch))
    return jm, tm, jm.init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_gradients_match_jax_grad(arch):
    jm, tm, jp = _models(arch)
    assert tm.cfg.remat
    batch = _batch(jm.cfg, 1)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = from_reference(jp, "cpu")
    for _, t in _leaves(tp):
        t.requires_grad_(True)
    tl, tmet = tm.loss(tp, {k: torch.from_numpy(v)
                            for k, v in batch.items()})
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(tmet["router_aux"]) - float(jmet["router_aux"])) <= \
        1e-5 * max(abs(float(jmet["router_aux"])), 1e-6)
    want = dict(_leaves(jg))
    got = dict(_leaves(tp))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].grad
        assert g is not None, path
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (path, err, np.abs(w).max())


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-3b-a800m"])
def test_three_train_steps_match_reference(arch):
    """f32 params and moments, warmup of one step, lr 1e-3, grad clip at
    1 (both stacks' grad norms exceed it, so the clip acts)."""
    jm, tm, jp = _models(arch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jopt, topt = JAdamW(JOptConfig(**kw)), AdamW(OptConfig(**kw))
    jstate = {"params": jp, "opt": jopt.init(jp)}
    tstate = {"params": from_reference(jp, "cpu"),
              "opt": from_reference(jopt.init(jp), "cpu")}
    jstep = jax.jit(j_make_step(jm, jopt))
    tstep = make_train_step(tm, topt)
    for i in range(3):
        batch = _batch(jm.cfg, 10 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        for key in ("loss", "grad_norm", "ce"):
            w = float(jmet[key])
            assert abs(float(tmet[key]) - w) <= 1e-4 * abs(w), (i, key)
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=1e-6)
    assert float(jmet["grad_norm"]) > 1.0
    bound, past = 3 * 2 * kw["lr"], 0
    got = dict(_leaves(tstate["params"]))
    for path, w in _leaves(jstate["params"]):
        diff = np.abs(got[path].detach().numpy() - np.asarray(w))
        assert diff.max() <= bound, (path, diff.max())
        past += int((diff > 1e-5).sum())
    n = sum(np.asarray(w).size for _, w in _leaves(jstate["params"]))
    # measured: 0 of 139584 (internlm2) and 2 of 846144 (granite-moe)
    assert past <= n // 1000, (past, n)
    assert int(tstate["opt"]["step"]) == 3


def test_launchers_train_then_serve_the_checkpoint(tmp_path):
    """12 smoke steps of internlm2 with a checkpoint every 5 (steps 5 and
    10 kept), then the serving launcher restores step 10 and serves."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, metrics = launch_train.main([
            "--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
            "--steps", "12", "--checkpoint-every", "5", "--ckpt-dir",
            str(tmp_path)])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("[train] step 0 loss")
    assert lines[-1].startswith("[launch.train] done; final loss")
    assert np.isfinite(float(metrics["loss"]))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_10",
                                                          "step_5"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--arch", "internlm2-1.8b", "--smoke",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path),
                           "--requests", "2", "--tokens", "4"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "[launch.serve] restored step 10"
    assert lines[1].startswith("[launch.serve] MSB-4b quantized")
    assert len(lines) == 4


def test_launch_train_refuses_production_meshes():
    with pytest.raises(ValueError, match="needs 256 devices"):
        launch_train.main(["--arch", "internlm2-1.8b", "--smoke",
                           "--device", "cpu", "--mesh", "single"])
