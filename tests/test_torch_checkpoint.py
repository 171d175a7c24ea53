"""Checkpoints of the port in the reference's on-disk format (CPU):

* the reference writes a train state (f32 and bf16 params, int8 moments
  with bf16 scales, uint8 log codes with -inf log-maxima, the int32 step)
  and the port restores it onto its tensors bit for bit, bf16 included;
* the port writes the same state carried across and every file
  (``leaf_*.npy`` and ``MANIFEST.json``) is byte for byte the
  reference's, so the CRCs are identical and ``repro.train.Checkpointer``
  restores it;
* a corrupt leaf is refused; ``keep`` prunes old steps; an async save
  holds the state as it was when ``save`` was called;
* a run resumed from a checkpoint continues bitwise as the uninterrupted
  run, and a preemption signal checkpoints and stops."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import AdamW as JAdamW
from repro.train import Checkpointer as JCheckpointer
from repro.train import OptConfig as JOptConfig
from repro_torch.configs import smoke_config
from repro_torch.convert import from_reference
from repro_torch.data import TokenStream
from repro_torch.models import Model
from repro_torch.train import (AdamW, Checkpointer, OptConfig,
                               PreemptionHandler, init_state, train_loop)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _reference_state():
    """A reference train state after one int8-moment AdamW step: params
    f32 and bf16, m as int8 codes with bf16 scales, v as uint8 log codes
    (one all-zero block keeps a -inf log-max), step 1."""
    rng = np.random.default_rng(0)
    params = {"dec": {"w": jnp.asarray(rng.standard_normal((4, 512)),
                                       jnp.float32)},
              "embed": jnp.asarray(rng.standard_normal((8, 256)),
                                   jnp.bfloat16),
              "norm": jnp.zeros((256,), jnp.float32)}
    opt = JAdamW(JOptConfig(moment_dtype="int8", min_quant_size=1024))
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    grads["dec"]["w"] = grads["dec"]["w"].at[:, :256].set(0.0)
    new_p, st = jax.jit(opt.update)(grads, opt.init(params), params)
    return {"params": new_p, "opt": st}


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _ref_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _reference_state()
    JCheckpointer(tmp_path, async_save=False).save(state, 7)
    like = from_reference(state, "cpu")
    tree, step = Checkpointer(tmp_path).restore_latest(like=like)
    assert step == 7
    want = dict(_leaves(state))
    got = dict(_leaves(tree))
    assert sorted(got) == sorted(want)
    assert got["params/embed"].dtype == torch.bfloat16
    assert got["opt/m/dec/w/s"].dtype == torch.bfloat16
    assert got["opt/v/dec/w/q"].dtype == torch.uint8
    assert torch.isinf(got["opt/v/dec/w/s"]).any()
    for key, w in want.items():
        np.testing.assert_array_equal(_bits(got[key]), _ref_bits(w))


def test_port_checkpoint_is_the_reference_file_for_file(tmp_path):
    state = _reference_state()
    JCheckpointer(tmp_path / "ref", async_save=False).save(state, 3)
    ck = Checkpointer(tmp_path / "port")
    ck.save(from_reference(state, "cpu"), 3)
    ck.wait()
    ref_dir, port_dir = tmp_path / "ref" / "step_3", tmp_path / "port" / \
        "step_3"
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names and len(names) > 10
    for name in names:
        assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes(
        ), name
    manifest = json.loads((port_dir / "MANIFEST.json").read_text())
    assert manifest["leaves"]["params/embed"]["dtype"] == "bfloat16"
    tree, step = JCheckpointer(tmp_path / "port").restore_latest(
        like=jax.tree_util.tree_map(np.asarray, state))
    assert step == 3
    for (k, got), (_, want) in zip(_leaves(tree), _leaves(state)):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), k


def test_corruption_keep_and_async_snapshot(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    x = torch.arange(6, dtype=torch.float32)
    for step in (1, 2, 3):
        ck.save({"x": x}, step)
        x.add_(10.0)                  # after save: the snapshot is older
    ck.wait()
    assert ck.steps() == [2, 3]
    tree, step = ck.restore(3, like={"x": torch.zeros(6)})
    assert torch.equal(tree["x"], torch.arange(6.0) + 20.0)
    leaf = tmp_path / "step_3" / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 1
    leaf.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        ck.restore(3)


def _data(start):
    stream = TokenStream(503, 16, 2, seed=1)
    step = start
    while True:
        yield stream.batch(step)
        step += 1


def _run(tmp, steps, start=0, should_stop=None):
    model = Model(smoke_config("internlm2-1.8b"))
    opt = AdamW(OptConfig(lr=1e-3, warmup_steps=1, total_steps=8))
    state = init_state(model, opt, torch.Generator().manual_seed(0), "cpu")
    return train_loop(model, opt, _data(start), steps=steps, state=state,
                      checkpointer=Checkpointer(tmp), checkpoint_every=2,
                      log_every=0, should_stop=should_stop)


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    full, _ = _run(tmp_path / "a", 4)
    _run(tmp_path / "b", 2)                       # saves step 2
    resumed, metrics = _run(tmp_path / "b", 4, start=2)
    assert int(resumed["opt"]["step"]) == 4
    for (k, a), (_, b) in zip(_leaves(full), _leaves(resumed)):
        assert torch.equal(a, b), k
    assert Checkpointer(tmp_path / "b").steps() == [2, 4]


def test_preemption_checkpoints_and_stops(tmp_path):
    handler = PreemptionHandler(signals=())
    calls = []

    def stop():
        calls.append(1)
        if len(calls) == 1:
            handler.trigger()
        return handler.should_stop()

    state, _ = _run(tmp_path, 6, should_stop=stop)
    assert int(state["opt"]["step"]) == 1
    assert Checkpointer(tmp_path).steps() == [1]
