"""bf16 at model level, the port against the JAX package: each family's
smoke config with ``dtype=bfloat16`` (params f32, activations bf16, as
the full configs run) through ``loss`` and ``prefill`` on the same params
and batch (CPU).

Both packages round every activation to bf16 at the same places, but their
bf16 matmuls sum in different orders (torch's CPU kernels and XLA's), so a
block's bf16 output may differ by an ulp and the stack carries it on. The
tolerances below are what that leaves (the measured values, ROADMAP §3,
with a margin of 2-4x):

* the loss within ``LOSS_TOL`` relative (f32 smoke configs: 1e-5);
* the last position's logits within ``LOGIT_TOL`` of each row's largest
  |logit| (jamba's 8-layer stack of mamba and MoE blocks carries the
  most: 0.17 of the row's largest at its last position, while each of
  its blocks on the reference's input stays within 2 bf16 ulps of its
  output's largest value, which ``test_jamba_blocks_within_two_ulps``
  holds);
* greedy tokens under the near-tie rule: where the argmax differs, the
  reference's own logits at the two tokens are within ``LOGIT_TOL`` of
  the row's largest."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import transformer as jtr
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.core.quantize import map_tensors
from repro_torch.models import Model as TModel
from repro_torch.models import transformer as ttr

B, S, S_ENC = 2, 24, 10
LOSS_TOL = {"internlm2-1.8b": 1e-4, "gemma2-2b": 1e-4, "qwen1.5-0.5b": 2e-4,
            "granite-moe-3b-a800m": 3e-3, "jamba-v0.1-52b": 1e-4,
            "xlstm-125m": 2e-3, "whisper-large-v3": 1e-3}
LOGIT_TOL = {"internlm2-1.8b": 1.5e-2, "gemma2-2b": 2e-3,
             "qwen1.5-0.5b": 1e-2, "granite-moe-3b-a800m": 1e-2,
             "jamba-v0.1-52b": 0.35, "xlstm-125m": 1e-2,
             "whisper-large-v3": 1.5e-2}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jm = JModel(dataclasses.replace(j_smoke(arch), dtype=jnp.bfloat16))
    tm = TModel(dataclasses.replace(t_smoke(arch), dtype=torch.bfloat16))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jm.cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if jm.cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, S_ENC, jm.cfg.d_model)).astype(np.float32)
    batch["labels"] = rng.integers(0, jm.cfg.vocab_size, (B, S)).astype(
        np.int32)
    return jm, tm, jp, from_reference(jp, "cpu"), batch


@pytest.mark.parametrize("arch", sorted(LOSS_TOL))
def test_bf16_loss_and_prefill_match_reference(arch):
    jm, tm, jp, tp, batch = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, _ = jax.jit(jm.loss)(jp, jb)
    tl, _ = tm.loss(tp, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL[arch] * abs(float(jl))
    del jb["labels"], tb["labels"]
    jlog, _ = jax.jit(jm.prefill)(jp, jb)
    tlog, cache = tm.prefill(tp, tb)
    want, got = np.asarray(jlog), tlog.numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    rowmax = np.abs(np.where(fin, want, 0.0)).max(-1)
    err = np.abs(np.where(fin, got - want, 0.0)).max(-1)
    assert np.all(err <= LOGIT_TOL[arch] * rowmax), (err / rowmax)
    for r in range(B):
        a, b = int(got[r].argmax()), int(want[r].argmax())
        assert a == b or want[r, b] - want[r, a] <= \
            LOGIT_TOL[arch] * rowmax[r], (r, a, b)
    assert tlog.dtype == torch.float32 and cache["layers"]


def test_jamba_blocks_within_two_ulps():
    """Each of jamba's eight blocks on the reference's bf16 input: output
    within 2 bf16 ulps (2^-7) of the output's largest |value|."""
    jm, tm, jp, tp, _ = _setup("jamba-v0.1-52b")
    cfg = jm.cfg
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    for slot, (mixer, ffn) in enumerate(jtr.layer_plan(cfg)):
        jlp = jax.tree_util.tree_map(lambda t: t[0], jp["dec"][f"s{slot}"])
        tlp = map_tensors(lambda t: t[0], tp["dec"][f"s{slot}"])
        jy = jax.jit(lambda lp, x_: jtr._block(
            x_, lp, cfg, mixer, ffn, window=jnp.int32(0),
            positions=jnp.arange(S), cur_pos=None, cache=None, enc_out=None,
            parallel=None, cross=False, decode_positions=None,
            paged=None)[0])(jlp, jx)
        ty = ttr._block(
            torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
                torch.bfloat16), tlp, tm.cfg, mixer, ffn, window=0,
            positions=torch.arange(S), cur_pos=None, cache=None,
            enc_out=None, cross=False, decode_positions=None,
            paged=None)[0]
        want = np.asarray(jy.astype(jnp.float32))
        err = np.abs(ty.float().numpy() - want).max()
        assert err <= 2.0 ** -7 * np.abs(want).max(), (slot, mixer, err)
        jx = jy
