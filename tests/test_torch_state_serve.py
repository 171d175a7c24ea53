"""The static engine over the stacks with per-sequence state, the port
against the JAX package on fp32 smoke configs:

* jamba (mamba layers, one attention layer, MoE every 2nd layer) and
  xlstm (sLSTM / mLSTM, no attention): ``ServeEngine.generate`` greedy
  tokens identical to ``repro.serve.ServeEngine``'s on the reference's
  quantized params (4-bit block-64 DP), packed and simulated, and
  ``score`` within 1e-5 relative;
* ``_grow_cache`` grows only attention's K/V rings: recurrent state and
  whisper's static ``xattn`` K/V come back as they were;
* ``convert.from_reference`` carries the new cache trees (f32 state,
  ``xattn``) across;
* ``ContinuousEngine`` refuses all four with the reference's reason, and
  the paged pools refuse them too;
* the launcher serves jamba and xlstm on the CPU, and fails for whisper
  and internvl where the reference's fails (no frames / patch
  embeddings)."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families_setup as fam
from repro.configs import smoke_config as j_smoke
from repro.models import Model as JModel
from repro.serve import ServeEngine as JServe
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model as TModel
from repro_torch.serve import ContinuousEngine, ServeEngine

SERVED = ["jamba-v0.1-52b", "xlstm-125m"]
STATE_ARCHS = SERVED + ["whisper-large-v3", "internvl2-76b"]
MAX_SEQ = 24


@pytest.fixture(scope="module", params=SERVED)
def setup(request):
    """(reference model, port model, reference quantized params, port
    quantized params) of one served arch: seeded init, 4-bit block-64 DP
    (``torch_families_setup._quantize``, jitted leaf by leaf)."""
    arch = request.param
    jm, tm = JModel(j_smoke(arch)), TModel(t_smoke(arch))
    jq = fam._quantize(jm.init(jax.random.PRNGKey(0)))
    return jm, tm, jq, from_reference(jq, "cpu")


@pytest.mark.parametrize("execution", ["packed", "simulated"])
def test_serve_engine_matches_reference_engine(setup, execution):
    """Three 11-token prompts, 8 greedy tokens identical to the reference
    engine's in the same execution mode; ``score`` of prompts and tokens
    within 1e-5 relative."""
    jm, tm, jq, tq = setup
    prompts = np.random.default_rng(6).integers(
        0, jm.cfg.vocab_size, (3, 11)).astype(np.int32)
    jeng = JServe(jm, jq, max_seq=MAX_SEQ, execution=execution)
    want = np.asarray(jeng.generate(jnp.asarray(prompts), 8))
    teng = ServeEngine(tm, tq, max_seq=MAX_SEQ, execution=execution,
                       device="cpu")
    got = teng.generate(prompts, 8)
    np.testing.assert_array_equal(got, want)
    scored = np.concatenate([prompts, want], axis=1)
    np.testing.assert_allclose(teng.score(scored),
                               jeng.score(jnp.asarray(scored)), rtol=1e-5)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m",
                                  "whisper-large-v3"])
def test_grow_cache_grows_only_attention_rings(arch):
    """A prefill cache of 5 positions grown to 24: ``attn/{k, v}`` rings of
    24 rows (the prefill's 5, then zeros), ``pos`` -1 past 5 where there
    is one; every other leaf (mamba, sLSTM / mLSTM state, whisper's
    ``xattn`` over its 9 encoder rows) the very tensor prefill gave."""
    tm = TModel(t_smoke(arch))
    cfg = tm.cfg
    params = tm.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32))}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32))
    _, cache = tm.prefill(params, batch)
    grown = ServeEngine(tm, {}, max_seq=MAX_SEQ, execution="simulated",
                        device="cpu")._grow_cache(cache, 5)
    before, after = dict(_leaves(cache)), dict(_leaves(grown))
    assert sorted(before) == sorted(after)
    kinds = set()
    for path, leaf in before.items():
        kinds.add(path[-2] if len(path) > 1 else path[0])
        if path[-2:] in (("attn", "k"), ("attn", "v")):
            assert after[path].shape[2] == MAX_SEQ
            assert torch.equal(after[path][:, :, :5], leaf)
            assert not after[path][:, :, 5:].any()
        elif path == ("pos",):
            assert torch.equal(after[path][:, :5], leaf)
            assert (after[path][:, 5:] == -1).all()
        else:
            assert after[path] is leaf
    want = {"jamba-v0.1-52b": {"attn", "mamba", "pos"},
            "xlstm-125m": {"slstm", "mlstm"},
            "whisper-large-v3": {"attn", "xattn", "pos"}}[arch]
    assert kinds == want
    if cfg.is_encdec:
        assert grown["layers"]["s0"]["xattn"]["k"].shape[2] == 9


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-large-v3"])
def test_from_reference_carries_state_caches(arch):
    """The reference's prefill cache (mamba's bf16-or-f32 conv and f32
    ssm state, attention K/V, whisper's ``xattn``, int32 ``pos``) comes
    across leaf for leaf with its dtype and values."""
    jm = JModel(j_smoke(arch))
    cfg = jm.cfg
    rng = np.random.default_rng(3)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 6)),
                                   jnp.int32)}
    if cfg.is_encdec:
        batch["frames"] = jnp.asarray(rng.standard_normal((2, 9, cfg.d_model)),
                                      jnp.float32)
    _, jcache = jax.jit(jm.prefill)(jm.init(jax.random.PRNGKey(0)), batch)
    tcache = from_reference(jcache, "cpu")
    want, got = dict(_leaves(jcache)), dict(_leaves(tcache))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert str(got[path].dtype)[6:] == np.asarray(leaf).dtype.name
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(leaf))
    assert any("xattn" in p for p in got) == cfg.is_encdec
    assert any("ssm" in p for p in got) == (cfg.layer_pattern == "jamba")


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_paged_path_refuses_state_stacks(arch):
    """``ContinuousEngine`` refuses with the reference's reason, before
    packing; so do the paged pools."""
    tm = TModel(t_smoke(arch))
    assert not tm.supports_paged()
    with pytest.raises(ValueError, match="paged serving needs a "
                       "decoder-only attention stack"):
        ContinuousEngine(tm, {}, device="cpu")
    with pytest.raises(ValueError, match="not a paged-servable arch"):
        tm.init_paged_pools(4, 4, device="cpu")


@pytest.mark.parametrize("arch", SERVED)
def test_launch_serve_smoke_on_cpu(arch):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "2", "--tokens", "4"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("[launch.serve] MSB-4b quantized")
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        "[launch.serve] request 0", "[launch.serve] request 1"]


@pytest.mark.parametrize("arch,missing", [("whisper-large-v3", "frames"),
                                          ("internvl2-76b", "patch_embeds")])
def test_launch_serve_needs_frontend_inputs(arch, missing):
    """The launcher feeds tokens only; whisper's encoder and internvl's
    frontend need their inputs, so it fails as the reference's does."""
    with pytest.raises(KeyError, match=missing):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "1", "--tokens", "2",
                           "--no-quant"])
