"""The port's static serving path against the JAX package's on fp32 smoke
internlm2: ``Model.prefill`` (logits 1e-4, cache 1e-5 — the projections sum
in another order than XLA's dot), ``decode_step`` from a reference cache
carried across, the loss forward, and ``ServeEngine`` — greedy tokens
identical to the reference engine (``execution="packed"``) and to the
port's own ``ContinuousEngine``, ``score`` within 1e-5 relative — plus the
launcher."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy as JPolicy
from repro.core import pack_params as j_pack
from repro.core import param_bits as j_param_bits
from repro.core import quantize_params as j_quant
from repro.models import Model as JModel
from repro.serve import ServeEngine as JServe
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.core import param_bits
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model as TModel
from repro_torch.serve import ContinuousEngine, ServeEngine

ARCH = "internlm2-1.8b"
MAX_SEQ = 48


@pytest.fixture(scope="module")
def setup():
    jm, tm = JModel(j_smoke(ARCH)), TModel(t_smoke(ARCH))
    plain = jm.init(jax.random.PRNGKey(0))
    policy = JPolicy(bits=4, block=64, solver="dp", min_size=1024)
    # jitted: the DP compiles op by op otherwise (~6x slower)
    qparams = jax.jit(lambda p: j_quant(p, policy)[0])(plain)
    trees = {"plain": plain, "quantized": qparams}
    return jm, tm, trees


def _tokens(seed, shape, vocab=503):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _model_params(trees, kind):
    """Params as the model functions take them: plain, or packed once."""
    jp = trees["plain"] if kind == "plain" else j_pack(trees[kind])[0]
    return jp, from_reference(jp, "cpu")


def _assert_cache_close(tcache, jcache):
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache["layers"]["s0"]["attn"][name].numpy(),
            np.asarray(jcache["layers"]["s0"]["attn"][name]), rtol=0,
            atol=1e-5)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def _grow(jcache, p):
    """The reference engine's ring cache after a prefill of length p."""
    return JServe._grow_cache(type("E", (), {"max_seq": MAX_SEQ})(), jcache,
                              p)


@pytest.mark.parametrize("kind", ["plain", "quantized"])
def test_prefill_and_decode_steps_match_reference(setup, kind):
    """Prefill of 2 x 40 tokens (longer than the smoke attn_chunk of 32,
    which the reference pads to 64; the port masks), then two decode steps
    that both sides start from the reference's ring cache."""
    jm, tm, trees = setup
    jp, tp = _model_params(trees, kind)
    toks = _tokens(0, (2, 40))
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    _assert_cache_close(tcache, jcache)
    assert tcache["layers"]["s0"]["attn"]["k"].shape == (2, 2, 40, 2, 16)

    jcache = _grow(jcache, 40)
    tcache = from_reference(jcache, "cpu")
    step = jax.jit(jm.decode_step)
    tok = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    for cur in (40, 41):
        cur_pos = np.full((2,), cur, np.int32)
        jlog, jcache = step(jp, jcache, jnp.asarray(tok),
                            jnp.asarray(cur_pos))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                      torch.from_numpy(cur_pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-4)
        _assert_cache_close(tcache, jcache)
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]


def test_loss_matches_reference(setup):
    """Loss forward on packed params with some labels masked (< 0)."""
    jm, tm, trees = setup
    jp, tp = _model_params(trees, "quantized")
    toks = _tokens(1, (2, 21))
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    jloss, jaux = jax.jit(jm.loss)(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    tloss, taux = tm.loss(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-5)
    assert float(taux["router_aux"]) == 0.0


@pytest.fixture(scope="module")
def engines(setup):
    """Reference and port ServeEngines (packed execution) per params kind,
    with the reference's greedy tokens and score on fixed inputs."""
    jm, tm, trees = setup
    prompts = _tokens(2, (3, 7))
    scored = _tokens(3, (2, 20))
    out = {}
    for kind, params in trees.items():
        jeng = JServe(jm, params, max_seq=MAX_SEQ, execution="packed")
        ref = {"tokens": np.asarray(jeng.generate(jnp.asarray(prompts),
                                                  10))}
        if kind == "quantized":
            ref["score"] = jeng.score(jnp.asarray(scored))
        teng = ServeEngine(tm, from_reference(params, "cpu"),
                           max_seq=MAX_SEQ, device="cpu")
        out[kind] = (teng, ref)
    return prompts, scored, out


@pytest.mark.parametrize("kind", ["plain", "quantized"])
def test_generate_matches_reference_engine(engines, kind):
    prompts, _, out = engines
    teng, ref = out[kind]
    toks = teng.generate(prompts, 10)
    assert toks.dtype == np.int32 and toks.shape == (3, 10)
    np.testing.assert_array_equal(toks, ref["tokens"])


def test_score_matches_reference_engine(engines):
    _, scored, out = engines
    teng, ref = out["quantized"]
    np.testing.assert_allclose(teng.score(scored), ref["score"], rtol=1e-5)


def test_static_and_continuous_engines_agree(engines, setup):
    """The reference's contract: the static and the continuous engine give
    the same greedy tokens on the same prompts."""
    prompts, _, out = engines
    teng, ref = out["quantized"]
    ceng = ContinuousEngine(teng.model, teng.params, max_batch=4,
                            page_size=4, num_pages=64, max_seq=MAX_SEQ,
                            device="cpu")
    for p in prompts:
        ceng.submit(p, 10)
    cont = ceng.run()
    ceng.close()
    for rid in range(len(prompts)):
        np.testing.assert_array_equal(cont[rid], ref["tokens"][rid])


def test_temperature_sampling_is_reproducible(engines):
    prompts, _, out = engines
    teng, _ = out["quantized"]

    def sample(seed):
        return teng.generate(prompts, 6, temperature=0.8,
                             generator=torch.Generator().manual_seed(seed))

    a, b, c = sample(5), sample(5), sample(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < 503)).all()
    np.testing.assert_array_equal(teng.generate(prompts, 6, temperature=0.8),
                                  sample(0))


@pytest.mark.parametrize("option", ["mesh", "parallel"])
def test_tensor_parallel_options_name_item_11(setup, option):
    """``mesh=`` and ``parallel=`` (GSPMD, ROADMAP item 11) are served;
    each refuses (TypeError) an object that is not its kind of mesh or
    context: a mesh ``make_tp_mesh`` did not make, a ``parallel=`` that is
    not a ``ParallelContext`` of a process mesh."""
    _, tm, _ = setup
    error, match = ((TypeError, "make_tp_mesh") if option == "mesh"
                    else (TypeError, "ParallelContext"))
    with pytest.raises(error, match=match):
        ServeEngine(tm, {}, max_seq=8, device="cpu", **{option: object()})


def test_cache_defs_and_init_cache_match_reference(setup):
    jm, tm, _ = setup
    jdefs, tdefs = jm.cache_defs(2, 12), tm.cache_defs(2, 12)
    assert tdefs["layers"]["s0"]["attn"]["k"][0] == \
        jdefs["layers"]["s0"]["attn"]["k"][0]
    assert tdefs["pos"] == ((2, 12), torch.int32)
    jc, tc = jm.init_cache(2, 12), tm.init_cache(2, 12, device="cpu")
    _assert_cache_close(tc, jc)


def test_from_reference_keeps_static_cache_dtypes():
    tree = {"layers": {"s0": {"attn": {
        "k": jnp.ones((2, 1, 3, 1, 16), jnp.bfloat16),
        "v": jnp.full((2, 1, 3, 1, 16), 0.5, jnp.bfloat16)}}},
        "pos": jnp.arange(3, dtype=jnp.int32)[None]}
    t = from_reference(tree, "cpu")
    assert t["layers"]["s0"]["attn"]["k"].dtype == torch.bfloat16
    assert float(t["layers"]["s0"]["attn"]["v"][0, 0, 0, 0, 0]) == 0.5
    assert t["pos"].dtype == torch.int32 and t["pos"].tolist() == [[0, 1, 2]]


def test_param_bits_matches_reference(setup):
    _, _, trees = setup
    for tree in (trees["plain"], trees["quantized"],
                 j_pack(trees["quantized"])[0]):
        assert param_bits(from_reference(tree, "cpu")) == j_param_bits(tree)


def test_launch_serve_smoke_on_cpu(tmp_path):
    """The launcher serves random params, and with ``--ckpt-dir`` naming a
    directory that holds no checkpoint it serves the same ones, as the
    reference's does (restoring a step: ``tests/test_torch_train.py``)."""
    outs = []
    for extra in ([], ["--ckpt-dir", str(tmp_path / "ckpt")]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--requests", "2", "--tokens", "4"] + extra)
        lines = buf.getvalue().splitlines()
        assert lines[0].startswith("[launch.serve] MSB-4b quantized")
        assert [ln.split(":")[0] for ln in lines[1:]] == [
            "[launch.serve] request 0", "[launch.serve] request 1"]
        outs.append(lines)
    assert outs[0] == outs[1]
