"""Every model family the paged engine serves, the port against the JAX
package on fp32 smoke configs (``tests/torch_families_setup.py``):
gemma2 (its window binding, softcaps, post-norm), qwen's qkv bias, granite,
and the MoE families (granite-moe; arctic's MoE beside a dense MLP).

The layer plan's windows and ``supports_paged`` for all ten archs; the
loss with the router's aux loss; ``prefill`` and ring ``decode_step``;
``paged_prefill_packed``, ``paged_step`` and ``paged_decode_horizon`` at
kv_bits 16, 8 and 4 (logits 1e-4, as ``tests/test_torch_model.py``: the
projections sum in another order than XLA's dot); ``ContinuousEngine``
greedy tokens identical to ``repro.serve.ContinuousEngine``'s at kv_bits
16, 8 and 4; ``ServeEngine`` greedy tokens identical to
``repro.serve.ServeEngine``'s and ``score`` within 1e-5. The stacks ROADMAP
item 10 brought last (jamba, xlstm, whisper, internvl) declare the
reference's params and are refused by the paged path alone; their parity
tests are ``tests/test_torch_{ssm,xlstm,encdec,state_serve}.py``.

The paged-path test calls the reference engine's own jitted dispatches at
the engine's shapes, so the reference compiles each once per arch and
kv_bits for both tests (its compiles are most of this file's time)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families_setup as fam
from repro.configs import get_config as j_config
from repro.models import Model as JModel
from repro.models import transformer as jtr
from repro.serve import ServeEngine as JServe
from repro_torch.configs import archs as t_archs
from repro_torch.configs import get_config as t_config
from repro_torch.models import Model as TModel
from repro_torch.models import transformer as ttr
from repro_torch.serve import ServeEngine

ALL_ARCHS = [c.name for c in t_archs.ALL]
UNPORTED = ["jamba-v0.1-52b", "xlstm-125m", "whisper-large-v3",
            "internvl2-76b"]


def _i32(a):
    return np.asarray(a, np.int32)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_window_plan_and_supports_paged_match_reference(arch):
    """``_window_array`` gives the reference's windows at full width
    (gemma2: 4096 on the 13 even layers, 0 on the odd ones) and
    ``supports_paged`` the reference's answer, for all ten archs."""
    jc, tc = j_config(arch), t_config(arch)
    want = np.asarray(jtr._window_array(jc)).tolist()
    assert ttr._window_array(tc) == want
    if arch == "gemma2-2b":
        assert [w for row in want for w in row] == [4096, 0] * 13
    assert TModel(tc).supports_paged() == JModel(jc).supports_paged()


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_stacks_name_roadmap_item_10(arch):
    """The stacks ROADMAP item 10 brought (per-sequence state, frontends)
    declare the reference's params at full width, and the only refusal
    left is the paged path's, as in the reference (nothing is allocated:
    the full configs are far too large for a test)."""
    jc, tc = j_config(arch), t_config(arch)
    want = {path: shape for path, (shape, _ax, _k) in
            jtr.param_defs(jc).items()}
    assert {path: shape for path, (shape, _k) in
            ttr.param_defs(tc).items()} == want
    model = TModel(tc)
    with pytest.raises(ValueError, match="not a paged-servable arch"):
        model.init_paged_pools(4, 4, device="cpu")


@pytest.mark.parametrize("arch", fam.ARCHS)
def test_loss_matches_reference(arch):
    """Loss (cross-entropy + z-loss + router_aux_weight x aux), its ce and
    the router's aux summed over layers (0 without MoE), rtol 1e-5."""
    jm, tm, trees = fam.setup(arch)
    jp, tp = trees["plain"]
    toks = np.random.default_rng(3).integers(0, fam.VOCAB, (2, 15))
    toks = _i32(toks)
    jl, jmet = jm.loss(jp, {"tokens": jnp.asarray(toks[:, :-1]),
                            "labels": jnp.asarray(toks[:, 1:])})
    tl, tmet = tm.loss(tp, {"tokens": torch.from_numpy(toks[:, :-1]),
                            "labels": torch.from_numpy(toks[:, 1:])})
    for got, want in ((tl, jl), (tmet["ce"], jmet["ce"]),
                      (tmet["router_aux"], jmet["router_aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert (float(tmet["router_aux"]) > 0) == bool(tm.cfg.n_experts)


@pytest.mark.parametrize("arch", fam.ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    """Packed params: a 13-token prefill (past gemma2's window: flash
    attention with the window) then three ring decode steps (decode
    attention with the window), logits 1e-4 each."""
    jm, tm, trees = fam.setup(arch)
    jp, tp = trees["packed"]
    prompts = _i32(np.random.default_rng(4).integers(0, fam.VOCAB, (2, 13)))
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    s = 20
    jcache = jax.tree_util.tree_map(
        lambda a: (jnp.pad(a, [(0, 0), (0, s - 13)], constant_values=-1)
                   if a.ndim == 2 else
                   jnp.pad(a, [(0, 0), (0, 0), (0, s - 13), (0, 0),
                               (0, 0)])), jcache)
    tcache = ServeEngine(tm, {}, max_seq=s, execution="simulated",
                         device="cpu")._grow_cache(tcache, 13)
    cur = 13
    tok = _i32(np.asarray(jlog).argmax(-1))[:, None]
    for _ in range(3):
        pos = _i32([cur, cur])
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok),
                                      jnp.asarray(pos))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-4)
        tok = _i32(np.asarray(jlog).argmax(-1))[:, None]
        cur += 1


# the engine both packages' ContinuousEngine tests run (``ENGINE``) and the
# shapes of its dispatches, which the paged-path test reuses so that the
# reference's jitted dispatches compile once per arch and kv_bits
ENGINE = dict(max_batch=4, page_size=fam.PS, num_pages=64, max_seq=40,
              prefill_chunk=6, prefill_buckets=(24,), decode_horizon=8)
WIDTH = ENGINE["max_seq"] // fam.PS               # block-table width


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: small ops run faster alone beside the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("arch", fam.ARCHS)
def test_paged_paths_match_reference(arch, bits):
    """Packed params over kv16 or quantized pools, through the reference
    engine's jitted dispatches at the shapes of ``ENGINE``: a packed
    prefill wave of two segments (11 and 7 tokens, past gemma2's window,
    pads behind), a paged decode step of both rows, then a decode horizon
    of 8 with greedy sampling on the device (rows stopping after 4 and 3
    tokens, two pad rows): logits 1e-4, horizon tokens and masks
    identical."""
    from repro.serve import continuous as jc
    jm, tm, trees = fam.setup(arch)
    jp, tp = trees["packed"]

    def quant(slots):
        return {} if bits == 16 else dict(slots=torch.from_numpy(slots))

    rng = np.random.default_rng(10 + bits)
    t = 24
    tokens, seg, pos = (np.zeros(t, np.int32), np.full(t, -1, np.int32),
                        np.full(t, -1, np.int32))
    tokens[:18] = rng.integers(0, fam.VOCAB, 18)
    seg[:11], seg[11:18] = 0, 1
    pos[:11], pos[11:18] = np.arange(11), np.arange(7)
    bt = np.zeros((4, WIDTH), np.int32)
    bt[0, :5], bt[1, :5] = np.arange(1, 6), np.arange(6, 11)
    slots = _i32([0, 2, -1, -1])
    wave = (tokens, seg, pos, _i32([11, 7, 0, 0]), bt, slots,
            _i32([10, 17, 0, 0]), _i32([0, 11, 0, 0]))
    jl, jpools = jc._paged_prefill_packed(
        jm, bits, jm.init_paged_pools(64, fam.PS, kv_bits=bits, max_seqs=4),
        jp, *_j(wave))
    tl, tpools = tm.paged_prefill_packed(
        tp, tm.init_paged_pools(64, fam.PS, kv_bits=bits, max_seqs=4,
                                device="cpu"), *_t(wave), kv_bits=bits)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], rtol=0,
                               atol=1e-4)
    step = (_i32(np.asarray(jl)[:2].argmax(-1))[:, None], _i32([[11], [7]]),
            _i32([12, 8]), bt[:2])
    jl, jpools = jc._paged_step(jm, bits, jpools, jp, *_j(step),
                                jnp.asarray(slots[:2]))
    tl, tpools = tm.paged_step(tp, tpools, *_t(step), kv_bits=bits,
                               **quant(slots[:2]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    nxt = np.zeros(4, np.int32)
    nxt[:2] = np.asarray(jl).argmax(-1)
    start, n_left, eos = _i32([12, 8, -1, -1]), _i32([4, 3, 0, 0]), \
        _i32([-1] * 4)
    jt, jv, _ = jc._paged_horizon_step(jm, 8, bits, jpools, jp, *_j(
        (nxt, start, n_left, eos, bt, slots)))
    tt, tv, _ = tm.paged_decode_horizon(
        tp, tpools, *_t((nxt, start, bt, n_left, eos)), 8, kv_bits=bits,
        **quant(slots))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _serve(eng):
    """The five requests of ``fam.requests``, the first alone so that the
    second hits the prefix cache. Returns (outputs, prefix hits)."""
    reqs = fam.requests()
    out = {}
    eng.submit(*reqs[0])
    out.update(eng.run())
    for r in reqs[1:]:
        eng.submit(*r)
    out.update(eng.run())
    return out, eng.n_prefix_hits


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("arch", fam.ARCHS)
def test_continuous_engine_tokens_match_reference(arch, bits):
    """Greedy tokens of the port's ``ContinuousEngine`` identical to
    ``repro.serve.ContinuousEngine``'s on the same quantized params
    (packed execution, decode horizon 8, packed prefill, prefix cache on;
    ``fam.requests``), and the same prefix hits.

    MoE at kv_bits 8 and 4 runs with a capacity no expert can overflow
    (``capacity_factor`` = padded experts / top-k, so capacity >= tokens):
    where an expert overflows, which choices drop depends on the pads'
    routing, and the reference gives a pad the mean of V over its row, the
    scratch page included, whose bytes its quantized commit writes through
    duplicate indices in an order the port does not reproduce (ROADMAP §3;
    witnessed by ``tests/test_torch_moe.py::
    test_moe_quantized_commit_writes_other_scratch_bytes``). At kv16 the
    scratch bytes agree and MoE runs its own capacity."""
    from repro.serve import ContinuousEngine as JEngine
    from repro_torch.serve import ContinuousEngine
    jm, tm, trees = fam.setup(arch)
    jq, tq = trees["quantized"]
    cfg = jm.cfg
    if cfg.n_experts and bits != 16:
        cf = cfg.n_experts_padded / cfg.n_experts_active
        jm = type(jm)(dataclasses.replace(cfg, capacity_factor=cf))
        tm = type(tm)(dataclasses.replace(tm.cfg, capacity_factor=cf))
    want, j_hits = _serve(JEngine(jm, jq, execution="packed", kv_bits=bits,
                                  **ENGINE))
    eng = ContinuousEngine(tm, tq, kv_bits=bits, device="cpu", **ENGINE)
    got, hits = _serve(eng)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert hits == j_hits >= 1
    eng.close()
    eng.cache.check_invariants(expect_idle=True)


@pytest.mark.parametrize("arch", fam.ARCHS)
def test_serve_engine_matches_reference_engine(arch):
    """``ServeEngine`` (packed execution) on three 13-token prompts: 8
    greedy tokens identical to the reference engine's; ``score`` of the
    prompts and tokens within 1e-5 relative."""
    jm, tm, trees = fam.setup(arch)
    jq, tq = trees["quantized"]
    prompts = _i32(np.random.default_rng(6).integers(0, fam.VOCAB, (3, 13)))
    jeng = JServe(jm, jq, max_seq=24, execution="packed")
    want = np.asarray(jeng.generate(jnp.asarray(prompts), 8))
    teng = ServeEngine(tm, tq, max_seq=24, device="cpu")
    got = teng.generate(prompts, 8)
    np.testing.assert_array_equal(got, want)
    scored = np.concatenate([prompts, want], axis=1)
    np.testing.assert_allclose(teng.score(scored),
                               jeng.score(jnp.asarray(scored)), rtol=1e-5)
