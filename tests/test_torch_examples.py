"""The port's example programs (``examples_torch/``) against the
reference's (``examples/``), on the CPU.

Each program's stages are held against the reference on the reference's
own params, carried across by ``repro_torch.convert.from_reference``.
Where the reference program is a function (``serve_api.build_engine``,
``train_quantize_serve.build_model``) it is loaded by path; otherwise the
test calls ``repro`` as the reference program does. The programs
themselves run with ``--device cpu``:

* ``serve_api``: greedy tokens on the chaos prompts identical to the
  reference engine's; ``--self-check`` and ``--self-check --chaos`` pass;
* ``train_quantize_serve --preset tiny``: 3 steps' loss and grad norm
  within 1e-4 relative; quantized codes and scales bitwise the
  reference's; the fp and 4-bit held-out NLL within 1e-5 relative; a
  relaunch on the same directory resumes from its checkpoint;
* ``serve_quantized``: the continuous engine's tokens equal the static
  engine's;
* ``distributed_quantize`` on a (2, 2) mesh of CPU ranks: each rank's
  codes and scales bitwise ``repro.core.quantize_blockwise`` of its
  shard, no collective in the solve;
* ``quickstart`` on a (64, 512) weight: every row's MSE within 1e-6
  relative of the reference's (per-tensor rows within 1 %), bits equal.
"""
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantPolicy as JPolicy
from repro.core import baselines as jbase
from repro.core import dequantize as j_dequantize
from repro.core import quantize_blockwise as j_quantize_blockwise
from repro.core import quantize_params as j_quantize_params
from repro.core import quantize_pertensor as j_quantize_pertensor
from repro.core import reconstruction_mse as j_mse
from repro.core import storage_bits_per_weight as j_bits
from repro.core.quantize import QTensor as JQTensor
from repro.data import MarkovStream as JMarkov
from repro.train import AdamW as JAdamW
from repro.train import OptConfig as JOptConfig
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.convert import from_reference, from_reference_state
from repro_torch.core import QTensor
from repro_torch.data import MarkovStream

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROGRAMS = ["distributed_quantize", "quickstart", "serve_api",
            "serve_quantized", "train_quantize_serve"]


def program(name):
    """The port's program ``examples_torch/<name>.py``, loaded by path
    under its own name; its directory goes on ``sys.path`` so a mesh's
    spawned ranks import the functions it sends them."""
    if name in sys.modules:
        return sys.modules[name]
    where = str(ROOT / "examples_torch")
    if where not in sys.path:
        sys.path.insert(0, where)
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def ref_program(name):
    """The reference's ``examples/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and beside the
    server's own threads and other test workers they slow every process
    down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_runs_on_the_card_by_default(name, monkeypatch):
    """Without ``--device`` a program resolves to the card and raises
    where there is none: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        program(name).main([])


# ---------------------------------------------------------------------------
# serve_api
# ---------------------------------------------------------------------------

def test_serve_api_tokens_match_reference_engine():
    """The program's engine over the reference's quantized params (its
    ``build_engine``, seed 0) gives the reference engine's greedy tokens
    on the chaos prompts, f32."""
    ref = ref_program("serve_api")
    j_eng = ref.build_engine()
    prompts = program("serve_api").chaos_prompts()
    rids = [j_eng.submit(np.asarray(p, np.int32), 16) for p in prompts]
    out = j_eng.run()
    want = [out[r].tolist() for r in rids]
    j_eng.close()

    prog = program("serve_api")
    eng = prog.build_engine(prog.smoke_model(),
                            from_reference(j_eng.params, "cpu"), "cpu")
    rids = [eng.submit(np.asarray(p, np.int32), 16) for p in prompts]
    out = eng.run()
    eng.close()
    assert [out[r].tolist() for r in rids] == want


def test_serve_api_self_check_passes():
    out = program("serve_api").main(["--self-check", "--device", "cpu"])
    assert out["new_traces"] == 0 and len(out["tokens"]) == 24


def test_serve_api_chaos_self_check_passes(tmp_path):
    metrics = tmp_path / "metrics.txt"
    out = program("serve_api").main(["--self-check", "--chaos", "--device",
                                     "cpu", "--metrics-out", str(metrics)])
    assert out["restarts"] > 0
    assert {s for s, _ in out["faults_fired"]} <= {"step", "apply", "alloc"}
    assert "msb_engine_restarts_total" in metrics.read_text()


# ---------------------------------------------------------------------------
# train_quantize_serve --preset tiny
# ---------------------------------------------------------------------------

STEPS = 3


@pytest.fixture(scope="module")
def tiny_reference():
    """The reference's tiny preset: its model, its initial state (PRNGKey
    0, as its ``train_loop`` makes it) and the per-step metrics of
    ``STEPS`` steps on ``MarkovStream(seed=7)``."""
    model, batch, seq = ref_program("train_quantize_serve").build_model(
        "tiny")
    data = JMarkov(model.cfg.vocab_size, seq, batch, seed=7)
    opt = JAdamW(JOptConfig(lr=3e-3, warmup_steps=10, total_steps=STEPS))
    state0 = j_init_state(model, opt, jax.random.PRNGKey(0))
    step = jax.jit(j_make_train_step(model, opt))
    state, metrics = state0, []
    for i in range(STEPS):
        state, m = step(state, data.batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return model, state0, state, metrics


def test_tiny_train_steps_match_reference(tiny_reference, tmp_path):
    _, state0, _, want = tiny_reference
    prog = program("train_quantize_serve")
    model, batch, seq = prog.build_model("tiny")
    data = MarkovStream(model.cfg.vocab_size, seq, batch, seed=7)
    state = from_reference_state(state0, "cpu")
    _, report = prog.train(model, data, STEPS, str(tmp_path),
                           torch.device("cpu"), state=state)
    assert report["resumed_from"] is None
    for i in range(STEPS):
        assert _rel(report["losses"][i], want[i]["loss"]) <= 1e-4, i
        assert _rel(report["grad_norms"][i], want[i]["grad_norm"]) <= 1e-4, i


def _qleaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qleaves(v, path + (k,))
    else:
        yield path, tree


def test_tiny_quantize_and_nll_match_reference(tiny_reference):
    """On the reference's trained params: quantized codes and scales
    bitwise the reference's, the fp and 4-bit held-out NLL within 1e-5
    relative."""
    j_model, _, state, _ = tiny_reference
    prog = program("train_quantize_serve")
    model, batch, seq = prog.build_model("tiny")
    params = from_reference(state["params"], "cpu")
    qparams = prog.quantize(params, torch.device("cpu"))
    # jitted: the reference's solver compiles op by op otherwise
    j_q = jax.jit(lambda p: j_quantize_params(p, JPolicy(
        bits=4, block=64, solver="dp", min_size=4096))[0])(state["params"])
    port = dict(_qleaves(qparams))
    n_q = 0
    for path, leaf in _qleaves(j_q):
        mine = port[path]
        if isinstance(leaf, JQTensor):
            assert isinstance(mine, QTensor), path
            assert np.array_equal(mine.codes.numpy(), np.asarray(leaf.codes))
            assert np.array_equal(mine.scales.numpy(),
                                  np.asarray(leaf.scales))
            n_q += 1
    assert n_q > 0

    data = JMarkov(j_model.cfg.vocab_size, seq, batch, seed=7)
    ev = data.batch(10_000)
    loss = jax.jit(j_model.loss)
    j_batch = {k: jnp.asarray(v) for k, v in ev.items()}
    for tree, j_tree in ((params, state["params"]), (qparams, j_q)):
        got = prog.held_out_nll(model, tree, ev, torch.device("cpu"))
        assert _rel(got, float(loss(j_tree, j_batch)[0])) <= 1e-5


def test_100m_policy_keeps_the_qkv_biases_dense():
    """At the 100m preset the reference's policy selects qwen's stacked
    q/k/v biases (12 x 768 = 9216 elements, 2-D; ``exclude`` names
    ``bias``, the leaves are ``bq``/``bk``/``bv``), which its ``dense``
    cannot add; the program's policy keeps them dense and selects every
    other leaf as the reference's does."""
    model, _, _ = ref_program("train_quantize_serve").build_model("100m")
    j_pol = JPolicy(bits=4, block=64, solver="dp", min_size=4096)
    mine = program("train_quantize_serve").policy()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    n_sel = 0
    for path, leaf in _qleaves(shapes):
        name = "/".join(path)
        want = j_pol.selects(name, leaf)
        got = mine.selects(name, torch.empty(leaf.shape, device="meta"))
        if path[-1] in ("bq", "bk", "bv"):
            assert want and not got, name
        else:
            assert got == want, name
            n_sel += got
    assert n_sel == 8          # wq, wk, wv, wo, wg, wi, wo and the table


def test_tiny_relaunch_resumes_from_checkpoint(tmp_path):
    prog = program("train_quantize_serve")
    argv = ["--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = prog.main(argv + ["--steps", "26"])
    assert first["resumed_from"] is None and first["steps_run"] == 26
    again = prog.main(argv + ["--steps", "27"])
    assert again["resumed_from"] == 25 and again["steps_run"] == 2
    for out in (first, again):
        assert all(np.isfinite(v) for v in out["losses"].values())
        assert np.isfinite(out["nll_fp"]) and np.isfinite(out["nll_q"])
        assert out["tokens"].shape == (4, 16)


def test_markov_stream_blocks_of_rows_match_reference():
    """The port's chain is built in blocks of ``ROWS`` rows on threads;
    with three blocks its tables and batches are the reference's bits."""
    v = 2 * MarkovStream.ROWS + 52
    mine, ref = MarkovStream(v, 32, 4, seed=7), JMarkov(v, 32, 4, seed=7)
    assert np.array_equal(mine.trans, ref.trans)
    assert np.array_equal(mine.cum, ref.cum)
    for step in (0, 10_000):
        a, b = mine.batch(step), ref.batch(step)
        assert all(np.array_equal(a[k], b[k]) for k in b)


# ---------------------------------------------------------------------------
# serve_quantized, distributed_quantize, quickstart
# ---------------------------------------------------------------------------

def test_serve_quantized_continuous_equals_static():
    out = program("serve_quantized").main(["--device", "cpu"])
    assert out["token_identical"] and out["divergences"] == []
    assert out["agreement"] > 0.5


def test_distributed_quantize_ranks_match_reference():
    out = program("distributed_quantize").main(["--mesh", "2", "2",
                                                "--device", "cpu"])
    assert out["collectives"] == 0
    w = out["weight"]
    solve = jax.jit(lambda a: j_quantize_blockwise(a, bits=4, block=64,
                                                   solver="dp"))
    shards = [w[i * 256:(i + 1) * 256, j * 512:(j + 1) * 512]
              for i in range(2) for j in range(2)]
    codes, scales = [], []
    for r, ws in enumerate(shards):
        q = solve(jnp.asarray(ws))
        assert np.array_equal(out["codes"][r].numpy(), np.asarray(q.codes))
        assert np.array_equal(out["scales"][r].numpy(),
                              np.asarray(q.scales))
        codes.append(np.asarray(q.codes).reshape(-1, 64))
        scales.append(np.asarray(q.scales).reshape(-1, q.scales.shape[-1]))
    q = JQTensor(jnp.asarray(np.concatenate(codes)),
                 jnp.asarray(np.concatenate(scales)), 4, 64, jnp.float32)
    sm = np.concatenate([s.reshape(-1, 64) for s in shards])
    assert _rel(out["mse"], float(j_mse(sm, j_dequantize(q)))) <= 1e-6


def test_quickstart_rows_match_reference():
    prog = program("quickstart")
    w = prog.make_weight(64, 512)
    rows = prog.table(w, torch.device("cpu"))

    def q(fn):
        out = fn()
        return float(j_mse(w, j_dequantize(out))), j_bits(out)

    def b(fn, bits):
        return float(j_mse(w, fn())), bits

    dp = jax.jit(lambda a: j_quantize_blockwise(a, 4, solver="dp"))
    wdp = jax.jit(lambda a: j_quantize_pertensor(a, 6, solver="wdp"))
    want = [q(lambda: dp(w)),
            q(lambda: j_quantize_blockwise(w, 4, solver="wgm")),
            b(lambda: jbase.rtn_quantize(w, 4, 64), 6.0),
            b(lambda: jbase.nf4_quantize(w, 4, 64), 4.5),
            b(lambda: jbase.hqq_quantize(w, 4, 64), 8.25),
            b(lambda: jbase.gptq_quantize(w, 4, 64), 4.5),
            q(lambda: wdp(w)),
            b(lambda: jbase.rtn_quantize(w, 6, -1), 6.0)]
    assert len(rows) == len(want)
    for (name, bits, _, mse), (w_mse, w_bits) in zip(rows, want):
        assert bits == pytest.approx(w_bits, rel=1e-12), name
        tol = 1e-2 if "per-tensor" in name else 1e-6
        assert _rel(mse, w_mse) <= tol, (name, mse, w_mse)
    dp = rows[0][3]
    assert all(dp <= r[3] for r in rows[1:6]), rows


def test_prefetcher_close_lets_a_blocked_fill_thread_end():
    """``Prefetcher.close`` lets a fill thread blocked on its full queue
    through, so the thread ends and lets go of its iterator."""
    from repro_torch.data import Prefetcher, TokenStream
    pf = Prefetcher(iter(TokenStream(50, 4, 2, seed=0)), depth=1)
    while not pf.q.full():
        pass
    pf.close()
    pf.t.join(timeout=10)
    assert not pf.t.is_alive()
