"""The unembedding entry ``msb_unembed`` (kernels/msb_matmul) and
``Model._logits`` on it: packed tables of both layouts — the untied
k-blocked ``unembed`` and a tied n-blocked ``embed`` read as its transpose.

On the CPU the entry takes its plain version: against the reference's
``Model._logits`` on the reference's own packed smoke tables (f32, 1e-5 of
the largest logit: the port's matmul sums in another order than XLA's
einsum), and bit for bit against the expressions ``_logits`` ran before the
entry existed. The kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_unembed.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy as JPolicy
from repro.core import pack_params as j_pack
from repro.core import quantize_params as j_quant
from repro.models import Model as JModel
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.core.quantize import (PackedQTensor, pack_qtensor,
                                       quantize_blockwise)
from repro_torch.kernels.msb_matmul import ops, ref
from repro_torch.models import Model as TModel
from repro_torch.models import model as model_mod

# untied (k-blocked unembed) and tied (n-blocked embed) smoke models; gemma2
# carries a logit softcap, and every smoke vocabulary (503) is padded to 512,
# so the vocab mask applies
ARCHS = {"internlm2-1.8b": True, "gemma2-2b": False, "qwen1.5-0.5b": False,
         "granite-3-2b": False}
POLICY = JPolicy(bits=4, block=64, solver="dp", min_size=1024)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def tables(request):
    """(arch, reference model, port model, the reference's packed table
    tree, the same tree in the port) for the smoke config's embed and
    unembed tables, quantized and packed by the reference."""
    arch = request.param
    jm, tm = JModel(j_smoke(arch)), TModel(t_smoke(arch))
    plain = jm.init(jax.random.PRNGKey(0))
    tree = {k: plain[k] for k in ("embed", "unembed") if k in plain}
    q, _ = j_quant(tree, POLICY)
    packed, _ = j_pack(q)
    return arch, jm, tm, packed, from_reference(packed, "cpu")


def _hidden(rng, b, d):
    return rng.standard_normal((b, d)).astype(np.float32)


def test_smoke_tables_have_the_layout_under_test(tables):
    arch, _, tm, _, tp = tables
    table = tp.get("unembed", tp["embed"])
    assert isinstance(table, PackedQTensor)
    assert table.kblocked == ARCHS[arch]
    assert ("unembed" in tp) == ARCHS[arch]
    assert table.n == (tm.cfg.vocab_padded if table.kblocked
                       else tm.cfg.d_model)


@pytest.mark.parametrize("b", [1, 3, 8])
def test_logits_match_the_reference(tables, b):
    """``Model._logits`` (the entry's plain version, softcap, vocab mask)
    against the reference's on the same packed table and hidden states."""
    _, jm, tm, jp, tp = tables
    h = _hidden(np.random.default_rng(b), b, tm.cfg.d_model)
    want = np.asarray(jm._logits(jp, jnp.asarray(h)))
    got = tm._logits(tp, torch.from_numpy(h)).numpy()
    assert got.shape == want.shape == (b, tm.cfg.vocab_padded)
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    assert finite.sum() == b * tm.cfg.vocab_size
    scale = np.abs(want[finite]).max()
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=1e-5 * scale)


def _table(rng, v, d, kblocked, dtype):
    """A random 4-bit/64 table (V, D) as the port quantizes and packs it:
    tied in natural orientation, untied transposed (k-blocked)."""
    w = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    q = quantize_blockwise(w.to(dtype), bits=4, block=64)
    return pack_qtensor(q, transpose=kblocked)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(192, 64), (100, 128), (64, 256)])
def test_tied_plain_version_is_the_old_expression(shape, dtype):
    """The tied plain version is bit for bit ``hidden @ dequant(table)
    .to(f32).t()``, what ``_logits`` computed before (weights rounded to the
    table's dtype), also for a strided hidden as ``prefill`` passes it."""
    v, d = shape
    rng = np.random.default_rng(v + d)
    pq = _table(rng, v, d, False, dtype)
    assert not pq.kblocked and pq.n == d
    full = torch.from_numpy(_hidden(rng, 12, d)).reshape(3, 4, d)
    for hidden in (full[:, -1], full.reshape(12, d)):
        old = hidden @ pq.dequantize().to(torch.float32).t()
        assert torch.equal(ops.msb_unembed(hidden, pq), old)


@pytest.mark.parametrize("m", [1, 4, 9])
def test_kblocked_plain_version_is_the_old_expression(m):
    """The k-blocked plain version is bit for bit ``packed_matmul(hidden,
    table)``, what ``_logits`` ran before (``msb_matmul_ref``)."""
    rng = np.random.default_rng(m)
    pq = _table(rng, 100, 128, True, torch.float32)
    assert pq.kblocked and pq.n == 100 and pq.n_pad == 128
    hidden = torch.from_numpy(_hidden(rng, m, 128))
    assert torch.equal(ops.msb_unembed(hidden, pq),
                       ops.packed_matmul(hidden, pq))


def test_logits_route_packed_tables_through_the_entry(monkeypatch):
    """``_logits`` sends a packed table of either layout through
    ``msb_unembed`` and nothing else there; an unpacked ``QTensor`` or a
    dense table keeps the f32 matmul."""
    seen = []

    def spy(hidden, pq):
        seen.append(pq.kblocked)
        return ops.msb_unembed(hidden, pq)

    monkeypatch.setattr(model_mod, "msb_unembed", spy)
    cfg = dataclasses.replace(t_smoke("internlm2-1.8b"), vocab_size=128)
    tm = TModel(cfg)
    rng = np.random.default_rng(3)
    hidden = torch.from_numpy(_hidden(rng, 2, cfg.d_model))
    w = torch.from_numpy(rng.standard_normal(
        (cfg.vocab_padded, cfg.d_model)).astype(np.float32))
    q = quantize_blockwise(w, bits=4, block=64)
    trees = {"kblocked": {"embed": w, "unembed": pack_qtensor(
                 q, transpose=True)},
             "tied": {"embed": pack_qtensor(q)},
             "qtensor": {"embed": q},
             "dense": {"embed": w}}
    out = {name: tm._logits(tree, hidden) for name, tree in trees.items()}
    assert seen == [True, False]
    # the three quantized forms of one table agree
    np.testing.assert_allclose(out["kblocked"].numpy(), out["tied"].numpy(),
                               rtol=0, atol=1e-5 * out["tied"].abs().max())
    np.testing.assert_allclose(out["qtensor"].numpy(), out["tied"].numpy(),
                               rtol=0, atol=1e-5 * out["tied"].abs().max())


NAMED = {  # (kp, n, kblocked): the K slices the plan gives
    (2048, 92672, True): 4,       # internlm2's untied table
    (2304, 256000, False): 1,     # gemma2's tied table
    (1024, 151936, False): 1,     # qwen1.5-0.5b's tied table
    (2048, 49216, False): 2,      # granite's tied table
    (64, 512, True): 1,           # the smoke tables
    (64, 512, False): 1,
}


@pytest.mark.parametrize("key", sorted(NAMED))
def test_unembed_plan_slices_depend_on_the_table_only(key):
    """The plan's K slices depend on (Kp, N, layout) alone, so a row's sum
    order is the same at every M; the rows of x a block are 1, 2, 4 or 8 and
    the shared memory fits a block."""
    kp, n, kb = key
    plans = [ops.unembed_plan(m, kp, n, kb) for m in (1, 2, 3, 8, 17, 64)]
    assert {p.slices for p in plans} == {NAMED[key]}
    assert [p.mt for p in plans] == [1, 2, 4, 8, 8, 8]
    assert all(p.smem <= ops.SMEM_LIMIT for p in plans)
    assert all(p.smem == ops.unembed_smem(p.mt, kp, p.slices, kb)
               for p in plans)
    assert (kp // 64) % NAMED[key] == 0


def test_unembed_plan_trades_rows_of_x_for_shared_memory():
    """A reduction too wide for 8 rows of x in shared memory takes fewer;
    one too wide for a single row is refused."""
    assert ops.unembed_plan(8, 8192, 2048, True).mt == 2
    assert ops.unembed_plan(8, 8192, 2048, False).mt == 4
    with pytest.raises(ValueError, match="shared memory"):
        ops.unembed_plan(1, 1 << 16, 2048, True)


def test_entry_refuses_what_the_kernel_does_not_take():
    """The kernel's checks, which run before any launch."""
    rng = np.random.default_rng(9)
    tied = _table(rng, 64, 128, False, torch.float32)
    kb = _table(rng, 64, 128, True, torch.float32)
    x = torch.zeros(2, 128)
    assert ops._check_unembed(x, tied) == (2, 128, 128, 64)
    assert ops._check_unembed(x, kb) == (2, 128, 128, 64)
    with pytest.raises(TypeError, match="f32"):
        ops._check_unembed(x.to(torch.bfloat16), tied)
    with pytest.raises(ValueError, match="does not fit"):
        ops._check_unembed(torch.zeros(2, 64), tied)
    with pytest.raises(TypeError, match="f32 or bf16"):
        ops._check_unembed(x, dataclasses.replace(tied, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_unembed(torch.zeros(128, 2).t(), kb)
