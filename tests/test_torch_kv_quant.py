"""The port's MSB-quantized KV pools (kv_bits 8|4) against the JAX package,
function by function: the page codec byte for byte, the quantized writes'
pools byte for byte, and the plain version of the fused-dequant attention
kernel (kernel C) against its jnp oracle. The engine's tokens are held to
the reference engine in ``test_torch_kv_quant_engine.py``. All inputs are
made from numpy seeds and handed to both sides; fp32 throughout. The
reference functions run under ``jax.jit``, as the reference engine runs
them."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize
from repro.kernels.paged_attention.ref import \
    paged_attention_decode_quant_ref as j_paq_ref
from repro.models import attention as j_attn
from repro_torch.convert import from_reference
from repro_torch.core import quantize as t_quantize
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import attention as t_attn

PS, KV, HD = 4, 2, 16


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 4, 2, 16), (2, 16, 8, 128)])
@pytest.mark.parametrize("bits", [8, 4])
def test_codec_bytes_match_reference(shape, bits):
    """Codes and scales byte-identical to the reference (tie-free normal
    inputs), and the dequantized pages equal, at 8 and 4 bits; (16, 8,
    128) is internlm2's full-width page."""
    x = np.random.default_rng(sum(shape) + bits).standard_normal(
        shape).astype(np.float32)
    jc, js = quantize.kv_quantize_pages(jnp.asarray(x), bits)
    tc, ts = t_quantize.kv_quantize_pages(_t(x), bits)
    spec = t_quantize.KVQuantSpec(bits, *shape[1:])
    assert tc.dtype == spec.code_dtype and ts.dtype == spec.scale_dtype
    assert tuple(tc.shape) == shape[:1] + spec.codes_tail
    assert tuple(ts.shape) == shape[:1] + spec.scales_tail
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js).astype(np.float32))
    jd = quantize.kv_dequantize_pages(jc, js, bits, jnp.float32)
    td = t_quantize.kv_dequantize_pages(tc, ts, bits, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("ps,kv,hd", [(16, 2, 16), (16, 8, 128), (4, 2, 16),
                                      (8, 1, 64)])
def test_spec_and_page_bytes_match_reference(bits, ps, kv, hd):
    j = quantize.KVQuantSpec(bits, ps, kv, hd)
    t = t_quantize.KVQuantSpec(bits, ps, kv, hd)
    assert (t.tokens_per_block, t.block, t.n_blocks, t.n_levels,
            t.codes_tail, t.scales_tail) == (
        j.tokens_per_block, j.block, j.n_blocks, j.n_levels, j.codes_tail,
        j.scales_tail)
    assert t.page_bytes() == j.page_bytes()
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        assert t_quantize.kv_native_page_bytes(ps, kv, hd, tdt) == \
            quantize.kv_native_page_bytes(ps, kv, hd, jdt)


def test_spec_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="4 or 8"):
        t_quantize.KVQuantSpec(16, 4, 2, 16)
    with pytest.raises(ValueError, match="even head_dim"):
        t_quantize.KVQuantSpec(4, 4, 2, 15)


# ---------------------------------------------------------------------------
# quantized writes and attention (function level)
# ---------------------------------------------------------------------------

def _cache(rng, bits, n_pages=24, n_hot=5):
    """A quantized cache of one layer: committed pages from random
    content, random hot rows (old partial pages). numpy arrays."""
    full = rng.standard_normal((2, n_pages, PS, KV, HD)).astype(np.float32)
    c = {}
    for i, x in enumerate(("k", "v")):
        codes, scales = _jit(quantize.kv_quantize_pages, 1)(
            jnp.asarray(full[i]), bits)
        c[f"{x}_codes"] = np.asarray(codes)
        c[f"{x}_scales"] = np.asarray(scales)
        c[f"{x}_hot"] = rng.standard_normal((n_hot, PS, KV, HD)).astype(
            np.float32)
    return c


def _both(c):
    return ({k: jnp.asarray(v) for k, v in c.items()},
            from_reference(c, "cpu"))


def _assert_pools_equal(jc, tc):
    """Codes and scales byte-equal, hot rows equal, apart from scratch
    page 0 and scratch hot row 0 (pad rows write there)."""
    for name in jc:
        a = np.asarray(jc[name])
        b = tc[name]
        b = b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
        if a.dtype == jnp.bfloat16:
            a = a.astype(np.float32)
        np.testing.assert_array_equal(b[1:], a[1:], err_msg=name)


@pytest.mark.parametrize("bits", [8, 4])
def test_paged_write_quant_matches_reference(bits):
    """Row 0 completes pages 0 and 1 (old hot content + new tokens); row 1
    completes page 1 and writes its new frontier page's hot row; row 2 is
    a pad row."""
    rng = np.random.default_rng(20 + bits)
    jc, tc = _both(_cache(rng, bits))
    k = rng.standard_normal((3, 6, KV, HD)).astype(np.float32)
    v = rng.standard_normal((3, 6, KV, HD)).astype(np.float32)
    bt = np.asarray([[3, 7, 9, 11], [4, 5, 6, 8], [0, 0, 0, 0]], np.int32)
    q_pos = np.asarray([[2, 3, 4, 5, 6, 7], [5, 6, 7, 8, -1, -1],
                        [-1] * 6], np.int32)
    lens = np.asarray([8, 9, 0], np.int32)
    slots = np.asarray([0, 2, -1], np.int32)
    jout = _jit(j_attn.paged_write_quant, 7)(
        jc, *(jnp.asarray(a) for a in (k, v, bt, q_pos, lens, slots)), bits)
    tout = t_attn.paged_write_quant(
        tc, *(_t(a) for a in (k, v, bt, q_pos, lens, slots)), bits)
    assert tout is tc                                       # in place
    _assert_pools_equal(jout, tout)


def _packed_case(rng):
    """Packed row of 12: segment 0 = positions 3..7 (completes page 0 from
    its old hot row + new tokens, and page 1 — pages before its
    frontier), segment 1 = positions 0..3 (completes page 0), segment 2
    pad, three pad tokens."""
    t = 12
    seg = np.full(t, -1, np.int32)
    pos = np.full(t, -1, np.int32)
    seg[:5], pos[:5] = 0, np.arange(3, 8)
    seg[5:9], pos[5:9] = 1, np.arange(4)
    return dict(
        k=rng.standard_normal((1, t, KV, HD)).astype(np.float32),
        v=rng.standard_normal((1, t, KV, HD)).astype(np.float32),
        bt=np.asarray([[2, 6, 10, 12], [13, 14, 15, 16], [0, 0, 0, 0]],
                      np.int32),
        seg=seg[None], pos=pos[None],
        lens=np.asarray([8, 4, 0], np.int32),
        slots=np.asarray([1, 3, -1], np.int32),
        seg_off=np.asarray([0, 5, 0], np.int32))


@pytest.mark.parametrize("bits", [8, 4])
def test_packed_prefill_write_and_attention_match_reference(bits):
    """A packed chunk completes pages before its segment's frontier: the
    pools match byte for byte, and every token's attention (causal bound
    per token, frontier per segment, completed pages read from their fresh
    codes) matches the reference within 1e-5 (f32, sums in another
    order); pad tokens are exactly 0 in the port."""
    rng = np.random.default_rng(30 + bits)
    jc, tc = _both(_cache(rng, bits))
    c = _packed_case(rng)
    names = ("k", "v", "bt", "seg", "pos", "lens", "slots", "seg_off")
    jout = _jit(j_attn.paged_write_quant_packed, 9)(
        jc, *(jnp.asarray(c[n]) for n in names), bits)
    t_attn.paged_write_quant_packed(tc, *(_t(c[n]) for n in names), bits)
    _assert_pools_equal(jout, tc)
    q = rng.standard_normal((1, 12, 4, HD)).astype(np.float32)
    a_names = ("bt", "seg", "pos", "lens", "slots")
    attn = _jit(functools.partial(j_attn.paged_attention_quant_packed,
                                  softcap=20.0), 7)
    ref = np.asarray(attn(jnp.asarray(q), jout,
                          *(jnp.asarray(c[n]) for n in a_names), bits))
    out = t_attn.paged_attention_quant_packed(
        _t(q), tc, *(_t(c[n]) for n in a_names), bits, softcap=20.0).numpy()
    live = c["seg"][0] >= 0
    np.testing.assert_allclose(out[0, live], ref[0, live], rtol=0, atol=1e-5)
    assert (out[0, ~live] == 0).all()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("softcap,scale", [(0.0, None), (30.0, 0.3)])
def test_quant_attention_plain_matches_oracle(bits, softcap, scale):
    """The plain version of kernel C (what the wrapper runs on a CPU
    tensor) against the jnp oracle: partial, full and zero-length rows,
    pad hot row 0. Live rows within 1e-5; zero-length rows exactly 0 (the
    oracle returns mean(V) there)."""
    rng = np.random.default_rng(40 + bits + int(softcap))
    c = _cache(rng, bits, n_pages=20, n_hot=6)
    lens = np.asarray([6, 8, 13, 0, 1], np.int32)
    hot_rows = np.asarray([1, 2, 5, 0, 3], np.int32)
    bt = (1 + np.arange(5 * 4).reshape(5, 4) % 19).astype(np.int32)
    q = rng.standard_normal((5, 4, HD)).astype(np.float32)
    args = (q, c["k_codes"], c["k_scales"], c["v_codes"], c["v_scales"],
            c["k_hot"], c["v_hot"], bt, lens, hot_rows)
    oracle = _jit(functools.partial(j_paq_ref, kv_bits=bits, softcap=softcap,
                                    scale=scale))
    ref = np.asarray(oracle(*(jnp.asarray(a) for a in args)))
    before = pa_ops.paged_attention_decode_quant.launches
    out = pa_ops.paged_attention_decode_quant(
        *(from_reference(a, "cpu") for a in args), kv_bits=bits,
        softcap=softcap, scale=scale).numpy()
    assert pa_ops.paged_attention_decode_quant.launches == before
    live = lens > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=0, atol=1e-5)
    assert (out[~live] == 0).all()
