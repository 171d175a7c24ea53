"""The port's flash attention (kernel D's plain version, and the model's
flash and ring-decode attention) against the JAX package's jnp oracles.

Inputs come from a numpy seed and go through both. Tolerance in f32:
``atol=2e-5, rtol=1e-4`` as ``tests/test_packed_prefill.py`` holds the
Pallas kernel — the port sums in 64-key tiles (and scales after the dot,
as the jnp path does) where the oracle sums in 512-position chunks; pad
rows and cross-segment isolation are held exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_ref,
                                                 flash_attention_segmented_ref)
from repro_torch.models import attention as tattn

TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(seed, b, h, kv, sq, skv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(dtype),
            rng.standard_normal((b, kv, skv, d)).astype(dtype),
            rng.standard_normal((b, kv, skv, d)).astype(dtype))


def _segments(b, s):
    """Three contiguous segments of different lengths per row, then pads."""
    segs = np.full((b, s), -1, np.int32)
    for i in range(b):
        cuts = [0, 13 + 5 * i, 40 + 7 * i, s - 6 - i]
        for j in range(3):
            segs[i, cuts[j]:cuts[j + 1]] = j
    return segs


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (causal, window, softcap, H, KV, Sq, Skv): rep 1, 2 and 4; S ragged
# against the 64-key tile and the oracle's 512 chunk
CASES = {
    "causal-rep2-s100": (True, 0, 0.0, 4, 2, 100, 100),
    "causal-rep4-s64": (True, 0, 0.0, 8, 2, 64, 64),
    "noncausal-rep1-s70x130": (False, 0, 0.0, 4, 4, 70, 130),
    "window17-rep2-s130": (True, 17, 0.0, 4, 2, 130, 130),
    "softcap30-rep4-s100": (True, 0, 30.0, 8, 2, 100, 100),
    "window-softcap-noncausal-s97": (False, 24, 20.0, 4, 2, 97, 97),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_flash_attention_ref(case):
    causal, window, softcap, h, kv, sq, skv = CASES[case]
    q, k, v = _qkv(0, 2, h, kv, sq, skv, 16)
    kw = dict(causal=causal, window=window, softcap=softcap)
    ref = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                              **kw))
    out = flash_attention_fwd(*_t(q, k, v), **kw).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    # the plain version called directly, with an explicit scale
    ref = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                              scale=0.3, **kw))
    out = flash_attention_ref(*_t(q, k, v), scale=0.3, **kw).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_plain_bf16_matches_reference():
    """bf16 inputs: both round p to bf16 before the PV product; the outputs
    are bf16, so the tolerance is a few bf16 ulps of values ~1."""
    q, k, v = _qkv(1, 1, 4, 2, 80, 80, 32)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (tq, tk, tv))
    ref = np.asarray(jref.flash_attention_ref(jq, jk, jv), np.float32)
    out = flash_attention_fwd(tq, tk, tv).float().numpy()
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_plain_segmented_matches_reference(causal, softcap):
    q, k, v = _qkv(2, 2, 4, 2, 96, 96, 16)
    segs = _segments(2, 96)
    kw = dict(causal=causal, softcap=softcap)
    ref = np.asarray(jref.flash_attention_segmented_ref(
        *map(jnp.asarray, (q, k, v, segs, segs)), **kw))
    out = flash_attention_fwd(*_t(q, k, v, segs, segs), **kw).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    out = flash_attention_segmented_ref(*_t(q, k, v, segs, segs),
                                        window=9, **kw).numpy()
    ref = np.asarray(jref.flash_attention_segmented_ref(
        *map(jnp.asarray, (q, k, v, segs, segs)), window=9, **kw))
    np.testing.assert_allclose(out, ref, **TOL)


def test_pad_rows_exactly_zero():
    q, k, v = _qkv(3, 2, 4, 2, 96, 96, 16)
    segs = _segments(2, 96)
    out = flash_attention_fwd(*_t(q, k, v, segs, segs)).numpy()
    pads = segs == -1
    assert pads.any()
    for b in range(2):
        assert (out[b][:, pads[b]] == 0).all()
        assert (np.abs(out[b][:, ~pads[b]]).sum(-1) > 0).all()


def test_cross_segment_isolation_bitwise():
    """New K and V for every other segment leave segment 1's rows
    bit-identical."""
    q, k, v = _qkv(4, 2, 4, 2, 96, 96, 16)
    segs = _segments(2, 96)
    out = flash_attention_fwd(*_t(q, k, v, segs, segs)).numpy()
    rng = np.random.default_rng(5)
    other = (segs != 1)[:, None, :, None]
    k2 = np.where(other, rng.standard_normal(k.shape) * 10, k).astype(
        np.float32)
    v2 = np.where(other, rng.standard_normal(v.shape) * 10, v).astype(
        np.float32)
    out2 = flash_attention_fwd(*_t(q, k2, v2, segs, segs)).numpy()
    mine = segs == 1
    for b in range(2):
        np.testing.assert_array_equal(out2[b][:, mine[b]], out[b][:, mine[b]])
        assert not np.array_equal(out2[b][:, ~mine[b] & (segs[b] >= 0)],
                                  out[b][:, ~mine[b] & (segs[b] >= 0)])


def test_segment_ids_both_or_neither():
    q, k, v = _t(*_qkv(6, 1, 2, 1, 8, 8, 16))
    segs = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        flash_attention_fwd(q, k, v, q_segs=segs)
    with pytest.raises(ValueError, match="both"):
        flash_attention_fwd(q, k, v, kv_segs=segs)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 20, 0.0), (False, 0, 0.0), (True, 0, 25.0)])
def test_model_flash_attention_matches_reference(causal, window, softcap):
    """(B, S, H, d) layout; the reference pads 45 up to its 32-chunks, the
    port masks instead."""
    rng = np.random.default_rng(7)
    s = 45 if causal else 64
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    ref = np.asarray(jattn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           chunk_q=32, chunk_kv=32, **kw))
    out = tattn.flash_attention(*_t(q, k, v), **kw)
    assert out.shape == (2, s, 4, 16)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 30.0)])
def test_decode_attention_matches_reference(window, softcap):
    """Ring buffer of 24 entries: row 0 has wrapped (positions 24..35 over
    0..11), row 1 is half empty (-1)."""
    rng = np.random.default_rng(8)
    s = 24
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    pos = np.stack([np.where(np.arange(s) < 12, np.arange(s) + 24,
                             np.arange(s)),
                    np.where(np.arange(s) < 13, np.arange(s), -1)]).astype(
        np.int32)
    cur = np.asarray([35, 12], np.int32)
    kw = dict(window=window, softcap=softcap)
    ref = np.asarray(jattn.decode_attention(
        *map(jnp.asarray, (q, kc, vc, pos, cur)), **kw))
    out = tattn.decode_attention(*_t(q, kc, vc, pos, cur), **kw).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
