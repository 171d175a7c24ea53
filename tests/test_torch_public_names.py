"""The reference's remaining public names in the port: the per-arch config
modules, ``unpack_ref`` and the dispatchers ``paged_attention``,
``paged_attention_kv_quant`` and ``attention`` with the reference's
``use_kernel`` flag (which may only confirm the device's choice), held
against the reference's modules and jnp oracles on the CPU."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as j_quantize
from repro.kernels.flash_attention import ops as j_fa
from repro.kernels.msb_matmul import ref as j_mm_ref
from repro.kernels.paged_attention import ops as j_pa
from repro_torch.kernels.flash_attention import attention
from repro_torch.kernels.msb_matmul import unpack_ref
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_kv_quant)

MODULES = ["arctic_480b", "gemma2_2b", "granite_3_2b",
           "granite_moe_3b_a800m", "internlm2_1_8b", "internvl2_76b",
           "jamba_v0_1_52b", "qwen1_5_0_5b", "whisper_large_v3",
           "xlstm_125m"]
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
# the flags a CPU tensor takes: both the plain version
FLAGS = [None, False]


@pytest.mark.parametrize("name", MODULES)
def test_config_module_matches_reference(name):
    want = importlib.import_module(f"repro.configs.{name}").CONFIG
    got = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "dtype":
            w = DTYPES[w]
        assert g == w, f.name
    assert {f.name for f in dataclasses.fields(got)} == \
        {f.name for f in dataclasses.fields(want)}


@pytest.mark.parametrize("n", [128, 100])
def test_unpack_ref_is_the_reference_bit_for_bit(n):
    packed = np.random.default_rng(n).integers(0, 256, (64, 64)).astype(
        np.uint8)
    jl, js = j_mm_ref.unpack_ref(jnp.asarray(packed), n)
    tl, ts = unpack_ref(torch.from_numpy(packed), n)
    assert tl.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _pools(rng, lens, h=4, kv=2, d=16, ps=4, n_pages=24, max_pages=6):
    k = rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32)
    bt = np.stack([rng.permutation(np.arange(1, n_pages))[:max_pages]
                   for _ in lens]).astype(np.int32)
    q = rng.standard_normal((len(lens), h, d)).astype(np.float32)
    return q, k, v, bt, np.asarray(lens, np.int32)


def _t(arrays):
    """numpy arrays as tensors (bf16 arrays through f32, exactly)."""
    return [torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
            if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a))
            for a in arrays]


LENS = [1, 7, 0, 24, 13]


@pytest.mark.parametrize("use_kernel", FLAGS)
def test_paged_attention_flags_match_oracle(use_kernel):
    q, k, v, bt, lens = _pools(np.random.default_rng(1), LENS)
    kw = dict(softcap=20.0, scale=0.3)
    want = np.asarray(j_pa.paged_attention(
        *map(jnp.asarray, (q, k, v, bt, lens)), use_kernel=False, **kw))
    got = paged_attention(*_t((q, k, v, bt, lens)), use_kernel=use_kernel,
                          **kw).numpy()
    live = lens > 0          # pad rows: the port 0, the oracle mean(V)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5)
    assert (got[~live] == 0).all()


def _quant_pools(rng, bits, ps=4, kv=2, d=16, n_pages=24, n_hot=5):
    out = {}
    for x in ("k", "v"):
        full = rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32)
        codes, scales = jax.jit(j_quantize.kv_quantize_pages,
                                static_argnums=1)(jnp.asarray(full), bits)
        out[x] = (np.asarray(codes), np.asarray(scales),
                  rng.standard_normal((n_hot, ps, kv, d)).astype(np.float32))
    return out


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("use_kernel", FLAGS)
def test_paged_attention_kv_quant_flags_match_oracle(bits, use_kernel):
    rng = np.random.default_rng(bits)
    q, _, _, bt, lens = _pools(rng, LENS)
    p = _quant_pools(rng, bits)
    hot = np.asarray([1, 2, 0, 3, 4], np.int32)
    args = (q, *p["k"][:2], *p["v"][:2], p["k"][2], p["v"][2], bt, lens,
            hot)
    kw = dict(kv_bits=bits, softcap=0.0, scale=None)
    want = np.asarray(j_pa.paged_attention_kv_quant(
        *map(jnp.asarray, args), use_kernel=False, **kw))
    got = paged_attention_kv_quant(*_t(args), use_kernel=use_kernel,
                                   **kw).numpy()
    live = lens > 0
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5)
    assert (got[~live] == 0).all()


def _segments(b, s):
    segs = np.full((b, s), -1, np.int32)
    for i in range(b):
        cuts = [0, 13 + 5 * i, 40 + 7 * i, s - 6 - i]
        for j in range(3):
            segs[i, cuts[j]:cuts[j + 1]] = j
    return segs


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("use_kernel", FLAGS)
def test_attention_flags_match_oracle(segmented, use_kernel):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 96, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 96, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 96, 16)).astype(np.float32)
    segs = _segments(2, 96) if segmented else None
    kw = dict(causal=True, window=17, softcap=30.0, scale=0.3)
    jseg = {} if segs is None else dict(q_segs=jnp.asarray(segs),
                                        kv_segs=jnp.asarray(segs))
    tseg = {} if segs is None else dict(q_segs=torch.from_numpy(segs),
                                        kv_segs=torch.from_numpy(segs))
    want = np.asarray(j_fa.attention(*map(jnp.asarray, (q, k, v)),
                                     use_kernel=False, **jseg, **kw))
    got = attention(*_t((q, k, v)), use_kernel=use_kernel, **tseg,
                    **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_dispatchers_refuse_what_the_cpu_cannot_honour():
    """``use_kernel=True`` on CPU tensors (the port has no interpreter),
    and ``attention`` with one of ``q_segs`` / ``kv_segs``."""
    rng = np.random.default_rng(4)
    q, k, v, bt, lens = _t(_pools(rng, LENS))
    with pytest.raises(ValueError, match="use_kernel=True"):
        paged_attention(q, k, v, bt, lens, use_kernel=True)
    p = _quant_pools(rng, 8)
    with pytest.raises(ValueError, match="use_kernel=True"):
        paged_attention_kv_quant(
            q, *_t((*p["k"][:2], *p["v"][:2], p["k"][2], p["v"][2])), bt,
            lens, torch.ones(5, dtype=torch.int32), kv_bits=8,
            use_kernel=True)
    qa = torch.zeros(1, 4, 32, 16)
    ka = torch.zeros(1, 2, 32, 16)
    with pytest.raises(ValueError, match="use_kernel=True"):
        attention(qa, ka, ka, use_kernel=True)
    segs = torch.zeros(1, 32, dtype=torch.int32)
    for one in (dict(q_segs=segs), dict(kv_segs=segs)):
        with pytest.raises(ValueError, match="both q_segs and kv_segs"):
            attention(qa, ka, ka, **one)
