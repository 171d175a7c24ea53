"""The plain versions of the port's two kernels against the JAX oracles
(the kernels themselves are held against these on the card by
tests/test_torch_cuda.py and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.msb_matmul.msb_matmul import msb_matmul as j_msb_matmul
from repro.kernels.msb_matmul.ref import msb_matmul_ref as j_msb_ref
from repro.kernels.paged_attention.ref import \
    paged_attention_decode_ref as j_pa_ref
from repro_torch.kernels.msb_matmul import ops as mm_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref


def _weights(rng, k, n, kblocked):
    packed = rng.integers(0, 256, (k, n // 2)).astype(np.uint8)
    shape = (k // 64, n, 8) if kblocked else (k, n // 64, 8)
    scales = np.sort(rng.random(shape).astype(np.float32) * 0.1, axis=-1)
    return packed, scales


@pytest.mark.parametrize("m", [1, 3, 8, 40])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("kblocked", [False, True])
def test_msb_matmul_plain_matches_oracles(m, bias, kblocked):
    rng = np.random.default_rng(m + 10 * bias + 100 * kblocked)
    k, n = 128, 192
    packed, scales = _weights(rng, k, n, kblocked)
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32) if bias else None
    y = mm_ops.msb_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                          torch.from_numpy(scales),
                          None if b is None else torch.from_numpy(b),
                          kblocked=kblocked).numpy()
    jb = None if b is None else jnp.asarray(b)
    y_ref = np.asarray(j_msb_ref(jnp.asarray(x), jnp.asarray(packed),
                                 jnp.asarray(scales), jb, kblocked=kblocked))
    tol = 1e-5 * np.abs(y_ref).max()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=tol)
    if m in (3, 40):      # the Pallas kernel still runs in interpret mode
        y_int = np.asarray(j_msb_matmul(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), jb,
            kblocked=kblocked, interpret=True))
        np.testing.assert_allclose(y, y_int, rtol=0, atol=tol)


def test_msb_matmul_plain_bf16_rounds_weights_like_the_oracle():
    rng = np.random.default_rng(7)
    packed, scales = _weights(rng, 128, 128, False)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y = mm_ops.msb_matmul(xt, torch.from_numpy(packed),
                          torch.from_numpy(scales))
    assert y.dtype == torch.bfloat16
    y_ref = np.asarray(j_msb_ref(jnp.asarray(xt.float().numpy(),
                                             jnp.bfloat16),
                                 jnp.asarray(packed), jnp.asarray(scales)))
    np.testing.assert_allclose(y.float().numpy(), y_ref.astype(np.float32),
                               rtol=0, atol=1e-2 * np.abs(y_ref).max())


def test_msb_matmul_k_splits_depend_on_k_and_n_only():
    assert mm_ops.k_splits(2048, 2048) == 8
    assert mm_ops.k_splits(2048, 92672) == 1
    assert mm_ops.k_splits(8192, 2048) == 8
    for k, n in ((64, 64), (128, 192), (2048, 1024), (2048, 8192)):
        s = mm_ops.k_splits(k, n)
        assert k % (64 * s) == 0 and s >= 1


def _pool_case(rng, lens, h=4, kv=2, d=16, ps=4, n_pages=24):
    b = len(lens)
    max_pages = 6
    k_pool = rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32)
    bt = np.stack([rng.permutation(np.arange(1, n_pages))[:max_pages]
                   for _ in range(b)]).astype(np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, k_pool, v_pool, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("softcap,scale", [(0.0, None), (30.0, None),
                                           (0.0, 0.3), (5.0, 0.7)])
def test_paged_attention_plain_matches_oracle(softcap, scale):
    rng = np.random.default_rng(int(softcap * 10 + (scale or 0) * 100))
    q, kp, vp, bt, lens = _pool_case(rng, [1, 7, 0, 24, 13])
    out = pa_ops.paged_attention_decode(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, lens)),
        softcap=softcap, scale=scale).numpy()
    ref = np.asarray(j_pa_ref(*(jnp.asarray(a) for a in (q, kp, vp, bt,
                                                          lens)),
                              softcap=softcap, scale=scale))
    live = lens > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=0, atol=1e-5)
    # pad rows differ on purpose: the port returns 0, the oracle mean(V)
    assert (out[~live] == 0).all()


def test_attend_gathered_is_causal_by_position():
    """Keys after q_pos never influence the output."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 3, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 6, 1, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 6, 1, 8)).astype(np.float32))
    q_pos = torch.tensor([[0, 2, 4]])
    lens = torch.tensor([5])
    a = pa_ref.attend_gathered(q, k, v, q_pos, lens)
    k2, v2 = k.clone(), v.clone()
    k2[:, 3:] += 100.0                 # after q_pos 0 and 2; 5 is past len
    v2[:, 3:] += 100.0
    b = pa_ref.attend_gathered(q, k2, v2, q_pos, lens)
    assert torch.equal(a[:, :2], b[:, :2])
    assert not torch.equal(a[:, 2], b[:, 2])
    np.testing.assert_allclose(a[0, 0, 0].numpy(), v[0, 0, 0].numpy(),
                               rtol=1e-6)
