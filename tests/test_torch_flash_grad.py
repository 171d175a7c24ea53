"""Gradients of attention: kernel D's log-sum-exp, the port's
``flash_attention_bwd`` and the autograd Function around kernel D, against
the reference's ``jax.custom_vjp`` (``repro.models.attention.
flash_attention``: ``_flash_fwd``'s lse residual and ``_flash_bwd``), in
f32 on the CPU.

Cases cover GQA, causal and not, a sliding window, a softcap, Sq != Skv
(cross-attention) and lengths that are not multiples of 64 or 512 (more
than one 512-chunk, so chunk pairs are skipped under the masks). Every
gradient is held within 1e-5 of its largest |value|; each row's lse
within 1e-5 of the largest |lse|. The raw launch's refusal of inputs that
require grad is checked here on its condition; the launch itself is in
``tests/test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.attention import (_Flash, flash_attention,
                                          flash_attention_bwd)

TOL = 1e-5
CASES = {  # B, H, KV, Sq, Skv, d, causal, window, softcap
    "causal GQA S=70": (2, 4, 2, 70, 70, 16, True, 0, 0.0),
    "cross Sq=33 Skv=70": (2, 4, 4, 33, 70, 16, False, 0, 0.0),
    "full S=150": (1, 2, 1, 150, 150, 32, False, 0, 0.0),
    "window 100 S=600": (1, 4, 2, 600, 600, 16, True, 100, 0.0),
    "softcap 5 S=130": (2, 2, 1, 130, 130, 16, True, 0, 5.0),
    "causal S=1030": (1, 2, 1, 1030, 1030, 16, True, 0, 0.0),
}


def _inputs(case):
    b, h, kv, sq, skv, d = CASES[case][:6]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, dout = (rng.standard_normal((b, sq, h, d)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((b, skv, kv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, dout


def _kw(case):
    causal, window, softcap = CASES[case][6:]
    return dict(causal=causal, window=window, softcap=softcap)


def _reference(case):
    """(out, (dq, dk, dv)) of the reference in the model layout."""
    q, k, v, dout = _inputs(case)
    out, vjp = jax.vjp(lambda *a: jattn.flash_attention(*a, **_kw(case)),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _head_major(*arrays):
    return [torch.from_numpy(a).transpose(1, 2) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_bwd_matches_reference_vjp(case):
    """The port's backward on the plain forward's out and lse."""
    q, k, v, dout = _inputs(case)
    _, want = _reference(case)
    qh, kh, vh, doh = _head_major(q, k, v, dout)
    lse = torch.empty(qh.shape[:3])
    out = fa_ops.flash_attention_fwd(qh, kh, vh, lse=lse, **_kw(case))
    grads = flash_attention_bwd(qh, kh, vh, out, lse, doh, **_kw(case))
    for g, w in zip(grads, want):
        _close(g.transpose(1, 2), w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_through_flash_attention_matches_reference(case):
    """``models.attention.flash_attention`` on tensors that require grad
    runs the autograd Function on the CPU too: out and (dq, dk, dv) as the
    reference's."""
    q, k, v, dout = _inputs(case)
    want_out, want = _reference(case)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*ts, **_kw(case))
    assert out.grad_fn.next_functions[0][0].name() == "_FlashBackward"
    _close(out, want_out)
    out.backward(torch.from_numpy(dout))
    for t, w in zip(ts, want):
        _close(t.grad, w)


# context parallelism: a rank's Sq query rows at positions q_offset + i
# against the whole Skv keys (B, H, KV, Sq, Skv, d, window)
OFFSET_SHAPE = (2, 4, 2, 48, 160, 16)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("q_offset", [0, 48, 112])
def test_q_offset_matches_reference_vjp(q_offset, window):
    """The plain D (out and lse), ``flash_attention_bwd`` and the autograd
    Function with ``q_offset`` in {0, Sq, Skv - Sq}, causal, with and
    without a window, against ``jax.vjp`` of the reference's
    ``flash_attention(q_offset=...)``."""
    b, h, kv, sq, skv, d = OFFSET_SHAPE
    rng = np.random.default_rng(q_offset + window)
    q, dout = (rng.standard_normal((b, sq, h, d)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((b, skv, kv, d)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=window)
    want_out, vjp = jax.vjp(
        lambda *a: jattn.flash_attention(*a, q_offset=q_offset, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    _, want_lse = jattn._fa_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=jnp.int32(window), q_offset=jnp.int32(q_offset), softcap=0.0,
        scale=d ** -0.5, chunk_q=sq, chunk_kv=skv)
    qh, kh, vh, doh = _head_major(q, k, v, dout)
    lse = torch.empty(qh.shape[:3])
    out = fa_ops.flash_attention_fwd(qh, kh, vh, lse=lse, q_offset=q_offset,
                                     **kw)
    _close(out.transpose(1, 2), np.asarray(want_out))
    _close(lse.transpose(1, 2), np.asarray(want_lse))
    grads = flash_attention_bwd(qh, kh, vh, out, lse, doh,
                                q_offset=q_offset, **kw)
    for g, w in zip(grads, want):
        _close(g.transpose(1, 2), w)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    flash_attention(*ts, q_offset=q_offset, **kw).backward(
        torch.from_numpy(dout))
    for t, w in zip(ts, want):
        _close(t.grad, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_matches_reference_residual(case):
    """The plain forward's lse (the kernel's, on the card) against the
    reference's ``_fa_fwd_impl`` residual (unpadded chunks of the whole
    length)."""
    b, h, kv, sq, skv, d = CASES[case][:6]
    q, k, v, _ = _inputs(case)
    kw = _kw(case)
    _, want = jattn._fa_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=kw["causal"],
        window=jnp.int32(kw["window"]), q_offset=jnp.int32(0),
        softcap=kw["softcap"], scale=d ** -0.5, chunk_q=sq, chunk_kv=skv)
    qh, kh, vh = _head_major(q, k, v)
    lse = torch.empty(qh.shape[:3])
    out = fa_ops.flash_attention_fwd(qh, kh, vh, lse=lse, **kw)
    _close(lse.transpose(1, 2), np.asarray(want))
    assert torch.equal(out, fa_ops.flash_attention_fwd(qh, kh, vh, **kw))


def test_lse_of_rows_that_see_no_key():
    """A pad row (segment -1) sees no key: its lse is the max's floor
    plus log(1e-30), as ``l_safe`` gives it, and its output 0."""
    q = torch.randn(1, 2, 5, 16)
    k = torch.randn(1, 1, 5, 16)
    segs = torch.tensor([[0, 0, 1, 1, -1]], dtype=torch.int32)
    lse = torch.empty(1, 2, 5)
    out = fa_ops.flash_attention_fwd(q, k, k, segs, segs, lse=lse)
    assert torch.all(out[:, :, 4] == 0)
    assert torch.all(lse[:, :, 4] == torch.tensor(-2.0e38) + np.log(1e-30))
    assert torch.all(lse[:, :, :4] > -1e3)


def test_raw_launch_refuses_inputs_that_require_grad():
    """The kernel's raw launch would leave q, k and v without a gradient:
    ``_launch`` refuses them before anything else while grad mode is on,
    and the condition clears under ``no_grad`` and for the Function's own
    forward (which runs with grad mode off)."""
    q = torch.randn(1, 2, 4, 16, requires_grad=True)
    k = torch.randn(1, 1, 4, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops._launch(q, k, k, None, None, True, 0, 0.0, None)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.refuse_grad(k, q, k)
    with torch.no_grad():
        fa_ops.refuse_grad(q, k, k)
    fa_ops.refuse_grad(q.detach(), k, k)

    class Probe(torch.autograd.Function):     # as ``_Flash.forward`` runs
        @staticmethod
        def forward(ctx, x):
            fa_ops.refuse_grad(x, x, x)
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g

    Probe.apply(q)
    assert issubclass(_Flash, torch.autograd.Function)
