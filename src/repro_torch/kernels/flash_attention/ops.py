"""Wrapper of the flash-attention forward kernel.

``flash_attention_fwd`` dispatches on the tensor's device and nothing else:
a CPU tensor takes the plain version (``ref.py``), a CUDA tensor launches
the hand-written kernel (``csrc/flash_attention.cu``: the tensor-core
kernel for bf16, the SIMT kernel for f32, chosen by dtype alone) or
raises. Its ``.launches`` counts the kernel's launches.

The kernel is forward-only and writes through raw pointers, so its output
has no autograd history: ``_launch`` refuses q, k or v that require grad
while grad mode is on. Training reaches it through the autograd Function
of ``models/attention.py``, whose forward runs with grad mode off and asks
for the per-row log-sum-exp (``lse``) its backward reads.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_use_kernel
from .ref import flash_attention_ref, flash_attention_segmented_ref


def _lib():
    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        vp, ci, cf, cl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_longlong)
        fn.argtypes = [vp] * 7 + [ci] * 6 + [cl] * 12 + [ci, ci, ci, cf, cf,
                                                          ci, vp]
        fn.restype = ci
    return fn


def refuse_grad(q, k, v):
    """Raise when grad mode is on and q, k or v requires grad: the raw
    launch would give them no gradient, silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_fwd: the kernel has no backward; q, k and v "
            "that require grad go through repro_torch.models.attention."
            "flash_attention (an autograd Function)")


def _launch(q, k, v, q_segs, kv_segs, causal, window, softcap, scale,
            lse=None, q_offset=0):
    what = "flash_attention_fwd"
    refuse_grad(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q must be (B, H, Sq, d) and k, v one "
                         "(B, KV, Skv, d) shape")
    b, h, sq, d = q.shape
    _, kv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or kv == 0 or h % kv:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if int(q_offset) < 0:
        raise ValueError(f"{what}: q_offset must be >= 0, got {q_offset}")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"{what}: head_dim {d} must be a multiple of 16 in "
                         "[16, 256]")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k and v must share one type, bf16 or "
                        "f32")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{what}: the last dim of q, k and v must be "
                         "contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError(f"{what}: bf16 q, k and v must start on a 16-byte "
                         "boundary with batch, head and row strides a "
                         "multiple of 8 elements (the tensor-core kernel "
                         "copies 16-byte rows)")
    ts = [q, k, v]
    if q_segs is not None:
        for name, t, n in (("q_segs", q_segs, sq), ("kv_segs", kv_segs, skv)):
            if t.dtype != torch.int32 or tuple(t.shape) != (b, n) or \
                    not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be contiguous int32 "
                                 f"({b}, {n})")
        ts += [q_segs, kv_segs]
    if lse is not None:
        if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq) or \
                not lse.is_contiguous():
            raise ValueError(f"{what}: lse must be contiguous f32 "
                             f"({b}, {h}, {sq})")
        ts.append(lse)
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: all tensors must be on one device")
    out = torch.empty_like(q)       # q's strides: (B, S, H, d) views stay so
    if out.numel() == 0:
        return out
    scale = float(scale if scale is not None else d ** -0.5)
    segs = ((q_segs.data_ptr(), kv_segs.data_ptr()) if q_segs is not None
            else (None, None))
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), *segs,
                 out.data_ptr(), None if lse is None else lse.data_ptr(),
                 b, h, kv, sq, skv, d, *strides,
                 int(bool(causal)), int(window), int(q_offset), scale,
                 float(softcap),
                 int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)
    flash_attention_fwd.launches += 1
    return out


def flash_attention_fwd(q, k, v, q_segs=None, kv_segs=None, *, causal=True,
                        window=0, softcap=0.0, scale=None, lse=None,
                        q_offset=0):
    """Forward attention in head-major layout. q: (B, H, Sq, d); k/v: (B,
    KV, Skv, d), any Sq and Skv, any strides with a contiguous last dim;
    ``q_segs``/``kv_segs``: optional (B, Sq)/(B, Skv) int32 segment ids —
    pass both or neither; a key of another segment gets weight exactly 0,
    and a row whose segment is -1 (a pad) outputs exactly 0. ``lse``: an
    optional contiguous f32 (B, H, Sq) tensor that receives each row's
    log-sum-exp ``m + log(max(l, 1e-30))`` of its (scaled, softcapped)
    scores. ``q_offset`` (>= 0): query row i sits at position ``q_offset +
    i`` for the causal and window masks (a context-parallel rank's rows),
    keys at 0 .. Skv - 1. Returns (B, H, Sq, d) in q's type."""
    if (q_segs is None) != (kv_segs is None):
        raise ValueError("pass both q_segs and kv_segs, or neither")
    if q.is_cuda:
        return _launch(q, k, v, q_segs, kv_segs, causal, window, softcap,
                       scale, lse, q_offset)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              with_lse=lse is not None, q_offset=q_offset)
    if q_segs is not None:
        res = flash_attention_segmented_ref(q, k, v, q_segs, kv_segs, **kw)
    else:
        res = flash_attention_ref(q, k, v, **kw)
    if lse is None:
        return res
    lse.copy_(res[1])
    return res[0]


flash_attention_fwd.launches = 0


def attention(q, k, v, *, q_segs=None, kv_segs=None, causal=True, window=0,
              softcap=0.0, scale=None, use_kernel=None):
    """The reference's dispatcher of kernel D, an alias of
    ``flash_attention_fwd``: the kernel on a CUDA tensor, its plain
    versions on a CPU one (``use_kernel`` may only confirm that:
    ``check_use_kernel``). Pass both ``q_segs`` and ``kv_segs``, or
    neither (ValueError)."""
    check_use_kernel(q, use_kernel, "attention")
    return flash_attention_fwd(q, k, v, q_segs, kv_segs, causal=causal,
                               window=window, softcap=softcap, scale=scale)
