"""AdamW with optionally int8-quantized moments (blockwise absmax).

Port of ``repro.train.optim`` on one device: ``OptConfig``, the warmup +
cosine ``lr_schedule`` (f32 arithmetic, as the reference's), the moment
codecs (linear int8 with bf16 scales for m, uint8 log codes over 12
decades for v), ``AdamW.init`` / ``update`` over the port's nested param
dict, ``global_norm`` and ``clip_by_global_norm``. Plain torch on every
device, as the reference's is jnp (no kernel).

``update`` runs under ``torch.no_grad()`` and writes the params and the
moments in place (the reference's train step donates its state; here the
tensors are reused), returning the same trees. ``moment_axes`` gives the
moments' logical axes (the sharding resolver's input), as the
reference's. On a rank of a process mesh ``update(..., sharding=...)``
runs on the rank's blocks: elementwise, except the int8 codecs' per-block
maxima, which are reduced (pmax) over the ranks of the last dim where a
shard cuts a 256-wide block (the scales then stay whole on every rank, as
``moment_axes`` resolves them), so each rank's codes are the ones the
whole leaf's codec gives.

A division by a constant is a multiplication by its f32 reciprocal here,
as XLA compiles the reference's (``x / 255.0`` becomes ``x * (1 / 255)``),
and v's log codec rounds its multiply-adds once, as XLA's fused multiply-
adds do (``_fma``): its codes span 12 decades, so a second rounding there
would move a dequantized v by up to ~30 ulps.

The reference floors ``_q8_log``'s max and values at 1e-38, an f32
subnormal that XLA flushes to 0; so an all-zero block (every block at
init) gets a log-max of -inf there. The port floors at 0 and keeps that.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: str = "f32"       # f32 | int8
    q_block: int = 256
    min_quant_size: int = 1 << 14   # small leaves keep f32 moments


def _f32(x):
    """A Python float rounded to f32, as a constant of an f32 program."""
    return float(torch.tensor(x, dtype=torch.float32))


def _fma(a, b, c):
    """a * b + c of f32 operands rounded once to f32 (f64 holds the
    product of two f32 exactly)."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def lr_schedule(cfg: OptConfig, step):
    """f32 learning rate at ``step`` (int or int tensor): linear warmup,
    then cosine decay to ``min_lr_ratio``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step * (1.0 / max(cfg.warmup_steps, 1))
    t = torch.clamp((step - cfg.warmup_steps)
                    * (1.0 / max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    cos = _fma(1 + torch.cos(math.pi * t),
               _f32((1 - cfg.min_lr_ratio) * 0.5), _f32(cfg.min_lr_ratio))
    return cfg.lr * torch.minimum(warm, cos)


# -- blockwise int8 state ----------------------------------------------------
# Blocks run along the last dim only; leaves whose last dim is not a
# multiple of q_block (or smaller than min_quant_size) keep f32 moments.

def _lastdim_blocks(x, block):
    return x.reshape(*x.shape[:-1], x.shape[-1] // block, block)


def _q8(x, block):
    """Signed x -> {"q" int8 codes, "s" bf16 per-block absmax / 127}."""
    fp = _lastdim_blocks(x, block)
    scale = torch.amax(torch.abs(fp), dim=-1) * (1.0 / 127.0)
    q = torch.round(fp / torch.clamp(scale, min=1e-20)[..., None]).to(
        torch.int8)
    return {"q": q.reshape(x.shape), "s": scale.to(torch.bfloat16)}


def _dq8(st, block, shape):
    fp = _lastdim_blocks(st["q"].to(torch.float32), block)
    return (fp * st["s"].to(torch.float32)[..., None]).reshape(shape)


_LOG_DECADES = 12.0 * math.log(10.0)   # dynamic range below block max


def _q8_log(x, block):
    """Non-negative x -> {"q" uint8 log codes (0 = exact zero), "s" f32
    per-block log-max}."""
    fp = _lastdim_blocks(x, block)
    logmax = torch.log(torch.amax(fp, dim=-1))
    logv = torch.log(fp) - logmax[..., None]
    code = torch.clamp(torch.round(
        255.0 * _fma(logv, _f32(1.0 / _LOG_DECADES), 1.0)), 0, 255)
    code = torch.where(fp > 0, torch.clamp(code, min=1),
                       torch.zeros((), device=x.device)).to(torch.uint8)
    return {"q": code.reshape(x.shape), "s": logmax}


def _dq8_log(st, block, shape):
    fp = _lastdim_blocks(st["q"].to(torch.float32), block)
    logv = _fma(_fma(fp, _f32(1.0 / 255.0), -1.0), _f32(_LOG_DECADES),
                st["s"][..., None].to(torch.float64))
    out = torch.where(fp > 0, torch.exp(logv),
                      torch.zeros((), device=fp.device))
    return out.reshape(shape)


def _is_q(leaf):
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


class _Cut:
    """A rank's block of an int8 moment whose last dim a shard cuts
    inside 256-wide blocks: ``bid`` the global block of each local
    column, ``nb`` the number of blocks, ``ctx``/``axes`` the ranks that
    share the blocks. Maxima go through ``pmax``, then every element is
    coded as the whole leaf's codec codes it."""

    def __init__(self, n_local, n_global, block, ctx, axes, device):
        off = ctx.index(axes) * n_local
        self.bid = torch.div(torch.arange(off, off + n_local, device=device),
                             block, rounding_mode="floor")
        self.nb = n_global // block
        self.ctx, self.axes = ctx, axes

    def block_max(self, x):
        from ..parallel.sharding import raw_pmax
        part = x.new_zeros(x.shape[:-1] + (self.nb,))
        part.scatter_reduce_(-1, self.bid.expand(x.shape), x, "amax")
        return raw_pmax(self.ctx, part, self.axes)

    def cols(self, per_block):
        return per_block[..., self.bid]


def _q8_cut(x, cut):
    scale = cut.block_max(torch.abs(x)) * (1.0 / 127.0)
    q = torch.round(x / torch.clamp(cut.cols(scale), min=1e-20)).to(
        torch.int8)
    return {"q": q, "s": scale.to(torch.bfloat16)}


def _dq8_cut(st, cut):
    return st["q"].to(torch.float32) * cut.cols(st["s"].to(torch.float32))


def _q8_log_cut(x, cut):
    logmax = torch.log(cut.block_max(x))
    logv = torch.log(x) - cut.cols(logmax)
    code = torch.clamp(torch.round(
        255.0 * _fma(logv, _f32(1.0 / _LOG_DECADES), 1.0)), 0, 255)
    code = torch.where(x > 0, torch.clamp(code, min=1),
                       torch.zeros((), device=x.device)).to(torch.uint8)
    return {"q": code, "s": logmax}


def _dq8_log_cut(st, cut):
    fp = st["q"].to(torch.float32)
    logv = _fma(_fma(fp, _f32(1.0 / 255.0), -1.0), _f32(_LOG_DECADES),
                cut.cols(st["s"]).to(torch.float64))
    return torch.where(fp > 0, torch.exp(logv),
                       torch.zeros((), device=fp.device))


def leaves(tree, path=()):
    """(path tuple, tensor) of a nested dict in sorted key order (the
    reference's pytree order); ``{"q", "s"}`` moment dicts are leaves."""
    if isinstance(tree, dict) and not _is_q(tree):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assign(dst, src):
    """Copy a moment (tensor or {"q", "s"}) into ``dst`` in place."""
    if _is_q(dst):
        dst["q"].copy_(src["q"])
        dst["s"].copy_(src["s"])
    else:
        dst.copy_(src)


class AdamW:
    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def _quantize_leaf(self, p):
        return self._quantize_shape(tuple(p.shape))

    def _quantize_shape(self, shape):
        return (self.cfg.moment_dtype == "int8"
                and math.prod(shape) >= self.cfg.min_quant_size
                and shape[-1] % self.cfg.q_block == 0)

    def moment_axes(self, params_axes, params_shapes):
        """Logical axes of the optimizer state, nested as ``init`` builds
        it: an int8 leaf's {"q", "s"} both take the param's axes (the
        resolver drops the last one for "s" where the shrunken dim stops
        dividing), ``step`` ()."""
        from ..parallel.sharding import tree_map_axes

        def one(axes, shape):
            if self._quantize_shape(tuple(shape)):
                return {"q": tuple(axes), "s": tuple(axes)}
            return tuple(axes)
        t = tree_map_axes(one, params_axes, params_shapes)
        return {"m": t, "v": t, "step": ()}

    def moment_shapes(self, params_shapes):
        """Global shapes of the optimizer state, nested as ``moment_axes``:
        an int8 leaf's "s" has the param's shape with the last dim
        divided by ``q_block``."""
        def one(shape):
            shape = tuple(shape)
            if self._quantize_shape(shape):
                return {"q": shape,
                        "s": shape[:-1] + (shape[-1] // self.cfg.q_block,)}
            return shape
        t = _map(one, params_shapes)
        return {"m": t, "v": t, "step": ()}

    def init(self, params):
        """Zero moments shaped like ``params`` (f32, or int8 / uint8 codes
        for the leaves ``_quantize_leaf`` picks) and step 0 (int32)."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        def zero_m(p):
            return (_q8(zeros(p), self.cfg.q_block)
                    if self._quantize_leaf(p) else zeros(p))

        def zero_v(p):
            return (_q8_log(zeros(p), self.cfg.q_block)
                    if self._quantize_leaf(p) else zeros(p))

        dev = next(t for _, t in leaves(params)).device
        return {"m": _map(zero_m, params), "v": _map(zero_v, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params, sharding=None):
        """One AdamW step: params and moments updated in place, returned
        as (params, {"m", "v", "step"}). ``grads`` is nested like
        ``params``. ``sharding`` (on a rank of a process mesh): (the
        rank's ``ParallelContext``, the state's spec tree as
        ``tree_shardings`` resolves ``moment_axes``, the params' global
        shapes); the trees then hold the rank's blocks."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = lr_schedule(cfg, step)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(cfg.b1, stepf)
        bc2 = 1 - torch.pow(cfg.b2, stepf)
        for path, p in leaves(params):
            g = _get(grads, path).to(torch.float32)
            m, v = _get(state["m"], path), _get(state["v"], path)
            cut = None if sharding is None else _cut_of(
                sharding, path, p, cfg.q_block) if _is_q(m) else None
            if cut is not None:
                mf, vf = _dq8_cut(m, cut), _dq8_log_cut(v, cut)
            else:
                mf = _dq8(m, cfg.q_block, p.shape) if _is_q(m) else m
                vf = _dq8_log(v, cfg.q_block, p.shape) if _is_q(v) else v
            mf = cfg.b1 * mf + (1 - cfg.b1) * g
            vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
            u = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
            if p.dim() >= 2:
                u = u + cfg.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
            if cut is not None:
                _assign(m, _q8_cut(mf, cut))
                _assign(v, _q8_log_cut(vf, cut))
                continue
            _assign(m, _q8(mf, cfg.q_block) if _is_q(m) else mf)
            _assign(v, _q8_log(vf, cfg.q_block) if _is_q(v) else vf)
        state["step"].copy_(step)
        return params, state


def _cut_of(sharding, path, p, block):
    """The ``_Cut`` of an int8 leaf whose shards cut its blocks, else None
    (blocks whole on each rank: the local codec is the global one)."""
    from ..parallel.sharding import _axes
    ctx, specs, shapes = sharding
    q_spec = _get(specs["opt"]["m"], path)["q"]
    s_spec = _get(specs["opt"]["m"], path)["s"]
    nd = p.dim()
    last = _axes(q_spec[nd - 1]) if len(q_spec) >= nd else ()
    s_last = _axes(s_spec[nd - 1]) if len(s_spec) >= nd else ()
    if not last or s_last == last:
        return None
    if s_last:
        raise ValueError(f"{'/'.join(path)}: moment scales sharded over "
                         f"{s_last}, codes over {last}")
    return _Cut(p.shape[-1], _get(shapes, path)[-1], block, ctx, last,
                p.device)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf (f32), summed leaf by leaf
    in sorted key order."""
    tot = None
    for _, t in leaves(tree):
        sq = torch.sum(t.to(torch.float32) ** 2)
        tot = sq if tot is None else tot + sq
    return torch.sqrt(tot)


def clip_by_global_norm(tree, max_norm):
    """(tree scaled by min(1, max_norm / norm), norm)."""
    n = global_norm(tree)
    factor = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return _map(lambda t: (t.to(torch.float32) * factor).to(t.dtype),
                tree), n
