"""Functions the ranks of a test's process mesh run (``ProcessMesh.run``
sends a function by name, so they live in a module the worker processes
import: this one imports torch alone), and the collectives of a one-rank
``ParallelContext``."""
import torch

from repro_torch.models import transformer
from repro_torch.models.moe import moe_layer, moe_param_specs
from repro_torch.parallel import sharding as shd
from repro_torch.train.compression import psum_compressed


def moe_block(rctx, p, x, cfg):
    """The rank's blocks of the global MoE params ``p`` and of the tokens
    ``x`` (B, S, D) under ``P(dp_axes, model)``, through ``moe_layer``
    with the rank's context: (the rank's y block, aux)."""
    ctx = rctx.par
    specs = moe_param_specs(cfg, ctx)
    local = {k: shd.local_block(v, specs[k], ctx).contiguous()
             for k, v in p.items()}
    xs = shd.resolve_spec(("batch", "sp", None), tuple(x.shape), ctx)
    y, aux = moe_layer(local, shd.local_block(x, xs, ctx).contiguous(),
                       cfg, ctx)
    return y, aux


def compressed_row(rctx, g, axis):
    """``psum_compressed`` of row ``rank`` of ``g`` (zero residual) over
    ``axis``: (the mean, the new residual)."""
    ctx = rctx.par
    row = g[ctx.index(axis)]
    return psum_compressed(row, torch.zeros_like(row), axis, ctx=ctx)


def residual_shapes(rctx, model, key, batch):
    """The loss on the rank's blocks with every block's output shape
    recorded: [(shape of x after block)], and the rank's ``Spmd.sp``."""
    seen = []
    inner = transformer._block_spmd

    def record(*args, **kw):
        x, cache, aux = inner(*args, **kw)
        seen.append((tuple(x.shape), kw["sm"].sp))
        return x, cache, aux

    transformer._block_spmd = record
    try:
        with torch.no_grad():
            model.loss(rctx.states[key], batch, rctx.par)
    finally:
        transformer._block_spmd = inner
    return seen


def stage_tanh(w, x):
    """A pipeline stage's layers: tanh(x @ w)."""
    return torch.tanh(x @ w)


def test_one_rank_context_collectives_are_the_identity():
    """On a one-rank mesh every collective returns its input and touches
    no process group."""
    ctx = shd.ParallelContext(mesh=shd.MeshShape((1, 1), ("data", "model")),
                              dp_axes=("data",), coords=(0, 0), groups={})
    x = torch.arange(6.0).reshape(2, 3)
    assert shd.psum(x, ctx, "model") is x
    assert shd.all_gather(x, ctx, ("data",), 0) is x
    assert shd.all_to_all(x, ctx, "model", 0, 1) is x
    assert shd.ppermute(x, ctx, "model") is x
    assert shd.pvary(x, ctx, "model") is x


def block_shapes(rctx, key):
    """The shapes of the blocks a rank holds under ``key`` (a cache or
    pools placed on the mesh), by path."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            out[path] = tuple(tree.shape)
    walk(rctx.states[key], ())
    return out


def kv_seq_combine(rctx, q, k, v, pos, cur):
    """``decode_attention`` on the rank's block of a ring cut over every
    mesh axis (row-major), joined by the flash-decode combine."""
    from repro_torch.models.attention import decode_attention
    ctx = rctx.par
    axes = ctx.mesh.axis_names
    spec = (None, axes)
    kb = shd.local_block(k, spec, ctx)
    vb = shd.local_block(v, spec, ctx)
    pb = shd.local_block(pos, spec, ctx)
    return decode_attention(q, kb, vb, pb, cur, combine=(ctx, axes))


def launches(rctx, zero=False):
    """The rank's kernel launch counters, then zeroed when ``zero``."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.msb_matmul import ops as mm
    from repro_torch.kernels.paged_attention import ops as pa
    fns = {"msb_matmul": mm.msb_matmul, "msb_unembed": mm.msb_unembed,
           "paged_attention_decode": pa.paged_attention_decode,
           "flash_attention_fwd": fa.flash_attention_fwd}
    out = {name: fn.launches for name, fn in fns.items()}
    if zero:
        for fn in fns.values():
            fn.launches = 0
    return out


def head_dim_split(rctx, q, k, v, pos, cur, kw):
    """``decode_attention`` on the rank's slice of d of q, k and v (cut
    over every mesh axis, row-major), the partial scores summed over
    them (``dsum``), the rank's slice of the output gathered along d."""
    from repro_torch.models.attention import decode_attention
    ctx = rctx.par
    axes = ctx.mesh.axis_names
    spec = (None, None, None, axes)
    o = decode_attention(*(shd.local_block(t, spec, ctx)
                           for t in (q, k, v)), pos, cur,
                         dsum=(ctx, axes), **kw)
    return shd.raw_all_gather(ctx, o, axes, 3)
