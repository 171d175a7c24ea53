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
        x, aux = inner(*args, **kw)
        seen.append((tuple(x.shape), kw["sm"].sp))
        return x, aux

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
