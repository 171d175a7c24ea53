"""Functions the ranks of a test's tensor-parallel mesh run
(``TPMesh.run`` sends a function by name, so it lives in a module the
worker processes import: this one imports torch alone), and the
collectives of a one-rank ``TPShard``."""
import torch

from repro_torch.parallel import TPShard


def raise_on_rank_1(ctx):
    if ctx.tp.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return ctx.tp.psum(torch.ones(2))


def psum_ranks(ctx):
    return float(ctx.tp.psum(torch.tensor(float(ctx.tp.rank + 1))))


def card_collectives(ctx):
    """``psum`` and ``all_gather`` of f32 and bf16 tensors on the rank's
    card, each rank's input made from its rank; the results on the host."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(100 + ctx.tp.rank)
        x = torch.randn(3, 40, generator=g).to(ctx.device, dtype)
        s = ctx.tp.psum(x)
        a = ctx.tp.all_gather(x, dim=-1)
        assert s.device == x.device and a.device == x.device
        out[str(dtype)] = (x.cpu(), s.cpu(), a.cpu())
    return out


def test_single_rank_collectives_are_the_identity():
    """A one-rank ``TPShard`` (no group) returns its input: ``psum`` and
    ``all_gather`` touch no process group."""
    tp = TPShard(size=1)
    x = torch.arange(6.0).reshape(2, 3)
    assert tp.psum(x) is x and tp.all_gather(x, dim=0) is x
