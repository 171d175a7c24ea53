"""Kernels: kernel A's expert batch (``msb_experts_kernel``, which runs
every expert's rows at up to 128 a dispatch) against its roofline in the
traced slice's decode steps. Work: each forward's routed choices
through gate, up and down, and each expert that uniform routing gives a
token read once (``cost.experts``); device time: the kernels whose names
hold one of ``PATTERNS`` inside the decode steps' spans. The waves are
left out: past 128 rows an expert the batch runs on
``msb_matmul_tc_kernel``, whose launches are not told apart from the
dense projections' by name."""
from cardbench import cost, readers

PATTERNS = ("msb_experts_kernel",)


def read(rec):
    cfg = rec["config"]
    if not cfg.get("num_local_experts"):
        return None
    return readers.roofline(
        rec, PATTERNS, lambda ctx, lr, segs: [cost.experts(cfg, len(ctx))],
        kind="decode")
