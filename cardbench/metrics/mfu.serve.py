"""The whole step: model FLOPs of the positions the traced slice's
dispatches computed (projections, top-k experts only, attention over
each position's context, the unembedding of its logits rows) over the
slice's seconds at the card's bf16 peak (989.4 TFLOP/s)."""
from cardbench import readers


def read(rec):
    return readers.mfu(rec) if rec["kind"] == "serve" else None
