"""Training of the port (port of ``repro.train``): AdamW with f32 or
int8 moments, the train step and loop on one device or GSPMD-style on a
process mesh (``parallel=`` a ``ParallelContext``), checkpoints in the
reference's format, error-feedback gradient compression, and the
fault-tolerance helpers the loop and the serving supervisor use."""
from .optim import (AdamW, OptConfig, clip_by_global_norm, global_norm,
                    lr_schedule)
from .train_loop import init_state, make_train_step, state_axes, train_loop
from .checkpoint import Checkpointer
from .fault import PreemptionHandler, StragglerMonitor
from . import compression

__all__ = ["AdamW", "Checkpointer", "OptConfig", "PreemptionHandler",
           "StragglerMonitor", "clip_by_global_norm", "compression",
           "global_norm", "init_state", "lr_schedule", "make_train_step",
           "state_axes", "train_loop"]
