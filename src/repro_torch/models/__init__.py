from .attention import decode_attention, flash_attention
from .model import Model
from .transformer import (init_params, layer_plan, n_periods, param_axes,
                          param_defs, param_shapes)

__all__ = ["Model", "decode_attention", "flash_attention", "init_params",
           "layer_plan", "n_periods", "param_axes", "param_defs",
           "param_shapes"]
