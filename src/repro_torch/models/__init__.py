from .model import Model
from .transformer import init_params, layer_plan, n_periods, param_defs

__all__ = ["Model", "init_params", "layer_plan", "n_periods", "param_defs"]
