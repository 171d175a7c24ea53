from .base import (SHAPES, LONG_CONTEXT_OK, ModelConfig, ShapeConfig,
                   cell_is_skipped, get_config, list_archs, smoke_config)
from . import archs  # populate registry

__all__ = ["SHAPES", "LONG_CONTEXT_OK", "ModelConfig", "ShapeConfig",
           "archs", "cell_is_skipped", "get_config", "list_archs",
           "smoke_config"]
