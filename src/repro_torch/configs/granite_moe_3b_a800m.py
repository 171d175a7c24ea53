"""Assigned architecture config: granite-moe-3b-a800m (see archs.py for the full table)."""
from .archs import GRANITE_MOE_3B as CONFIG  # noqa: F401
