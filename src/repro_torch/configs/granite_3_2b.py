"""Assigned architecture config: granite-3-2b (see archs.py for the full table)."""
from .archs import GRANITE3_2B as CONFIG  # noqa: F401
