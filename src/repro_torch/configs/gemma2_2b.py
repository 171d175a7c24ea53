"""Assigned architecture config: gemma2-2b (see archs.py for the full table)."""
from .archs import GEMMA2_2B as CONFIG  # noqa: F401
