"""Assigned architecture config: qwen1.5-0.5b (see archs.py for the full table)."""
from .archs import QWEN15_05B as CONFIG  # noqa: F401
