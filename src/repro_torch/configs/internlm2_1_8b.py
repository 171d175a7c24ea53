"""Assigned architecture config: internlm2-1.8b (see archs.py for the full table)."""
from .archs import INTERNLM2_18B as CONFIG  # noqa: F401
