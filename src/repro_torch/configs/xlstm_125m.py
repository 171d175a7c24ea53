"""Assigned architecture config: xlstm-125m (see archs.py for the full table)."""
from .archs import XLSTM_125M as CONFIG  # noqa: F401
