"""Assigned architecture config: arctic-480b (see archs.py for the full table)."""
from .archs import ARCTIC_480B as CONFIG  # noqa: F401
