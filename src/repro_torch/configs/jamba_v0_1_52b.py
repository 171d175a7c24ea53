"""Assigned architecture config: jamba-v0.1-52b (see archs.py for the full table)."""
from .archs import JAMBA_52B as CONFIG  # noqa: F401
