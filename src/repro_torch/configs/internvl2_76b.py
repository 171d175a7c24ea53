"""Assigned architecture config: internvl2-76b (see archs.py for the full table)."""
from .archs import INTERNVL2_76B as CONFIG  # noqa: F401
