"""Assigned architecture config: whisper-large-v3 (see archs.py for the full table)."""
from .archs import WHISPER_LARGE_V3 as CONFIG  # noqa: F401
