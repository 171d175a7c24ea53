"""Synthetic token streams for training (port of ``repro.data``)."""
from .synthetic import MarkovStream, Prefetcher, TokenStream

__all__ = ["MarkovStream", "Prefetcher", "TokenStream"]
