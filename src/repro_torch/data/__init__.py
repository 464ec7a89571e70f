"""Data sources of the port (a copy of repro.data): the synthetic motif
stream, byte-level corpus windows and a background prefetcher."""
from .pipeline import (  # noqa: F401
    ByteCorpus, DataConfig, Prefetcher, SyntheticLM,
)

__all__ = ["ByteCorpus", "DataConfig", "Prefetcher", "SyntheticLM"]
