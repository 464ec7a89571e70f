"""Model configurations of the port + registry."""
from .registry import ARCHS, get_config, smoke_config  # noqa: F401

__all__ = ["ARCHS", "get_config", "smoke_config"]
