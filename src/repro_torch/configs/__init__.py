"""Architecture configs of the LM scaffold (shapes only; no weights are loaded)."""
from .base import ARCH_IDS, SHAPES, ArchConfig, get_config

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "get_config"]
