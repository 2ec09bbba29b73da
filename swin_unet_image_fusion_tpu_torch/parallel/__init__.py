"""Parallel serving paths of the port: tiled high-resolution fusion on one device."""

from .tiled import TiledFuser

__all__ = ["TiledFuser"]
