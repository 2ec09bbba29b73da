"""Parallel paths of the port: the process group (``mesh``; the data-parallel step is
``train.py::make_train_step(cfg, group)``), tiled high-resolution fusion on one device or over
ranks (``tiled``) and exact spatial fusion with the rows split over ranks (``spatial``)."""

from .spatial import SpatialFuser
from .tiled import TiledFuser

__all__ = ["SpatialFuser", "TiledFuser"]
