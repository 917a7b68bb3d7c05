"""Detector registry: the ported detectors by config NAME."""
from __future__ import annotations

from .detector3d_template import DatasetMeta, Detector3DTemplate
from .point_3dssd import Point3DSSD

__all__ = {
    "3DSSD": Point3DSSD,
    "Point3DSSD": Point3DSSD,
}
