"""Offline dataset builders (host code, off every training path): TrackML
point clouds (`trackml.py`, pandas) and Delphes pileup events (`pileup.py`,
uproot); both import their library only when called."""

from .trackml import PointCloudBuilder, build_point_cloud, load_trackml_event

__all__ = ["PointCloudBuilder", "build_point_cloud", "load_trackml_event"]
