"""Carry parameters and intermediate state across from the JAX package.

The pipeline has no weights; what crosses over is the config, the
intermediate state of each stage and the SLAM state, given as numpy arrays
(for example ``np.asarray`` of a JAX result). The tests use these to feed
each stage of this package the reference's own inputs. Nothing here imports
JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.ops.cellstats import CellStats
from deplex_tpu_torch.ops.cylinder import CylinderSegments
from deplex_tpu_torch.ops.growing import PlaneSegments, RoundData
from deplex_tpu_torch.slam.ba import BAProblem
from deplex_tpu_torch.slam.frontend import MapState
from deplex_tpu_torch.slam.planes import PlaneObs
from deplex_tpu_torch.slam.pose_graph import PoseGraph

_BOOL_FIELDS = {"planar"}
_INT_FIELDS = {"round_map", "nr_rounds", "nr_planes", "nr_cylinders"}


def config_from_dict(values: Mapping) -> Config:
    """A Config from ``dataclasses.asdict`` of the reference's Config."""
    names = {f.name for f in dataclasses.fields(Config)}
    unknown = set(values) - names
    if unknown:
        raise KeyError(f"Unknown parameter name(s): {sorted(unknown)}")
    return Config(**dict(values))


def _tensor(name: str, value, device, add_batch_axis: bool) -> torch.Tensor:
    arr = np.asarray(value)
    if name == "nr_pts" and arr.ndim:
        # A batched reference carries the (shared) cell size once per frame.
        if not (arr == arr.reshape(-1)[0]).all():
            raise ValueError("nr_pts differs between frames")
        arr = arr.reshape(-1)[:1].reshape(())
    if name in _BOOL_FIELDS:
        arr = arr.astype(bool)
    elif name in _INT_FIELDS:
        arr = arr.astype(np.int32)
    else:
        arr = arr.astype(np.float32)
    t = torch.from_numpy(arr.copy(order="C")).to(device)
    if add_batch_axis and name != "nr_pts":
        t = t[None]
    return t


def _convert(cls, fields: Mapping, device, add_batch_axis: bool):
    missing = set(cls._fields) - set(fields)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{f: _tensor(f, fields[f], device, add_batch_axis) for f in cls._fields})


def cell_stats_from_numpy(fields: Mapping[str, np.ndarray], device="cpu", *,
                          add_batch_axis: bool = False) -> CellStats:
    """{field: array} of the reference's CellStats -> CellStats on `device`.
    add_batch_axis: the arrays are one frame's; give them a frame axis."""
    return _convert(CellStats, fields, device, add_batch_axis)


def round_data_from_numpy(fields: Mapping[str, np.ndarray], device="cpu", *,
                          add_batch_axis: bool = False) -> RoundData:
    """{field: array} of the reference's RoundData -> RoundData on `device`."""
    return _convert(RoundData, fields, device, add_batch_axis)


def cylinder_segments_from_numpy(fields: Mapping[str, np.ndarray], device="cpu", *,
                                 add_batch_axis: bool = False) -> CylinderSegments:
    """{field: array} of the reference's CylinderSegments -> CylinderSegments."""
    return _convert(CylinderSegments, fields, device, add_batch_axis)


def plane_segments_from_numpy(fields: Mapping[str, np.ndarray], device="cpu", *,
                              add_batch_axis: bool = False) -> PlaneSegments:
    """{field: array} of the reference's PlaneSegments -> PlaneSegments."""
    return _convert(PlaneSegments, fields, device, add_batch_axis)


# SLAM fields that are not float32: landmark and node indices, the map count.
_SLAM_DTYPES = {"obs_lm": torch.int64, "edge_a": torch.int64, "edge_b": torch.int64,
                "count": torch.int32}


def _slam_state(cls, fields: Mapping, device):
    """A SLAM NamedTuple from numpy fields; optional fields may be absent or
    None and stay None."""
    missing = set(cls._fields) - set(fields) - set(cls._field_defaults)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    out = {}
    for f in cls._fields:
        value = fields.get(f)
        out[f] = None if value is None else torch.tensor(
            np.asarray(value), dtype=_SLAM_DTYPES.get(f, torch.float32), device=device)
    return cls(**out)


def plane_obs_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> PlaneObs:
    """{field: array} of the reference's PlaneObs -> PlaneObs on `device`."""
    return _slam_state(PlaneObs, fields, device)


def map_state_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> MapState:
    """{field: array} of the reference's MapState -> MapState on `device`."""
    return _slam_state(MapState, fields, device)


def ba_problem_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> BAProblem:
    """{field: array or None} of the reference's BAProblem -> BAProblem."""
    return _slam_state(BAProblem, fields, device)


def pose_graph_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> PoseGraph:
    """{field: array or None} of the reference's PoseGraph -> PoseGraph."""
    return _slam_state(PoseGraph, fields, device)


def fields_of(named_tuple) -> dict:
    """{field: np.ndarray or None} of any NamedTuple of arrays (either
    package's)."""
    return {f: None if getattr(named_tuple, f) is None else np.asarray(getattr(named_tuple, f))
            for f in named_tuple._fields}
