"""Algorithm configuration for the PyTorch plane extractor.

The same frozen dataclass as ``deplex_tpu.config.Config``: the 16 tunables of
the reference deplex library with its defaults and INI key names, plus the
static bounds (``max_planes``, ``max_region_growing_rounds``) that fix the
shapes of the plane table and the rounds table, and the cylinder fields.
The backend switches (``use_pallas_*``) are kept so that a config converts
field for field between the two packages; this package does not read them.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Mapping, Union


@dataclasses.dataclass(frozen=True)
class Config:
    """Plane-extraction parameters (field names follow the reference struct,
    INI keys follow the reference parser, camelCase)."""

    # Cell (patch) side length, unit: pixels.
    patch_size: int = 10
    # Seed selection: bins per spherical coordinate in the normals histogram.
    histogram_bins_per_coord: int = 20
    # cos(angle) threshold for merging two regions.
    min_cos_angle_merge: float = 0.90
    # Distance between two regions threshold, unit: mm (squared-compare).
    max_merge_dist: float = 500.0
    # Minimum number of cells in the dominant histogram bin to keep growing.
    min_region_growing_candidate_size: int = 5
    # Minimum number of activated cells for a region to be considered.
    min_region_growing_cells_activated: int = 4
    # Planarity score (lambda_max / sum(lambda)) threshold for a region.
    min_region_planarity_score: float = 0.55
    # Depth-adaptive planarity threshold: (coeff * z^2 + margin)^2 >= MSE.
    depth_sigma_coeff: float = 1.425e-6
    depth_sigma_margin: float = 10.0
    # A cell needs >= cell_points_total*3 / min_pts_per_cell valid points.
    min_pts_per_cell: int = 3
    # Depth jump (mm) between adjacent pixels counted as a discontinuity.
    depth_discontinuity_threshold: float = 160.0
    # Maximum allowed discontinuity count along the mid row / mid column.
    max_number_depth_discontinuity: int = 1
    # RANSAC refinement stage (stage 6, ops/ransac.py).
    ransac_refinement: bool = False
    ransac_max_iterations: int = 1000
    ransac_threshold: float = 1.0
    ransac_inliers_ratio: float = 0.9
    # --- static bounds (no reference analog) ---
    # Plane-segment slots tracked by the pipeline.
    max_planes: int = 64
    # Upper bound on region-growing rounds.
    max_region_growing_rounds: int = 256
    # Backend switches of the JAX package; kept for field parity, unused here.
    use_pallas_growing: bool | None = None
    use_pallas_cellstats: bool | None = None
    # --- cylinder extraction (ops/cylinder.py; extract_primitives forces it on) ---
    cylinder_extraction: bool = False
    min_cylinder_cells: int = 4
    max_cylinders: int = 16
    cylinder_rmse_max: float = 20.0
    cylinder_rmse_rel: float = 0.05

    def __post_init__(self):
        if self.patch_size < 0:
            raise ValueError(
                f"Error! Invalid config parameter: patchSize({self.patch_size})."
                " patchSize has to be positive."
            )

    @classmethod
    def from_ini(cls, config_path: str) -> "Config":
        """Parse the reference INI dialect: '#' comments, '[section]' headers
        ignored, 'key=value' lines, unknown keys warn on stderr."""
        try:
            with open(config_path, "r") as f:
                lines = f.read().splitlines()
        except OSError as e:
            raise RuntimeError(f"Couldn't open ini file: {config_path}") from e
        values = {}
        for line in lines:
            if not line or line[0] == "#":
                continue
            eq = line.find("=")
            if eq <= 0:
                continue
            key, value = line[:eq], line[eq + 1:]
            field = _INI_KEYS.get(key)
            if field is None:
                print(f"Unknown parameter name: {key}", file=sys.stderr)
                continue
            values[field] = _FIELD_TYPES[field](value)
        return cls(**values)

    @classmethod
    def from_dict(cls, param_map: Mapping[str, Union[str, int, float]]) -> "Config":
        """Construct from a key->value map. Accepts both INI-style camelCase
        keys and dataclass field names."""
        values = {}
        for key, value in param_map.items():
            field = _INI_KEYS.get(key, key)
            if field not in _FIELD_TYPES:
                raise KeyError(f"Unknown parameter name: {key}")
            values[field] = _FIELD_TYPES[field](value)
        return cls(**values)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


# INI key -> dataclass field (the reference parser's key set plus extras).
_INI_KEYS = {
    "patchSize": "patch_size",
    "histogramBinsPerCoord": "histogram_bins_per_coord",
    "minCosAngleForMerge": "min_cos_angle_merge",
    "maxMergeDist": "max_merge_dist",
    "minRegionGrowingCandidateSize": "min_region_growing_candidate_size",
    "minRegionGrowingCellsActivated": "min_region_growing_cells_activated",
    "minRegionPlanarityScore": "min_region_planarity_score",
    "depthSigmaCoeff": "depth_sigma_coeff",
    "depthSigmaMargin": "depth_sigma_margin",
    "minPtsPerCell": "min_pts_per_cell",
    "depthDiscontinuityThreshold": "depth_discontinuity_threshold",
    "maxNumberDepthDiscontinuity": "max_number_depth_discontinuity",
    "ransacRefinement": "ransac_refinement",
    "ransacMaxIterations": "ransac_max_iterations",
    "ransacThreshold": "ransac_threshold",
    "ransacInliersRatio": "ransac_inliers_ratio",
    "maxPlanes": "max_planes",
    "maxRegionGrowingRounds": "max_region_growing_rounds",
    "usePallasGrowing": "use_pallas_growing",
    "usePallasCellstats": "use_pallas_cellstats",
    "cylinderExtraction": "cylinder_extraction",
    "minCylinderCells": "min_cylinder_cells",
    "maxCylinders": "max_cylinders",
    "cylinderRmseMax": "cylinder_rmse_max",
    "cylinderRmseRel": "cylinder_rmse_rel",
}


def _parse_bool(v):
    return bool(int(v))


def _parse_optional_bool(v):
    if v is None or v == "":
        return None
    return bool(int(v))


# dataclasses keeps annotations as strings under `from __future__ import annotations`.
_FIELD_TYPES = {
    f.name: {"int": int, "float": float, "bool": _parse_bool,
             "bool | None": _parse_optional_bool}[f.type]
    for f in dataclasses.fields(Config)
}
