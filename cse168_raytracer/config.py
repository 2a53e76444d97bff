"""Runtime render configuration.

Replaces the reference's compile-time constants and -D feature flags
(Miro.h:8-20, Makedefs:14-15) with one dataclass. Every reference
constant keeps its value and a citation so parity can be audited.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Global numeric constants (Miro.h:8-20).
MIRO_TMAX = 1e12            # Miro.h:8
EPSILON = 1e-4              # Miro.h:9
PI = 3.1415926535897932384626433832795028841972  # Miro.h:10


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All knobs that were compile-time in the reference.

    Reference: Miro.h:13-20 for the numeric defaults; feature booleans
    correspond to -DPATH_TRACING / -DDOF / -DDISABLE_SHADOWS /
    -DSTATS / -DVISUALIZE_PHOTON_MAP build flags (Makedefs:14-15).
    """

    width: int = 512
    height: int = 512

    # Integrator
    trace_depth: int = 10            # TRACE_DEPTH, Miro.h:13
    trace_depth_photons: int = 5     # TRACE_DEPTH_PHOTONS, Miro.h:14
    trace_samples: int = 1000        # TRACE_SAMPLES, Miro.h:15 (spp in PT/DOF mode)
    path_tracing: bool = False       # -DPATH_TRACING
    disable_shadows: bool = False    # -DDISABLE_SHADOWS (Phong.cpp:91)
    light_samples: int = 1           # NEE samples/light (Phong.cpp:65-75:
                                     # the reference ships samples=1 with
                                     # a commented-out 49 for SquareLight
                                     # soft shadows; >1 enables the
                                     # stratified grid, SquareLight.h:23-39)

    # Photon mapping
    photon_max_dist: float = 1e10    # PHOTON_MAX_DIST, Miro.h:16
    photon_samples: int = 500        # PHOTON_SAMPLES (kNN count), Miro.h:17
    photons_per_light: int = 200000  # PhotonsPerLightSource, Scene.h:67
    # cell size multiplier of the sparse-region fallback grid level
    # (ops/photon.build_grid coarse_factor); 0 disables the level
    photon_coarse_factor: float = 8.0
    # emission-batch cap per map build (the reference's while loop is
    # uncapped, Scene.cpp:370 — caustic store rates ~0.3% need ~1000
    # batches to reach the 200k target; 200 keeps interactive builds
    # bounded and golden runs raise it)
    photon_max_batches: int = 200
    caustic_photons_per_light: int = 200000  # Scene.h:68
    photon_grid_radius: float = 0.25  # fixed-radius gather radius (fixed-
                                      # shape design choice; replaces the
                                      # unbounded kNN, SURVEY.md #21)
    photon_grid_max_per_cell: int = 64

    # Depth of field
    dof: bool = False                # -DDOF
    dof_aperture: float = 0.20       # DOF_APERTURE, Miro.h:18
    dof_focus_plane: float = 15.3    # DOF_FOCUS_PLANE, Miro.h:19

    # Wavefront sizing (no reference equivalent)
    ray_block: int = 2048            # rays per device-side wavefront block
    whitted_pool_factor: int = 4     # max specular-split ray pool = N_pixels * factor
    row_tile: int = 0                # rows per wavefront chunk (0 = whole
                                     # frame). Bounds wavefront memory for
                                     # final-scene-size renders (2048x1365
                                     # @ 1000spp, writeup/A3/index.html:44);
                                     # must be a multiple of 8 (the pixel-
                                     # block ray order)

    # Numerics
    dtype: str = "float32"
    seed: int = 0

    # Stats collection (-DSTATS, Stats.h)
    collect_stats: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
