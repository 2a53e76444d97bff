"""Scene pytree: the data-parallel replacement for the reference Scene
registry (Scene.h:14-69) — geometry pools + material/light tables +
environment, one differentiable pytree passed through jit.

Static (non-traced) structure lives in `SceneStatic` so jitted render
functions can specialize on it: which texture kinds exist, whether any
material has a bump map, light count, etc.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import numpy as np

from cse168_raytracer.models.geometry import (PlanePool, SpherePool,
                                              TrianglePack,
                                              empty_plane_pool,
                                              empty_sphere_pool,
                                              empty_triangle_pack)
from cse168_raytracer.models.lights import LightTable, make_light_table
from cse168_raytracer.models.materials import MaterialTable, UVW_KINDS
from cse168_raytracer.models.textures import (CellularTexture,
                                              Environment, ImageTexture,
                                              active_kinds, has_bump,
                                              make_environment)
from cse168_raytracer.utils import pytree


@pytree.dataclass
class Scene:
    """All traced scene data (differentiable leaves)."""
    tris: TrianglePack
    spheres: SpherePool
    planes: PlanePool
    materials: MaterialTable
    lights: LightTable
    env: Environment
    images: Tuple[ImageTexture, ...] = ()
    # Cellular point-set textures (CellularTexture2D, Texture.h:84-99)
    cellulars: Tuple[CellularTexture, ...] = ()
    # BVH/accelerator arrays are attached by ops/accel.py (may be None)
    accel: Optional[object] = None
    # Photon grids (global, caustic) attached by ops/photon.py (may be None)
    photons: Optional[object] = None
    # Bilinear patches (reference BLPatch API, implemented for real)
    blpatches: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Hashable static scene facts for jit specialization."""
    texture_kinds: Tuple[int, ...]
    any_bump: bool
    num_lights: int
    # Shadow-ray behavior needs to know whether refractive materials
    # exist at all (Phong.cpp:98-113's attenuation branch)
    any_refractive: bool
    any_reflective: bool


def make_scene(tris: Optional[TrianglePack] = None,
               spheres: Optional[SpherePool] = None,
               planes: Optional[PlanePool] = None,
               materials: Optional[MaterialTable] = None,
               lights: Optional[Sequence[dict]] = None,
               env: Optional[Environment] = None,
               images: Sequence[ImageTexture] = (),
               cellulars: Sequence[CellularTexture] = (),
               blpatches=None) -> tuple[Scene, SceneStatic]:
    if tris is None:
        tris = empty_triangle_pack()
    if spheres is None:
        spheres = empty_sphere_pool()
    if planes is None:
        planes = empty_plane_pool()
    if materials is None:
        from cse168_raytracer.models.materials import MaterialBuilder
        materials = MaterialBuilder().build()
    light_table = (lights if isinstance(lights, LightTable)
                   else make_light_table(list(lights or [])))
    if env is None:
        env = make_environment()
    scene = Scene(tris=tris, spheres=spheres, planes=planes,
                  materials=materials, lights=light_table, env=env,
                  images=tuple(images), cellulars=tuple(cellulars),
                  blpatches=blpatches)
    static = SceneStatic(
        texture_kinds=active_kinds(materials),
        any_bump=has_bump(materials),
        num_lights=int(light_table.num_lights),
        any_refractive=bool(np.any(np.asarray(materials.kt) > 0)),
        any_reflective=bool(np.any(np.asarray(materials.ks) > 0)),
    )
    return scene, static
