"""Material parameter table (SoA; learnable leaves).

Replaces the reference's Material/Phong/Lambert/TexturedPhong virtual
hierarchy (Material.h, Phong.h/.cpp, Lambert.h, Texture.h:302-319) with
one table of per-material parameters indexed by material_id. All float
leaves are differentiable — gradients flow from pixels into kd/ks/kt/
shininess/ior.

Semantics parity:
- Energy-conservation clamps from the Phong ctor (Phong.cpp:23-31):
  kt := clip(kt, 0, 1-ks); kd := clip(kd, 0, 1-ks-kt). Applied in
  `energy_clamp` (used at table build AND differentiable at runtime if
  raw parameters are optimized).
- Flags (Material.h:32-34, Phong.cpp:39-42): reflective = any(ks>0),
  refractive = any(kt>0), diffuse = any(kd>0) — computed on the fly.
- The reference's plain-Phong quirk: Phong::diffuse2D returns m_diffuse
  and Phong::shade multiplies by m_diffuse AGAIN (Phong.cpp:146), so an
  untextured material contributes kd^2 to direct lighting; TexturedPhong
  sets m_diffuse=1 (Texture.cpp:513-514) so textured materials
  contribute tex*kd_clamped. We reproduce this exactly: `texture_kind=0`
  (constant) materials use kd as their "texture color".
- Shininess: the reference uses `infinity` for perfect mirrors; we store
  a large sentinel (SHININESS_INF) and compare against it for the
  "skip specular highlight" test (Phong.cpp:149).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cse168_raytracer.core.fastgather import take_rows
import numpy as np

SHININESS_INF = 1.0e30  # stand-in for the reference's `infinity` shininess

# texture_kind codes (see models/textures.py for evaluation)
TEX_CONSTANT = 0       # use kd as diffuse color (plain Phong)
TEX_CHECKER = 1        # CheckerBoardTexture (Texture.h:112-133)
TEX_STONE = 2          # StoneTexture (Texture.cpp:358-440)
TEX_CLOUD = 3          # CloudTexture (Texture.h:135-169)  [3D lookup]
TEX_PETAL = 4          # PetalTexture (Texture.cpp:447-505) [3D lookup]
TEX_STEM = 5           # StemTexture (Texture.h:184-213)
TEX_LEAF = 6           # LeafTexture (Texture.h:216-251)   [3D lookup]
TEX_FLOWER_CENTER = 7  # FlowerCenterTexture (Texture.h:253-277) [3D]
TEX_IMAGE = 8          # LoadedTexture (Texture.cpp:30-185)
TEX_CELLULAR = 9       # CellularTexture2D (Texture.h:84-99); image_id
                       # indexes Scene.cellulars

# which kinds do 3D (world-position) lookups — GetLookupCoordinates()==UVW
UVW_KINDS = (TEX_CLOUD, TEX_PETAL, TEX_LEAF, TEX_FLOWER_CENTER)

N_TEX_PARAMS = 12      # per-material procedural texture parameter slots


class MaterialTable(NamedTuple):
    """All scene materials as arrays of shape (M, ...)."""
    kd: jax.Array          # (M, 3) clamped diffuse
    ks: jax.Array          # (M, 3) specular/reflection
    kt: jax.Array          # (M, 3) transmission/refraction
    shininess: jax.Array   # (M,)
    ior: jax.Array         # (M,) refraction index
    texture_kind: jax.Array    # (M,) i32
    texture_params: jax.Array  # (M, N_TEX_PARAMS) f32 (kind-specific)
    texture_color2: jax.Array  # (M, 3) secondary color (checker color2 etc.)
    image_id: jax.Array        # (M,) i32 index into the image atlas, -1 none

    @property
    def num_materials(self) -> int:
        return self.kd.shape[0]


def energy_clamp(kd, ks, kt):
    """Phong ctor energy balance (Phong.cpp:23-31), differentiable."""
    kt = jnp.clip(kt, 0.0, jnp.maximum(1.0 - ks, 0.0))
    kd = jnp.clip(kd, 0.0, jnp.maximum(1.0 - ks - kt, 0.0))
    return kd, kt


def is_reflective(mat: MaterialTable, mid: jax.Array) -> jax.Array:
    return jnp.any(take_rows(mat.ks, mid) > 0.0, axis=-1)


def is_refractive(mat: MaterialTable, mid: jax.Array) -> jax.Array:
    return jnp.any(take_rows(mat.kt, mid) > 0.0, axis=-1)


def is_diffuse(mat: MaterialTable, mid: jax.Array) -> jax.Array:
    return jnp.any(take_rows(mat.kd, mid) > 0.0, axis=-1)


class MaterialBuilder:
    """Host-side accumulation of materials; produces a MaterialTable.

    Mirrors scene-construction code like `new Phong(kd, ks, kt, s, ior)`
    (assignment2.cpp:417-435) but returns integer material ids.
    """

    def __init__(self):
        self._rows = []

    def phong(self, kd=(1.0, 1.0, 1.0), ks=(0.0, 0.0, 0.0),
              kt=(0.0, 0.0, 0.0), shininess=1.0, ior=1.0) -> int:
        """Plain Phong (Lambert == Phong with defaults, Lambert.h:9)."""
        return self._add(kd, ks, kt, shininess, ior, TEX_CONSTANT,
                         np.zeros(N_TEX_PARAMS), (0, 0, 0), -1)

    def textured(self, kind: int, params, ks=(0.0, 0.0, 0.0),
                 kt=(0.0, 0.0, 0.0), shininess=1.0, ior=1.0,
                 color1=(1.0, 1.0, 1.0), color2=(0.0, 0.0, 0.0),
                 image_id: int = -1) -> int:
        """TexturedPhong: kd = 1 (Texture.cpp:513-514)."""
        p = np.zeros(N_TEX_PARAMS, np.float32)
        params = np.asarray(params, np.float32).ravel()
        p[:params.shape[0]] = params
        return self._add(color1 if kind == TEX_CHECKER else (1.0, 1.0, 1.0),
                         ks, kt, shininess, ior, kind, p, color2, image_id)

    def _add(self, kd, ks, kt, shininess, ior, kind, params, color2,
             image_id) -> int:
        if shininess == float("inf"):
            shininess = SHININESS_INF
        self._rows.append((np.asarray(kd, np.float32),
                           np.asarray(ks, np.float32),
                           np.asarray(kt, np.float32),
                           np.float32(shininess), np.float32(ior),
                           np.int32(kind), np.asarray(params, np.float32),
                           np.asarray(color2, np.float32),
                           np.int32(image_id)))
        return len(self._rows) - 1

    def build(self) -> MaterialTable:
        if not self._rows:
            self.phong()
        kd = np.stack([r[0] for r in self._rows])
        ks = np.stack([r[1] for r in self._rows])
        kt = np.stack([r[2] for r in self._rows])
        kd_c, kt_c = energy_clamp(kd, ks, kt)
        return MaterialTable(
            kd=jnp.asarray(np.asarray(kd_c, np.float32)),
            ks=jnp.asarray(ks),
            kt=jnp.asarray(np.asarray(kt_c, np.float32)),
            shininess=jnp.asarray(np.stack([r[3] for r in self._rows])),
            ior=jnp.asarray(np.stack([r[4] for r in self._rows])),
            texture_kind=jnp.asarray(np.stack([r[5] for r in self._rows])),
            texture_params=jnp.asarray(np.stack([r[6] for r in self._rows])),
            texture_color2=jnp.asarray(np.stack([r[7] for r in self._rows])),
            image_id=jnp.asarray(np.stack([r[8] for r in self._rows])),
        )
