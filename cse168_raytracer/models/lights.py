"""Light table + batched sampling (replaces PointLight.h / SquareLight.h /
DirectionalAreaLight.h class hierarchy with a tagged SoA table).

Light types:
- LIGHT_POINT (PointLight.h:8-63): origin = position; photon direction
  uniform on the sphere; NEE falloff 1/(4 pi^2 r^2) (Phong.cpp:140).
- LIGHT_SQUARE (SquareLight.h): origin stratified on the rectangle,
  photon direction cosine-biased about the normal; shades like a point
  light at the sampled origin.
- LIGHT_DIRECTIONAL_AREA (DirectionalAreaLight.h): disc origin, photon
  direction = normal (parallel beam); NEE direction = -normal with
  in-beam disc test and constant falloff 1/pi (Phong.cpp:122-136).
  Only this type emits photons (Scene.cpp:368,430 dynamic_cast gate).

All sampling is branchless over the type tag (masked selects — a
wavefront shades against every light anyway).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.config import PI
from cse168_raytracer.core.sampling import (cosine_hemisphere,
                                            uniform_disc, uniform_sphere)
from cse168_raytracer.core.vecmath import onb, safe_normalize

LIGHT_POINT = 0
LIGHT_SQUARE = 1
LIGHT_DIRECTIONAL_AREA = 2


class LightTable(NamedTuple):
    kind: jax.Array      # (L,) i32
    position: jax.Array  # (L, 3)
    normal: jax.Array    # (L, 3) unit (square/directional)
    color: jax.Array     # (L, 3)
    wattage: jax.Array   # (L,)
    radius: jax.Array    # (L,) disc radius (directional-area)
    dims: jax.Array      # (L, 2) width/height (square)

    @property
    def num_lights(self) -> int:
        return self.kind.shape[0]


def make_light_table(lights: list[dict]) -> LightTable:
    """lights: list of dicts with keys kind/position/color/wattage and
    optional normal/radius/dims."""
    n = max(len(lights), 1)
    kind = np.zeros(n, np.int32)
    pos = np.zeros((n, 3), np.float32)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (n, 1))
    col = np.zeros((n, 3), np.float32)
    wat = np.zeros(n, np.float32)
    rad = np.ones(n, np.float32)
    dim = np.ones((n, 2), np.float32)
    for i, l in enumerate(lights):
        kind[i] = l["kind"]
        pos[i] = l["position"]
        col[i] = l.get("color", (1.0, 1.0, 1.0))
        wat[i] = l.get("wattage", 0.0)
        if "normal" in l:
            v = np.asarray(l["normal"], np.float64)
            nrm[i] = v / np.linalg.norm(v)
        rad[i] = l.get("radius", 1.0)
        dim[i] = l.get("dims", (1.0, 1.0))
    return LightTable(kind=jnp.asarray(kind), position=jnp.asarray(pos),
                      normal=jnp.asarray(nrm), color=jnp.asarray(col),
                      wattage=jnp.asarray(wat), radius=jnp.asarray(rad),
                      dims=jnp.asarray(dim))


def sample_origin(lt: LightTable, li: int, key: jax.Array, shape,
                  sample_idx: int = 0, total_samples: int = 1) -> jax.Array:
    """samplePhotonOrigin for light index `li`, batched to `shape`.

    Point: position (PointLight.h:48-51). Square: jittered sample in
    cell (sx, sy) of the sqrt(totalSamples)-sided stratification grid
    (SquareLight.h:23-39); with totalSamples=1 — the value the shipped
    reference uses, Phong.cpp:68-75 — this is one uniform sample over
    the whole rectangle. DirectionalArea: uniform disc of `radius` in
    the tangent frame (DirectionalAreaLight.h:19-23).
    """
    kind = lt.kind[li]
    pos = lt.position[li]
    nrm = lt.normal[li]
    t1, t2 = onb(nrm)
    k1, k2 = jax.random.split(key)
    # square (SquareLight.h:26-37): n x n cells, n = sqrt(totalSamples)
    # (the reference truncates side_length to int for the cell index but
    # keeps the float for du/dv; totalSamples is always a square in
    # practice — 1 or 49)
    side = float(np.sqrt(float(total_samples)))
    du_dv = lt.dims[li] / side
    sx = sample_idx % int(side)
    sy = sample_idx // int(side)
    cell = jnp.asarray([sx, sy], jnp.float32)
    uv = ((jax.random.uniform(k1, tuple(shape) + (2,)) + cell) * du_dv
          - 0.5 * lt.dims[li])
    sq = pos + uv[..., 0:1] * t1 + uv[..., 1:2] * t2
    # disc
    dxy = uniform_disc(k2, lt.radius[li], shape)
    dc = pos + dxy[..., 0:1] * t1 + dxy[..., 1:2] * t2
    pt = jnp.broadcast_to(pos, tuple(shape) + (3,))
    return jnp.where(kind == LIGHT_POINT, pt,
                     jnp.where(kind == LIGHT_SQUARE, sq, dc))


def sample_photon_direction(lt: LightTable, li: int, key: jax.Array,
                            shape) -> jax.Array:
    """samplePhotonDirection: point=uniform sphere (PointLight.h:28-31),
    square=cosine about normal (SquareLight.h:41-48), directional=normal
    (DirectionalAreaLight.h:31-34)."""
    kind = lt.kind[li]
    nrm = jnp.broadcast_to(lt.normal[li], tuple(shape) + (3,))
    sph = uniform_sphere(key, shape)
    cos_d, _ = cosine_hemisphere(key, nrm)
    return jnp.where(kind == LIGHT_POINT, sph,
                     jnp.where(kind == LIGHT_SQUARE, cos_d, nrm))


class NEESample(NamedTuple):
    """Per-shading-point NEE quantities for one light (Phong.cpp:78-156)."""
    l: jax.Array          # (N, 3) unit direction toward the light
    dist: jax.Array       # (N,) shadow-ray tMax (= |origin-P|, or 1 for
                          # directional lights where l = -normal is unit)
    falloff: jax.Array    # (N,) reference falloff term
    in_beam: jax.Array    # (N,) bool (directional beam test; True otherwise)
    n_dot_l: jax.Array    # (N,) using the directional rule when applicable


def nee_sample(lt: LightTable, li: int, p: jax.Array, n: jax.Array,
               key: jax.Array, sample_idx: int = 0,
               total_samples: int = 1) -> NEESample:
    """Reproduces the geometry part of the Phong::shade light loop.

    p: (N,3) shading points, n: (N,3) shading normals.
    sample_idx/total_samples: stratification cell for SquareLight
    multi-sample NEE (Phong.cpp:77-80).
    """
    shape = p.shape[:-1]
    origin = sample_origin(lt, li, key, shape, sample_idx, total_samples)
    kind = lt.kind[li]
    nrm = lt.normal[li]

    # generic (point/square) path: l = origin - P (Phong.cpp:81-88)
    l_vec = origin - p
    fall2 = jnp.sum(l_vec * l_vec, axis=-1)              # length2
    dist = jnp.sqrt(jnp.maximum(fall2, 1e-30))
    l_pt = l_vec / dist[..., None]
    fall_pt = 1.0 / (jnp.maximum(fall2, 1e-30) * 4.0 * PI * PI)  # Phong.cpp:140
    ndl_pt = jnp.sum(n * l_pt, axis=-1)

    # directional path (Phong.cpp:122-136): l = -normal (unit), dist = 1
    l_dir = jnp.broadcast_to(-nrm, p.shape)
    ndl_dir = jnp.sum(n * -nrm, axis=-1)
    # beam test: t = dot(normal, position - P) / -1; in-beam iff
    # |(P - t*normal) - position|^2 <= radius^2
    t_beam = jnp.sum(nrm * (lt.position[li] - p), axis=-1) / -1.0
    beam_vec = (p - t_beam[..., None] * nrm) - lt.position[li]
    in_beam = jnp.sum(beam_vec * beam_vec, axis=-1) <= lt.radius[li] ** 2
    fall_dir = jnp.full(shape, 1.0 / PI)

    is_dir = kind == LIGHT_DIRECTIONAL_AREA
    return NEESample(
        l=jnp.where(is_dir, l_dir, l_pt),
        dist=jnp.where(is_dir, jnp.ones_like(dist), dist),
        falloff=jnp.where(is_dir, fall_dir, fall_pt),
        in_beam=jnp.where(is_dir, in_beam, jnp.ones_like(in_beam)),
        n_dot_l=jnp.where(is_dir, ndl_dir, ndl_pt),
    )
