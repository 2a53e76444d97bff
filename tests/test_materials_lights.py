"""Material table + light table semantics (Phong.cpp:23-42,
PointLight.h, DirectionalAreaLight.h)."""

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.config import PI
from cse168_raytracer.models.lights import (LIGHT_DIRECTIONAL_AREA,
                                            LIGHT_POINT, make_light_table,
                                            nee_sample)
from cse168_raytracer.models.materials import (MaterialBuilder,
                                               energy_clamp, is_diffuse,
                                               is_reflective,
                                               is_refractive)


def test_energy_clamp_matches_phong_ctor():
    # Phong(kd=1, ks=0.7, kt=0.3): kt = min(0.3, 1-0.7) = 0.3,
    # kd = min(1, 1-0.7-0.3) = 0 (Phong.cpp:23-31)
    kd, kt = energy_clamp(np.ones(3), np.full(3, 0.7), np.full(3, 0.3))
    np.testing.assert_allclose(kt, 0.3)
    np.testing.assert_allclose(kd, 0.0)
    # water: kd=1, ks=0, kt=1 -> kd = 0
    kd, kt = energy_clamp(np.ones(3), np.zeros(3), np.ones(3))
    np.testing.assert_allclose(kt, 1.0)
    np.testing.assert_allclose(kd, 0.0)


def test_material_flags():
    mb = MaterialBuilder()
    lambert = mb.phong(kd=(1, 1, 1))
    mirror = mb.phong(kd=(0, 0, 0), ks=(1, 1, 1))
    glass = mb.phong(kd=(0, 0, 0), kt=(1, 1, 1), ior=1.5)
    mat = mb.build()
    mids = jnp.arange(3)
    assert np.asarray(is_diffuse(mat, mids)).tolist() == [True, False, False]
    assert np.asarray(is_reflective(mat, mids)).tolist() == [False, True, False]
    assert np.asarray(is_refractive(mat, mids)).tolist() == [False, False, True]


def test_point_light_nee_falloff():
    lt = make_light_table([dict(kind=LIGHT_POINT, position=(0, 2, 0),
                                color=(1, 1, 1), wattage=100.0)])
    p = jnp.array([[0.0, 0.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    s = nee_sample(lt, 0, p, n, jax.random.key(0))
    # r^2 = 4, falloff = 1/(4 * 4pi^2) (Phong.cpp:140)
    np.testing.assert_allclose(float(s.falloff[0]),
                               1.0 / (4.0 * 4.0 * PI * PI), rtol=1e-6)
    np.testing.assert_allclose(float(s.dist[0]), 2.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s.l[0]), [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(float(s.n_dot_l[0]), 1.0, rtol=1e-6)


def test_directional_light_nee_beam():
    # beam straight down, radius 1 (DirectionalAreaLight.h:25-34,
    # Phong.cpp:122-136)
    lt = make_light_table([dict(kind=LIGHT_DIRECTIONAL_AREA,
                                position=(0, 5, 0), normal=(0, -1, 0),
                                color=(1, 1, 1), wattage=4.0, radius=1.0)])
    p = jnp.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]])  # in-beam, out-of-beam
    n = jnp.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    s = nee_sample(lt, 0, p, n, jax.random.key(0))
    assert bool(s.in_beam[0]) and not bool(s.in_beam[1])
    np.testing.assert_allclose(np.asarray(s.l), [[0, 1, 0], [0, 1, 0]],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(s.falloff), 1.0 / PI, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s.dist), 1.0, rtol=1e-6)
