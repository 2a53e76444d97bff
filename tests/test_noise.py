"""Noise goldens generated from the reference implementation
(lib/src/Perlin.cpp, lib/src/Worley.cpp compiled with the intended
uint32 seed semantics) at 5 probe points."""

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.core import noise

PTS = np.array([
    [0.5, 0.5, 0.5],
    [1.3, -2.7, 0.9],
    [10.1, 5.5, -3.3],
    [0.05, 0.02, 0.9],
    [-7.7, 3.14, 2.71],
], dtype=np.float32)

PERLIN_GOLDEN = np.array(
    [-0.25, -0.0144420713, 0.545241833, 0.0563295484, -0.426904708],
    dtype=np.float32)

WORLEY3_GOLDEN = np.array([
    (1.3486011, 1.40005767),
    (0.661819398, 1.10294831),
    (0.594230413, 1.27512646),
    (1.44486821, 1.48781931),
    (1.35758972, 1.77739942),
], dtype=np.float32)

WORLEY2_GOLDEN = np.array([
    (0.179905578, 0.393455774),
    (0.279281467, 1.10222554),
    (0.70514667, 1.39998543),
    (0.478781432, 0.491107315),
    (0.461813211, 0.755485475),
], dtype=np.float32)


def test_perlin_matches_reference():
    p = jnp.asarray(PTS)
    got = np.asarray(noise.perlin(p[:, 0], p[:, 1], p[:, 2]))
    np.testing.assert_allclose(got, PERLIN_GOLDEN, atol=2e-6)


def test_worley3_matches_reference():
    f, delta, ids = noise.worley3(jnp.asarray(PTS), max_order=2)
    np.testing.assert_allclose(np.asarray(f), WORLEY3_GOLDEN, rtol=2e-5)


def test_worley2_matches_reference():
    f, delta, ids = noise.worley2(jnp.asarray(PTS[:, :2]), max_order=2)
    np.testing.assert_allclose(np.asarray(f), WORLEY2_GOLDEN, rtol=2e-5)


def test_worley_delta_consistent():
    f, delta, _ = noise.worley3(jnp.asarray(PTS), max_order=2)
    # |delta| must equal F (delta is the vector to the feature point)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(delta), axis=-1),
                               np.asarray(f), rtol=2e-5)


def test_perlin_differentiable():
    g = jax.grad(lambda x: noise.perlin(x, jnp.float32(0.3), jnp.float32(0.7)))(
        jnp.float32(0.21))
    eps = 1e-3
    fd = (noise.perlin(jnp.float32(0.21 + eps), 0.3, 0.7)
          - noise.perlin(jnp.float32(0.21 - eps), 0.3, 0.7)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-2)


def test_turbulence_finite():
    key = jax.random.PRNGKey(0)
    p = jax.random.uniform(key, (64, 3), minval=-10, maxval=10)
    t = np.asarray(noise.perlin_turbulence(p, octaves=4))
    assert np.all(np.isfinite(t))
    assert np.all(t >= 0)
