import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.core import sampling, vecmath as vm


def test_cosine_hemisphere_distribution():
    key = jax.random.PRNGKey(0)
    n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (200_000, 3))
    d, pdf = sampling.cosine_hemisphere(key, n)
    cos_t = np.asarray(vm.dot(d, n))
    assert np.all(cos_t >= -1e-6)
    # E[cos theta] = 2/3 for cosine-weighted hemisphere
    np.testing.assert_allclose(cos_t.mean(), 2.0 / 3.0, atol=5e-3)
    # pdf must equal cos/pi
    np.testing.assert_allclose(np.asarray(pdf), cos_t / np.pi, atol=1e-4)


def test_phong_lobe_concentrates():
    key = jax.random.PRNGKey(1)
    axis = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (100_000, 3))
    d_sharp, _ = sampling.phong_lobe(key, axis, jnp.full((100_000,), 1000.0))
    d_soft, _ = sampling.phong_lobe(key, axis, jnp.full((100_000,), 1.0))
    cs = np.asarray(vm.dot(d_sharp, axis))
    cl = np.asarray(vm.dot(d_soft, axis))
    assert cs.mean() > 0.99
    # E[cos] for pdf (s+1)/(2pi) cos^s is (s+1)/(s+2) = 2/3 at s=1
    np.testing.assert_allclose(cl.mean(), 2.0 / 3.0, atol=5e-3)


def test_uniform_sphere_moments():
    key = jax.random.PRNGKey(2)
    d = sampling.uniform_sphere(key, (200_000,))
    m = np.asarray(d).mean(axis=0)
    np.testing.assert_allclose(m, 0.0, atol=5e-3)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0,
                               atol=1e-5)
    # each component^2 has mean 1/3 on the sphere
    np.testing.assert_allclose((np.asarray(d) ** 2).mean(axis=0), 1 / 3,
                               atol=5e-3)


def test_uniform_disc_radius():
    key = jax.random.PRNGKey(3)
    p = sampling.uniform_disc(key, 2.0, (100_000,))
    r = np.linalg.norm(np.asarray(p), axis=-1)
    assert r.max() <= 2.0 + 1e-6
    # E[r] = 2/3 * R for uniform disc
    np.testing.assert_allclose(r.mean(), 4.0 / 3.0, atol=1e-2)


def test_uniform_hemisphere_halfspace():
    key = jax.random.PRNGKey(4)
    n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (50_000, 3))
    d = sampling.uniform_hemisphere(key, n)
    cos_t = np.asarray(vm.dot(d, n))
    assert np.all(cos_t >= -1e-6)
    # E[cos] = 1/2 for uniform hemisphere
    np.testing.assert_allclose(cos_t.mean(), 0.5, atol=5e-3)


def test_stratified_grid_covers():
    key = jax.random.PRNGKey(5)
    s = np.asarray(sampling.stratified_grid_jitter(key, 7))
    assert s.shape == (49, 2)
    assert s.min() >= 0 and s.max() < 1
    # each stratum occupied exactly once
    cells = (s * 7).astype(int)
    assert len({(int(a), int(b)) for a, b in cells}) == 49
