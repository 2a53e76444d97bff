import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cse168_raytracer.core import vecmath as vm


def rand_dirs(key, n):
    v = jax.random.normal(key, (n, 3))
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def test_normalize_and_dot():
    v = jnp.array([[3.0, 4.0, 0.0]])
    n = vm.normalize(v)
    np.testing.assert_allclose(np.asarray(vm.length(n)), 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(vm.dot(v, v)), 25.0, rtol=1e-6)


def test_tangent_frame_orthogonal():
    key = jax.random.PRNGKey(0)
    n = rand_dirs(key, 128)
    t1, t2 = vm.onb(n)
    np.testing.assert_allclose(np.asarray(vm.dot(t1, n)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.dot(t2, n)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.dot(t1, t2)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.length(t1)), 1.0, atol=1e-5)


def test_tangent_frame_degenerate_axis():
    # normal == +z triggers the fallback branch (Utility.h:29)
    n = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    t1, t2 = vm.onb(n)
    assert np.all(np.isfinite(np.asarray(t1)))
    np.testing.assert_allclose(np.asarray(vm.dot(t1, n)), 0.0, atol=1e-6)


def test_reflect_mirror():
    d = vm.normalize(jnp.array([[1.0, -1.0, 0.0]]))
    n = jnp.array([[0.0, 1.0, 0.0]])
    r = vm.reflect(d, n)
    expect = vm.normalize(jnp.array([[1.0, 1.0, 0.0]]))
    np.testing.assert_allclose(np.asarray(r), np.asarray(expect), atol=1e-6)


def test_refract_snell():
    # straight-on ray passes through unchanged
    d = jnp.array([[0.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    ior = jnp.array([1.5])
    out, tir = vm.refract(d, n, ior)
    assert not bool(tir[0])
    np.testing.assert_allclose(np.asarray(out), np.asarray(d), atol=1e-6)

    # 45 degrees into glass: sin(theta_t) = sin(45)/1.5
    d45 = vm.normalize(jnp.array([[1.0, -1.0, 0.0]]))
    out, tir = vm.refract(d45, n, ior)
    sin_t = np.abs(np.asarray(out)[0, 0])
    np.testing.assert_allclose(sin_t, np.sin(np.pi / 4) / 1.5, atol=1e-5)


def test_refract_tir():
    # shallow ray exiting glass -> total internal reflection
    d = vm.normalize(jnp.array([[1.0, 0.05, 0.0]]))  # exiting (d.n > 0)
    n = jnp.array([[0.0, 1.0, 0.0]])
    ior = jnp.array([1.5])
    out, tir = vm.refract(d, n, ior)
    assert bool(tir[0])
    np.testing.assert_allclose(np.asarray(out), np.asarray(vm.reflect(d, n)),
                               atol=1e-6)


def test_fresnel_range_and_tir():
    key = jax.random.PRNGKey(1)
    d = rand_dirs(key, 256)
    n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (256, 3))
    ior = jnp.full((256,), 1.5)
    rs = vm.fresnel_rs(d, n, ior)
    assert np.all(np.asarray(rs) >= 0.0)
    assert np.all(np.asarray(rs) <= 1.0 + 1e-6)
    # normal incidence entering: reference formula gives
    # ((n1 - 1)/(n1 + 1))^2 with its missing-n2 quirk -> n1=1: 0? No:
    # entering, n1=1, n2=1.5: Rs = ((1*1 - 1)/(1*1 + 1))^2 = 0 (quirk!)
    d0 = jnp.array([[0.0, -1.0, 0.0]])
    n0 = jnp.array([[0.0, 1.0, 0.0]])
    rs0 = vm.fresnel_rs(d0, n0, jnp.array([1.5]))
    np.testing.assert_allclose(np.asarray(rs0), 0.0, atol=1e-6)


def test_fresnel_grazing_is_one():
    d = vm.normalize(jnp.array([[1.0, -1e-4, 0.0]]))
    n = jnp.array([[0.0, 1.0, 0.0]])
    rs = vm.fresnel_rs(d, n, jnp.array([1.5]))
    np.testing.assert_allclose(np.asarray(rs), 1.0, atol=1e-2)


def test_fresnel_differentiable():
    def f(ior):
        d = vm.normalize(jnp.array([1.0, -1.0, 0.0]))
        n = jnp.array([0.0, 1.0, 0.0])
        return vm.fresnel_rs(d[None], n[None], jnp.array([ior]))[0]

    g = jax.grad(f)(1.5)
    assert np.isfinite(float(g))
    # finite-difference check
    eps = 1e-3
    fd = (f(1.5 + eps) - f(1.5 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-2)
