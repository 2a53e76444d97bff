"""Texture parity tests (Texture.h/.cpp formulas)."""

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.config import PI
from cse168_raytracer.models.textures import (ImageTexture,
                                              build_image_texture,
                                              checker_lookup, env_lookup,
                                              generate_noise,
                                              image_lookup,
                                              make_environment)


def test_checker_parity():
    """CheckerBoardTexture::lookup2D (Texture.h:125-132) oracle."""
    rng = np.random.RandomState(0)
    u = rng.uniform(-5, 5, 256).astype(np.float32)
    v = rng.uniform(-5, 5, 256).astype(np.float32)
    scale = 3.0

    def oracle(u, v):
        su, sv = abs(scale * u), abs(scale * v)
        if u < 0:
            su += scale
        if v < 0:
            sv += scale
        return 1.0 if (int(su) + int(sv)) % 2 == 0 else 0.0

    want = np.array([oracle(a, b) for a, b in zip(u, v)])
    c1 = jnp.ones((256, 3))
    c2 = jnp.zeros((256, 3))
    got = jax.jit(lambda u, v: checker_lookup(u, v, scale, c1, c2))(
        jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(got)[:, 0], want)


def test_generate_noise_range_and_zero_mean():
    x = jnp.linspace(0.0, 10.0, 512)
    n = jax.jit(lambda x: generate_noise(x, x * 0.7, jnp.zeros_like(x),
                                         1.0, 2.0, 0.5, 5))(x)
    n = np.asarray(n)
    assert np.abs(n).max() <= 1.0 + 1e-5      # normalized by sum(amp)
    assert np.abs(n.mean()) < 0.2


def _tiny_image():
    rng = np.random.RandomState(1)
    return rng.uniform(0, 1, (48, 96, 3)).astype(np.float32)


def test_image_bilinear_oracle():
    """LoadedTexture::lookup bilinear parity (Texture.cpp:161-185)."""
    px = _tiny_image()
    tex = build_image_texture(px, is_hdr=False)
    rng = np.random.RandomState(2)
    us = rng.uniform(0, 0.99, 64).astype(np.float32)
    vs = rng.uniform(0, 0.99, 64).astype(np.float32)

    h, w = px.shape[:2]

    def oracle(u, v):
        pxr, pyr = w * u, h * v
        x1 = int(pxr); x2 = (x1 + 1) % w; x1 %= w
        xe = pxr - x1
        y1 = int(pyr); y2 = (y1 + 1) % h; y1 %= h
        ye = pyr - y1
        return ((px[y1, x1] * (1 - xe) + px[y1, x2] * xe) * (1 - ye)
                + (px[y2, x1] * (1 - xe) + px[y2, x2] * xe) * ye)

    want = np.stack([oracle(u, v) for u, v in zip(us, vs)])
    got = jax.jit(lambda u, v: image_lookup(tex, u, v))(
        jnp.asarray(us), jnp.asarray(vs))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)


def test_hdr_tonemap_applied_after_interp():
    px = np.full((8, 8, 3), 4.0, np.float32)
    tex = build_image_texture(px, is_hdr=True)
    got = image_lookup(tex, jnp.array([0.5]), jnp.array([0.5]))
    # tonemap: min(1.5*(v/max)^0.5, 1) = min(1.5*1, 1) = 1 (Texture.cpp:27)
    np.testing.assert_allclose(np.asarray(got), 1.0, rtol=1e-6)


def test_env_lookup_directions():
    """Scene::getEnvironmentMap mapping (Scene.cpp:657-688)."""
    # gradient image: u encodes red, v encodes green
    h, w = 64, 128
    uu, vv = np.meshgrid(np.arange(w) / w, np.arange(h) / h)
    img = np.stack([uu, vv, np.zeros_like(uu)], axis=-1).astype(np.float32)
    tex = build_image_texture(img, is_hdr=False)
    env = make_environment(image=tex)

    d = jnp.asarray([[0.0, 0.0, 1.0],    # +z: phi=atan2(0,1)+pi=pi -> u=0.5
                     [0.0, 1.0, 0.0]])   # up: theta=pi/2 -> v=1
    out = jax.jit(lambda d: env_lookup(env, d, jnp.zeros(2, bool)))(d)
    out = np.asarray(out)
    assert abs(out[0, 0] - 0.5) < 0.02       # red ~ u = 0.5
    assert out[1, 1] > 0.9 or out[1, 1] < 0.1  # v at pole wraps (reflection)


def test_env_bg_color_when_empty():
    env = make_environment(bg_color=(0.25, 0.5, 0.75))
    out = env_lookup(env, jnp.asarray([[0.0, 0.0, 1.0]]), jnp.zeros(1, bool))
    np.testing.assert_allclose(np.asarray(out)[0], [0.25, 0.5, 0.75])


def test_cellular_distances_vs_bruteforce():
    """CellularTexture2D::getClosestDistances (Texture.cpp:252-354):
    grid-bucketed 3x3 gather must match a brute-force toroidal kNN."""
    from cse168_raytracer.models.textures import (build_cellular_texture,
                                                  cellular_distances)
    rng = np.random.RandomState(7)
    pts = rng.random_sample((60, 2)).astype(np.float32)
    tex = build_cellular_texture(60, grid_width=8, grid_height=8,
                                 points=pts)
    u = rng.random_sample(128).astype(np.float32)
    v = rng.random_sample(128).astype(np.float32)

    du = np.abs(u[:, None] - pts[None, :, 0])
    dv = np.abs(v[:, None] - pts[None, :, 1])
    du = np.minimum(du, 1.0 - du)
    dv = np.minimum(dv, 1.0 - dv)
    want = np.sort(np.sqrt(du * du + dv * dv), axis=1)[:, :4]

    got = jax.jit(lambda u, v: cellular_distances(tex, u, v, 4))(
        jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-6)


def test_cellular_lookup_formula_and_grad():
    """lookup2D combine exp(-(f1-f0+f2-0.8*f3)*100) (Texture.cpp:238-245)
    and gradient flow into the point positions."""
    from cse168_raytracer.models.textures import (build_cellular_texture,
                                                  cellular_distances,
                                                  cellular_lookup)
    tex = build_cellular_texture(40, grid_width=6, grid_height=6, seed=3)
    u = jnp.linspace(0.05, 0.95, 32)
    v = jnp.linspace(0.12, 0.88, 32)
    f = cellular_distances(tex, u, v, 4)
    want = np.exp(-(np.asarray(f[:, 1] - f[:, 0] + f[:, 2]
                               - 0.8 * f[:, 3])) * 100.0)
    got = np.asarray(cellular_lookup(tex, u, v))
    np.testing.assert_allclose(got[:, 0], want, rtol=1e-5)
    np.testing.assert_allclose(got[:, 1], got[:, 0])

    def loss(points):
        t = tex.replace(points=points)
        return jnp.sum(cellular_lookup(t, u, v))

    g = jax.grad(loss)(tex.points)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0.0
