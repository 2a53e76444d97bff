"""End-to-end render tests: accel parity, tiny-image smoke renders,
tonemap behavior, camera geometry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cse168_raytracer.config import RenderConfig
from cse168_raytracer.ops.accel import accel_closest_hit, attach_accel
from cse168_raytracer.ops.intersect import closest_hit
from cse168_raytracer.render.camera import eye_rays, make_camera
from cse168_raytracer.render.integrator import render_hdr
from cse168_raytracer.render.tonemap import sigmoid_tonemap
from cse168_raytracer.scenes import build


@pytest.fixture(scope="module")
def knot():
    return build("knot", RenderConfig(width=32, height=32))


def test_camera_center_ray_points_at_lookat():
    cam = make_camera(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45)
    # center of the image plane = view direction
    o, d = eye_rays(cam, jnp.array([15]), jnp.array([15]), 32, 32)
    want = np.asarray([0, -3, -6]) / np.linalg.norm([0, -3, -6])
    assert np.allclose(np.asarray(d[0]), want, atol=0.1)
    assert np.allclose(np.asarray(o[0]), [0, 3, 6])


def test_accel_matches_brute_force(knot):
    scene, static, cam, cfg = knot
    scene_a = attach_accel(scene)
    ys, xs = jnp.meshgrid(jnp.arange(32), jnp.arange(32), indexing="ij")
    o, d = eye_rays(cam, xs.ravel(), ys.ravel(), 32, 32)
    hb = jax.jit(lambda o, d: closest_hit(
        scene.tris, scene.spheres, scene.planes, o, d))(o, d)
    ha = jax.jit(lambda o, d: accel_closest_hit(
        scene_a.accel, scene_a.tris, scene_a.spheres, scene_a.planes,
        o, d))(o, d)
    assert bool(jnp.all(hb.hit == ha.hit))
    m = np.asarray(hb.hit)
    np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(ha.t)[m],
                               rtol=1e-5, atol=1e-5)


def test_render_sphere_smoke():
    cfg = RenderConfig(width=24, height=24, trace_depth=3)
    scene, static, cam, cfg = build("sphere", cfg)
    hdr, stats = jax.jit(render_hdr, static_argnames=("static", "cfg"))(
        scene, static, cam, cfg, jax.random.key(0))
    hdr = np.asarray(hdr)
    assert hdr.shape == (24, 24, 3)
    assert np.isfinite(hdr).all()
    assert hdr.max() > 0          # something is lit
    assert int(stats.primary_rays) == 24 * 24


def test_render_deterministic_without_sampling():
    cfg = RenderConfig(width=16, height=16, trace_depth=2)
    scene, static, cam, cfg = build("sphere", cfg)
    f = jax.jit(render_hdr, static_argnames=("static", "cfg"))
    a, _ = f(scene, static, cam, cfg, jax.random.key(0))
    b, _ = f(scene, static, cam, cfg, jax.random.key(0))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_cornell_refraction_spawns_secondaries():
    cfg = RenderConfig(width=16, height=16, trace_depth=4)
    scene, static, cam, cfg = build("cornell_proxy", cfg)
    scene = attach_accel(scene)
    hdr, stats = jax.jit(render_hdr, static_argnames=("static", "cfg"))(
        scene, static, cam, cfg, jax.random.key(0))
    assert int(stats.secondary_rays) > 0    # the glass knot refracts
    hdr = np.asarray(hdr)
    # red wall tints the left, green the right (cornell box materials)
    assert hdr.max() > 0.1
    assert np.isfinite(hdr).all()


def test_tonemap_nan_scrub_and_sigmoid():
    hdr = jnp.array([[[0.5, jnp.nan, 2.0]]])
    out = np.asarray(sigmoid_tonemap(hdr))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[0, 0, 0], 1 / (1 + np.exp(-0.0)),
                               rtol=1e-6)  # sigmoid(6*0.5-3)=sigmoid(0)
    # NaN replaced with max intensity (2.0) then tonemapped
    np.testing.assert_allclose(out[0, 0, 1], 1 / (1 + np.exp(-9.0)),
                               rtol=1e-6)


def test_path_tracing_mode_runs():
    cfg = RenderConfig(width=8, height=8, trace_depth=2, trace_samples=2,
                       path_tracing=True)
    scene, static, cam, cfg = build("sphere", cfg)
    hdr, stats = jax.jit(render_hdr, static_argnames=("static", "cfg"))(
        scene, static, cam, cfg, jax.random.key(0))
    assert np.isfinite(np.asarray(hdr)).all()
    assert int(stats.primary_rays) == 8 * 8 * 2


def test_gradients_flow_to_materials():
    """Pixel gradients w.r.t. the material kd table are finite and
    nonzero (the BASELINE differentiability requirement)."""
    cfg = RenderConfig(width=8, height=8, trace_depth=1)
    scene, static, cam, cfg = build("sphere", cfg)

    def loss(kd):
        s = scene.replace(materials=scene.materials._replace(kd=kd))
        hdr, _ = render_hdr(s, static, cam, cfg, jax.random.key(0))
        return jnp.sum(hdr)

    g = jax.jit(jax.grad(loss))(scene.materials.kd)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0


def test_row_tiled_render_matches_untiled():
    """cfg.row_tile chunks the wavefront into row bands (bounded memory
    for the 2048x1365 final-scene config); the Whitted render is
    deterministic, so the tiled image must match the untiled one."""
    import numpy as np
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.render.integrator import render_hdr
    from cse168_raytracer.scenes import build

    cfg = RenderConfig(width=32, height=32, trace_depth=3)
    scene, static, cam, cfg = build("knot", cfg)
    key = jax.random.key(0)
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))
    full, st_full = render(scene, static, cam, cfg, key)
    tiled, st_tiled = render(scene, static, cam,
                             cfg.replace(row_tile=8), key)
    np.testing.assert_allclose(np.asarray(full), np.asarray(tiled),
                               rtol=1e-5, atol=1e-6)
    assert int(st_full.shadow_rays) == int(st_tiled.shadow_rays)
