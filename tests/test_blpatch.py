"""Bilinear patch intersection tests (the reference's BLPatch API is a
stub returning false, BLPatch.cpp:19-24; ours actually intersects)."""

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.models.geometry import make_blpatch_pool
from cse168_raytracer.ops.intersect import (PRIM_BLPATCH,
                                            intersect_blpatches)
from cse168_raytracer.ops.surface import _blpatch_surface


def _flat_patch():
    # unit square in the y=0 plane: S(u,v) = (u, 0, v)
    return make_blpatch_pool(p00=(0, 0, 0), p10=(1, 0, 0),
                             p01=(0, 0, 1), p11=(1, 0, 1),
                             material_ids=0)


def test_flat_patch_hit_and_uv():
    pool = _flat_patch()
    o = jnp.array([[0.25, 2.0, 0.75], [0.5, 1.0, 0.5], [2.0, 1.0, 2.0]])
    d = jnp.tile(jnp.array([0.0, -1.0, 0.0]), (3, 1))
    h = jax.jit(lambda o, d: intersect_blpatches(pool, o, d, 0.0, 1e12))(o, d)
    assert np.asarray(h.hit).tolist() == [True, True, False]
    np.testing.assert_allclose(np.asarray(h.t)[:2], [2.0, 1.0], rtol=1e-5)
    assert np.asarray(h.prim_type)[0] == PRIM_BLPATCH

    p, n, gn, uv, mid = _blpatch_surface(pool, o, d, h.t,
                                         jnp.zeros(3, jnp.int32))
    np.testing.assert_allclose(np.asarray(uv)[0], [0.25, 0.75], atol=1e-4)
    # normal = Su x Sv = (1,0,0)x(0,0,1) = (0,-1,0)
    nn = np.asarray(n)[0] / np.linalg.norm(np.asarray(n)[0])
    np.testing.assert_allclose(nn, [0, -1, 0], atol=1e-5)


def test_curved_patch_point_on_surface():
    # saddle: p11 lifted
    pool = make_blpatch_pool(p00=(0, 0, 0), p10=(1, 0, 0),
                             p01=(0, 0, 1), p11=(1, 1, 1),
                             material_ids=0)
    rng = np.random.RandomState(0)
    o = jnp.asarray(rng.uniform(0.1, 0.9, (32, 3)).astype(np.float32)
                    * np.array([1, 0, 1]) + np.array([0, 3.0, 0]))
    d = jnp.tile(jnp.array([0.0, -1.0, 0.0]), (32, 1))
    h = intersect_blpatches(pool, o, d, 0.0, 1e12)
    assert bool(jnp.all(h.hit))
    p, n, gn, uv, mid = _blpatch_surface(pool, o, d, h.t,
                                         jnp.zeros(32, jnp.int32))
    # hit point must satisfy the bilinear surface equation: y = u*v
    uv = np.asarray(uv)
    pp = np.asarray(p)
    np.testing.assert_allclose(pp[:, 1], uv[:, 0] * uv[:, 1], atol=1e-4)
    np.testing.assert_allclose(pp[:, 0], uv[:, 0], atol=1e-4)
    np.testing.assert_allclose(pp[:, 2], uv[:, 1], atol=1e-4)


def test_patch_in_scene_render():
    """End-to-end: a bilinear patch renders through the full pipeline."""
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.models.lights import LIGHT_POINT
    from cse168_raytracer.models.materials import MaterialBuilder
    from cse168_raytracer.models.scene import make_scene
    from cse168_raytracer.render.camera import make_camera
    from cse168_raytracer.render.integrator import render_hdr

    mb = MaterialBuilder()
    m = mb.phong(kd=(1, 1, 1))
    # u along +z, v along +x so the normal Su x Sv points up (+y)
    pool = make_blpatch_pool(p00=(-2, 0, -2), p10=(-2, 0, 2),
                             p01=(2, 0, -2), p11=(2, 1.5, 2),
                             material_ids=m)
    scene, static = make_scene(materials=mb.build(), blpatches=pool,
                               lights=[dict(kind=LIGHT_POINT,
                                            position=(0, 5, 0),
                                            color=(1, 1, 1),
                                            wattage=500.0)])
    cam = make_camera(eye=(0, 4, 6), look_at=(0, 0, 0), fov=45)
    cfg = RenderConfig(width=16, height=16, trace_depth=1)
    hdr, _ = jax.jit(render_hdr, static_argnames=("static", "cfg"))(
        scene, static, cam, cfg, jax.random.key(0))
    hdr = np.asarray(hdr)
    assert np.isfinite(hdr).all()
    assert hdr.max() > 0
