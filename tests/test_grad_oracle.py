"""Finite-difference gradient oracle (the BASELINE.json acceptance
metric: pixel gradients allclose vs finite differences).

Protocol per SURVEY.md §7: the oracle uses the SAME fixed random
sequence and the same discrete decisions (hit selection, RR branches)
— only continuous parameters move. Central differences in float32 at
eps tuned per parameter magnitude; visibility gradients are out of
scope (discrete), so perturbations are small enough not to flip any
discrete choice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cse168_raytracer.config import RenderConfig
from cse168_raytracer.render.integrator import render_hdr
from cse168_raytracer.scenes import build


def central_diff(f, x0, eps):
    """Scalar-output central difference over every element of x0."""
    x0 = np.asarray(x0, np.float64)
    g = np.zeros_like(x0)
    it = np.nditer(x0, flags=["multi_index"])
    while not it.finished:
        i = it.multi_index
        xp = x0.copy(); xp[i] += eps
        xm = x0.copy(); xm[i] -= eps
        g[i] = (f(xp.astype(np.float32)) - f(xm.astype(np.float32))) / (2 * eps)
        it.iternext()
    return g


@pytest.fixture(scope="module")
def sphere_setup():
    cfg = RenderConfig(width=12, height=12, trace_depth=2)
    scene, static, cam, cfg = build("sphere", cfg)
    key = jax.random.key(0)
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))
    return scene, static, cam, cfg, key, render


def test_grad_wrt_kd_matches_fd(sphere_setup):
    scene, static, cam, cfg, key, render = sphere_setup

    def loss_np(kd):
        s = scene.replace(materials=scene.materials._replace(
            kd=jnp.asarray(kd)))
        hdr, _ = render(s, static, cam, cfg, key)
        return float(jnp.sum(hdr))

    def loss_jx(kd):
        s = scene.replace(materials=scene.materials._replace(kd=kd))
        hdr, _ = render(s, static, cam, cfg, key)
        return jnp.sum(hdr)

    kd0 = scene.materials.kd
    g = np.asarray(jax.jit(jax.grad(loss_jx))(kd0))
    g_fd = central_diff(loss_np, kd0, 1e-2)
    # kd enters quadratically (the reference kd^2 quirk) — fd at
    # kd=1 sees d(kd^2)=2kd; tolerance covers f32 render noise
    np.testing.assert_allclose(g, g_fd, rtol=5e-2, atol=1e-3)


def test_grad_wrt_light_wattage_matches_fd(sphere_setup):
    scene, static, cam, cfg, key, render = sphere_setup

    def loss_np(w):
        s = scene.replace(lights=scene.lights._replace(
            wattage=jnp.asarray(w)))
        hdr, _ = render(s, static, cam, cfg, key)
        return float(jnp.sum(hdr))

    def loss_jx(w):
        s = scene.replace(lights=scene.lights._replace(wattage=w))
        hdr, _ = render(s, static, cam, cfg, key)
        return jnp.sum(hdr)

    w0 = scene.lights.wattage
    g = np.asarray(jax.jit(jax.grad(loss_jx))(w0))
    g_fd = central_diff(loss_np, w0, 1.0)
    np.testing.assert_allclose(g, g_fd, rtol=2e-2, atol=1e-6)


def test_grad_wrt_light_position_matches_fd(sphere_setup):
    """Light position moves falloff + shading continuously (shadowing
    is discrete but the perturbation is too small to flip it)."""
    scene, static, cam, cfg, key, render = sphere_setup

    def loss_np(p):
        s = scene.replace(lights=scene.lights._replace(
            position=jnp.asarray(p)))
        hdr, _ = render(s, static, cam, cfg, key)
        return float(jnp.sum(hdr))

    def loss_jx(p):
        s = scene.replace(lights=scene.lights._replace(position=p))
        hdr, _ = render(s, static, cam, cfg, key)
        return jnp.sum(hdr)

    p0 = scene.lights.position
    g = np.asarray(jax.jit(jax.grad(loss_jx))(p0))
    g_fd = central_diff(loss_np, p0, 1e-2)
    np.testing.assert_allclose(g, g_fd, rtol=5e-2, atol=1e-4)


def test_grad_wrt_sphere_center_matches_fd_frozen_discrete(sphere_setup):
    """Geometry gradients under the SURVEY §7 oracle protocol: freeze
    all discrete decisions (hit winners, shadow visibility) at the base
    parameters, then differentiate only the continuous math. A naive FD
    on the full render does not converge for geometry parameters — each
    eps flips different silhouette/shadow pixels — which is exactly why
    the protocol fixes the discrete structure."""
    from cse168_raytracer.models.lights import nee_sample
    from cse168_raytracer.ops.intersect import closest_hit
    from cse168_raytracer.ops.surface import make_surface
    from cse168_raytracer.core.vecmath import safe_normalize
    from cse168_raytracer.render.camera import eye_rays

    scene, static, cam, cfg, key, _render = sphere_setup
    w = h = 12
    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    o, d = eye_rays(cam, xs.ravel(), ys.ravel(), w, h)

    # frozen discrete structure at the base parameters
    hit0 = closest_hit(scene.tris, scene.spheres, scene.planes, o, d)
    surf0 = make_surface(scene.tris, scene.spheres, scene.planes, o, d, hit0)
    s0 = nee_sample(scene.lights, 0, surf0.p, safe_normalize(surf0.n), key)
    sh0 = closest_hit(scene.tris, scene.spheres, scene.planes,
                      surf0.p + s0.l * 1e-4, s0.l, 0.0, s0.dist)
    visible0 = ~sh0.hit & hit0.hit

    def radiance(center):
        s = scene.replace(spheres=scene.spheres._replace(center=center))
        surf = make_surface(s.tris, s.spheres, s.planes, o, d, hit0)
        n = safe_normalize(surf.n)
        smp = nee_sample(s.lights, 0, surf.p, n, key)
        watt = s.lights.wattage[0]
        kd = s.materials.kd[surf.material_id]
        contrib = (jnp.maximum(0.0, smp.n_dot_l * smp.falloff * watt)[:, None]
                   * kd * kd)
        return jnp.sum(jnp.where(visible0[:, None], contrib, 0.0))

    c0 = scene.spheres.center
    g = np.asarray(jax.jit(jax.grad(radiance))(c0))
    f = jax.jit(radiance)
    g_fd = central_diff(lambda c: float(f(jnp.asarray(c))), c0, 1e-3)
    np.testing.assert_allclose(g, g_fd, rtol=2e-2, atol=1e-4)


def test_grad_env_bg_color(sphere_setup):
    """Miss rays hit the background: d(sum)/d(bg) = #miss-pixels."""
    scene, static, cam, cfg, key, render = sphere_setup

    def loss_jx(bg):
        s = scene.replace(env=scene.env._replace(bg_color=bg))
        hdr, _ = render(s, static, cam, cfg, key)
        return jnp.sum(hdr)

    g = np.asarray(jax.jit(jax.grad(loss_jx))(scene.env.bg_color))
    assert (g > 0).all()
    assert g[0] == g[1] == g[2]   # each channel counts the same misses


# ---------------------------------------------------------------------------
# BASELINE-scene coverage: cornell refraction (kt/ior), mesh geometry
# (floor translation), texture colors (checkerboard), and image
# environment texels — every differentiable leaf class exercised
# through the REAL render (render_hdr), not a hand-built pipeline.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell_setup():
    cfg = RenderConfig(width=12, height=12, trace_depth=3)
    scene, static, cam, cfg = build("cornell_proxy", cfg)
    key = jax.random.key(0)
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))
    return scene, static, cam, cfg, key, render


def test_grad_wrt_kt_through_refraction(cornell_setup):
    """d(image)/d(kt) of the glass material: flows through the Fresnel
    split weights (Scene.cpp:314-336)."""
    scene, static, cam, cfg, key, render = cornell_setup
    water = 4  # material index of the glass knot (registry order)

    def loss_jx(kt_row):
        kt = scene.materials.kt.at[water].set(kt_row)
        s = scene.replace(materials=scene.materials._replace(kt=kt))
        hdr, _ = render(s, static, cam, cfg, key)
        return jnp.sum(hdr)

    def loss_np(kt_row):
        return float(loss_jx(jnp.asarray(kt_row)))

    kt0 = scene.materials.kt[water] * 0.9   # off the clamp boundary
    g = np.asarray(jax.jit(jax.grad(loss_jx))(kt0))
    g_fd = central_diff(loss_np, np.asarray(kt0), 5e-3)
    np.testing.assert_allclose(g, g_fd, rtol=8e-2, atol=5e-3)


def test_grad_wrt_ior_through_refraction():
    """d(image)/d(ior): bends refracted rays and shifts Fresnel Rs
    (Ray.h:168-243). Perturbing ior MOVES child hits, so some pixels
    cross silhouettes and their finite difference measures a visibility
    jump the detached-selection gradient deliberately excludes (SURVEY
    protocol). The oracle therefore compares PER-PIXEL jvp vs FD and
    requires agreement on the stable majority.

    The scene is the refract_spheres IOR-sweep geometry over a SMOOTH
    constant-kd floor: with the reference's StoneTexture floor
    (Worley+Perlin) the radiance is so high-frequency in the hit point
    that FD at any usable eps measures secants across texture features
    instead of derivatives (measured: FD only converges to the jvp as
    eps -> 2e-5, where f32 render noise dominates)."""
    from cse168_raytracer.models.geometry import (make_plane_pool,
                                                  make_sphere_pool)
    from cse168_raytracer.models.lights import LIGHT_POINT
    from cse168_raytracer.models.materials import MaterialBuilder
    from cse168_raytracer.models.scene import make_scene
    from cse168_raytracer.scenes.registry import make_camera

    mb = MaterialBuilder()
    floor = mb.phong(kd=(0.5, 0.5, 0.5))
    centers, radii, mats = [], [], []
    for y in range(3):
        for x in range(3):
            centers.append((3 * (x - 1), 3 * y + 1.5, -9))
            radii.append(1.5)
            mats.append(mb.phong(kd=(0, 0, 0), kt=(1, 1, 1), shininess=10,
                                 ior=1.0 + (y * 3.0 + x * 2.0) / 20))
    # 10x the reference scene's wattages: the oracle thresholds on
    # |fd| > 0.05, and at the reference's 1/(4 pi^2 r^2) falloff the
    # 16x16 image tops out at 0.028 — too dim to select responders
    lights = [dict(kind=LIGHT_POINT, position=(-2, 3, -6), wattage=300.0,
                   color=(1, 1, 1)),
              dict(kind=LIGHT_POINT, position=(0, 20, 0), wattage=10000.0,
                   color=(1, 1, 1))]
    scene, static = make_scene(
        spheres=make_sphere_pool(centers, radii, mats),
        planes=make_plane_pool([(0, -0.5, 0)], [(0, 1, 0)], [floor]),
        materials=mb.build(), lights=lights)
    cam = make_camera(eye=(0, 4, 2), look_at=(0, 4, 1), fov=60,
                      bg_color=(1, 1, 1))
    cfg = RenderConfig(width=16, height=16, trace_depth=3)
    key = jax.random.key(0)
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))

    def image(dior):
        s = scene.replace(materials=scene.materials._replace(
            ior=scene.materials.ior + dior))
        hdr, _ = render(s, static, cam, cfg, key)
        return hdr

    _, tangent = jax.jvp(image, (jnp.float32(0.0),), (jnp.float32(1.0),))
    tangent = np.asarray(tangent)
    assert np.isfinite(tangent).all()
    eps = 5e-4
    fd = (np.asarray(image(jnp.float32(eps)))
          - np.asarray(image(jnp.float32(-eps)))) / (2 * eps)
    sel = np.abs(fd) > 0.05           # pixels that actually respond
    assert sel.sum() > 20
    rel = np.abs(tangent[sel] - fd[sel]) / np.maximum(np.abs(fd[sel]), 0.05)
    # the stable majority agrees; silhouette-crossing pixels may not
    frac_ok = float(np.mean(rel < 0.15))
    assert frac_ok > 0.7, (frac_ok, float(np.median(rel)))


def test_grad_wrt_mesh_translation(sphere_setup):
    """Geometry gradient through the real render: translate the floor
    triangle vertically; radiance moves through hit positions,
    shadow-ray origins and falloff (vertex-position gradient class)."""
    scene, static, cam, cfg, key, render = sphere_setup
    floor = np.asarray(scene.tris.material_id) >= 0   # all tris = floor
    mask = jnp.asarray(floor & np.asarray(scene.tris.valid))[:, None]

    def shifted(dy):
        up = jnp.array([0.0, 1.0, 0.0]) * dy
        tris = scene.tris._replace(v0=scene.tris.v0 + mask * up)
        return scene.replace(tris=tris)

    def loss_jx(dy):
        hdr, _ = render(shifted(dy), static, cam, cfg, key)
        return jnp.sum(hdr)

    def loss_np(v):
        return float(loss_jx(jnp.asarray(v, jnp.float32)))

    g = float(jax.jit(jax.grad(loss_jx))(jnp.float32(0.0)))
    assert abs(g) > 0
    # the sphere rests EXACTLY on the floor (tangency), so any eps that
    # straddles a silhouette/shadow flip measures a visibility jump
    # (measured: fd=1793 at eps=1e-3 vs 0.90 at 3e-5). Median over
    # three eps values rejects the interval that caught a flip.
    fds = [(loss_np(e) - loss_np(-e)) / (2 * e) for e in (1e-5, 2e-5, 4e-5)]
    g_fd = float(np.median(fds))
    np.testing.assert_allclose(g, g_fd, rtol=0.2, atol=1e-2)


def test_grad_wrt_checker_colors():
    """Texture-parameter gradients: the checkerboard's two colors on
    the test_sphere plane (TexturedPhong path, Texture.h:112-133)."""
    cfg = RenderConfig(width=12, height=12, trace_depth=2)
    scene, static, cam, cfg = build("test_sphere", cfg)
    key = jax.random.key(0)
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))

    def loss_jx(c1):
        mats = scene.materials._replace(
            kd=scene.materials.kd.at[1].set(c1))
        hdr, _ = render(scene.replace(materials=mats), static, cam,
                        cfg, key)
        return jnp.sum(hdr)

    def loss_np(v):
        return float(loss_jx(jnp.asarray(v, jnp.float32)))

    c0 = scene.materials.kd[1] * 0.8
    g = np.asarray(jax.jit(jax.grad(loss_jx))(c0))
    g_fd = central_diff(loss_np, np.asarray(c0), 1e-2)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(g, g_fd, rtol=8e-2, atol=1e-3)


def test_grad_wrt_env_texels():
    """Image-environment texel gradients (bilinear env_lookup,
    Scene.cpp:657-688): rays that miss pick up d(image)/d(texel)."""
    from cse168_raytracer.models.geometry import make_sphere_pool
    from cse168_raytracer.models.lights import LIGHT_POINT
    from cse168_raytracer.models.materials import MaterialBuilder
    from cse168_raytracer.models.scene import make_scene
    from cse168_raytracer.models.textures import (build_image_texture,
                                                  make_environment)
    from cse168_raytracer.scenes.registry import make_camera

    rng = np.random.default_rng(0)
    tex = build_image_texture(
        rng.uniform(0.1, 0.9, (4, 8, 3)).astype(np.float32), is_hdr=False)
    mb = MaterialBuilder()
    white = mb.phong(kd=(1, 1, 1))
    scene, static = make_scene(
        spheres=make_sphere_pool([(0, 0, -4)], [1.0], [white]),
        materials=mb.build(),
        lights=[dict(kind=LIGHT_POINT, position=(3, 3, 3), color=(1, 1, 1),
                     wattage=100.0)],
        env=make_environment(image=tex))
    cam = make_camera(eye=(0, 0, 2), look_at=(0, 0, -4), fov=70,
                      bg_color=(0, 0, 0))
    cfg = RenderConfig(width=12, height=12, trace_depth=2)
    key = jax.random.key(0)
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))
    img0 = scene.env.image.image

    def loss_jx(img):
        env = scene.env._replace(image=scene.env.image.replace(image=img))
        hdr, _ = render(scene.replace(env=env), static, cam, cfg, key)
        return jnp.sum(hdr)

    def loss_np(v):
        return float(loss_jx(jnp.asarray(v, jnp.float32)))

    g = np.asarray(jax.jit(jax.grad(loss_jx))(img0))
    assert np.abs(g).sum() > 0
    # full-texel FD over 96 entries is cheap at 12x12
    g_fd = central_diff(loss_np, np.asarray(img0), 1e-2)
    np.testing.assert_allclose(g, g_fd, rtol=8e-2, atol=2e-3)


def test_grad_photon_power():
    """d(image)/d(stored photon power) through the photon-map gather
    (PhotonMap.cpp:136-141 estimator; grid_irradiance is plain jnp and
    fully differentiable in the stored powers). The map itself is a
    constant w.r.t. light/material parameters — the build detaches at
    the host boundary (build_photon_maps docstring) — so the oracle
    perturbs the STORED powers, the exact surface BASELINE.json's
    differentiable indirect pass needs."""
    from cse168_raytracer.models.geometry import make_plane_pool
    from cse168_raytracer.models.lights import LIGHT_DIRECTIONAL_AREA
    from cse168_raytracer.models.materials import MaterialBuilder
    from cse168_raytracer.models.scene import make_scene
    from cse168_raytracer.ops.photon import build_photon_maps
    from cse168_raytracer.scenes.registry import make_camera

    mb = MaterialBuilder()
    white = mb.phong(kd=(0.8, 0.8, 0.8))
    planes = make_plane_pool([(0, 0, 0), (0, 4, 0)],
                             [(0, 1, 0), (0, -1, 0)], [white, white])
    lights = [dict(kind=LIGHT_DIRECTIONAL_AREA, position=(0, 3, 0),
                   normal=(0, -1, 0), radius=1.0,
                   color=(1, 1, 1), wattage=100.0)]
    scene, static = make_scene(planes=planes, materials=mb.build(),
                               lights=lights)
    cam = make_camera(eye=(0, 2, 6), look_at=(0, 1, 0), fov=60,
                      bg_color=(0, 0, 0))
    cfg = RenderConfig(width=8, height=8, trace_depth=1,
                       photons_per_light=1500,
                       caustic_photons_per_light=0)
    maps = build_photon_maps(scene, static, cfg, jax.random.key(1))
    assert maps is not None and maps.global_map is not None
    key = jax.random.key(0)
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))

    # scale the stored powers by a learnable per-channel gain: the
    # adjoint sums d(image)/d(power) against the stored powers, probing
    # every gather path at once
    def f(gain):
        g = maps.global_map
        m = maps.replace(global_map=g.replace(
            power=g.power * jnp.asarray(gain)[None, :]))
        hdr, _ = render(scene.replace(photons=m), static, cam, cfg, key)
        return jnp.sum(hdr)

    gain0 = np.ones(3, np.float32)
    g_ad = np.asarray(jax.grad(lambda g: f(g))(jnp.asarray(gain0)))
    g_fd = central_diff(lambda g: float(f(g)), gain0, 1e-2)
    assert g_ad.shape == (3,)
    assert np.all(np.abs(g_ad) > 0), "photon gather must carry gradient"
    np.testing.assert_allclose(g_ad, g_fd, rtol=2e-2, atol=1e-4)
