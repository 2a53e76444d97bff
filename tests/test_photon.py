"""Photon mapping tests: emission gates, RR semantics, grid gather."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cse168_raytracer.config import PI, RenderConfig
from cse168_raytracer.models.geometry import (make_plane_pool,
                                              make_sphere_pool)
from cse168_raytracer.models.lights import (LIGHT_DIRECTIONAL_AREA,
                                            LIGHT_POINT)
from cse168_raytracer.models.materials import MaterialBuilder
from cse168_raytracer.models.scene import make_scene
from cse168_raytracer.ops.photon import (build_grid, build_photon_maps,
                                         grid_irradiance,
                                         trace_photon_batch)


@pytest.fixture(scope="module")
def caustic_scene():
    """Glass sphere over a diffuse floor under a directional beam."""
    mb = MaterialBuilder()
    floor = mb.phong(kd=(0.8, 0.8, 0.8))
    glass = mb.phong(kd=(0, 0, 0), kt=(1, 1, 1), ior=1.5)
    spheres = make_sphere_pool([(0, 1, 0)], [1.0], [glass])
    planes = make_plane_pool([(0, 0, 0)], [(0, 1, 0)], [floor])
    lights = [dict(kind=LIGHT_DIRECTIONAL_AREA, position=(0, 8, 0),
                   normal=(0, -1, 0), color=(1, 1, 1), wattage=10.0,
                   radius=3.0)]
    return make_scene(spheres=spheres, planes=planes,
                      materials=mb.build(), lights=lights)


def test_grid_gather_oracle():
    """Fixed-radius gather equals a brute-force numpy sum."""
    rng = np.random.RandomState(0)
    pos = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    pw = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    dirs = np.tile(np.array([0, -1, 0], np.float32), (500, 1))
    r = 0.5
    # coarse_factor=None: this oracle pins the FIXED-RADIUS machinery
    # (with only 500 photons total the k-NN search finds < knn inside r
    # and would otherwise fall back to the coarse level — covered by
    # test_sparse_region_falls_back_to_coarse_level)
    grid = build_grid(pos, pw, dirs, r, max_per_cell=64,
                      coarse_factor=None)

    q = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    n = np.tile(np.array([0, 1, 0], np.float32), (16, 1))
    got = np.asarray(jax.jit(lambda q, n: grid_irradiance(grid, q, n))(
        jnp.asarray(q), jnp.asarray(n)))

    for i in range(16):
        d2 = ((pos - q[i]) ** 2).sum(-1)
        accept = (d2 < r * r)  # dirs oppose n everywhere
        want = pw[accept].sum(0) / (np.pi * r * r)
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-5)


def test_sparse_region_falls_back_to_coarse_level():
    """Sparse-region parity with the reference's UNBOUNDED k-NN search
    (PHOTON_MAX_DIST=1e10, Miro.h:16; PhotonMap.cpp:63-81): a query
    point with NO photons inside the grid radius must still see a
    cluster 2.5 radii away through the coarse fallback level. The
    bounded single-level gather returned exactly zero here (the r04
    verdict's sparse-region gap)."""
    rng = np.random.RandomState(1)
    r = 0.5
    # 600 photons clustered in a ball of radius 0.3 centered 1.25 away
    center = np.array([1.25, 0.0, 0.0], np.float32)
    pos = (center + rng.uniform(-0.3, 0.3, (600, 3))).astype(np.float32)
    pw = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    dirs = np.tile(np.array([0, -1, 0], np.float32), (600, 1))
    grid = build_grid(pos, pw, dirs, r, max_per_cell=64,
                      coarse_factor=8.0)
    assert grid.knn == 500

    q = np.zeros((1, 3), np.float32)
    n = np.tile(np.array([0, 1, 0], np.float32), (1, 1))
    got = np.asarray(jax.jit(lambda q, n: grid_irradiance(grid, q, n))(
        jnp.asarray(q), jnp.asarray(n)))[0]

    # brute-force replication of the coarse level's estimate: 12-step
    # bisection of the k-NN disc on r'^2 from (8r)^2, then
    # sum(within)/(pi r'^2)
    d2 = ((pos - q[0]) ** 2).sum(-1)
    lo, hi = 0.0, (8 * r) ** 2
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        if (d2 < mid).sum() >= 500:
            hi = mid
        else:
            lo = mid
    want = pw[d2 < hi].sum(0) / (np.pi * hi)
    assert got.sum() > 0.0             # the old bounded gather: exactly 0
    np.testing.assert_allclose(got, want, rtol=0.05)


def test_global_photons_die_on_first_bounce_specular(caustic_scene):
    """Scene.cpp:612-628: global-map photons that hit a specular
    surface on the FIRST bounce terminate; straight-down photons here
    either hit the glass sphere (die for global) or the diffuse floor
    (first diffuse bounce is not stored, depth>1 only)."""
    scene, static = caustic_scene
    out = jax.jit(trace_photon_batch,
                  static_argnames=("static", "light_i", "n_emit", "caustic",
                                   "depth_limit", "path_tracing"))(
        scene, static=static, light_i=0, n_emit=512, caustic=False,
        depth_limit=5, path_tracing=False, key=jax.random.key(0))
    mask = np.asarray(out.mask)
    assert mask[0].sum() == 0          # depth 1 never stores
    assert mask.sum() > 0              # later diffuse bounces store


def test_caustic_photons_need_specular_first_bounce(caustic_scene):
    scene, static = caustic_scene
    out = jax.jit(trace_photon_batch,
                  static_argnames=("static", "light_i", "n_emit", "caustic",
                                   "depth_limit", "path_tracing"))(
        scene, static=static, light_i=0, n_emit=512, caustic=True,
        depth_limit=5, path_tracing=False, key=jax.random.key(0))
    mask = np.asarray(out.mask)
    pos = np.asarray(out.pos)
    stored = pos.reshape(-1, 3)[mask.reshape(-1)]
    assert stored.shape[0] > 0
    # every stored caustic photon refracted through the sphere first ->
    # lands on the floor inside the sphere's footprint-ish region
    assert np.abs(stored[:, [0, 2]]).max() < 3.0
    assert np.abs(stored[:, 1]).max() < 1e-3   # on the floor plane


def test_point_lights_do_not_emit():
    mb = MaterialBuilder()
    floor = mb.phong(kd=(0.9, 0.9, 0.9))
    planes = make_plane_pool([(0, 0, 0)], [(0, 1, 0)], [floor])
    lights = [dict(kind=LIGHT_POINT, position=(0, 5, 0),
                   color=(1, 1, 1), wattage=100.0)]
    scene, static = make_scene(planes=planes, materials=mb.build(),
                               lights=lights)
    cfg = RenderConfig(photons_per_light=100, caustic_photons_per_light=100)
    maps = build_photon_maps(scene, static, cfg, jax.random.key(0),
                             path_tracing=False)
    assert maps is None   # dynamic_cast gate (Scene.cpp:368)


def test_caustic_focus(caustic_scene):
    """The glass sphere focuses the beam: irradiance under the sphere
    must dominate everywhere else (the physics smoke test)."""
    scene, static = caustic_scene
    cfg = RenderConfig(photons_per_light=0, caustic_photons_per_light=2000)
    maps = build_photon_maps(scene, static, cfg, jax.random.key(1),
                             path_tracing=False)
    assert maps.global_map is None and maps.caustic_map is not None
    p = jnp.array([[0.0, 0.0, 0.0], [2.5, 0.0, 2.5]])
    n = jnp.array([[0.0, 1.0, 0.0]] * 2)
    irr = np.asarray(jax.jit(
        lambda p, n: grid_irradiance(maps.caustic_map, p, n))(p, n))
    assert irr[0, 0] > 10 * (irr[1, 0] + 1e-6)


def test_overflow_cells_preserve_energy():
    """Dense cells must not silently lose photon power: build_grid folds
    overflow power into the kept photons (the reference's kd-tree keeps
    every photon, PhotonMap.cpp:252-259, so energy conservation is the
    parity requirement)."""
    import numpy as np
    from cse168_raytracer.ops.photon import build_grid, grid_irradiance
    rng = np.random.default_rng(3)
    # a tight blob: everything lands in one or two cells
    n = 400
    pos = rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    power = np.abs(rng.normal(1.0, 0.2, (n, 3))).astype(np.float32)
    dirs = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (n, 1))
    r = 1.0
    # knn past the photon count pins the FIXED-radius estimator (the
    # adaptive k-NN shrink is exercised by the 500-NN test below)
    grid = build_grid(pos, power, dirs, radius=r, max_per_cell=16,
                      knn=1 << 30)
    # total power in the grid must equal the input exactly
    np.testing.assert_allclose(np.asarray(grid.power).sum(0), power.sum(0),
                               rtol=1e-5)
    # gather at the blob center sees ALL the energy (everything within r)
    import jax.numpy as jnp
    est = grid_irradiance(grid, jnp.zeros((1, 3)),
                          jnp.array([[0.0, 1.0, 0.0]]))
    expected = power.sum(0) / (np.pi * r * r)
    np.testing.assert_allclose(np.asarray(est)[0], expected, rtol=1e-4)


def test_clustered_gather_matches_bruteforce():
    """grid_irradiance vs an exact fixed-radius brute-force oracle on a
    CLUSTERED distribution (the case where the per-cell cap used to
    bind)."""
    import numpy as np
    import jax.numpy as jnp
    from cse168_raytracer.ops.photon import build_grid, grid_irradiance
    rng = np.random.default_rng(4)
    blobs = rng.uniform(-2, 2, (6, 3))
    pos = np.concatenate([b + rng.normal(0, 0.08, (700, 3))
                          for b in blobs]).astype(np.float32)
    n = pos.shape[0]
    power = np.full((n, 3), 1.0 / n, np.float32)
    dirs = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (n, 1))
    r = 0.35
    grid = build_grid(pos, power, dirs, radius=r, max_per_cell=64,
                      knn=1 << 30)   # fixed-radius mode (see above)
    q = blobs[:4].astype(np.float32)
    nrm = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (4, 1))
    est = np.asarray(grid_irradiance(grid, jnp.asarray(q), jnp.asarray(nrm)))
    # oracle: exact sum of photons within r (all face the +y normal)
    for i in range(4):
        d2 = ((pos - q[i]) ** 2).sum(1)
        exact = power[d2 < r * r].sum(0) / (np.pi * r * r)
        # cap-merge relocates energy within a cell; the blob scale
        # (0.08) is well under r so nearly all energy stays inside r
        np.testing.assert_allclose(est[i], exact, rtol=0.1)


def _two_plane_photon_scene():
    """Floor + ceiling + a directional area light between them: photons
    bounce floor->ceiling (and back), so the GLOBAL map stores
    indirect photons on both planes."""
    from cse168_raytracer.models.geometry import make_plane_pool
    from cse168_raytracer.models.lights import LIGHT_DIRECTIONAL_AREA
    from cse168_raytracer.models.materials import MaterialBuilder
    from cse168_raytracer.models.scene import make_scene
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
    return scene, static, cam


def test_photon_maps_brighten_render():
    """End-to-end: attaching photon maps must add irradiance on diffuse
    surfaces (Scene.cpp:286-299 adds the estimate to the direct
    term)."""
    import jax
    import numpy as np
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.ops.photon import build_photon_maps
    from cse168_raytracer.render.integrator import render_hdr
    scene, static, cam = _two_plane_photon_scene()
    cfg = RenderConfig(width=32, height=32, trace_depth=2,
                       photons_per_light=2000,
                       caustic_photons_per_light=0)
    maps = build_photon_maps(scene, static, cfg, jax.random.key(1))
    assert maps is not None and maps.global_map is not None
    assert int(maps.global_map.n_valid) > 100
    base, _ = jax.jit(lambda s: render_hdr(s, static, cam, cfg,
                                           jax.random.key(0)))(scene)
    lit, _ = jax.jit(lambda s: render_hdr(s, static, cam, cfg,
                                          jax.random.key(0)))(
        scene.replace(photons=maps))
    base, lit = np.asarray(base), np.asarray(lit)
    assert (lit >= base - 1e-6).all()
    assert lit.sum() > base.sum() * 1.01   # visibly brighter somewhere


def test_sharded_photon_emission_matches_total_energy():
    """Photon emission sharded over the 8-device CPU mesh produces the
    same number of stored photons per emitted photon (statistically)
    and partitions work evenly across devices."""
    import jax
    import numpy as np
    from cse168_raytracer.ops.photon import trace_photon_batch_sharded
    from cse168_raytracer.parallel.sharding import make_mesh
    scene, static, cam = _two_plane_photon_scene()
    mesh = make_mesh()
    n_dev = mesh.size
    assert n_dev >= 2, "conftest should expose 8 virtual CPU devices"
    out = trace_photon_batch_sharded(scene, static, 0, 1024, False,
                                     3, False, jax.random.key(5), mesh)
    mask = np.asarray(out.mask)          # (L, 1024)
    assert mask.sum() > 50
    # per-device shards received distinct RNG: stored counts differ but
    # are all nonzero
    per_dev = mask.reshape(mask.shape[0], n_dev, -1).sum(axis=(0, 2))
    assert (per_dev > 0).all()
    assert len(set(per_dev.tolist())) > 1


def test_auto_radius_targets_500nn_estimate():
    """The fixed-radius estimate at the _auto_radius(k=500) radius must
    track the reference's true 500-NN estimate (PhotonMap.cpp:136-243,
    Miro.h:16-17): irradiance = sum(P_k) / (pi r_500^2) over the 500
    nearest photons. The per-cell cap folds overflow power instead of
    dropping it, so density hotspots stay comparable."""
    import numpy as np
    import jax.numpy as jnp
    from cse168_raytracer.ops.photon import (_auto_radius, build_grid,
                                             grid_irradiance)
    rng = np.random.default_rng(11)
    # photons on a plane with a density hotspot (caustic-like)
    n_bg, n_hot = 12000, 6000
    bg = np.stack([rng.uniform(-4, 4, n_bg), np.zeros(n_bg),
                   rng.uniform(-4, 4, n_bg)], 1)
    hot = np.stack([rng.normal(0, 0.25, n_hot), np.zeros(n_hot),
                    rng.normal(0, 0.25, n_hot)], 1)
    pos = np.concatenate([bg, hot]).astype(np.float32)
    n = pos.shape[0]
    power = rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32) / n
    power = np.repeat(power, 3, 1)
    dirs = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (n, 1))

    r = _auto_radius(pos, 500, 64)
    # the radius really holds ~500 photons at a typical point
    d2c = ((pos - pos[rng.integers(0, n, 64)][:, None]) ** 2).sum(-1)
    within = (d2c < r * r).sum(1)
    assert 150 < np.median(within) < 1500

    grid = build_grid(pos, power, dirs, r, max_per_cell=64, knn=500)
    q = np.array([[0.0, 0.0, 0.0],        # hotspot center (cap binds)
                  [2.0, 0.0, 2.0],        # background
                  [0.6, 0.0, 0.0]], np.float32)
    nrm = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (3, 1))
    est = np.asarray(grid_irradiance(grid, jnp.asarray(q),
                                     jnp.asarray(nrm)))
    for i in range(3):
        d2 = ((pos - q[i]) ** 2).sum(1)
        idx = np.argsort(d2)[:500]
        r500 = np.sqrt(d2[idx[-1]])
        knn = power[idx].sum(0) / (np.pi * r500 * r500)
        # the adaptive gather shrinks its disc to ~500 photons, so it
        # tracks the reference's k-NN estimate even across the ~30x
        # density contrast (fold-weight counting keeps capped cells
        # comparable)
        np.testing.assert_allclose(est[i], knn, rtol=0.35)


def test_photon_visualization_overlay():
    """-DVISUALIZE_PHOTON_MAP analog (Scene.cpp:405-409,586-591):
    stored photons project through the camera onto the frame; photons
    on the floor plane between the walls must land inside the image."""
    import jax
    import numpy as np
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.ops.photon import build_photon_maps
    from cse168_raytracer.render.photon_viz import (photon_overlay,
                                                    project_points)
    scene, static, cam = _two_plane_photon_scene()
    cfg = RenderConfig(width=48, height=48, trace_depth=2,
                       photons_per_light=1500,
                       caustic_photons_per_light=0)
    maps = build_photon_maps(scene, static, cfg, jax.random.key(1))
    assert maps is not None and maps.global_map is not None
    base = np.zeros((48, 48, 3), np.uint8)
    ov = photon_overlay(base, cam, maps, 48, 48)
    green = (ov[:, :, 1] > 200) & (ov[:, :, 0] < 100)
    assert green.sum() > 20, "photon dots must appear in-frame"
    # projection inverts eye_rays: a point straight down the view axis
    # lands at the image center
    import jax.numpy as jnp
    center = np.asarray(cam.eye + cam.view_dir * 5.0)[None]
    xy, vis = project_points(cam, center, 48, 48)
    assert vis[0]
    assert abs(int(xy[0, 0]) - 24) <= 1 and abs(int(xy[0, 1]) - 24) <= 1
    # points behind the camera are invisible
    behind = np.asarray(cam.eye - cam.view_dir * 5.0)[None]
    _, vis_b = project_points(cam, behind, 48, 48)
    assert not vis_b[0]
