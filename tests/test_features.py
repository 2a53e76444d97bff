"""Feature-flag coverage the reference exercises only via ad-hoc scenes:
SquareLight stratified sampling (SquareLight.h:23-39), depth of field
(-DDOF, Camera.cpp:135-148), the Radiance .hdr loading path
(Texture.cpp:23-50), and the integrator's no-silent-energy-loss
guarantee (pool-overflow accounting)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cse168_raytracer.config import RenderConfig
from cse168_raytracer.scenes import build
from cse168_raytracer.models.geometry import (make_plane_pool,
                                              make_sphere_pool)
from cse168_raytracer.models.lights import (LIGHT_POINT, LIGHT_SQUARE,
                                            make_light_table,
                                            sample_origin)
from cse168_raytracer.models.materials import MaterialBuilder
from cse168_raytracer.models.scene import make_scene
from cse168_raytracer.render.integrator import render_hdr
from cse168_raytracer.scenes.registry import make_camera


# ---------------------------------------------------------------------------
# SquareLight stratification (SquareLight.h:23-39)
# ---------------------------------------------------------------------------

def test_square_light_stratified_cells():
    """samplePhotonOrigin(i, n): sample i is jittered within cell
    (i % side, i // side) of the side x side grid."""
    lt = make_light_table([dict(kind=LIGHT_SQUARE, position=(1.0, 2.0, 3.0),
                                normal=(0, 1, 0), dims=(4.0, 2.0),
                                wattage=100.0)])
    total = 4           # 2x2 grid: du = 2.0, dv = 1.0
    for si in range(total):
        pts = np.asarray(sample_origin(lt, 0, jax.random.key(si), (512,),
                                       sample_idx=si, total_samples=total))
        u = pts[:, 0] - 1.0   # tangent frame of (0,1,0) spans x/z
        v = pts[:, 2] - 3.0
        sx, sy = si % 2, si // 2
        # cell extents per SquareLight.h:34-35 (modulo tangent order /
        # sign, which is an arbitrary frame choice in both codebases)
        au, av = np.abs(u), np.abs(v)
        assert au.max() <= 2.0 + 1e-5 and av.max() <= 1.0 + 1e-5
        lo_u, hi_u = (0.0, 2.0) if sx else (-2.0, 0.0)
        lo_v, hi_v = (0.0, 1.0) if sy else (-1.0, 0.0)
        uu = np.sort(np.stack([u, v]), axis=0)  # frame-order agnostic
        # each sample stays inside ONE quadrant-cell of the rectangle
        in_cell_u = ((u >= lo_u - 1e-5) & (u <= hi_u + 1e-5)) | \
                    ((u >= -hi_u - 1e-5) & (u <= -lo_u + 1e-5))
        in_cell_v = ((v >= lo_v - 1e-5) & (v <= hi_v + 1e-5)) | \
                    ((v >= -hi_v - 1e-5) & (v <= -lo_v + 1e-5))
        assert in_cell_u.all() and in_cell_v.all()
        # and the 4 cells together must tile the rectangle: the spread
        # within one cell is half the side
        assert u.max() - u.min() <= 2.0 + 1e-5
        assert v.max() - v.min() <= 1.0 + 1e-5

    # union over all cells covers the full rectangle
    allpts = np.concatenate([
        np.asarray(sample_origin(lt, 0, jax.random.key(si), (512,),
                                 sample_idx=si, total_samples=total))
        for si in range(total)])
    u = allpts[:, 0] - 1.0
    v = allpts[:, 2] - 3.0
    assert u.min() < -1.5 and u.max() > 1.5
    assert v.min() < -0.75 and v.max() > 0.75


def _square_light_scene():
    mb = MaterialBuilder()
    white = mb.phong(kd=(1, 1, 1))
    spheres = make_sphere_pool([(0.0, 1.5, -4.0)], [0.7], [white])
    planes = make_plane_pool([(0, 0, 0)], [(0, 1, 0)], [white])
    lights = [dict(kind=LIGHT_SQUARE, position=(0.0, 4.0, -4.0),
                   normal=(0, -1, 0), dims=(3.0, 3.0), color=(1, 1, 1),
                   wattage=3000.0)]
    scene, static = make_scene(spheres=spheres, planes=planes,
                               materials=mb.build(), lights=lights)
    cam = make_camera(eye=(0, 3.0, 2.0), look_at=(0, 0.5, -4), fov=55,
                      bg_color=(0, 0, 0))
    return scene, static, cam


def test_square_light_soft_shadow_penumbra():
    """Stratified multi-sample NEE converges to the soft-shadow answer:
    with 1 sample each pixel's visibility is a binary coin flip in the
    penumbra, so its error against a 64-sample reference is much larger
    than the 16-sample estimate's (Phong.cpp:77-97 loop semantics)."""
    scene, static, cam = _square_light_scene()
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))

    def img(light_samples, seed):
        cfg = RenderConfig(width=48, height=48, trace_depth=2,
                           light_samples=light_samples)
        hdr, _ = render(scene, static, cam, cfg, jax.random.key(seed))
        return np.asarray(hdr).sum(-1)

    ref = img(64, 7)
    assert ref.max() > 0
    err1 = np.abs(img(1, 0) - ref).mean()
    err16 = np.abs(img(16, 0) - ref).mean()
    # 16 stratified samples cut the soft-shadow error way down
    assert err1 > 1.8 * err16, (err1, err16)
    # and the penumbra really exists: pixels strictly between umbra and
    # full illumination in the converged image
    lit = np.percentile(ref[ref > 0], 90)
    frac = ((ref > 0.2 * lit) & (ref < 0.6 * lit)).sum()
    assert frac > 10


# ---------------------------------------------------------------------------
# Depth of field (-DDOF, Camera.cpp:135-148)
# ---------------------------------------------------------------------------

def test_dof_blurs_out_of_focus_only():
    """Thin-lens: the sphere at the focus plane stays sharp, the far
    sphere defocuses (its silhouette gains intermediate-value pixels)."""
    mb = MaterialBuilder()
    white = mb.phong(kd=(1, 1, 1))
    spheres = make_sphere_pool([(-1.2, 0.0, -5.0), (2.0, 0.0, -14.0)],
                               [1.0, 2.2], [white, white])
    lights = [dict(kind=LIGHT_POINT, position=(0, 8, 0), color=(1, 1, 1),
                   wattage=5000.0)]
    scene, static = make_scene(spheres=spheres, materials=mb.build(),
                               lights=lights)
    cam = make_camera(eye=(0, 0, 0), look_at=(0, 0, -5), fov=45,
                      bg_color=(0, 0, 0))
    key = jax.random.key(1)
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))

    def img(aperture):
        # both renders go through the sampled thin-lens path with the
        # SAME key (identical pixel jitter): the only difference is the
        # aperture, so image changes are pure defocus
        cfg = RenderConfig(width=48, height=48, trace_depth=2, dof=True,
                           dof_aperture=aperture, dof_focus_plane=5.0,
                           trace_samples=48)
        hdr, _ = render(scene, static, cam, cfg, key)
        return np.asarray(hdr).sum(-1)

    sharp = img(1e-5)
    blurred = img(0.45)
    lit = np.percentile(sharp[sharp > 0], 90)

    # DOF changes the image where the geometry is OUT of focus: the far
    # sphere's half moves a lot, the focus sphere's half barely
    diff = np.abs(blurred - sharp) / lit
    d_left = diff[:, :24].mean()
    d_right = diff[:, 24:].mean()
    assert d_right > 3.0 * d_left, (d_left, d_right)
    # the in-focus interior radiance is essentially unchanged
    in_focus = sharp[:, :24] > 0.8 * lit
    assert in_focus.sum() > 10
    rel = (np.abs(blurred[:, :24] - sharp[:, :24])[in_focus]
           / np.maximum(sharp[:, :24][in_focus], 1e-6))
    assert np.median(rel) < 0.15


# ---------------------------------------------------------------------------
# Radiance .hdr path (Texture.cpp:23-50)
# ---------------------------------------------------------------------------

def test_radiance_hdr_roundtrip(tmp_path):
    from cse168_raytracer.models.textures import (read_radiance_hdr,
                                                  write_radiance_hdr)
    rng = np.random.default_rng(0)
    img = (rng.uniform(0.0, 1.0, (7, 9, 3)) ** 2 * 37.0).astype(np.float32)
    img[0, 0] = 0.0                       # zero-exponent pixel
    p = str(tmp_path / "t.hdr")
    write_radiance_hdr(p, img)
    back = read_radiance_hdr(p)
    assert back.shape == img.shape
    # RGBE stores 8-bit mantissas with a shared exponent: ~1/256 of the
    # channel max per pixel
    scale = np.maximum(img.max(axis=-1, keepdims=True), 1e-6)
    assert np.abs(back - img).max() / 37.0 < 0.02
    assert float(np.abs(back - img).max() / scale.max()) < 0.01


def test_hdr_env_texture_through_loader(tmp_path):
    """A synthetic .hdr loaded via load_image_texture drives env-map
    lighting through the HDR tonemap branch (Texture.cpp:23-28:
    min(1.5*sqrt(v/max), 1))."""
    from cse168_raytracer.models.textures import (image_lookup,
                                                  load_image_texture,
                                                  make_environment)
    img = np.zeros((8, 16, 3), np.float32)
    img[:, :8] = 4.0      # bright half
    img[:, 8:] = 0.25     # dim half
    p = str(tmp_path / "env.hdr")
    from cse168_raytracer.models.textures import write_radiance_hdr
    write_radiance_hdr(p, img)
    tex = load_image_texture(p)
    assert tex.is_hdr
    assert float(tex.max_intensity) == pytest.approx(4.0, rel=1e-3)
    # tonemap check at a texel center: v=4 -> min(1.5*sqrt(1), 1) = 1;
    # v=0.25 -> 1.5*sqrt(0.0625) = 0.375
    val_bright = np.asarray(image_lookup(tex, jnp.float32(0.25),
                                         jnp.float32(0.5)))
    val_dim = np.asarray(image_lookup(tex, jnp.float32(0.75),
                                      jnp.float32(0.5)))
    assert val_bright == pytest.approx(1.0, abs=0.02)
    assert val_dim == pytest.approx(0.375, abs=0.02)

    # and through the full render: env-lit miss rays pick up the texture
    mb = MaterialBuilder()
    _ = mb.phong(kd=(1, 1, 1))
    scene, static = make_scene(materials=mb.build(),
                               lights=[dict(kind=LIGHT_POINT,
                                            position=(0, 5, 0),
                                            color=(1, 1, 1), wattage=0.0)],
                               env=make_environment(image=tex))
    cam = make_camera(eye=(0, 0, 0), look_at=(0, 0, -1), fov=60,
                      bg_color=(0, 0, 0))
    cfg = RenderConfig(width=8, height=8, trace_depth=1)
    hdr, _ = render_hdr(scene, static, cam, cfg, jax.random.key(0))
    assert float(jnp.max(hdr)) > 0.3


# ---------------------------------------------------------------------------
# No silent energy loss: pool-overflow accounting (integrator _compact)
# ---------------------------------------------------------------------------

def test_no_dropped_rays_on_refractive_cornell():
    """The refractive cornell render must fit its child rays in the
    2x pool (silent energy loss would be invisible to every other
    test)."""
    from cse168_raytracer.scenes import build
    cfg = RenderConfig(width=32, height=32, trace_depth=5)
    scene, static, cam, cfg = build("cornell_proxy", cfg)
    hdr, stats = jax.jit(render_hdr, static_argnames=("static", "cfg"))(
        scene, static, cam, cfg, jax.random.key(0))
    assert int(stats.dropped_rays) == 0
    assert int(stats.secondary_rays) > 0
    assert np.isfinite(np.asarray(hdr)).all()


# ---------------------------------------------------------------------------
# --stats plumbing: in-kernel traversal counters through a full render
# (Stats.cpp:15-27 semantics; VERDICT r3 item 6)
# ---------------------------------------------------------------------------

def test_collect_stats_counts_full_render():
    """cfg.collect_stats must surface the -DSTATS counters measured
    inside the traversal for the WHOLE render (closest + shadow rays),
    not a separate primary-only pass (the bvh walk counts on the CPU;
    the cuda kernel counts the same way on the card)."""
    import dataclasses
    from cse168_raytracer.ops.accel import attach_accel
    from cse168_raytracer.scenes import build

    cfg = RenderConfig(width=32, height=32, trace_depth=2,
                       collect_stats=True)
    scene, static, cam, cfg = build("knot", cfg)
    scene = attach_accel(scene, kind="bvh", leaf_size=4)
    hdr, stats = render_hdr(scene, static, cam, cfg, jax.random.key(0))
    n_rays = (int(stats.primary_rays) + int(stats.secondary_rays)
              + int(stats.shadow_rays))
    box = float(stats.box_tests)
    tri = float(stats.tri_tests)
    assert box > 0 and tri > 0
    # two box tests per internal visit, four slots per leaf visit
    assert box % 2 == 0 and tri % 4 == 0
    assert tri / n_rays < scene.tris.num_tris / 10
    assert box / n_rays < 2 * scene.accel.num_nodes
    # without collect_stats the counters stay at their zero default
    cfg2 = dataclasses.replace(cfg, collect_stats=False)
    _, stats2 = render_hdr(scene, static, cam, cfg2, jax.random.key(0))
    assert float(stats2.box_tests) == 0.0


def test_attach_accel_rejects_unknown_kwargs():
    """Mistyped accelerator options must raise, not silently drop
    (attach_accel validates per kind)."""
    import pytest
    from cse168_raytracer.ops.accel import attach_accel
    cfg = RenderConfig(width=8, height=8)
    scene, static, cam, cfg = build("knot", cfg)
    with pytest.raises(TypeError, match="unsupported options"):
        attach_accel(scene, kind="cuda", tile=16)
    with pytest.raises(TypeError, match="unsupported options"):
        attach_accel(scene, kind="bvh", tile=64)
    with pytest.raises(TypeError, match="unsupported options"):
        attach_accel(scene, kind="block", leaf_size=8)


def test_sponza_proxy_scene_scale():
    """The sponza stand-in must stay benchmark-scale (>=100k tris) and
    keep its interior camera."""
    import numpy as np
    cfg = RenderConfig(width=8, height=8)
    scene, static, cam, cfg = build("sponza_proxy", cfg)
    assert int(np.asarray(scene.tris.valid).sum()) >= 100_000


def test_png_writer_round_trips_without_imageio(tmp_path):
    """write_image's PNG path is numpy + zlib only (the GPU host has no
    imageio): decode the file by hand and get the rows back top-down."""
    import struct
    import zlib
    from cse168_raytracer.render.image_io import write_image
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)   # bottom-up
    path = str(tmp_path / "x.png")
    write_image(path, img)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (w, h, depth, ctype) == (7, 5, 8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(5, 1 + 7 * 3)
    assert np.all(rows[:, 0] == 0)
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), img[::-1])


def test_compile_cache_rule(monkeypatch):
    """One cache rule for the CLI, bench.py and chip_smoke.py: the
    environment's JAX_COMPILATION_CACHE_DIR when set (left to JAX),
    else <checkout>/.jax_cache."""
    from cse168_raytracer.utils import compile_cache
    saved = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        jax.config.update("jax_compilation_cache_dir", saved)
        assert compile_cache.enable_compile_cache() == "/elsewhere"
        assert jax.config.jax_compilation_cache_dir == saved
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.DEFAULT_DIR
        assert path.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
