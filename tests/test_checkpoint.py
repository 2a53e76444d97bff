"""Checkpoint/resume + progressive rendering tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.config import RenderConfig
from cse168_raytracer.render.progressive import render_progressive
from cse168_raytracer.scenes import build
from cse168_raytracer.utils.checkpoint import (load_photon_maps,
                                               load_render_state,
                                               save_photon_maps,
                                               save_render_state)


def test_render_state_roundtrip(tmp_path):
    p = str(tmp_path / "state.npz")
    accum = jnp.arange(12.0).reshape(4, 3)
    key = jax.random.key(42)
    save_render_state(p, accum, 7, key)
    a2, n2, k2 = load_render_state(p)
    np.testing.assert_array_equal(np.asarray(a2), np.asarray(accum))
    assert n2 == 7
    assert jnp.all(jax.random.key_data(k2) == jax.random.key_data(key))


def test_progressive_resume_equals_straight_run(tmp_path):
    """Interrupting after k samples and resuming must give the exact
    same image as an uninterrupted run (bitwise: same keys consumed)."""
    cfg = RenderConfig(width=8, height=8, trace_depth=1, trace_samples=4,
                       path_tracing=True)
    scene, static, cam, cfg = build("sphere", cfg)
    key = jax.random.key(3)

    full = render_progressive(scene, static, cam, cfg, key)

    ckpt = str(tmp_path / "r.npz")
    cfg2 = cfg.replace(trace_samples=2)
    render_progressive(scene, static, cam, cfg2, key,
                       checkpoint_path=ckpt, checkpoint_every=1)
    resumed = render_progressive(scene, static, cam, cfg, key,
                                 checkpoint_path=ckpt, checkpoint_every=2)
    np.testing.assert_allclose(np.asarray(resumed), np.asarray(full),
                               rtol=1e-6, atol=1e-7)


def test_photon_map_roundtrip(tmp_path):
    from cse168_raytracer.ops.photon import (PhotonMaps, build_grid,
                                             grid_irradiance)
    rng = np.random.RandomState(0)
    pos = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    pw = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    d = np.tile(np.array([0, -1, 0], np.float32), (100, 1))
    maps = PhotonMaps(global_map=build_grid(pos, pw, d, 0.3),
                      caustic_map=None)
    p = str(tmp_path / "photons.npz")
    save_photon_maps(p, maps)
    m2 = load_photon_maps(p)
    assert m2.caustic_map is None
    q = jnp.zeros((4, 3))
    n = jnp.tile(jnp.array([0.0, 1.0, 0.0]), (4, 1))
    a = grid_irradiance(maps.global_map, q, n)
    b = grid_irradiance(m2.global_map, q, n)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
