"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cse168_raytracer.config import RenderConfig
from cse168_raytracer.parallel.sharding import (make_mesh,
                                                render_hdr_sharded,
                                                train_step_sharded)
from cse168_raytracer.render.integrator import render_hdr
from cse168_raytracer.scenes import build


@pytest.fixture(scope="module")
def sphere16():
    cfg = RenderConfig(width=16, height=16, trace_depth=2)
    return build("sphere", cfg)


def test_sharded_render_matches_single_device(sphere16):
    """Pixel-row sharding is a pure partition: the sharded forward
    render must equal the single-device one wherever randomness doesn't
    enter (deterministic Whitted rays, point light)."""
    scene, static, cam, cfg = sphere16
    mesh = make_mesh(8)
    key = jax.random.key(0)
    ref, _ = jax.jit(render_hdr, static_argnames=("static", "cfg"))(
        scene, static, cam, cfg, key)
    shd = jax.jit(
        lambda s, c, k: render_hdr_sharded(s, static, c, cfg, k, mesh))(
        scene, cam, key)
    np.testing.assert_allclose(np.asarray(shd), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_train_step_reduces_loss(sphere16):
    scene, static, cam, cfg = sphere16
    mesh = make_mesh(4)
    key = jax.random.key(0)
    target = jnp.full((16, 16, 3), 0.02, jnp.float32)
    step = jax.jit(lambda s, k: train_step_sharded(
        s, static, cam, cfg, k, mesh, target, lr=0.5))
    s1, l1 = step(scene, key)
    s2, l2 = step(s1, key)
    _, l3 = step(s2, key)
    assert float(l3) < float(l1)


def test_gradients_synchronized_across_devices(sphere16):
    """The psum'd material gradient must be identical regardless of
    device count (all-reduce correctness)."""
    scene, static, cam, cfg = sphere16
    key = jax.random.key(0)
    target = jnp.zeros((16, 16, 3), jnp.float32)

    outs = []
    for n in (2, 8):
        mesh = make_mesh(n)
        s, loss = jax.jit(lambda s, k: train_step_sharded(
            s, static, cam, cfg, k, mesh, target))(scene, key)
        outs.append((np.asarray(s.materials.kd), float(loss)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-7)
    assert abs(outs[0][1] - outs[1][1]) < 1e-6


def test_multihost_module_single_process(sphere16):
    """init_multihost degrades to a no-op single-process; global_mesh
    covers all (virtual) devices; gather_image returns the full frame;
    process_tile_rows assigns every row exactly once."""
    from cse168_raytracer.parallel import distributed as dist
    scene, static, cam, cfg = sphere16
    assert dist.init_multihost() == 0
    mesh = dist.global_mesh()
    assert mesh.size == len(jax.devices())
    key = jax.random.key(0)
    ref, _ = jax.jit(render_hdr, static_argnames=("static", "cfg"))(
        scene, static, cam, cfg, key)
    hdr = jax.jit(
        lambda s, c, k: render_hdr_sharded(s, static, c, cfg, k, mesh))(
        scene, cam, key)
    img = dist.gather_image(hdr)
    assert img.shape == (16, 16, 3)
    np.testing.assert_allclose(img, np.asarray(ref), rtol=1e-5, atol=1e-6)
    row0, nrows = dist.process_tile_rows(16, mesh)
    assert (row0, nrows) == (0, 16)   # single process owns every row


def test_two_process_distributed_render(tmp_path):
    """REAL multi-process jax.distributed: two CPU processes (4 virtual
    devices each) join a localhost coordinator, render the sphere scene
    sharded over an 8-device global mesh, and the gathered frame must
    equal this (single-process, 8-device) render bit-for-bit — the
    sharded render derives every tile's rays and RNG from its mesh
    position, which is identical in both topologies."""
    import socket
    import subprocess
    import sys as _sys

    # pick a free port for the coordinator
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"

    worker = os.path.join(os.path.dirname(__file__),
                          "_multiproc_worker.py")
    out = str(tmp_path / "two_proc.npy")
    # env must be set BEFORE the interpreter starts:
    # jax.distributed.initialize must run before any backend touch
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [subprocess.Popen(
        [_sys.executable, worker, coord, "2", str(pid), out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in (0, 1)]
    outs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for pid, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{o}"
        assert f"[worker {pid}] ok" in o
    img2 = np.load(out)

    # single-process reference on the local 8-device mesh
    from cse168_raytracer.parallel import distributed as dist
    from cse168_raytracer.parallel.sharding import render_hdr_sharded
    from cse168_raytracer.scenes import build
    cfg = RenderConfig(width=16, height=16, trace_depth=2)
    scene, static, cam, cfg = build("sphere", cfg)
    mesh = dist.global_mesh()
    assert mesh.size == 8
    hdr = jax.jit(lambda s, c, k: render_hdr_sharded(
        s, static, c, cfg, k, mesh))(scene, cam, jax.random.key(0))
    img1 = np.asarray(hdr)
    np.testing.assert_array_equal(img1, img2)
