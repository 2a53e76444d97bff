"""Worker for the REAL two-process jax.distributed smoke test
(tests/test_parallel.py::test_two_process_distributed_render).

Each process joins a localhost coordinator with 4 virtual CPU devices
(8-device global mesh), renders the 16x16 sphere scene sharded over
rows, gathers the full frame, and process 0 writes it to the given
.npy path. Run as:

    python tests/_multiproc_worker.py <coordinator> <n_proc> <pid> <out>
"""

import os
import sys

# CPU-only with 4 virtual devices per process. The launcher sets these
# in the subprocess environment; the setdefaults cover direct manual
# runs.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=4")

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))


def main():
    coordinator, n_proc, pid, out = (sys.argv[1], int(sys.argv[2]),
                                     int(sys.argv[3]), sys.argv[4])
    from cse168_raytracer.parallel import distributed as dist
    proc = dist.init_multihost(coordinator, n_proc, pid)

    import jax
    import numpy as np
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.parallel.sharding import render_hdr_sharded
    from cse168_raytracer.scenes import build

    assert jax.process_count() == n_proc, jax.process_count()
    assert len(jax.devices()) == 4 * n_proc
    mesh = dist.global_mesh()

    cfg = RenderConfig(width=16, height=16, trace_depth=2)
    scene, static, cam, cfg = build("sphere", cfg)
    hdr = jax.jit(lambda s, c, k: render_hdr_sharded(
        s, static, c, cfg, k, mesh))(scene, cam, jax.random.key(0))
    img = dist.gather_image(hdr)

    row0, n_rows = dist.process_tile_rows(cfg.height, mesh)
    assert n_rows == cfg.height // n_proc, (row0, n_rows)
    assert row0 == pid * n_rows, (row0, pid)

    if proc == 0:
        np.save(out, np.asarray(img))
    print(f"[worker {pid}] ok shape={img.shape}", flush=True)


if __name__ == "__main__":
    main()
