"""Multi-chip scaling: mesh construction + sharded render/train steps
(replaces the reference's OpenMP scanline fork, Scene.cpp:112-115, with
shard_map over a jax device mesh)."""

from cse168_raytracer.parallel.sharding import (  # noqa: F401
    make_mesh, render_hdr_sharded, train_step_sharded)
