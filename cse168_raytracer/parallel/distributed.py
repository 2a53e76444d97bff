"""Multi-host distributed rendering/training (the jax.distributed path).

The reference is a single process: its only scaling axis is OpenMP
threads over scanlines (Scene.cpp:112-115). Here the scaling spans
HOSTS: processes are joined by `jax.distributed.initialize`, and one
global `Mesh` covers every device in the job. The forward render is
embarrassingly parallel over pixel tiles (no collectives); the backward
pass all-reduces the replicated-parameter gradients — shard_map's
transpose inserts the psum, XLA routes it (NCCL on GPUs).

One process per host drives all of that host's GPUs: a JAX process
reserves most of each card's memory it opens, so two processes on one
card fail. To run one process per GPU instead, give each its card with
`local_device_ids` (init_multihost's argument).

Usage (one command per host; every argument is required, nothing is
inferred from the environment but JAX_COORDINATOR_ADDRESS):

    python -m cse168_raytracer.cli render --scene sponza_proxy \
        --coordinator 10.0.0.1:8476 --num-processes 4 --process-id $i ...

or from Python:

    from cse168_raytracer.parallel import distributed as dist
    dist.init_multihost(coordinator, num_processes, process_id)
    mesh = dist.global_mesh()
    hdr = render_hdr_sharded(scene, static, cam, cfg, key, mesh)
    img = dist.gather_image(hdr)          # full frame on every host

Everything here also runs single-process (init_multihost is then a
no-op and global_mesh == make_mesh over local devices) — that is how
the logic is exercised in CI on the virtual CPU mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   local_device_ids=None) -> int:
    """Join (or create) the multi-host job. Returns this process' id.

    Single-process (all args None, no JAX_COORDINATOR_ADDRESS): a no-op
    — JAX's local backend is already the whole job. local_device_ids
    limits this process to some of the host's devices (one process per
    GPU). Idempotent: calling twice is safe (jax.distributed raises on
    re-init; we guard).
    """
    global _initialized
    single = (coordinator_address is None and num_processes in (None, 1)
              and not os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if single:
        return 0
    if not _initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
        _initialized = True
    return jax.process_index()


def global_mesh(axis: str = "tiles") -> Mesh:
    """A 1-D mesh over EVERY device in the job (all processes).

    jax.devices() is global after jax.distributed.initialize; in a
    single process it is just the local devices, so this degrades to
    parallel.sharding.make_mesh.
    """
    return Mesh(np.array(jax.devices()), (axis,))


def process_tile_rows(height: int, mesh: Mesh):
    """This process' row span in render_hdr_sharded's SHARDED buffer:
    (row0, n_rows). Rows are assigned to devices CYCLICALLY in image
    space (device d computes image rows d, d+n, ...), so this span
    indexes the pre-de-interleave buffer, not contiguous image rows;
    the returned n_rows is still exactly this process' share of the
    work."""
    n_dev = mesh.size
    assert height % n_dev == 0
    h_loc = height // n_dev
    locals_ = [d for d in mesh.devices.flat
               if d.process_index == jax.process_index()]
    ids = sorted(np.where(np.isin(mesh.devices.flat, locals_))[0])
    if not ids:
        return 0, 0
    # the (row0, n_rows) contract only holds when this process' devices
    # occupy CONTIGUOUS mesh positions (true for the default
    # jax.devices() order, which groups by process) — fail loudly on
    # exotic interleaved layouts instead of misreporting ownership
    assert int(ids[-1]) - int(ids[0]) + 1 == len(ids), (
        f"process devices not contiguous in mesh: positions {ids}")
    return int(ids[0]) * h_loc, len(ids) * h_loc


def gather_image(hdr: jax.Array) -> np.ndarray:
    """Assemble the full frame on every host.

    hdr is the global array returned by render_hdr_sharded (sharded on
    rows across the global mesh). Single-process: just device_get. A
    fully-addressable array skips the collective; otherwise
    multihost_utils.process_allgather all-gathers the shards.
    """
    if jax.process_count() == 1 or hdr.is_fully_addressable:
        return np.asarray(jax.device_get(hdr))
    from jax.experimental import multihost_utils
    return np.asarray(
        multihost_utils.process_allgather(hdr, tiled=True))
