"""Device-mesh sharding for rendering and differentiable training.

The reference's only parallelism is OpenMP threads over scanlines with
critical sections (Scene.cpp:112-115,157-163) and photon batches
(Scene.cpp:372-394). Here:

- mesh axis "tiles": pixel rows sharded across devices (the DP
  analog) — each device renders its own row-block with the full
  (replicated) scene; no communication in the forward pass.
- scene/materials replicated; in the backward pass shard_map's AD
  inserts the psum over "tiles" for replicated-parameter gradients
  (the gradient all-reduce of the north star), which XLA hands to
  NCCL on GPUs.
- photon emission: ops/photon.py trace_photon_batch_sharded shards the
  emission batch over the same mesh (build_photon_maps(mesh=...));
  stored photons come back sharded on the photon axis and the host
  concatenates them into the grid (no collective needed forward).

All functions work identically on a virtual CPU mesh
(xla_force_host_platform_device_count) — that is how the multi-device
logic is tested without several cards; `python chip_smoke.py
--four-cards` runs the render and the training step on four GPUs.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from cse168_raytracer.config import RenderConfig
from cse168_raytracer.models.scene import Scene, SceneStatic
from cse168_raytracer.render.camera import Camera
from cse168_raytracer.render.integrator import integrate, eye_rays


def make_mesh(n_devices: Optional[int] = None, axis: str = "tiles",
              devices=None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np
    return Mesh(np.array(devs), (axis,))


def render_hdr_sharded(scene: Scene, static: SceneStatic, cam: Camera,
                       cfg: RenderConfig, key: jax.Array, mesh: Mesh):
    """Scene::raytraceImage with pixel rows sharded over the mesh.

    Each device renders height/n_devices rows, assigned CYCLICALLY
    (device d owns rows d, d+n, d+2n, ...) — the static analog of the
    reference's `schedule(dynamic, 2)` (Scene.cpp:112-115): contiguous
    row bands concentrate a centered subject's traversal work on the
    middle devices, while striding spreads it evenly. The de-interleave back to image order is one
    reshape+transpose on the assembled array.
    Returns (H, W, 3) HDR radiance in image row order.
    """
    n_dev = mesh.size
    w, h = cfg.width, cfg.height
    assert h % n_dev == 0, f"height {h} must divide over {n_dev} devices"
    h_loc = h // n_dev

    def tile_fn(scene, cam, key):
        ti = jax.lax.axis_index("tiles")
        ys, xs = jnp.meshgrid(ti + n_dev * jnp.arange(h_loc),
                              jnp.arange(w),
                              indexing="ij")
        xs = xs.reshape(-1)
        ys = ys.reshape(-1)
        pixel = jnp.arange(h_loc * w, dtype=jnp.int32)  # tile-local ids
        tkey = jax.random.fold_in(key, ti)

        if cfg.path_tracing or cfg.dof:
            spp = cfg.trace_samples

            def body(carry, skey):
                k_cam, k_int = jax.random.split(skey)
                o, d = eye_rays(cam, xs, ys, w, h, key=k_cam,
                                dof_aperture=cfg.dof_aperture if cfg.dof
                                else 0.0,
                                dof_focus=cfg.dof_focus_plane)
                r, _ = integrate(scene, static, o, d, pixel, h_loc * w,
                                 k_int, cfg.trace_depth,
                                 path_tracing=cfg.path_tracing,
                                 disable_shadows=cfg.disable_shadows)
                return carry + r, None

            acc, _ = jax.lax.scan(body, jnp.zeros((h_loc * w, 3)),
                                  jax.random.split(tkey, spp))
            r = acc / spp
        else:
            o, d = eye_rays(cam, xs, ys, w, h, key=None)
            r, _ = integrate(scene, static, o, d, pixel, h_loc * w, tkey,
                             cfg.trace_depth, path_tracing=False,
                             disable_shadows=cfg.disable_shadows)
        return r.reshape(h_loc, w, 3)

    # check_vma=False — a DOCUMENTED DECISION, not an oversight. With
    # the checker on, it demands `jax.lax.pvary(..., 'tiles')` on every
    # traversal/integrator scan-carry INIT (fresh zeros/_BIG constants
    # deep inside ops/intersect.py, ops/bvh.py, render/integrator.py).
    # Those functions also run OUTSIDE any mesh, where pvary('tiles')
    # is invalid — satisfying the checker would couple shared library
    # internals to shard_map context (or duplicate them). The body is
    # embarrassingly parallel over "tiles" (each tile computes its own
    # rows from axis_index, no cross-tile communication), the constants
    # the checker flags are value-identical on every tile, and the
    # in/out specs fully describe the sharding for AD — the gradient
    # psum this spec layout induces is exercised by
    # tests/test_parallel.py::test_train_step_* and the two-process
    # test compares output bit-for-bit against single-process.
    fn = shard_map(tile_fn, mesh=mesh,
                   in_specs=(P(), P(), P()),
                   out_specs=P("tiles", None, None),
                   check_vma=False)
    sharded = fn(scene, cam, key)
    # de-interleave the cyclic rows: sharded[s*h_loc + j] holds image
    # row j*n_dev + s
    return (sharded.reshape(n_dev, h_loc, w, 3)
            .transpose(1, 0, 2, 3).reshape(h, w, 3))


def train_step_sharded(scene: Scene, static: SceneStatic, cam: Camera,
                       cfg: RenderConfig, key: jax.Array, mesh: Mesh,
                       target: jax.Array, lr: float = 1e-2):
    """One differentiable-render training step: L2 loss between the
    sharded render and a target image, gradient w.r.t. the material
    table (kd/ks/kt), SGD update. The parameter gradient all-reduce
    over "tiles" is inserted by shard_map's transpose.

    Returns (new_scene, loss).
    """
    params = (scene.materials.kd, scene.materials.ks, scene.materials.kt)

    def loss_fn(params):
        kd, ks, kt = params
        s = scene.replace(materials=scene.materials._replace(
            kd=kd, ks=ks, kt=kt))
        hdr = render_hdr_sharded(s, static, cam, cfg, key, mesh)
        return jnp.mean((hdr - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    kd, ks, kt = new_params
    new_scene = scene.replace(materials=scene.materials._replace(
        kd=kd, ks=ks, kt=kt))
    return new_scene, loss
