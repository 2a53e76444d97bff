"""Checkpoint / resume for long renders and photon maps.

The reference has none (SURVEY.md §5: a render is all-or-nothing and
photon maps are rebuilt every run, Scene.cpp:76-82). Here:

- photon maps serialize to one .npz (save_photon_maps /
  load_photon_maps) so the expensive trace pass is reusable across
  renders of the same scene;
- progressive render state (sample accumulator + count + RNG key)
  serializes the same way, letting a long path-traced render resume
  after interruption (render/progressive.py drives this).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def save_photon_maps(path: str, maps) -> None:
    from cse168_raytracer.ops.photon import PhotonMaps
    assert isinstance(maps, PhotonMaps)
    data = {}
    for name, g in (("g", maps.global_map), ("c", maps.caustic_map)):
        if g is None:
            continue
        data[f"{name}_pos"] = np.asarray(g.pos)
        data[f"{name}_power"] = np.asarray(g.power)
        data[f"{name}_dir"] = np.asarray(g.dir)
        data[f"{name}_hash"] = np.asarray(g.cell_hash)
        data[f"{name}_weight"] = np.asarray(g.weight)
        data[f"{name}_meta"] = np.asarray(
            [float(g.radius), int(g.n_valid), g.table_size, g.max_per_cell,
             g.knn])
    np.savez_compressed(path, **data)


def load_photon_maps(path: str):
    from cse168_raytracer.ops.photon import PhotonGrid, PhotonMaps
    z = np.load(path)

    def grid(name):
        if f"{name}_pos" not in z:
            return None
        meta = z[f"{name}_meta"]
        n = z[f"{name}_pos"].shape[0]
        # pre-r04 checkpoints lack weight/knn: weight 1 per stored row
        # and the k=500 default reproduce the old estimator closely
        wgt = (z[f"{name}_weight"] if f"{name}_weight" in z
               else np.ones(n, np.float32))
        return PhotonGrid(
            pos=jnp.asarray(z[f"{name}_pos"]),
            power=jnp.asarray(z[f"{name}_power"]),
            dir=jnp.asarray(z[f"{name}_dir"]),
            weight=jnp.asarray(wgt),
            cell_hash=jnp.asarray(z[f"{name}_hash"]),
            radius=jnp.float32(meta[0]),
            n_valid=jnp.int32(meta[1]),
            table_size=int(meta[2]),
            max_per_cell=int(meta[3]),
            knn=int(meta[4]) if meta.shape[0] > 4 else 500)

    return PhotonMaps(global_map=grid("g"), caustic_map=grid("c"))


def save_render_state(path: str, accum: jax.Array, samples_done: int,
                      key: jax.Array) -> None:
    np.savez_compressed(path, accum=np.asarray(accum),
                        samples_done=samples_done,
                        key=np.asarray(jax.random.key_data(key)))


def load_render_state(path: str):
    if not os.path.exists(path):
        return None
    z = np.load(path)
    key = jax.random.wrap_key_data(jnp.asarray(z["key"]))
    return jnp.asarray(z["accum"]), int(z["samples_done"]), key
