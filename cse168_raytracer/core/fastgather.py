"""Row lookup for the small tables a wavefront indexes every bounce.

For materials, texture params and sphere/plane pools, `take_rows`
computes `table[ids]` as a one-hot product `(N, M) @ (M, F)` at full
float32 precision, whose adjoint is another product instead of a
scatter-add; large tables use the plain gather. Whether the one-hot
form still beats the GPU's gather at these shapes is not measured yet
(ROADMAP).

`take_rows` picks the strategy by table height; the one-hot path is
exact for float tables and for ints below 2^24 (stored exactly in
f32). Used by ops/surface.py, ops/shading.py, render/integrator.py,
models/textures.py, ops/photon.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# beyond a few hundred rows the (N, M) one-hot product costs real
# FLOPs and bandwidth
ONEHOT_MAX_ROWS = 256


def select_component(arr: jax.Array, idx: jax.Array) -> jax.Array:
    """arr[i, idx[i]] for arr (N, C) with C small (2-4) and idx (N,) in
    [0, C): a chain of elementwise jnp.where instead of a gather
    (take_along_axis)."""
    out = arr[:, 0]
    for c in range(1, arr.shape[1]):
        out = jnp.where(idx == c, arr[:, c], out)
    return out


def take_rows(table: jax.Array, ids: jax.Array) -> jax.Array:
    """table[ids] for 1-D or 2-D `table` and integer `ids` of any
    shape. One-hot matmul for small tables, plain gather otherwise."""
    m = table.shape[0]
    if m > ONEHOT_MAX_ROWS:
        return table[ids]
    squeeze = table.ndim == 1
    t2 = table[:, None] if squeeze else table
    dt = t2.dtype
    tf = t2.astype(jnp.float32)
    oh = (ids[..., None] == jnp.arange(m, dtype=ids.dtype)).astype(
        jnp.float32)
    out = jax.lax.dot_general(
        oh, tf, (((oh.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    if jnp.issubdtype(dt, jnp.integer):
        out = jnp.round(out).astype(dt)
    elif dt == jnp.bool_:
        out = out > 0.5
    elif out.dtype != dt:
        out = out.astype(dt)
    return out[..., 0] if squeeze else out
