"""Traversal statistics (the -DSTATS counters, Stats.{h,cpp}).

The reference's A2 writeup validates its BVH with ray-box and ray-tri
test counts per ray (writeup/A2/Readme.tex:90-107: teapot 3.75
tri-tests/ray, sponza 10.33, ...). This module measures the same
quantities for the block-cull traversal: a ray "tests" a triangle when
its tile visits the triangle's block AND the ray's own slab test for
that block passed (the per-ray descent criterion, matching how the
reference counts per-ray packet tests).

Ray counts themselves (primary/secondary/shadow) are tracked inline by
the integrator (render/integrator.py RenderStats).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cse168_raytracer.config import MIRO_TMAX
from cse168_raytracer.ops.accel import (BLOCK, GROUP, BlockAccel, _slab)


class TraversalStats(NamedTuple):
    box_tests_per_ray: jax.Array   # () f32
    tri_tests_per_ray: jax.Array   # () f32
    rays: int


def measure_traversal_stats(accel: BlockAccel, o: jax.Array, d: jax.Array,
                            tmin=0.0, tmax=MIRO_TMAX) -> TraversalStats:
    """Count per-ray box/tri tests for one wavefront (no hit output —
    use the normal traversal for that). Small and jit-friendly; meant
    for --stats runs, not the hot path."""
    n = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, o.dtype), (n,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, o.dtype), (n,))
    d_rcp = 1.0 / d
    ng = accel.group_lo.shape[0]

    def group_body(carry, gi):
        box, tri = carry
        ghit = _slab(o, d_rcp, accel.group_lo[gi], accel.group_hi[gi],
                     tmin, tmax)
        box = box + jnp.float32(n)          # every ray slab-tests the group
        def visit(carry):
            box, tri = carry
            def blk(carry, bj):
                box, tri = carry
                bi = gi * GROUP + bj
                bhit = _slab(o, d_rcp, accel.block_lo[bi],
                             accel.block_hi[bi], tmin, tmax)
                box = box + jnp.float32(n)
                tri = tri + jnp.sum(bhit.astype(jnp.float32)) * BLOCK
                return (box, tri), None
            (box, tri), _ = jax.lax.scan(blk, (box, tri),
                                         jnp.arange(GROUP, dtype=jnp.int32))
            return box, tri
        carry = jax.lax.cond(jnp.any(ghit), visit, lambda c: c, (box, tri))
        return carry, None

    (box, tri), _ = jax.lax.scan(group_body,
                                 (jnp.float32(0), jnp.float32(0)),
                                 jnp.arange(ng, dtype=jnp.int32))
    return TraversalStats(box_tests_per_ray=box / n,
                          tri_tests_per_ray=tri / n, rays=n)


def traversal_stats(accel, o: jax.Array, d: jax.Array,
                    tmin=0.0, tmax=MIRO_TMAX) -> TraversalStats:
    """Per-ray box/tri test counts for any attached accelerator.

    For the cuda and bvh walks the counts come from counters carried
    INSIDE the traversal (exact, the reference's -DSTATS accounting:
    two ray-box tests per internal node visited, every triangle of every
    leaf visited); for the block accel they come from the approximating
    separate pass above."""
    from cse168_raytracer.ops.bvh import BVHAccel, bvh_closest_hit_triangles
    from cse168_raytracer.ops.cuda_bvh import (CudaBVH,
                                               cuda_closest_hit_triangles)
    n = o.shape[0]
    if isinstance(accel, CudaBVH):
        _, box, tri = cuda_closest_hit_triangles(accel, o, d, tmin, tmax,
                                                 with_stats=True)
    elif isinstance(accel, BVHAccel):
        _, st = bvh_closest_hit_triangles(accel, o, d, tmin, tmax,
                                          collect_stats=True)
        box, tri = 2 * st.node_visits, st.tri_tests
    else:
        return measure_traversal_stats(accel, o, d, tmin, tmax)
    return TraversalStats(
        box_tests_per_ray=jnp.sum(box.astype(jnp.float32)) / n,
        tri_tests_per_ray=jnp.sum(tri.astype(jnp.float32)) / n, rays=n)
