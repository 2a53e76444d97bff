"""Hierarchical BVH: the real replacement for the reference's SAH BVH
(BVH.cpp:60-339 build, BVH.cpp:438-658 ordered traversal).

Build (host, vectorized numpy — the LBVH recipe):
  * triangles are Morton-sorted (ops/accel.morton_order) and grouped
    into leaves of LEAF triangles (the reference packs 4-8 per SSE leaf,
    BVH.h:55-62; ours default to 8);
  * an *implicit complete binary tree* is laid over the next-pow2 leaf
    count: internal node i has children 2i+1 / 2i+2, leaves occupy node
    ids [P-1, 2P-2].  No pointers — ideal for fixed-shape XLA;
  * every internal node stores BOTH children's AABBs contiguously
    (cbox, (P-1, 12)) so a visit costs exactly one 12-float gather (the
    same trick as the reference's 2-box SSE slab test, BVH.cpp:513-584);
  * leaf triangle data is pre-gathered into (L, LEAF*9) rows
    [v0|e1|e2] so a leaf visit costs one row gather (the reference's
    SSE leaf caches, BVH.cpp:91-166).

Traversal (on device): a wavefront of rays advances in lockstep under
one lax.while_loop; each ray carries a short stack (node id + entry t).
Per iteration every ray pops one entry and either

  * internal: slab-tests both children against [tmin, min(tmax, best_t)]
    and pushes the survivors far-then-near (ordered descent,
    BVH.cpp:586-651 semantics — near child popped first), or
  * leaf: intersects the LEAF-triangle packet (Pluecker numerators,
    Triangle.cpp:152-158 acceptance semantics) and updates the running
    closest hit.

Early-out: popped entries whose recorded entry-t exceeds the current
best_t are discarded (the reference's `result.t < tMin` pruning,
BVH.cpp:600-650).  The loop ends when every ray's stack is empty.

Counters: node visits and triangle tests are accumulated per ray
*inside* the traversal (Stats.h sites Ray.h:66-68 / BVH.cpp:486-497)
when `collect_stats=True` — these are the numbers the reference's A2
tables report (writeup/A2/Readme.tex:90-107). Each internal visit
slab-tests both children (two ray-box tests); each leaf visit tests
all LEAF slots, padding included.

All traversal inputs are gradient-stopped (see ops/intersect.py
detach_tri_hit): hit selection is discrete; winners' continuous surface
math is recomputed differentiably downstream (ops/surface.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.config import EPSILON, MIRO_TMAX
from cse168_raytracer.models.geometry import TrianglePack
from cse168_raytracer.ops.intersect import (_BIG, _DEN_TINY, PRIM_NONE,
                                            PRIM_TRI, Hit, accept_bounds)

_FAR = 1.0e30  # degenerate AABB placed at infinity: slab always fails


class BVHAccel(NamedTuple):
    """Flattened implicit BVH (all leaves at one level of a complete
    binary tree over the Morton-ordered leaf blocks)."""
    cbox: jax.Array       # (max(P-1,1), 12) f32: [lo_L, hi_L, lo_R, hi_R]
    leaf_tri: jax.Array   # (L, LEAF*9) f32: [v0 | e1 | e2] per triangle
    # static ints (python, part of the pytree aux via NamedTuple of arrays
    # would retrace — keep them as 0-d numpy so equality hashing works)
    n_internal: int       # P - 1
    n_leaves: int         # L (real leaves; node id = n_internal + leaf)
    leaf_size: int        # LEAF
    stack_depth: int      # log2(P) + 2

    @property
    def num_nodes(self) -> int:
        return 2 * (self.n_internal + 1) - 1


# NamedTuple with python ints is fine as a pytree: jax treats every field
# as a leaf, and ints become weak-typed scalars. That would retrace and
# also break `isinstance` dispatch cheaply — instead register as pytree
# with arrays as children and the ints static.
def _bvh_flatten(b: BVHAccel):
    return (b.cbox, b.leaf_tri), (b.n_internal, b.n_leaves, b.leaf_size,
                                  b.stack_depth)


def _bvh_unflatten(aux, children):
    cbox, leaf_tri = children
    return BVHAccel(cbox, leaf_tri, *aux)


jax.tree_util.register_pytree_node(BVHAccel, _bvh_flatten, _bvh_unflatten)


def _leaf_boxes(pack: TrianglePack, leaf_size: int):
    """Per-leaf AABBs of a Morton-ordered pack; padding triangles are
    excluded, empty leaves get a degenerate box at _FAR."""
    valid = np.asarray(pack.valid)
    t = valid.shape[0]
    assert t % leaf_size == 0, "pack padding must be a multiple of leaf_size"
    n_leaves = t // leaf_size
    lo, hi = accept_bounds(pack.v0, pack.e1, pack.e2)
    lo_t = np.where(valid[:, None], lo, _FAR)
    hi_t = np.where(valid[:, None], hi, -_FAR)
    leaf_lo = lo_t.reshape(n_leaves, leaf_size, 3).min(axis=1)
    leaf_hi = hi_t.reshape(n_leaves, leaf_size, 3).max(axis=1)
    empty = ~valid.reshape(n_leaves, leaf_size).any(axis=1)
    leaf_lo = np.where(empty[:, None], _FAR, leaf_lo)
    leaf_hi = np.where(empty[:, None], _FAR, leaf_hi)
    return leaf_lo, leaf_hi, n_leaves


def _build_cbox(leaf_lo: np.ndarray, leaf_hi: np.ndarray):
    """Bottom-up AABB fit of the implicit complete tree. Returns
    (cbox (max(P-1,1), 12), n_internal, stack_depth)."""
    n_leaves = leaf_lo.shape[0]
    p = 1 << max(0, (n_leaves - 1).bit_length())             # next pow2
    n_internal = p - 1
    # box[n] over all 2P-1 nodes; leaves occupy [P-1, 2P-2]
    box_lo = np.full((2 * p - 1, 3), _FAR)
    box_hi = np.full((2 * p - 1, 3), _FAR)
    box_lo[p - 1:p - 1 + n_leaves] = leaf_lo
    box_hi[p - 1:p - 1 + n_leaves] = leaf_hi
    # bottom-up level sweep (vectorized per level)
    level_start = p - 1
    while level_start > 0:
        parent_start = (level_start - 1) // 2
        n_par = level_start - parent_start
        li = level_start + 2 * np.arange(n_par)
        lo_l, lo_r = box_lo[li], box_lo[li + 1]
        hi_l, hi_r = box_hi[li], box_hi[li + 1]
        both_empty = (lo_l[:, 0] >= _FAR) & (lo_r[:, 0] >= _FAR)
        # min/max ignoring empty (_FAR, _FAR) boxes: an empty child's
        # lo=_FAR never lowers the min; its hi=_FAR WOULD raise the max,
        # so mask it to -_FAR first.
        hi_l = np.where(lo_l[:, 0:1] >= _FAR, -_FAR, hi_l)
        hi_r = np.where(lo_r[:, 0:1] >= _FAR, -_FAR, hi_r)
        plo = np.minimum(lo_l, lo_r)
        phi = np.maximum(hi_l, hi_r)
        plo = np.where(both_empty[:, None], _FAR, plo)
        phi = np.where(both_empty[:, None], _FAR, phi)
        box_lo[parent_start:level_start] = plo
        box_hi[parent_start:level_start] = phi
        level_start = parent_start
    if n_internal > 0:
        ii = np.arange(n_internal)
        cbox = np.concatenate([
            box_lo[2 * ii + 1], box_hi[2 * ii + 1],
            box_lo[2 * ii + 2], box_hi[2 * ii + 2]], axis=1)  # (P-1, 12)
    else:
        cbox = np.full((1, 12), _FAR)
    return cbox, n_internal, max(2, p.bit_length() + 1)


def build_bvh(pack: TrianglePack, leaf_size: int = 8) -> BVHAccel:
    """Build the implicit LBVH for a Morton-ORDERED TrianglePack.

    The pack's padding triangles (valid=False, all-zero vertices) sort
    last under morton_order and produce degenerate leaves whose AABB is
    placed at _FAR, so traversal never descends into them.
    """
    leaf_lo, leaf_hi, n_leaves = _leaf_boxes(pack, leaf_size)
    cbox, n_internal, stack_depth = _build_cbox(leaf_lo, leaf_hi)
    v0 = np.asarray(pack.v0, np.float64)
    e1 = np.asarray(pack.e1, np.float64)
    e2 = np.asarray(pack.e2, np.float64)
    leaf_tri = np.concatenate([
        v0.reshape(n_leaves, leaf_size * 3),
        e1.reshape(n_leaves, leaf_size * 3),
        e2.reshape(n_leaves, leaf_size * 3)], axis=1)         # (L, LEAF*9)
    return BVHAccel(cbox=jnp.asarray(cbox, jnp.float32),
                    leaf_tri=jnp.asarray(leaf_tri, jnp.float32),
                    n_internal=int(n_internal), n_leaves=int(n_leaves),
                    leaf_size=int(leaf_size), stack_depth=int(stack_depth))


def _slab2(o, d_rcp, cb, tmin, tmax):
    """Slab-test both children of a node. cb: (R, 12). Returns
    (t_enter_L, hit_L, t_enter_R, hit_R)."""
    def one(lo, hi):
        t0 = (lo - o) * d_rcp
        t1 = (hi - o) * d_rcp
        tn = jnp.minimum(t0, t1)
        tf = jnp.maximum(t0, t1)
        tn = jnp.where(jnp.isnan(tn), -jnp.inf, tn)
        tf = jnp.where(jnp.isnan(tf), jnp.inf, tf)
        enter = jnp.maximum(jnp.max(tn, axis=-1), tmin)
        exit_ = jnp.minimum(jnp.min(tf, axis=-1), tmax)
        return enter, enter <= exit_
    tl, hl = one(cb[:, 0:3], cb[:, 3:6])
    tr, hr = one(cb[:, 6:9], cb[:, 9:12])
    return tl, hl, tr, hr


def _leaf_intersect(leaf_rows, o, d, m, tmin, tmax, leaf_size):
    """Pluecker-numerator intersection of each ray against its gathered
    leaf packet. leaf_rows: (R, LEAF*9). Acceptance = Triangle.cpp:158.

    Returns (t_best (R,), j_best (R,) in [0, LEAF), any_ok (R,))."""
    r = o.shape[0]
    k = leaf_size
    v0 = leaf_rows[:, 0:3 * k].reshape(r, k, 3)
    e1 = leaf_rows[:, 3 * k:6 * k].reshape(r, k, 3)
    e2 = leaf_rows[:, 6 * k:9 * k].reshape(r, k, 3)
    n_geo = jnp.cross(e1, e2)
    dN = d[:, None, :]
    mN = m[:, None, :]
    den = -jnp.sum(dN * n_geo, axis=-1)
    beta_num = (jnp.sum(mN * e2, axis=-1)
                + jnp.sum(dN * jnp.cross(v0, e2), axis=-1))
    gamma_num = (-jnp.sum(mN * e1, axis=-1)
                 + jnp.sum(dN * jnp.cross(e1, v0), axis=-1))
    t_num = jnp.sum((o[:, None, :] - v0) * n_geo, axis=-1)
    safe_den = jnp.where(jnp.abs(den) < _DEN_TINY, 1.0, den)
    inv_den = 1.0 / safe_den
    beta = beta_num * inv_den
    gamma = gamma_num * inv_den
    tt = t_num * inv_den
    ok = ((beta >= -EPSILON) & (gamma >= -EPSILON)
          & (beta + gamma <= 1.0 + EPSILON)
          & (tt >= tmin[:, None]) & (tt <= tmax[:, None])
          & (jnp.abs(den) >= _DEN_TINY))
    tm = jnp.where(ok, tt, _BIG)
    t_best = jnp.min(tm, axis=1)
    j_best = jnp.argmin(tm, axis=1).astype(jnp.int32)
    return t_best, j_best, t_best < _BIG


class TraversalStats(NamedTuple):
    node_visits: jax.Array  # (N,) i32 internal-node visits per ray
    tri_tests: jax.Array    # (N,) i32 ray-triangle tests per ray


def bvh_closest_hit_triangles(accel: BVHAccel, o: jax.Array, d: jax.Array,
                              tmin, tmax, collect_stats: bool = False,
                              any_hit: bool = False):
    """Ordered stack traversal for a wavefront of rays.

    Returns Hit (prim_id = Morton-order triangle index, i.e. the pack
    row) — or, with any_hit=True, Hit where .hit is first-hit occlusion
    (t/prim_id are whatever hit terminated the ray). With collect_stats
    also returns TraversalStats.
    """
    accel, o, d, tmin, tmax = jax.lax.stop_gradient(
        (accel, o, d, tmin, tmax))
    n = o.shape[0]
    s = accel.stack_depth
    ni = accel.n_internal
    nl = accel.n_leaves
    k = accel.leaf_size

    tmin = jnp.broadcast_to(jnp.asarray(tmin, o.dtype), (n,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, o.dtype), (n,))
    d_rcp = 1.0 / d
    m = jnp.cross(o, d)
    rows = jnp.arange(n)

    stack_i0 = jnp.zeros((n, s), jnp.int32)           # root = node 0
    stack_t0 = jnp.zeros((n, s), jnp.float32)
    sp0 = jnp.ones((n,), jnp.int32)
    # rays whose interval is empty never traverse at all
    sp0 = jnp.where(tmax < tmin, 0, sp0)
    best_t0 = jnp.full((n,), _BIG)
    best_id0 = jnp.zeros((n,), jnp.int32)
    nv0 = jnp.zeros((n,), jnp.int32)
    tt0 = jnp.zeros((n,), jnp.int32)

    def cond(state):
        _si, _st, sp, _bt, _bi, _nv, _tt = state
        return jnp.any(sp > 0)

    def body(state):
        stack_i, stack_t, sp, best_t, best_id, nv, tt = state
        active = sp > 0
        spm = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(stack_i, spm[:, None], axis=1)[:, 0]
        ten = jnp.take_along_axis(stack_t, spm[:, None], axis=1)[:, 0]
        sp = spm

        cur_tmax = jnp.minimum(tmax, best_t)
        process = active & (ten <= cur_tmax)
        is_leaf = node >= ni
        do_int = process & ~is_leaf
        do_leaf = process & is_leaf

        # ---- internal: test both children, push far then near ----
        ci = jnp.clip(node, 0, max(ni - 1, 0))
        cb = accel.cbox[ci]                                # (R, 12) gather
        tl, hl, tr, hr = _slab2(o, d_rcp, cb, tmin, cur_tmax)
        hl = hl & do_int
        hr = hr & do_int
        l_near = tl <= tr
        near_i = jnp.where(l_near, 2 * node + 1, 2 * node + 2)
        far_i = jnp.where(l_near, 2 * node + 2, 2 * node + 1)
        near_t = jnp.where(l_near, tl, tr)
        far_t = jnp.where(l_near, tr, tl)
        near_h = jnp.where(l_near, hl, hr)
        far_h = jnp.where(l_near, hr, hl)

        def push(si, st, sp, idx, tv, mask):
            col = jnp.where(mask, sp, 0)
            old_i = jnp.take_along_axis(si, col[:, None], axis=1)[:, 0]
            old_t = jnp.take_along_axis(st, col[:, None], axis=1)[:, 0]
            si = si.at[rows, col].set(jnp.where(mask, idx, old_i))
            st = st.at[rows, col].set(jnp.where(mask, tv, old_t))
            return si, st, sp + mask.astype(jnp.int32)

        stack_i, stack_t, sp = push(stack_i, stack_t, sp,
                                    far_i, far_t, far_h)
        stack_i, stack_t, sp = push(stack_i, stack_t, sp,
                                    near_i, near_t, near_h)

        # ---- leaf: packet intersect ----
        leaf = jnp.clip(node - ni, 0, max(nl - 1, 0))
        rows9 = accel.leaf_tri[leaf]                       # (R, K*9) gather
        lt, lj, lok = _leaf_intersect(rows9, o, d, m, tmin, cur_tmax, k)
        better = do_leaf & lok & (lt < best_t)
        best_t = jnp.where(better, lt, best_t)
        best_id = jnp.where(better, leaf * k + lj, best_id)
        if any_hit:
            # first accepted hit occludes: empty the stack (Phong.cpp:97
            # continue-on-any-opaque semantics)
            sp = jnp.where(better, 0, sp)

        if collect_stats:
            nv = nv + do_int.astype(jnp.int32)
            tt = tt + do_leaf.astype(jnp.int32) * k
        return stack_i, stack_t, sp, best_t, best_id, nv, tt

    state = (stack_i0, stack_t0, sp0, best_t0, best_id0, nv0, tt0)
    state = jax.lax.while_loop(cond, body, state)
    _si, _st, _sp, best_t, best_id, nv, tt = state
    hit = best_t < _BIG
    h = Hit(t=best_t, prim_type=jnp.where(hit, PRIM_TRI, PRIM_NONE),
            prim_id=best_id, hit=hit)
    if collect_stats:
        return h, TraversalStats(node_visits=nv, tri_tests=tt)
    return h


def bvh_closest_hit(accel: BVHAccel, tris, spheres, planes, o, d,
                    tmin=0.0, tmax=MIRO_TMAX, blpatches=None) -> Hit:
    """Scene::trace with the hierarchical accelerator: BVH triangle pass
    then the unbounded lists (Scene.cpp:214-231)."""
    from cse168_raytracer.ops.intersect import (_merge,
                                                intersect_blpatches,
                                                intersect_planes,
                                                intersect_spheres)
    h = bvh_closest_hit_triangles(accel, o, d, tmin, tmax)
    h = _merge(h, intersect_spheres(spheres, o, d, tmin, tmax))
    h = _merge(h, intersect_planes(planes, o, d, tmin, tmax))
    if blpatches is not None:
        h = _merge(h, intersect_blpatches(blpatches, o, d, tmin, tmax))
    return h


def bvh_any_hit(accel: BVHAccel, tris, spheres, planes, o, d,
                tmin=0.0, tmax=MIRO_TMAX, blpatches=None):
    """Boolean shadow occlusion across all pools (gradient-stopped)."""
    from cse168_raytracer.ops.intersect import (intersect_blpatches,
                                                intersect_planes,
                                                intersect_spheres)
    (accel, tris, spheres, planes, o, d, tmin, tmax, blpatches) = \
        jax.lax.stop_gradient((accel, tris, spheres, planes, o, d,
                               tmin, tmax, blpatches))
    h = bvh_closest_hit_triangles(accel, o, d, tmin, tmax, any_hit=True)
    occ = h.hit
    occ = occ | intersect_spheres(spheres, o, d, tmin, tmax).hit
    occ = occ | intersect_planes(planes, o, d, tmin, tmax).hit
    if blpatches is not None:
        occ = occ | intersect_blpatches(blpatches, o, d, tmin, tmax).hit
    return occ
