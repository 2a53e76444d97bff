"""Accelerator choice and the block-AABB sweep: an XLA replacement for
the reference's recursive SAH BVH (BVH.cpp:60-339 build, 438-658
traversal).

`attach_accel` builds one of three accelerators and `scene_closest_hit`
/ `scene_any_hit` dispatch on its type. The block sweep lives here:

1. *Build* (host/numpy): triangles are sorted by the Morton code of
   their centroid (the LBVH ordering — spatially coherent), grouped
   into fixed blocks of BLOCK tris, and each block gets an AABB; blocks
   are further grouped into super-blocks of GROUP blocks with their own
   AABB. This is a shallow implicit 2-level BVH whose leaves are wide
   triangle packets (the reference packs 4-wide SSE leaf caches,
   BVH.cpp:91-166; ours are 128-wide).

2. *Traversal*: rays are processed in tiles of TILE rays (camera tiles
   are spatially coherent, shadow rays converge on a light — the same
   coherence the reference exploits with near-to-far packet descent).
   A lax.scan walks super-blocks; a ray-tile tests the super-AABB and
   skips all its blocks with lax.cond when no ray in the tile can hit
   it closer than its current best. Surviving blocks run the
   (TILE, 6) @ (6, 3*BLOCK) Pluecker product of ops/intersect.py at
   full float32 precision.

Everything is fixed-shape, so it compiles on any backend; it is the
CPU default.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.config import EPSILON, MIRO_TMAX
from cse168_raytracer.models.geometry import (PlanePool, SpherePool,
                                              TrianglePack,
                                              build_pack_from_arrays)
from cse168_raytracer.ops.intersect import (Hit, PRIM_NONE, PRIM_TRI,
                                            _BIG, _DEN_TINY, _merge,
                                            _ray4, _ray6, accept_bounds,
                                            intersect_planes,
                                            intersect_spheres)

BLOCK = 128   # triangles per leaf block
GROUP = 16    # blocks per super-block
TILE = 8192   # rays per traversal tile

# the Pluecker products are 6- and 4-deep: float32 products and sums
# (never TF32, which keeps ~3 decimal digits) cost nothing extra here
_HIGHEST = jax.lax.Precision.HIGHEST

_FAR = 1.0e30  # sentinel AABB for empty blocks (never hit)


class BlockAccel(NamedTuple):
    block_lo: jax.Array   # (NB, 3)
    block_hi: jax.Array   # (NB, 3)
    group_lo: jax.Array   # (NG, 3)
    group_hi: jax.Array   # (NG, 3)

    @property
    def num_blocks(self) -> int:
        return self.block_lo.shape[0]


def morton_order(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                 valid: np.ndarray) -> np.ndarray:
    """Permutation sorting valid triangles by 30-bit Morton code of the
    centroid (GPU-LBVH ordering); invalid (padding) tris go last."""
    cent = v0 + (e1 + e2) / 3.0
    lo = cent[valid].min(axis=0) if valid.any() else np.zeros(3)
    hi = cent[valid].max(axis=0) if valid.any() else np.ones(3)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023.0)
    q = np.clip(q, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) \
        | spread(q[:, 2])
    code = np.where(valid, code, np.uint64(0xFFFFFFFFFFFF))
    return np.argsort(code, kind="stable")


def reorder_pack(pack: TrianglePack, perm: np.ndarray) -> TrianglePack:
    """Permute all per-triangle arrays (and rebuild the matmul
    operands so they stay consistent)."""
    g = lambda a: np.asarray(a)[perm]
    return build_pack_from_arrays(
        g(pack.v0), g(pack.e1), g(pack.e2),
        g(pack.n0), g(pack.n1), g(pack.n2),
        g(pack.t0), g(pack.t1), g(pack.t2),
        g(pack.has_uv), g(pack.material_id), g(pack.valid))


def build_accel(pack: TrianglePack):
    """Build block/group AABBs for a Morton-ORDERED pack. Use
    `attach_accel` to do ordering + build in one step."""
    valid = np.asarray(pack.valid)
    t = valid.shape[0]
    assert t % BLOCK == 0
    nb = t // BLOCK
    lo, hi = accept_bounds(pack.v0, pack.e1, pack.e2)
    pts_lo = np.where(valid[:, None], lo, _FAR)
    pts_hi = np.where(valid[:, None], hi, _FAR)
    blo = pts_lo.reshape(nb, BLOCK, 3).min(axis=1)
    bhi = pts_hi.reshape(nb, BLOCK, 3).max(axis=1)
    # empty blocks: min=_FAR, but hi may be _FAR too — keep degenerate
    bhi = np.where(blo >= _FAR, _FAR, bhi)

    ng = -(-nb // GROUP)
    pad = ng * GROUP - nb
    if pad:
        blo_p = np.concatenate([blo, np.full((pad, 3), _FAR)])
        bhi_p = np.concatenate([bhi, np.full((pad, 3), _FAR)])
    else:
        blo_p, bhi_p = blo, bhi
    glo = blo_p.reshape(ng, GROUP, 3).min(axis=1)
    ghi = bhi_p.reshape(ng, GROUP, 3).max(axis=1)
    ghi = np.where(glo >= _FAR, _FAR, ghi)

    return BlockAccel(block_lo=jnp.asarray(blo_p, jnp.float32),
                      block_hi=jnp.asarray(bhi_p, jnp.float32),
                      group_lo=jnp.asarray(glo, jnp.float32),
                      group_hi=jnp.asarray(ghi, jnp.float32))


KINDS = ("block", "bvh", "cuda")


def default_kind(backend: str) -> str:
    """The accelerator `attach_accel(kind="auto")` picks per platform:
    the CUDA kernel on GPUs (it won the card's A/B, PERF.md), the block
    sweep on CPUs (the test platform). Other backends have no measured
    traversal, so they raise rather than fall back silently."""
    if backend == "gpu":
        return "cuda"
    if backend == "cpu":
        return "block"
    raise ValueError(f"no traversal is chosen for backend {backend!r}; "
                     f"pass kind= one of {KINDS}")


def attach_accel(scene, kind: str = "auto", **kwargs):
    """Order the scene's triangles and attach an accelerator.

    kind:
      "block"  — 2-level BlockAccel scan traversal (fixed block sweep
                 with group/block culling; strong for small scenes);
      "bvh"    — per-ray ordered BVH walk in XLA (ops/bvh.py): exact
                 reference-style traversal with in-traversal counters;
      "cuda"   — one-thread-per-ray CUDA walk of a binned-SAH tree
                 (ops/cuda_bvh.py + csrc/bvh_trace.cu); GPU only;
      "auto"   — `default_kind(jax.default_backend())`.
    Extra kwargs: leaf_size (bvh builder), block (cuda: rays per CUDA
    block); unknown or kind-mismatched options raise TypeError here
    (a silently dropped option once cost a round of wrong A/B numbers).
    Returns the updated Scene.
    """
    if kind == "auto":
        kind = default_kind(jax.default_backend())
    if kind not in KINDS:
        raise ValueError(f"unknown accelerator kind {kind!r}; have {KINDS}")
    _KIND_KWARGS = {
        "bvh": {"leaf_size"},
        "cuda": {"block"},
    }
    unknown = set(kwargs) - _KIND_KWARGS.get(kind, set())
    if unknown:
        raise TypeError(
            f"attach_accel(kind={kind!r}) got unsupported options "
            f"{sorted(unknown)}; this kind accepts "
            f"{sorted(_KIND_KWARGS.get(kind, set())) or 'no options'}")
    if kind == "cuda":
        # the SAH builder defines its own triangle order (compact leaves)
        from cse168_raytracer.ops.cuda_bvh import build_cuda_bvh
        new_pack, accel = build_cuda_bvh(scene.tris, **kwargs)
        return scene.replace(tris=new_pack, accel=accel)
    pack = scene.tris
    perm = morton_order(np.asarray(pack.v0), np.asarray(pack.e1),
                        np.asarray(pack.e2), np.asarray(pack.valid))
    pack = reorder_pack(pack, perm)
    if kind == "bvh":
        from cse168_raytracer.ops.bvh import build_bvh
        return scene.replace(tris=pack, accel=build_bvh(pack, **kwargs))
    return scene.replace(tris=pack, accel=build_accel(pack))


def _with_unbounded(h, spheres, planes, blpatches, o, d, tmin, tmax):
    """Merge the unbounded primitive lists into a triangle Hit
    (Scene.cpp:214-231)."""
    h = _merge(h, intersect_spheres(spheres, o, d, tmin, tmax))
    h = _merge(h, intersect_planes(planes, o, d, tmin, tmax))
    if blpatches is not None:
        from cse168_raytracer.ops.intersect import intersect_blpatches
        h = _merge(h, intersect_blpatches(blpatches, o, d, tmin, tmax))
    return h


def _occluded_unbounded(occ, spheres, planes, blpatches, o, d, tmin,
                        tmax):
    """`occ` or'd with occlusion by the unbounded primitive lists."""
    occ = occ | intersect_spheres(spheres, o, d, tmin, tmax).hit
    occ = occ | intersect_planes(planes, o, d, tmin, tmax).hit
    if blpatches is not None:
        from cse168_raytracer.ops.intersect import intersect_blpatches
        occ = occ | intersect_blpatches(blpatches, o, d, tmin, tmax).hit
    return occ


def scene_closest_hit(accel, tris: TrianglePack, spheres: SpherePool,
                      planes: PlanePool, o, d, tmin=0.0,
                      tmax=MIRO_TMAX, blpatches=None,
                      with_stats: bool = False):
    """Dispatch on the attached accelerator type.

    with_stats=True returns (Hit, box_tests, tri_tests): per-ray int32
    counts of ray-box and ray-triangle tests measured INSIDE the
    traversal that produced the hits (Stats.h accounting). The cuda and
    bvh walks count; block returns zeros."""
    from cse168_raytracer.ops.bvh import (BVHAccel, bvh_closest_hit,
                                          bvh_closest_hit_triangles)
    from cse168_raytracer.ops.cuda_bvh import (CudaBVH,
                                               cuda_closest_hit_triangles)
    if isinstance(accel, CudaBVH):
        res = cuda_closest_hit_triangles(accel, o, d, tmin, tmax,
                                         with_stats=with_stats)
        h = _with_unbounded(res[0] if with_stats else res, spheres, planes,
                            blpatches, o, d, tmin, tmax)
        return (h, *res[1:]) if with_stats else h
    if with_stats:
        if isinstance(accel, BVHAccel):
            h, st = bvh_closest_hit_triangles(accel, o, d, tmin, tmax,
                                              collect_stats=True)
            h = _with_unbounded(h, spheres, planes, blpatches, o, d,
                                tmin, tmax)
            return h, 2 * st.node_visits, st.tri_tests
        h = scene_closest_hit(accel, tris, spheres, planes, o, d,
                              tmin, tmax, blpatches=blpatches)
        zero = jnp.zeros(o.shape[:1], jnp.int32)
        return h, zero, zero
    if isinstance(accel, BVHAccel):
        return bvh_closest_hit(accel, tris, spheres, planes, o, d,
                               tmin, tmax, blpatches=blpatches)
    return accel_closest_hit(accel, tris, spheres, planes, o, d, tmin, tmax,
                             blpatches=blpatches)


def accel_any_hit_triangles(accel: BlockAccel, pack: TrianglePack,
                            o: jax.Array, d: jax.Array, tmin, tmax):
    """Boolean occlusion: does ANY triangle lie in [tmin, tmax]?

    Shadow rays don't need the closest hit when no material is
    refractive (Phong.cpp:97-100 just `continue`s on any opaque
    occluder): rays resolve on first hit, and blocks/groups are skipped
    once no unresolved ray can hit them."""
    n = o.shape[0]
    t_total = pack.num_tris
    ng = accel.group_lo.shape[0]

    tile = min(TILE, n)
    n_tiles = -(-n // tile)
    n_pad = n_tiles * tile

    def pad(x, fill=0.0):
        if n_pad == n:
            return x
        return jnp.concatenate(
            [x, jnp.full((n_pad - n,) + x.shape[1:], fill, x.dtype)])

    tmin = jnp.broadcast_to(jnp.asarray(tmin, o.dtype), (n,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, o.dtype), (n,))
    o_p = pad(o).reshape(n_tiles, tile, 3)
    d_p = pad(d, 1.0).reshape(n_tiles, tile, 3)
    tmin_p = pad(tmin).reshape(n_tiles, tile)
    tmax_p = pad(tmax, -1.0).reshape(n_tiles, tile)

    real_nb = t_total // BLOCK
    w6 = pack.w6.reshape(6, real_nb, BLOCK, 3)
    valid_b = pack.valid.reshape(real_nb, BLOCK)
    w4r = pack.w4.reshape(4, real_nb, BLOCK)

    def tile_body(_, ray_tile):
        o_t, d_t, tmin_t, tmax_t = ray_tile
        r6 = _ray6(o_t, d_t)
        r4 = _ray4(o_t)
        d_rcp = 1.0 / d_t

        def group_body(occ, gi):
            ghit = _slab(o_t, d_rcp, accel.group_lo[gi], accel.group_hi[gi],
                         tmin_t, tmax_t) & ~occ

            def visit(occ):
                def block_step(occ, bj):
                    bi = gi * GROUP + bj
                    bhit = _slab(o_t, d_rcp, accel.block_lo[bi],
                                 accel.block_hi[bi], tmin_t, tmax_t) & ~occ

                    def test(occ):
                        bic = jnp.minimum(bi, real_nb - 1)
                        w6b = jax.lax.dynamic_index_in_dim(
                            w6, bic, axis=1, keepdims=False)
                        vb = jax.lax.dynamic_index_in_dim(
                            valid_b, bic, axis=0, keepdims=False)
                        w4b = jax.lax.dynamic_index_in_dim(
                            w4r, bic, axis=1, keepdims=False)
                        nums = jnp.dot(r6, w6b.reshape(6, BLOCK * 3),
                                       preferred_element_type=jnp.float32,
                                       precision=_HIGHEST)
                        nums = nums.reshape(tile, BLOCK, 3)
                        t_num = jnp.dot(r4, w4b,
                                        preferred_element_type=jnp.float32,
                                        precision=_HIGHEST)
                        den = nums[:, :, 2]
                        safe_den = jnp.where(jnp.abs(den) < _DEN_TINY,
                                             1.0, den)
                        inv_den = 1.0 / safe_den
                        beta = nums[:, :, 0] * inv_den
                        gamma = nums[:, :, 1] * inv_den
                        t = t_num * inv_den
                        ok = ((beta >= -EPSILON) & (gamma >= -EPSILON)
                              & (beta + gamma <= 1.0 + EPSILON)
                              & (t >= tmin_t[:, None])
                              & (t <= tmax_t[:, None])
                              & (jnp.abs(den) >= _DEN_TINY) & vb[None, :])
                        return occ | jnp.any(ok, axis=1)

                    return jax.lax.cond(jnp.any(bhit), test,
                                        lambda c: c, occ), None

                occ, _ = jax.lax.scan(block_step, occ,
                                      jnp.arange(GROUP, dtype=jnp.int32))
                return occ

            return jax.lax.cond(jnp.any(ghit), visit, lambda c: c, occ), None

        occ0 = jnp.zeros((tile,), bool)
        occ, _ = jax.lax.scan(group_body, occ0,
                              jnp.arange(ng, dtype=jnp.int32))
        return None, occ

    _, occ = jax.lax.scan(tile_body, None, (o_p, d_p, tmin_p, tmax_p))
    return occ.reshape(n_pad)[:n]


def scene_any_hit(accel, tris: TrianglePack,
                  spheres: SpherePool, planes: PlanePool, o, d,
                  tmin=0.0, tmax=MIRO_TMAX, blpatches=None,
                  with_stats: bool = False):
    """Boolean shadow occlusion across all primitive pools.

    All inputs are gradient-stopped: the boolean result carries no
    gradient, and keeping AD out of the traversal scans avoids
    linearization residuals that blow up compile time.

    with_stats=True returns (occ, box_tests, tri_tests) — in-traversal
    counters for the cuda accel, zeros otherwise (see
    scene_closest_hit)."""
    from cse168_raytracer.ops.bvh import BVHAccel, bvh_any_hit
    from cse168_raytracer.ops.cuda_bvh import (CudaBVH,
                                               cuda_closest_hit_triangles)
    if isinstance(accel, CudaBVH):
        (spheres, planes, o, d, tmin, tmax, blpatches) = \
            jax.lax.stop_gradient((spheres, planes, o, d, tmin, tmax,
                                   blpatches))
        res = cuda_closest_hit_triangles(accel, o, d, tmin, tmax,
                                         any_hit=True, with_stats=with_stats)
        occ = _occluded_unbounded((res[0] if with_stats else res).hit,
                                  spheres, planes, blpatches, o, d, tmin,
                                  tmax)
        return (occ, *res[1:]) if with_stats else occ
    if with_stats:
        occ = scene_any_hit(accel, tris, spheres, planes, o, d,
                            tmin, tmax, blpatches=blpatches)
        zero = jnp.zeros(o.shape[:1], jnp.int32)
        return occ, zero, zero
    if isinstance(accel, BVHAccel):
        return bvh_any_hit(accel, tris, spheres, planes, o, d, tmin, tmax,
                           blpatches=blpatches)
    (accel, tris, spheres, planes, o, d, tmin, tmax, blpatches) = \
        jax.lax.stop_gradient((accel, tris, spheres, planes, o, d,
                               tmin, tmax, blpatches))
    occ = accel_any_hit_triangles(accel, tris, o, d, tmin, tmax)
    return _occluded_unbounded(occ, spheres, planes, blpatches, o, d, tmin,
                               tmax)


def _slab(o, d_rcp, lo, hi, tmin, tmax):
    """Ray-AABB slab test (BVH.cpp:513-584 semantics). o: (N,3),
    d_rcp: (N,3); lo/hi: (3,) or (N,3). Returns (N,) bool."""
    t0 = (lo - o) * d_rcp
    t1 = (hi - o) * d_rcp
    # NaN from 0*inf -> treat as always-pass for that axis (reference
    # inherits x86 min/max NaN semantics; this is the safe direction)
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    tn = jnp.where(jnp.isnan(tn), -jnp.inf, tn)
    tf = jnp.where(jnp.isnan(tf), jnp.inf, tf)
    enter = jnp.maximum(jnp.max(tn, axis=-1), tmin)
    exit_ = jnp.minimum(jnp.min(tf, axis=-1), tmax)
    return enter <= exit_


def accel_intersect_triangles(accel: BlockAccel, pack: TrianglePack,
                              o: jax.Array, d: jax.Array, tmin, tmax) -> Hit:
    """Closest-hit against Morton-ordered triangle blocks with
    group/block AABB culling. Rays are processed in TILE-sized tiles.

    Gradient-detached like intersect_triangles (see detach_tri_hit):
    keeps AD from linearizing the traversal scans/conds."""
    accel, pack, o, d, tmin, tmax = jax.lax.stop_gradient(
        (accel, pack, o, d, tmin, tmax))
    return _accel_intersect_triangles_impl(accel, pack, o, d, tmin, tmax)


def _accel_intersect_triangles_impl(accel: BlockAccel, pack: TrianglePack,
                                    o: jax.Array, d: jax.Array,
                                    tmin, tmax) -> Hit:
    n = o.shape[0]
    t_total = pack.num_tris
    nb = accel.num_blocks
    ng = accel.group_lo.shape[0]

    tile = min(TILE, n)
    n_tiles = -(-n // tile)
    n_pad = n_tiles * tile

    def pad(x, fill=0.0):
        if n_pad == n:
            return x
        return jnp.concatenate(
            [x, jnp.full((n_pad - n,) + x.shape[1:], fill, x.dtype)])

    tmin = jnp.broadcast_to(jnp.asarray(tmin, o.dtype), (n,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, o.dtype), (n,))
    o_p = pad(o).reshape(n_tiles, tile, 3)
    d_p = pad(d, 1.0).reshape(n_tiles, tile, 3)
    tmin_p = pad(tmin).reshape(n_tiles, tile)
    tmax_p = pad(tmax, -1.0).reshape(n_tiles, tile)  # padding rays: tmax<tmin

    # accel block list may be padded past the pack (group rounding);
    # padded blocks have AABB=_FAR and never pass the slab test, but the
    # data index is clamped anyway.
    real_nb = t_total // BLOCK
    w6 = pack.w6.reshape(6, real_nb, BLOCK, 3)
    valid_b = pack.valid.reshape(real_nb, BLOCK)

    def tile_body(_, ray_tile):
        o_t, d_t, tmin_t, tmax_t = ray_tile
        r6 = _ray6(o_t, d_t)
        r4 = _ray4(o_t)
        d_rcp = 1.0 / d_t

        def group_body(carry, gi):
            best_t, best_id = carry
            cur_max = jnp.minimum(tmax_t, best_t)
            ghit = _slab(o_t, d_rcp, accel.group_lo[gi], accel.group_hi[gi],
                         tmin_t, cur_max)

            def visit(carry):
                best_t, best_id = carry

                def block_step(carry, bj):
                    best_t, best_id = carry
                    bi = gi * GROUP + bj
                    cur = jnp.minimum(tmax_t, best_t)
                    bhit = _slab(o_t, d_rcp, accel.block_lo[bi],
                                 accel.block_hi[bi], tmin_t, cur)

                    def test(carry):
                        best_t, best_id = carry
                        bic = jnp.minimum(bi, real_nb - 1)
                        w6b = jax.lax.dynamic_index_in_dim(
                            w6, bic, axis=1, keepdims=False)  # (6,BLOCK,3)
                        vb = jax.lax.dynamic_index_in_dim(
                            valid_b, bic, axis=0, keepdims=False)
                        w4b = jax.lax.dynamic_index_in_dim(
                            pack.w4.reshape(4, real_nb, BLOCK), bic,
                            axis=1, keepdims=False)
                        nums = jnp.dot(r6, w6b.reshape(6, BLOCK * 3),
                                       preferred_element_type=jnp.float32,
                                       precision=_HIGHEST)
                        nums = nums.reshape(tile, BLOCK, 3)
                        t_num = jnp.dot(r4, w4b,
                                        preferred_element_type=jnp.float32,
                                        precision=_HIGHEST)
                        den = nums[:, :, 2]
                        safe_den = jnp.where(jnp.abs(den) < _DEN_TINY, 1.0, den)
                        inv_den = 1.0 / safe_den
                        beta = nums[:, :, 0] * inv_den
                        gamma = nums[:, :, 1] * inv_den
                        t = t_num * inv_den
                        ok = ((beta >= -EPSILON) & (gamma >= -EPSILON)
                              & (beta + gamma <= 1.0 + EPSILON)
                              & (t >= tmin_t[:, None]) & (t <= cur[:, None])
                              & (jnp.abs(den) >= _DEN_TINY) & vb[None, :])
                        tm = jnp.where(ok, t, _BIG)
                        bmin = jnp.min(tm, axis=1)
                        barg = (jnp.argmin(tm, axis=1).astype(jnp.int32)
                                + bic * BLOCK)
                        better = bmin < best_t
                        return (jnp.where(better, bmin, best_t),
                                jnp.where(better, barg, best_id))

                    return jax.lax.cond(jnp.any(bhit), test,
                                        lambda c: c, (best_t, best_id)), None

                (best_t, best_id), _ = jax.lax.scan(
                    block_step, (best_t, best_id),
                    jnp.arange(GROUP, dtype=jnp.int32))
                return best_t, best_id

            carry = jax.lax.cond(jnp.any(ghit), visit, lambda c: c,
                                 (best_t, best_id))
            return carry, None

        init = (jnp.full((tile,), _BIG), jnp.zeros((tile,), jnp.int32))
        (best_t, best_id), _ = jax.lax.scan(
            group_body, init, jnp.arange(ng, dtype=jnp.int32))
        return None, (best_t, best_id)

    _, (bt, bid) = jax.lax.scan(
        tile_body, None, (o_p, d_p, tmin_p, tmax_p))
    best_t = bt.reshape(n_pad)[:n]
    best_id = bid.reshape(n_pad)[:n]
    hit = best_t < _BIG
    return Hit(t=best_t, prim_type=jnp.where(hit, PRIM_TRI, PRIM_NONE),
               prim_id=best_id, hit=hit)


def accel_closest_hit(accel: BlockAccel, tris: TrianglePack,
                      spheres: SpherePool, planes: PlanePool,
                      o: jax.Array, d: jax.Array, tmin=0.0,
                      tmax=MIRO_TMAX, blpatches=None) -> Hit:
    """Scene::trace with acceleration: culled triangle pass, then the
    unbounded lists (Scene.cpp:214-231)."""
    h = accel_intersect_triangles(accel, tris, o, d, tmin, tmax)
    return _with_unbounded(h, spheres, planes, blpatches, o, d, tmin, tmax)
