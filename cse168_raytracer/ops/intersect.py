"""Batched brute-force ray-primitive intersection: the plain reference
every accelerator is checked against.

Rays are tested against triangle blocks with one (N,6)@(6,3*TB)
product per block (Pluecker form — see TrianglePack in
models/geometry.py) under a lax.scan running-min, replacing the
reference's per-ray tests (Triangle.cpp:136-169). Acceptance semantics
match Triangle.cpp:158 exactly:

    reject if beta < -eps or gamma < -eps or beta+gamma > 1+eps
              or t < tMin or t > tMax

(signed division by den = dot(-d, n), so backfaces hit, as in the
reference). Sphere semantics: Sphere.cpp:27-69 (strict t bounds).
Plane semantics: Plane.cpp:32-48.

All outputs are differentiable w.r.t. ray origins/directions and
triangle vertices; hit *selection* (argmin) is discrete and detached,
matching the finite-difference-oracle protocol (SURVEY.md §7).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.config import EPSILON, MIRO_TMAX
from cse168_raytracer.models.geometry import (PlanePool, SpherePool,
                                              TrianglePack)

PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SPHERE = 2
PRIM_PLANE = 3
PRIM_BLPATCH = 4

# np scalar, NOT jnp: a module-level jnp array would initialize the XLA
# backend at import time, which breaks jax.distributed.initialize for
# any caller that imports the package before joining the job
_BIG = np.float32(3.0e37)
_DEN_TINY = 1e-30

# Every product here runs in float32. On GPUs XLA may otherwise compute a
# float32 dot in TF32 (~3 decimal digits), which moves hits near edges,
# t near tmin/tmax and shadow acne against EPSILON.
_HIGHEST = jax.lax.Precision.HIGHEST

# Acceptance widens each triangle by EPSILON in barycentrics, so a hit can
# lie outside the triangle's vertex box. Accelerator boxes bound the
# triangle widened by twice that (the rest covers float32 rounding of
# beta and gamma), plus a few ulps of the coordinates for the slab test.
_BAND = 2 * EPSILON
_BOX_ULPS = 8 * float(np.finfo(np.float32).eps)


def accept_bounds(v0, e1, e2):
    """float32 (lo, hi) (T, 3) boxes holding every point the acceptance
    rule of `intersect_triangles` can accept on each triangle."""
    v0, e1, e2 = (np.asarray(a, np.float64) for a in (v0, e1, e2))
    b = _BAND
    pts = np.stack([v0 - b * (e1 + e2), v0 + (1 + 2 * b) * e1 - b * e2,
                    v0 - b * e1 + (1 + 2 * b) * e2], axis=1)
    lo, hi = pts.min(axis=1), pts.max(axis=1)
    pad = _BOX_ULPS * np.maximum(np.abs(lo), np.abs(hi))
    return (lo - pad).astype(np.float32), (hi + pad).astype(np.float32)


class Hit(NamedTuple):
    """Wavefront hit record (SoA HitInfo, Ray.h:21-38)."""
    t: jax.Array          # (N,) f32, _BIG when miss
    prim_type: jax.Array  # (N,) i32
    prim_id: jax.Array    # (N,) i32
    hit: jax.Array        # (N,) bool


def _ray6(o: jax.Array, d: jax.Array) -> jax.Array:
    """Per-ray Pluecker 6-vector [d, cross(o, d)]."""
    return jnp.concatenate([d, jnp.cross(o, d)], axis=-1)


def _ray4(o: jax.Array) -> jax.Array:
    return jnp.concatenate([o, jnp.ones_like(o[..., :1])], axis=-1)


def intersect_triangles(pack: TrianglePack, o: jax.Array, d: jax.Array,
                        tmin, tmax, tri_block: int = 2048) -> Hit:
    """Closest-hit of N rays against every triangle in `pack`.

    o, d: (N, 3). tmin/tmax: scalar or (N,). Scans triangle blocks of
    `tri_block` keeping a running (t, id) min per ray.

    DETACHED for AD (custom zero VJP, see `detach_tri_hit`): triangle
    winners' continuous quantities are recomputed differentiably in
    ops/surface.py from the gathered primitive, so the t gradient here
    is never consumed — detaching keeps JAX from linearizing the
    traversal scan (residuals per block step otherwise dominate
    backward compile time and memory).
    """
    return detach_tri_hit(_intersect_triangles_impl, pack, o, d,
                          tmin, tmax, tri_block)


def _intersect_triangles_impl(pack: TrianglePack, o: jax.Array, d: jax.Array,
                              tmin, tmax, tri_block: int = 2048) -> Hit:
    n = o.shape[0]
    t_total = pack.num_tris
    assert t_total % 128 == 0, "TrianglePack must be padded to 128"
    # largest multiple of 128 <= tri_block that divides t_total
    tb = min(tri_block, t_total)
    while t_total % tb != 0:
        tb -= 128
    n_blocks = t_total // tb

    r6 = _ray6(o, d)                       # (N, 6)
    r4 = _ray4(o)                          # (N, 4)
    tmin = jnp.broadcast_to(jnp.asarray(tmin, o.dtype), (n,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, o.dtype), (n,))

    w6 = pack.w6.reshape(6, n_blocks, tb, 3)
    w4 = pack.w4.reshape(4, n_blocks, tb)
    valid = pack.valid.reshape(n_blocks, tb)

    def body(carry, blk):
        best_t, best_id = carry
        w6b, w4b, vb, base = blk
        nums = jnp.dot(r6, w6b.reshape(6, tb * 3),
                       preferred_element_type=jnp.float32,
                       precision=_HIGHEST)
        nums = nums.reshape(n, tb, 3)
        t_num = jnp.dot(r4, w4b, preferred_element_type=jnp.float32,
                        precision=_HIGHEST)                      # (N,TB)
        den = nums[:, :, 2]
        safe_den = jnp.where(jnp.abs(den) < _DEN_TINY, 1.0, den)
        inv_den = 1.0 / safe_den
        beta = nums[:, :, 0] * inv_den
        gamma = nums[:, :, 1] * inv_den
        t = t_num * inv_den
        ok = ((beta >= -EPSILON) & (gamma >= -EPSILON)
              & (beta + gamma <= 1.0 + EPSILON)
              & (t >= tmin[:, None]) & (t <= tmax[:, None])
              & (jnp.abs(den) >= _DEN_TINY) & vb[None, :])
        tm = jnp.where(ok, t, _BIG)
        bmin = jnp.min(tm, axis=1)
        barg = jnp.argmin(tm, axis=1).astype(jnp.int32) + base
        better = bmin < best_t
        return (jnp.where(better, bmin, best_t),
                jnp.where(better, barg, best_id)), None

    bases = jnp.arange(n_blocks, dtype=jnp.int32) * tb
    init = (jnp.full((n,), _BIG), jnp.zeros((n,), jnp.int32))
    (best_t, best_id), _ = jax.lax.scan(
        body, init, (jnp.moveaxis(w6, 1, 0), jnp.moveaxis(w4, 1, 0),
                     valid, bases))
    hit = best_t < _BIG
    return Hit(t=best_t, prim_type=jnp.where(hit, PRIM_TRI, PRIM_NONE),
               prim_id=best_id, hit=hit)


def detach_tri_hit(impl, pack, o, d, tmin, tmax, *extra):
    """Run a triangle closest-hit `impl` under stop_gradient.

    Hit outputs are discrete selections; the winner's continuous
    surface math is recomputed differentiably downstream
    (ops/surface.py), so zero cotangents here are exact — and AD never
    builds the adjoint of the traversal loop."""
    pack, o, d, tmin, tmax = jax.lax.stop_gradient((pack, o, d, tmin, tmax))
    return impl(pack, o, d, tmin, tmax, *extra)


def intersect_spheres(pool: SpherePool, o: jax.Array, d: jax.Array,
                      tmin, tmax) -> Hit:
    """Quadratic-formula sphere intersection (Sphere.cpp:27-69)."""
    n = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, o.dtype), (n,))[:, None]
    tmax = jnp.broadcast_to(jnp.asarray(tmax, o.dtype), (n,))[:, None]
    to_o = o[:, None, :] - pool.center[None, :, :]        # (N, S, 3)
    a = jnp.sum(d * d, axis=-1)[:, None]
    b = 2.0 * jnp.sum(d[:, None, :] * to_o, axis=-1)
    c = jnp.sum(to_o * to_o, axis=-1) - pool.radius[None, :] ** 2
    disc = b * b - 4.0 * a * c
    has_real = disc >= 0.0
    sq = jnp.sqrt(jnp.where(has_real, disc, 0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    ok0 = (t0 > tmin) & (t0 < tmax)
    ok1 = (t1 > tmin) & (t1 < tmax)
    t = jnp.where(ok0, t0, t1)
    ok = has_real & (ok0 | ok1) & pool.valid[None, :]
    tm = jnp.where(ok, t, _BIG)
    best_t = jnp.min(tm, axis=1)
    best_id = jnp.argmin(tm, axis=1).astype(jnp.int32)
    hit = best_t < _BIG
    return Hit(t=best_t, prim_type=jnp.where(hit, PRIM_SPHERE, PRIM_NONE),
               prim_id=best_id, hit=hit)


def intersect_planes(pool: PlanePool, o: jax.Array, d: jax.Array,
                     tmin, tmax) -> Hit:
    """Infinite-plane intersection (Plane.cpp:32-48); planes are the
    reference's unbounded list scanned after the BVH (Scene.cpp:219-230)."""
    n = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, o.dtype), (n,))[:, None]
    tmax = jnp.broadcast_to(jnp.asarray(tmax, o.dtype), (n,))[:, None]
    ndotd = jnp.einsum("nk,pk->np", d, pool.normal, precision=_HIGHEST)
    safe = jnp.where(jnp.abs(ndotd) < 1e-6, 1.0, ndotd)
    num = jnp.einsum("pk,npk->np", pool.normal,
                     pool.origin[None, :, :] - o[:, None, :],
                     precision=_HIGHEST)
    t = num / safe
    ok = (jnp.abs(ndotd) >= 1e-6) & (t >= tmin) & (t <= tmax) \
        & pool.valid[None, :]
    tm = jnp.where(ok, t, _BIG)
    best_t = jnp.min(tm, axis=1)
    best_id = jnp.argmin(tm, axis=1).astype(jnp.int32)
    hit = best_t < _BIG
    return Hit(t=best_t, prim_type=jnp.where(hit, PRIM_PLANE, PRIM_NONE),
               prim_id=best_id, hit=hit)


def intersect_blpatches(pool, o: jax.Array, d: jax.Array,
                        tmin, tmax) -> Hit:
    """Bilinear patch intersection (implements the reference's dead
    BLPatch API, BLPatch.cpp:19-24, for real).

    With S(u,v) = uv*A + u*B + v*C + E (A = p11-p10-p01+p00,
    B = p10-p00, C = p01-p00, E = p00), the parallel condition
    cross(S - o, d) = 0 gives, per component,
        uv*Ax + u*Bx + v*Cx + Qx = 0   (X = cross(X3, d), Q = E - o)
    eliminating u between two components yields a quadratic in v; u
    follows linearly and t from the largest-|d| component. Both roots
    are tested; the closer valid (u, v in [0,1], t in range) wins.
    """
    n = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, o.dtype), (n,))[:, None]
    tmax = jnp.broadcast_to(jnp.asarray(tmax, o.dtype), (n,))[:, None]

    a3 = pool.p11 - pool.p10 - pool.p01 + pool.p00    # (B, 3)
    b3 = pool.p10 - pool.p00
    c3 = pool.p01 - pool.p00
    e3 = pool.p00

    # broadcast rays against patches: (N, B, 3)
    dN = d[:, None, :]
    A = jnp.cross(jnp.broadcast_to(a3, (n,) + a3.shape), dN)
    B = jnp.cross(jnp.broadcast_to(b3, (n,) + b3.shape), dN)
    C = jnp.cross(jnp.broadcast_to(c3, (n,) + c3.shape), dN)
    Q = jnp.cross(e3[None] - o[:, None, :], dN)

    # pick the two components excluding the largest |d| axis (best
    # conditioning: that axis has the smallest cross contributions)
    k = jnp.argmax(jnp.abs(d), axis=-1)               # (N,)
    i_idx = (k + 1) % 3
    j_idx = (k + 2) % 3
    take = lambda M, idx: jnp.take_along_axis(
        M, idx[:, None, None], axis=2)[..., 0]
    Ai, Aj = take(A, i_idx), take(A, j_idx)
    Bi, Bj = take(B, i_idx), take(B, j_idx)
    Ci, Cj = take(C, i_idx), take(C, j_idx)
    Qi, Qj = take(Q, i_idx), take(Q, j_idx)

    qa = Ci * Aj - Cj * Ai
    qb = Ci * Bj + Qi * Aj - Cj * Bi - Qj * Ai
    qc = Qi * Bj - Qj * Bi

    disc = qb * qb - 4.0 * qa * qc
    has_real = disc >= 0.0
    sq = jnp.sqrt(jnp.where(has_real, disc, 0.0))
    lin = jnp.abs(qa) < 1e-12
    safe_qa = jnp.where(lin, 1.0, qa)
    safe_qb = jnp.where(jnp.abs(qb) < 1e-20, 1.0, qb)
    v_lin = -qc / safe_qb
    roots = [jnp.where(lin, v_lin, (-qb - sq) / (2.0 * safe_qa)),
             jnp.where(lin, jnp.full_like(v_lin, -1.0),
                       (-qb + sq) / (2.0 * safe_qa))]

    eps = 1e-5
    best_t = jnp.full((n, pool.p00.shape[0]), _BIG)
    best_u = jnp.zeros_like(best_t)
    best_v = jnp.zeros_like(best_t)
    dk = jnp.take_along_axis(d, k[:, None], axis=1)   # (N, 1)
    safe_dk = jnp.where(jnp.abs(dk) < 1e-20, 1.0, dk)
    for v in roots:
        denom_u = v * Ai + Bi
        alt = jnp.abs(v * Aj + Bj) > jnp.abs(denom_u)
        u = jnp.where(alt,
                      -(v * Cj + Qj) / jnp.where(jnp.abs(v * Aj + Bj) < 1e-20,
                                                 1.0, v * Aj + Bj),
                      -(v * Ci + Qi) / jnp.where(jnp.abs(denom_u) < 1e-20,
                                                 1.0, denom_u))
        s = (u * v)[..., None] * a3 + u[..., None] * b3 \
            + v[..., None] * c3 + e3
        sk = jnp.take_along_axis(s - o[:, None, :], k[:, None, None],
                                 axis=2)[..., 0]
        t = sk / safe_dk
        ok = (has_real | lin) & (u >= -eps) & (u <= 1 + eps) \
            & (v >= -eps) & (v <= 1 + eps) \
            & (t >= tmin) & (t <= tmax) & pool.valid[None, :]
        better = ok & (t < best_t)
        best_t = jnp.where(better, t, best_t)
        best_u = jnp.where(better, u, best_u)
        best_v = jnp.where(better, v, best_v)

    tm = best_t
    bmin = jnp.min(tm, axis=1)
    barg = jnp.argmin(tm, axis=1).astype(jnp.int32)
    hit = bmin < _BIG
    return Hit(t=bmin, prim_type=jnp.where(hit, PRIM_BLPATCH, PRIM_NONE),
               prim_id=barg, hit=hit)


def _merge(a: Hit, b: Hit) -> Hit:
    """Keep the closer hit (Scene.cpp:224: strict <, first wins ties)."""
    b_better = b.hit & (~a.hit | (b.t < a.t))
    return Hit(t=jnp.where(b_better, b.t, a.t),
               prim_type=jnp.where(b_better, b.prim_type, a.prim_type),
               prim_id=jnp.where(b_better, b.prim_id, a.prim_id),
               hit=a.hit | b.hit)


def closest_hit(tris: TrianglePack, spheres: SpherePool, planes: PlanePool,
                o: jax.Array, d: jax.Array, tmin=0.0, tmax=MIRO_TMAX,
                tri_block: int = 2048, blpatches=None) -> Hit:
    """Scene::trace equivalent (Scene.cpp:214-231): accelerated pass
    over bounded prims then the unbounded plane list."""
    h = intersect_triangles(tris, o, d, tmin, tmax, tri_block)
    h = _merge(h, intersect_spheres(spheres, o, d, tmin, tmax))
    h = _merge(h, intersect_planes(planes, o, d, tmin, tmax))
    if blpatches is not None:
        h = _merge(h, intersect_blpatches(blpatches, o, d, tmin, tmax))
    return h
