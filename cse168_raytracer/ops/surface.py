"""Hit -> shading surface reconstruction (differentiable).

Given the discrete winner (prim_type, prim_id) from ops/intersect.py,
recompute P, shading normal, UV and material id by gathering that one
primitive and redoing the continuous math, so gradients flow to
vertices/centers/normals while the winner index stays detached.

Semantics parity:
- Triangle P = A + beta*e1 + gamma*e2 and UNNORMALIZED interpolated
  normal (Triangle.cpp:160-162); normalization happens in the bump
  step (Scene.cpp:234-263), which for materials with zero bump height
  reduces to plain normalization — reproduced in shading.apply_bump.
- Triangle UV: Cramer's rule discarding the "largest" normal axis with
  the reference's exact (signed, quirky) axis choice and >=0 clamps
  (Triangle.cpp:172-222).
- Sphere P = o + t*d, N = normalize(P - center) (Sphere.cpp:63-66),
  spherical UV (Sphere.cpp:83-95).
- Plane N = plane normal, UV = (x, z) of P (Plane.cpp:50-60).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cse168_raytracer.config import PI
from cse168_raytracer.core.fastgather import select_component, take_rows
from cse168_raytracer.core.vecmath import dotk, safe_normalize
from cse168_raytracer.models.geometry import (PlanePool, SpherePool,
                                              TrianglePack)
from cse168_raytracer.ops.intersect import (PRIM_PLANE, PRIM_SPHERE,
                                            PRIM_TRI, Hit)


class Surface(NamedTuple):
    """Wavefront shading-point record."""
    p: jax.Array            # (N, 3) hit point
    n: jax.Array            # (N, 3) shading normal (pre-bump, may be unnormalized)
    geo_n: jax.Array        # (N, 3) geometric normal (unnormalized)
    uv: jax.Array           # (N, 2)
    material_id: jax.Array  # (N,) i32
    hit: jax.Array          # (N,) bool


def pack_attr_rows(pack: TrianglePack) -> jax.Array:
    """The (T, 29) fused attribute table _tri_surface gathers from.
    Rebuilt per trace (NOT cached on the pack): callers differentiate
    through pack fields (vertex/normal/uv gradients), so a cached table
    would be stale under traced field replacement and would silently
    detach those gradients."""
    return jnp.concatenate([
        pack.v0, pack.e1, pack.e2, pack.n_geo,
        pack.n0, pack.n1, pack.n2,
        pack.t0, pack.t1, pack.t2,
        pack.has_uv[:, None].astype(jnp.float32),
        pack.material_id[:, None].astype(jnp.float32),
    ], axis=1)


def _tri_surface(pack: TrianglePack, o, d, tri_id):
    # ONE fused row gather for every per-triangle attribute (and one
    # scatter-add adjoint in the backward) instead of twelve; the
    # layout is sliced back apart below.
    attr = pack_attr_rows(pack)
    g = attr[tri_id]                            # (N, 29)
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    n_geo = g[:, 9:12]
    n0, n1, n2 = g[:, 12:15], g[:, 15:18], g[:, 18:21]
    t0, t1, t2 = g[:, 21:23], g[:, 23:25], g[:, 25:27]
    has_uv = g[:, 27] > 0.5
    mat_id = jnp.round(g[:, 28]).astype(jnp.int32)

    den = jnp.sum(-d * n_geo, axis=-1)
    safe_den = jnp.where(jnp.abs(den) < 1e-30, 1.0, den)
    om_a = o - v0
    beta = jnp.sum(-d * jnp.cross(om_a, e2), axis=-1) / safe_den
    gamma = jnp.sum(-d * jnp.cross(e1, om_a), axis=-1) / safe_den
    p = v0 + beta[:, None] * e1 + gamma[:, None] * e2   # Triangle.cpp:160
    n = ((1.0 - beta - gamma)[:, None] * n0
         + beta[:, None] * n1
         + gamma[:, None] * n2)                         # Triangle.cpp:162

    # UV (Triangle.cpp:190-221): discard "largest" normal axis.
    # Reference: i=0, j=1; if (n.x > n.z) i=2; else if (n.y > n.z) j=2.
    i_idx = jnp.where(n_geo[:, 0] > n_geo[:, 2], 2, 0)
    j_idx = jnp.where((n_geo[:, 0] > n_geo[:, 2]),
                      1, jnp.where(n_geo[:, 1] > n_geo[:, 2], 2, 1))
    pv = p - v0
    # component select by index: a where-chain instead of
    # take_along_axis (a gather per call)
    take = select_component
    p_i, p_j = take(pv, i_idx), take(pv, j_idx)
    b_i, b_j = take(e1, i_idx), take(e1, j_idx)
    c_i, c_j = take(e2, i_idx), take(e2, j_idx)
    det_pc = p_i * c_j - c_i * p_j
    det_bp = b_i * p_j - p_i * b_j
    det_bc = b_i * c_j - c_i * b_j
    safe_bc = jnp.where(jnp.abs(det_bc) < 1e-30, 1.0, det_bc)
    ub = jnp.maximum(det_pc / safe_bc, 0.0)
    ug = jnp.maximum(det_bp / safe_bc, 0.0)
    ua = jnp.maximum(1.0 - (ub + ug), 0.0)
    uv = (ua[:, None] * t0 + ub[:, None] * t1 + ug[:, None] * t2)
    # meshes without texcoords return (0,0) (Triangle.cpp:174-175)
    uv = jnp.where(has_uv[:, None], uv, 0.0)
    return p, n, n_geo, uv, mat_id


def _sphere_surface(pool: SpherePool, o, d, t, sph_id):
    # `t` from the traversal is DETACHED (discrete winner); recompute it
    # differentiably from the quadratic so d(P)/d(ray, center, radius)
    # is exact (picking the root nearest the detached t keeps the same
    # discrete solution).
    c = take_rows(pool.center, sph_id)
    r = take_rows(pool.radius, sph_id)
    oc = o - c
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(d * oc, axis=-1)
    cc = jnp.sum(oc * oc, axis=-1) - r ** 2
    disc = b * b - 4.0 * a * cc
    root = jnp.where(disc > 0,
                     jnp.sqrt(jnp.where(disc > 0, disc, 1.0)), 0.0)
    t0 = (-b - root) / (2.0 * a)
    t1 = (-b + root) / (2.0 * a)
    t_re = jnp.where(jnp.abs(t0 - jax.lax.stop_gradient(t))
                     <= jnp.abs(t1 - jax.lax.stop_gradient(t)), t0, t1)
    # non-sphere / miss lanes (disc<=0 or garbage id): detached t
    t_use = jnp.where(disc > 0, t_re, t)
    p = o + t_use[:, None] * d
    n = p - c
    n_unit = safe_normalize(n)
    u = jnp.arctan2(n_unit[:, 0], n_unit[:, 2]) / (2.0 * PI) + 0.5
    v = jnp.clip(jnp.arcsin(jnp.clip(n_unit[:, 1], -1.0, 1.0)),
                 -PI / 2, PI / 2) / PI + 0.5
    return (p, n_unit, n, jnp.stack([u, v], axis=-1),
            take_rows(pool.material_id, sph_id))


def _plane_surface(pool: PlanePool, o, d, t, pl_id):
    # recompute t differentiably (see _sphere_surface note)
    nrm = take_rows(pool.normal, pl_id)
    org = take_rows(pool.origin, pl_id)
    ndotd = jnp.sum(nrm * d, axis=-1)
    safe = jnp.where(jnp.abs(ndotd) < 1e-6, 1.0, ndotd)
    t_re = jnp.sum(nrm * (org - o), axis=-1) / safe
    t_use = jnp.where(jnp.abs(ndotd) >= 1e-6, t_re, t)
    p = o + t_use[:, None] * d
    uv = jnp.stack([p[:, 0], p[:, 2]], axis=-1)   # Plane.cpp:50-60
    return p, nrm, nrm, uv, take_rows(pool.material_id, pl_id)


def _blpatch_surface(pool, o, d, t, bp_id):
    """Bilinear patch shading data at the recorded hit t: solve (u, v)
    for the winning patch from P = o + t*d (Newton on the bilinear
    system — 4 iterations from the patch center), normal = Su x Sv."""
    p00 = take_rows(pool.p00, bp_id)
    p10 = take_rows(pool.p10, bp_id)
    p01 = take_rows(pool.p01, bp_id)
    a3 = take_rows(pool.p11, bp_id) - p10 - p01 + p00
    b3 = p10 - p00
    c3 = p01 - p00
    p = o + t[:, None] * d
    rhs = p - p00
    u = jnp.full(t.shape, 0.5)
    v = jnp.full(t.shape, 0.5)
    for _ in range(4):
        su = v[:, None] * a3 + b3
        sv = u[:, None] * a3 + c3
        r = (u * v)[:, None] * a3 + u[:, None] * b3 + v[:, None] * c3 - rhs
        # 2x2 normal equations of the Jacobian [su, sv]
        a11 = jnp.sum(su * su, -1)
        a12 = jnp.sum(su * sv, -1)
        a22 = jnp.sum(sv * sv, -1)
        g1 = jnp.sum(su * r, -1)
        g2 = jnp.sum(sv * r, -1)
        det = a11 * a22 - a12 * a12
        det = jnp.where(jnp.abs(det) < 1e-20, 1.0, det)
        u = u - (a22 * g1 - a12 * g2) / det
        v = v - (a11 * g2 - a12 * g1) / det
    u = jnp.clip(u, 0.0, 1.0)
    v = jnp.clip(v, 0.0, 1.0)
    su = v[:, None] * a3 + b3
    sv = u[:, None] * a3 + c3
    n = jnp.cross(su, sv)
    # differentiable hit position: project the ray onto the local
    # tangent plane at S(u,v) (t from the traversal is detached; this
    # restores d(P)/d(ray, corners) to first order)
    s_uv = (u * v)[:, None] * a3 + u[:, None] * b3 + v[:, None] * c3 + p00
    ndotd = jnp.sum(n * d, axis=-1)
    safe = jnp.where(jnp.abs(ndotd) < 1e-12, 1.0, ndotd)
    t_re = jnp.sum(n * (s_uv - o), axis=-1) / safe
    t_use = jnp.where(jnp.abs(ndotd) >= 1e-12, t_re, t)
    p = o + t_use[:, None] * d
    return (p, n, n, jnp.stack([u, v], axis=-1),
            take_rows(pool.material_id, bp_id))


def make_surface(tris: TrianglePack, spheres: SpherePool, planes: PlanePool,
                 o: jax.Array, d: jax.Array, hit: Hit,
                 blpatches=None) -> Surface:
    """Build the Surface record for a wavefront of rays, branch-free
    over primitive type (lax.switch would serialize; masks are cheap)."""
    from cse168_raytracer.ops.intersect import PRIM_BLPATCH
    tri_id = jnp.where(hit.prim_type == PRIM_TRI, hit.prim_id, 0)
    sph_id = jnp.where(hit.prim_type == PRIM_SPHERE, hit.prim_id, 0)
    pl_id = jnp.where(hit.prim_type == PRIM_PLANE, hit.prim_id, 0)
    # miss lanes carry t = _BIG (3e37): P = o + t*d then |P|^2 overflows
    # f32 to inf, and inf forward residuals NaN every backward pass even
    # though the lanes are masked later. Clamp t on misses.
    t_safe = jnp.where(hit.hit, hit.t, 1.0)

    tp, tn, tgn, tuv, tm = _tri_surface(tris, o, d, tri_id)
    sp, sn, sgn, suv, sm = _sphere_surface(spheres, o, d, t_safe, sph_id)
    pp, pn, pgn, puv, pm = _plane_surface(planes, o, d, t_safe, pl_id)

    is_t = (hit.prim_type == PRIM_TRI)[:, None]
    is_s = (hit.prim_type == PRIM_SPHERE)[:, None]

    p = jnp.where(is_t, tp, jnp.where(is_s, sp, pp))
    n = jnp.where(is_t, tn, jnp.where(is_s, sn, pn))
    gn = jnp.where(is_t, tgn, jnp.where(is_s, sgn, pgn))
    uv = jnp.where(is_t, tuv, jnp.where(is_s, suv, puv))
    mat = jnp.where(hit.prim_type == PRIM_TRI, tm,
                    jnp.where(hit.prim_type == PRIM_SPHERE, sm, pm))

    if blpatches is not None:
        bp_id = jnp.where(hit.prim_type == PRIM_BLPATCH, hit.prim_id, 0)
        bp, bn, bgn, buv, bm = _blpatch_surface(blpatches, o, d, t_safe, bp_id)
        is_b = (hit.prim_type == PRIM_BLPATCH)[:, None]
        p = jnp.where(is_b, bp, p)
        n = jnp.where(is_b, bn, n)
        gn = jnp.where(is_b, bgn, gn)
        uv = jnp.where(is_b, buv, uv)
        mat = jnp.where(hit.prim_type == PRIM_BLPATCH, bm, mat)
    # miss lanes carry t = _BIG: P = o + t*d overflows and the garbage
    # UV would NaN procedural noise (inf - inf) — forward NaNs there are
    # masked out later, but their AD residuals poison every gradient.
    # Pin missed lanes to benign values instead.
    ok = hit.hit[:, None]
    up = jnp.array([0.0, 1.0, 0.0], p.dtype)
    p = jnp.where(ok, p, 0.0)
    n = jnp.where(ok, n, up)
    gn = jnp.where(ok, gn, up)
    uv = jnp.where(ok, uv, 0.0)
    return Surface(p=p, n=n, geo_n=gn, uv=uv,
                   material_id=mat.astype(jnp.int32), hit=hit.hit)
