"""Scene geometry as SoA pytrees (replaces the reference's
Object/Sphere/Triangle/Plane virtual-dispatch hierarchy, Object.h:10-49).

TrianglePack holds the Pluecker precompute of the ray x triangle
intersector (see ops/intersect.py): the reference packs 4 triangles per
SSE leaf with precomputed A, B-A, C-A and normals (BVH.cpp:91-166); we
do the same precompute for ALL triangles, padded to 128-row blocks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class Mesh(NamedTuple):
    """Loaded OBJ mesh arrays (TriangleMesh.h SoA layout)."""
    vertices: jax.Array   # (V, 3) f32
    normals: jax.Array    # (N, 3) f32
    texcoords: jax.Array  # (TC, 2) f32 (may be empty)
    tri_vidx: jax.Array   # (T, 3) i32
    tri_nidx: jax.Array   # (T, 3) i32
    tri_tidx: jax.Array   # (T, 3) i32, -1 when absent


class TrianglePack(NamedTuple):
    """All scene triangles, padded to a block multiple, with Pluecker
    precompute for the matmul intersector.

    For ray (o, d) with moment m = cross(o, d), and triangle
    (A, e1=B-A, e2=C-A, n=cross(e1, e2)):
        den       = dot(-d, n)                      (Triangle.cpp:152)
        t * den   = dot(o, n) - dot(A, n)           (Triangle.cpp:154)
        beta*den  = dot(m, e2) + dot(d, cross(A,e2))(Triangle.cpp:155)
        gamma*den = -dot(m, e1) + dot(d, cross(e1,A))(Triangle.cpp:156)
    so beta/gamma/den are one (N,6)@(6,3T) matmul and t is (N,4)@(4,T).
    """
    # Raw per-triangle data (used for shading recompute + grads)
    v0: jax.Array         # (T, 3)
    e1: jax.Array         # (T, 3)
    e2: jax.Array         # (T, 3)
    n_geo: jax.Array      # (T, 3) unnormalized cross(e1, e2)
    # Vertex shading normals per corner
    n0: jax.Array         # (T, 3)
    n1: jax.Array         # (T, 3)
    n2: jax.Array         # (T, 3)
    # Texcoords per corner (0 when absent)
    t0: jax.Array         # (T, 2)
    t1: jax.Array         # (T, 2)
    t2: jax.Array         # (T, 2)
    has_uv: jax.Array     # (T,) bool
    material_id: jax.Array  # (T,) i32
    # Pluecker matmul operands
    w6: jax.Array         # (6, T, 3) -> [beta | gamma | den] numerators
    w4: jax.Array         # (4, T)    -> t numerator
    valid: jax.Array      # (T,) bool (False for padding)

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


class SpherePool(NamedTuple):
    """All spheres (Sphere.h/.cpp) as arrays."""
    center: jax.Array      # (S, 3)
    radius: jax.Array      # (S,)
    material_id: jax.Array  # (S,) i32
    valid: jax.Array       # (S,) bool


class PlanePool(NamedTuple):
    """All infinite planes (Plane.h/.cpp) — unbounded objects that
    bypass the accelerator (Scene.cpp:219-230)."""
    origin: jax.Array      # (P, 3)
    normal: jax.Array      # (P, 3)
    material_id: jax.Array  # (P,) i32
    valid: jax.Array       # (P,) bool


class BLPatchPool(NamedTuple):
    """Bilinear patches. The reference declares BLPatch but its
    intersect is a stub returning false (BLPatch.cpp:19-24); here it is
    implemented properly (Ramsey-style quadratic solve, see
    ops/intersect.py:intersect_blpatches). Corner layout:
    S(u,v) = (1-u)(1-v)p00 + u(1-v)p10 + (1-u)v p01 + uv p11."""
    p00: jax.Array         # (B, 3)
    p10: jax.Array         # (B, 3)
    p01: jax.Array         # (B, 3)
    p11: jax.Array         # (B, 3)
    material_id: jax.Array  # (B,) i32
    valid: jax.Array       # (B,) bool


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)


def pack_triangles(meshes: list[tuple[dict, int]], block: int = 128,
                   reorder: Optional[np.ndarray] = None) -> TrianglePack:
    """Build a TrianglePack from [(obj_dict, material_id), ...].

    obj_dict is load_obj() output. Triangles from all meshes are
    concatenated, optionally reordered (Morton order for the clustered
    accelerator), and padded to a multiple of `block` with degenerate
    triangles (n_geo = 0 -> den = 0 -> never hit).
    """
    v0s, e1s, e2s, n0s, n1s, n2s, t0s, t1s, t2s, uvs, mats = \
        [], [], [], [], [], [], [], [], [], [], []
    for obj, mat_id in meshes:
        v = obj["vertices"].astype(np.float64)
        n = obj["normals"].astype(np.float64)
        tc = obj["texcoords"]
        vi = obj["tri_vidx"]
        ni = obj["tri_nidx"]
        ti = obj["tri_tidx"]
        a, b, c = v[vi[:, 0]], v[vi[:, 1]], v[vi[:, 2]]
        v0s.append(a)
        e1s.append(b - a)
        e2s.append(c - a)
        n0s.append(n[ni[:, 0]])
        n1s.append(n[ni[:, 1]])
        n2s.append(n[ni[:, 2]])
        has = ti[:, 0] >= 0
        uvs.append(has)
        if tc.shape[0] > 0:
            tis = np.where(ti >= 0, ti, 0)
            t0s.append(tc[tis[:, 0]])
            t1s.append(tc[tis[:, 1]])
            t2s.append(tc[tis[:, 2]])
        else:
            z = np.zeros((vi.shape[0], 2), np.float32)
            t0s.append(z)
            t1s.append(z)
            t2s.append(z)
        mats.append(np.full((vi.shape[0],), mat_id, np.int32))

    v0 = np.concatenate(v0s)
    e1 = np.concatenate(e1s)
    e2 = np.concatenate(e2s)
    n0 = np.concatenate(n0s)
    n1 = np.concatenate(n1s)
    n2 = np.concatenate(n2s)
    t0 = np.concatenate(t0s).astype(np.float32)
    t1 = np.concatenate(t1s).astype(np.float32)
    t2 = np.concatenate(t2s).astype(np.float32)
    has_uv = np.concatenate(uvs)
    mat = np.concatenate(mats)

    t_count = v0.shape[0]
    if reorder is not None:
        perm = np.asarray(reorder)
        v0, e1, e2 = v0[perm], e1[perm], e2[perm]
        n0, n1, n2 = n0[perm], n1[perm], n2[perm]
        t0, t1, t2 = t0[perm], t1[perm], t2[perm]
        has_uv, mat = has_uv[perm], mat[perm]

    padded = ((t_count + block - 1) // block) * block
    v0 = _pad_to(v0, padded)
    e1 = _pad_to(e1, padded)
    e2 = _pad_to(e2, padded)
    n0 = _pad_to(n0, padded)
    n1 = _pad_to(n1, padded)
    n2 = _pad_to(n2, padded)
    t0 = _pad_to(t0, padded)
    t1 = _pad_to(t1, padded)
    t2 = _pad_to(t2, padded)
    has_uv = _pad_to(has_uv, padded)
    mat = _pad_to(mat, padded)
    valid = np.arange(padded) < t_count

    return build_pack_from_arrays(v0, e1, e2, n0, n1, n2, t0, t1, t2,
                                  has_uv, mat, valid)


def plucker_operands(v0, e1, e2, n_geo=None):
    """The matmul intersector's operands from raw triangle data:
    w6 (6, T, 3) rows [d(0:3), m(3:6)], columns [beta, gamma, den];
    w4 (4, T) for the t numerator. Differentiable under jnp inputs."""
    xp = jnp if isinstance(v0, jax.Array) else np
    if n_geo is None:
        n_geo = xp.cross(e1, e2)
    a_x_e2 = xp.cross(v0, e2)
    e1_x_a = xp.cross(e1, v0)
    w6 = xp.stack([
        xp.stack([a_x_e2[:, 0], e1_x_a[:, 0], -n_geo[:, 0]], axis=-1),
        xp.stack([a_x_e2[:, 1], e1_x_a[:, 1], -n_geo[:, 1]], axis=-1),
        xp.stack([a_x_e2[:, 2], e1_x_a[:, 2], -n_geo[:, 2]], axis=-1),
        xp.stack([e2[:, 0], -e1[:, 0], xp.zeros_like(e1[:, 0])], axis=-1),
        xp.stack([e2[:, 1], -e1[:, 1], xp.zeros_like(e1[:, 1])], axis=-1),
        xp.stack([e2[:, 2], -e1[:, 2], xp.zeros_like(e1[:, 2])], axis=-1),
    ], axis=0)  # (6, T, 3)
    w4 = xp.stack([n_geo[:, 0], n_geo[:, 1], n_geo[:, 2],
                   -xp.sum(v0 * n_geo, axis=-1)], axis=0)  # (4, T)
    return w6, w4


def build_pack_from_arrays(v0, e1, e2, n0, n1, n2, t0, t1, t2,
                           has_uv, mat, valid) -> TrianglePack:
    """Assemble the Pluecker operands (differentiable w.r.t. vertices
    when called with jnp inputs — geometry gradients flow through w6/w4)."""
    xp = jnp if isinstance(v0, jax.Array) else np
    n_geo = xp.cross(e1, e2)
    w6, w4 = plucker_operands(v0, e1, e2, n_geo=n_geo)

    f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
    return TrianglePack(
        v0=f32(v0), e1=f32(e1), e2=f32(e2), n_geo=f32(n_geo),
        n0=f32(n0), n1=f32(n1), n2=f32(n2),
        t0=f32(t0), t1=f32(t1), t2=f32(t2),
        has_uv=jnp.asarray(has_uv, dtype=bool),
        material_id=jnp.asarray(mat, dtype=jnp.int32),
        w6=f32(w6), w4=f32(w4),
        valid=jnp.asarray(valid, dtype=bool),
    )


def make_sphere_pool(centers, radii, material_ids) -> SpherePool:
    centers = np.atleast_2d(np.asarray(centers, np.float32))
    radii = np.atleast_1d(np.asarray(radii, np.float32))
    mids = np.atleast_1d(np.asarray(material_ids, np.int32))
    return SpherePool(center=jnp.asarray(centers), radius=jnp.asarray(radii),
                      material_id=jnp.asarray(mids),
                      valid=jnp.ones((len(radii),), dtype=bool))


def make_plane_pool(origins, normals, material_ids) -> PlanePool:
    origins = np.atleast_2d(np.asarray(origins, np.float32))
    normals = np.atleast_2d(np.asarray(normals, np.float32))
    mids = np.atleast_1d(np.asarray(material_ids, np.int32))
    return PlanePool(origin=jnp.asarray(origins), normal=jnp.asarray(normals),
                     material_id=jnp.asarray(mids),
                     valid=jnp.ones((origins.shape[0],), dtype=bool))


def empty_sphere_pool() -> SpherePool:
    return SpherePool(center=jnp.zeros((1, 3), jnp.float32),
                      radius=jnp.ones((1,), jnp.float32),
                      material_id=jnp.zeros((1,), jnp.int32),
                      valid=jnp.zeros((1,), dtype=bool))


def empty_plane_pool() -> PlanePool:
    return PlanePool(origin=jnp.zeros((1, 3), jnp.float32),
                     normal=jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
                     material_id=jnp.zeros((1,), jnp.int32),
                     valid=jnp.zeros((1,), dtype=bool))


def make_blpatch_pool(p00, p10, p01, p11, material_ids) -> BLPatchPool:
    f = lambda x: jnp.asarray(np.atleast_2d(np.asarray(x, np.float32)))
    mids = np.atleast_1d(np.asarray(material_ids, np.int32))
    return BLPatchPool(p00=f(p00), p10=f(p10), p01=f(p01), p11=f(p11),
                       material_id=jnp.asarray(mids),
                       valid=jnp.ones((len(mids),), dtype=bool))


def empty_blpatch_pool() -> BLPatchPool:
    z = jnp.zeros((1, 3), jnp.float32)
    return BLPatchPool(p00=z, p10=z, p01=z, p11=z,
                       material_id=jnp.zeros((1,), jnp.int32),
                       valid=jnp.zeros((1,), dtype=bool))


def empty_triangle_pack(block: int = 128) -> TrianglePack:
    z3 = np.zeros((block, 3), np.float32)
    z2 = np.zeros((block, 2), np.float32)
    return build_pack_from_arrays(
        z3, z3, z3, z3, z3, z3, z2, z2, z2,
        np.zeros((block,), bool), np.zeros((block,), np.int32),
        np.zeros((block,), bool))
