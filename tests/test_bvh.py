"""Hierarchical-BVH tests: the per-ray traversal (ops/bvh.py) must
agree exactly with the brute-force intersector (the reference's correctness bar: BVH::intersect returns
the same hits as testing every object, BVH.cpp:438-658 vs
Triangle.cpp:136-169), and the in-traversal counters must be sane
(Stats.h parity, writeup/A2/Readme.tex:95-102)."""

import numpy as np
import jax.numpy as jnp
import pytest

from cse168_raytracer.models.geometry import pack_triangles
from cse168_raytracer.ops.accel import morton_order, reorder_pack
from cse168_raytracer.ops.bvh import build_bvh, bvh_closest_hit_triangles
from cse168_raytracer.ops.intersect import intersect_triangles
from cse168_raytracer.scenes.registry import model_ctm, torus_knot


@pytest.fixture(scope="module")
def knot_pack():
    """A 3,072-triangle torus knot under a model CTM, Morton-ordered."""
    mesh = torus_knot(ctm=model_ctm(position=(0.3, 1.0, -0.2), rot_y=0.7,
                                    scl=(1.5, 1.5, 1.5)))
    pack = pack_triangles([(mesh, 0)])
    perm = morton_order(np.asarray(pack.v0), np.asarray(pack.e1),
                        np.asarray(pack.e2), np.asarray(pack.valid))
    return reorder_pack(pack, perm)


@pytest.fixture(scope="module")
def rays(knot_pack):
    rng = np.random.default_rng(7)
    n = 2048 + 13   # non-multiple of any tile size: exercises padding
    v = np.asarray(knot_pack.v0)[np.asarray(knot_pack.valid)]
    lo, hi = v.min(0), v.max(0)
    c, ext = (lo + hi) / 2, (hi - lo).max()
    o = (c + rng.normal(0, 2 * ext, (n, 3))).astype(np.float32)
    tgt = (c + rng.normal(0, 0.3 * ext, (n, 3))).astype(np.float32)
    d = tgt - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _check_against_brute(h, h_ref):
    rh = np.asarray(h_ref.hit)
    assert np.array_equal(np.asarray(h.hit), rh)
    both = rh & np.asarray(h.hit)
    np.testing.assert_allclose(np.asarray(h.t)[both],
                               np.asarray(h_ref.t)[both],
                               rtol=1e-4, atol=1e-5)
    # ids may differ only on exact-t ties; require 99%+ agreement
    agree = np.mean(np.asarray(h.prim_id)[both]
                    == np.asarray(h_ref.prim_id)[both])
    assert agree > 0.99


def test_perray_bvh_matches_brute_force(knot_pack, rays):
    o, d = rays
    h_ref = intersect_triangles(knot_pack, o, d, 0.0, 1e10)
    for leaf in (4, 8):
        accel = build_bvh(knot_pack, leaf_size=leaf)
        h = bvh_closest_hit_triangles(accel, o, d, 0.0, 1e10)
        _check_against_brute(h, h_ref)


def test_any_hit_matches_closest_hit_mask(knot_pack, rays):
    o, d = rays
    h_ref = intersect_triangles(knot_pack, o, d, 0.0, 1e10)
    accel = build_bvh(knot_pack, leaf_size=8)
    occ = bvh_closest_hit_triangles(accel, o, d, 0.0, 1e10, any_hit=True)
    assert np.array_equal(np.asarray(occ.hit), np.asarray(h_ref.hit))


def test_any_hit_respects_tmax(knot_pack, rays):
    """Occlusion within [0, t_hit - eps) must NOT count the hit itself
    (shadow-ray semantics, Phong.cpp:92-97)."""
    o, d = rays
    h_ref = intersect_triangles(knot_pack, o, d, 0.0, 1e10)
    accel = build_bvh(knot_pack, leaf_size=8)
    short = jnp.where(h_ref.hit, h_ref.t * 0.5, 1e-3)
    occ = bvh_closest_hit_triangles(accel, o, d, 0.0, short, any_hit=True)
    # a first-hit at t can never be inside [0, t/2]
    assert not np.any(np.asarray(occ.hit) & np.asarray(h_ref.hit)
                      & (np.asarray(occ.t) > np.asarray(short)))


def test_traversal_counters(knot_pack, rays):
    """In-traversal counters: tri tests must be far below brute force
    and node visits sane (the reference's teapot table shows 3.75
    tests/ray at 4 tris/leaf, writeup/A2/Readme.tex:95)."""
    o, d = rays
    n = o.shape[0]
    n_tris = knot_pack.num_tris
    accel = build_bvh(knot_pack, leaf_size=4)
    h, st = bvh_closest_hit_triangles(accel, o, d, 0.0, 1e10,
                                      collect_stats=True)
    assert st.tri_tests.shape == (n,) and st.node_visits.shape == (n,)
    tri_per_ray = float(jnp.sum(st.tri_tests)) / n
    assert 0 < tri_per_ray < n_tris / 10, tri_per_ray
    assert float(jnp.sum(st.node_visits)) / n < 128
    # misses can still descend; hits always reach a leaf
    hit = np.asarray(h.hit)
    assert np.all(np.asarray(st.tri_tests)[hit] >= 4)


def test_empty_interval_rays(knot_pack):
    """Rays with tmax < tmin (the integrator's dead lanes) must miss
    without traversing."""
    o = jnp.zeros((130, 3))
    d = jnp.ones((130, 3)) / np.sqrt(3.0)
    accel = build_bvh(knot_pack, leaf_size=8)
    h, st = bvh_closest_hit_triangles(accel, o, d, 0.0, -1.0,
                                      collect_stats=True)
    assert not np.any(np.asarray(h.hit))
    assert int(jnp.sum(st.node_visits)) == 0
