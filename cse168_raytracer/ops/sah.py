"""Binned-SAH BVH build (host side) — ctypes bridge to the native
builder in csrc/bvh_builder.cpp, with a pure-numpy fallback.

The reference builds its SAH tree in C++ (BVH.cpp:60-339, a 32-step
binary-search split per axis); ours is the standard 16-bin sweep with
the same surface-area cost model. The builder emits

  * nodes (Nn, 14) f32: [loL(3) hiL(3) loR(3) hiR(3) childL childR],
    child links stored as exact small floats (>=0 internal node id,
    <0 => ~leaf id), so a node visit is one row fetch;
  * per leaf, up to LEAF_CAP triangle ids (-1 padded);

and `sah_build_compact` re-orders the TrianglePack so every leaf's
triangles are contiguous rows, with no padding between leaves (the
layout ops/cuda_bvh.py hands the GPU traversal).
"""

from __future__ import annotations

import ctypes

import numpy as np

from cse168_raytracer.models.geometry import (TrianglePack,
                                              build_pack_from_arrays)
from cse168_raytracer.ops.intersect import accept_bounds

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    try:
        from cse168_raytracer import native
        lib = native.load(native.CPU_LIB)
        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 2
        lib.bvh_num_nodes.restype = ctypes.c_int32
        lib.bvh_num_nodes.argtypes = [ctypes.c_void_p]
        lib.bvh_num_leaves.restype = ctypes.c_int32
        lib.bvh_num_leaves.argtypes = [ctypes.c_void_p]
        lib.bvh_max_depth.restype = ctypes.c_int32
        lib.bvh_max_depth.argtypes = [ctypes.c_void_p]
        lib.bvh_export.restype = None
        lib.bvh_export.argtypes = [ctypes.c_void_p] * 3
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib = False
    return _lib


def _sah_native(lo, hi, cent, leaf_cap):
    lib = _load_lib()
    if not lib:
        return None
    n = lo.shape[0]
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    cent = np.ascontiguousarray(cent, np.float32)
    h = lib.bvh_build(lo.ctypes.data_as(ctypes.c_void_p),
                      hi.ctypes.data_as(ctypes.c_void_p),
                      cent.ctypes.data_as(ctypes.c_void_p),
                      np.int32(n), np.int32(leaf_cap))
    nn = lib.bvh_num_nodes(h)
    nl = lib.bvh_num_leaves(h)
    depth = lib.bvh_max_depth(h)
    nodes = np.empty((nn, 14), np.float32)
    leaf_tris = np.empty((nl * leaf_cap,), np.int32)
    lib.bvh_export(h, nodes.ctypes.data_as(ctypes.c_void_p),
                   leaf_tris.ctypes.data_as(ctypes.c_void_p))
    lib.bvh_free(h)
    return nodes, leaf_tris.reshape(nl, leaf_cap), depth


def _sah_numpy(lo, hi, cent, leaf_cap):
    """Recursive median/SAH fallback (same output contract)."""
    n = lo.shape[0]
    nodes = []
    leaves = []
    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    max_depth = [0]

    def build(idx, depth):
        max_depth[0] = max(max_depth[0], depth)
        if idx.shape[0] <= leaf_cap:
            leaf_id = len(leaves)
            pad = np.full(leaf_cap, -1, np.int32)
            pad[:idx.shape[0]] = idx
            leaves.append(pad)
            return ~leaf_id
        c = cent[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        mid = idx.shape[0] // 2
        part = np.argpartition(c[:, axis], mid)
        li, ri = idx[part[:mid]], idx[part[mid:]]
        node_id = len(nodes)
        nodes.append(None)
        cl = build(li, depth + 1)
        cr = build(ri, depth + 1)
        row = np.empty(14, np.float32)
        row[0:3] = lo[li].min(0)
        row[3:6] = hi[li].max(0)
        row[6:9] = lo[ri].min(0)
        row[9:12] = hi[ri].max(0)
        row[12] = cl
        row[13] = cr
        nodes[node_id] = row
        return node_id

    if n == 0:
        leaves.append(np.full(leaf_cap, -1, np.int32))
        row = np.full(14, 1e30, np.float32)
        row[12] = row[13] = float(~0)
        nodes.append(row)
    else:
        r = build(np.arange(n, dtype=np.int32), 0)
        if r < 0:
            row = np.full(14, 1e30, np.float32)
            row[0:3] = lo.min(0)
            row[3:6] = hi.max(0)
            row[12] = r
            leaves.append(np.full(leaf_cap, -1, np.int32))
            row[13] = float(~(len(leaves) - 1))
            nodes = [row]
    sys.setrecursionlimit(old)
    return np.stack(nodes), np.stack(leaves), max_depth[0]


def sah_build_compact(pack: TrianglePack, leaf_cap: int = 4,
                      block: int = 128):
    """Build the SAH tree over `pack`'s valid triangles and re-order the
    pack so each leaf's triangles are contiguous rows.

    Returns (new_pack, nodes (Nn, 14) f32, leaf_first (L,) i32,
    leaf_count (L,) i32, max_depth). Leaf l owns rows
    [leaf_first[l], leaf_first[l] + leaf_count[l]); the valid rows come
    first in leaf order and the pack is padded to a multiple of `block`
    with degenerate rows (valid=False, never hit)."""
    valid = np.asarray(pack.valid)
    v0 = np.asarray(pack.v0, np.float64)[valid]
    e1 = np.asarray(pack.e1, np.float64)[valid]
    e2 = np.asarray(pack.e2, np.float64)[valid]
    orig_idx = np.nonzero(valid)[0]
    # node boxes are unions of these: the acceptance band, not the vertices
    lo, hi = accept_bounds(v0, e1, e2)
    cent = (v0 + (e1 + e2) / 3.0).astype(np.float32)

    out = _sah_native(lo, hi, cent, leaf_cap)
    if out is None:
        out = _sah_numpy(lo, hi, cent, leaf_cap)
    nodes, leaf_tris, depth = out

    leaf_count = (leaf_tris >= 0).sum(axis=1).astype(np.int32)
    leaf_first = (np.cumsum(leaf_count) - leaf_count).astype(np.int32)
    src = orig_idx[leaf_tris[leaf_tris >= 0]]      # row-major = leaf order
    n = src.shape[0]
    n_pad = max(block, -(-n // block) * block)

    def g(a):
        a = np.asarray(a)[src]
        pad = np.zeros((n_pad - n,) + a.shape[1:], a.dtype)
        return np.concatenate([a, pad])

    new_pack = build_pack_from_arrays(
        g(pack.v0), g(pack.e1), g(pack.e2),
        g(pack.n0), g(pack.n1), g(pack.n2),
        g(pack.t0), g(pack.t1), g(pack.t2),
        g(pack.has_uv), g(pack.material_id), np.arange(n_pad) < n)
    return new_pack, nodes, leaf_first, leaf_count, depth
