"""GPU triangle traversal: a CUDA kernel (csrc/bvh_trace.cu) that walks
the binned-SAH tree of ops/sah.py with one thread per ray, called
through the XLA FFI.

A per-ray stack walk is what a GPU runs well and what XLA cannot
express: ops/bvh.py advances every ray in lockstep (each iteration pays
for the slowest ray) and ops/accel.py's block sweep nests conditionals
inside scans. Here each thread keeps its own short stack, descends
near-first and prunes against its best hit so far.

Host side (this module, testable on the CPU):
  * `build_cuda_bvh` re-orders the pack into compact leaves and lays
    the tree out as the kernel reads it (see the layout note in
    csrc/bvh_trace.cu): nodes (Nn, 16) int32 holding the float32 bits
    of both child boxes and the child links in columns 12-13 (int32, so
    no float op can ever touch a link), and a (T, 20) f32 table of each
    triangle's Pluecker operands taken from the pack's own w6/w4, so the kernel
    and the brute-force oracle (ops/intersect.py) test the same
    numbers;
  * `pack_rays` stages rays as an (8, N_pad) structure of arrays
    padded with dead rays (tmax < tmin) to a multiple of the block.

Device side: `cuda_closest_hit_triangles` runs under stop_gradient like
every traversal (ops/intersect.py detach_tri_hit): the hit is a
discrete selection, and the winner's surface is recomputed
differentiably in ops/surface.py.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cse168_raytracer.config import EPSILON
from cse168_raytracer.models.geometry import TrianglePack
from cse168_raytracer.ops.intersect import (_BIG, _DEN_TINY, PRIM_NONE,
                                            PRIM_TRI, Hit)

BLOCK = 64         # rays per CUDA block (threads), the fastest of
                   # 64/128/256 on an H100 (PERF.md); ray counts pad to it
MAX_BLOCK = 256    # the kernel's launch bound
LEAF_SIZE = 4      # triangles per SAH leaf (at most)
LEAF_SHIFT = 6     # leaf link = ~(first << LEAF_SHIFT | count), count < 64
MAX_STACK = 64     # the kernel's private stack (entries per thread)
TARGET = "cse168_bvh_trace"


class CudaBVH(NamedTuple):
    nodes: jax.Array     # (Nn, 16) i32: f32 box bits, links in cols 12-13
    tris: jax.Array      # (T, 20) f32 Pluecker rows in pack order
    leaf_size: int       # static
    stack_depth: int     # static: entries the walk can hold at once
    block: int = BLOCK   # static: rays (threads) per CUDA block

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]


jax.tree_util.register_pytree_node(
    CudaBVH,
    lambda b: ((b.nodes, b.tris), (b.leaf_size, b.stack_depth, b.block)),
    lambda aux, ch: CudaBVH(*ch, *aux))


def encode_leaf(first, count):
    """Leaf link: the bitwise NOT of (first << LEAF_SHIFT | count)."""
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    return ~((first << LEAF_SHIFT) | count)


def decode_link(link):
    """(is_leaf, node_or_first, count) of int32 links."""
    link = np.asarray(link, np.int64)
    v = ~link
    return link < 0, np.where(link < 0, v >> LEAF_SHIFT, link), \
        np.where(link < 0, v & ((1 << LEAF_SHIFT) - 1), 0)


def tri_table(pack: TrianglePack) -> np.ndarray:
    """(T, 20) rows [beta(6) gamma(6) den(3) tnum(4) 0] from the pack's
    Pluecker operands (w6 (6, T, 3) columns beta/gamma/den; the den
    column's moment rows are identically zero)."""
    w6 = np.asarray(pack.w6, np.float32)
    w4 = np.asarray(pack.w4, np.float32)
    t = w6.shape[1]
    return np.concatenate([w6[:, :, 0].T, w6[:, :, 1].T, w6[0:3, :, 2].T,
                           w4.T, np.zeros((t, 1), np.float32)], axis=1)


def build_cuda_bvh(pack: TrianglePack, block: int = BLOCK):
    """SAH-build `pack` and lay it out for the kernel, which will run
    `block` rays per CUDA block. Returns (leaf-ordered pack, CudaBVH)."""
    if not 0 < block <= MAX_BLOCK:
        raise ValueError(f"block {block} outside 1..{MAX_BLOCK}")
    from cse168_raytracer.ops.sah import sah_build_compact
    new_pack, nodes14, first, count, depth = sah_build_compact(
        pack, leaf_cap=LEAF_SIZE)
    # the walk holds at most one deferred sibling per level
    stack_depth = int(depth) + 1
    if stack_depth > MAX_STACK:
        raise ValueError(f"SAH tree depth {depth} exceeds the kernel's "
                         f"{MAX_STACK}-entry stack")
    if first.size and int(first.max()) >= (1 << (31 - LEAF_SHIFT)):
        raise ValueError("too many triangles for the leaf link encoding")
    child = nodes14[:, 12:14].astype(np.int64)
    leaf = child < 0
    lid = np.where(leaf, ~child, 0)
    links = np.where(leaf, encode_leaf(first[lid], count[lid]), child)
    nodes = np.zeros((nodes14.shape[0], 16), np.int32)
    nodes[:, :12] = np.ascontiguousarray(nodes14[:, :12],
                                         np.float32).view(np.int32)
    nodes[:, 12:14] = links
    accel = CudaBVH(nodes=jnp.asarray(nodes),
                    tris=jnp.asarray(tri_table(new_pack)),
                    leaf_size=LEAF_SIZE, stack_depth=stack_depth,
                    block=block)
    return new_pack, accel


def pack_rays(o, d, tmin, tmax, block: int = BLOCK):
    """(8, N_pad) f32 rows ox oy oz dx dy dz tmin tmax, N_pad the next
    multiple of `block`. Padding rays are dead (tmax = -1 < tmin = 0):
    the kernel writes a miss for them without visiting the tree."""
    n = o.shape[0]
    n_pad = max(block, -(-n // block) * block)
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (n,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))
    rows = jnp.concatenate([o.T, d.T, tmin[None], tmax[None]], axis=0)
    if n_pad > n:
        pad = jnp.zeros((8, n_pad - n), jnp.float32)
        pad = pad.at[5].set(1.0).at[7].set(-1.0)
        rows = jnp.concatenate([rows, pad], axis=1)
    return rows.astype(jnp.float32), n_pad


_registered = False
_lock = threading.Lock()


def ensure_kernel():
    """Build csrc/libbvh_trace.so if stale and register its FFI target
    (once per process). Needs a CUDA GPU and nvcc."""
    global _registered
    with _lock:
        if _registered:
            return
        if jax.default_backend() != "gpu":
            raise RuntimeError(
                "the cuda traversal runs only on an NVIDIA GPU (backend "
                f"is {jax.default_backend()!r}); use kind='block' here")
        from cse168_raytracer import native
        lib = native.load(native.CUDA_LIB)
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.BvhTrace),
                                    platform="CUDA")
        _registered = True


def cuda_closest_hit_triangles(accel: CudaBVH, o, d, tmin, tmax,
                               any_hit: bool = False,
                               with_stats: bool = False):
    """Closest hit (or, with any_hit, first-found occlusion) of N rays.

    Returns Hit (prim_id = row of the leaf-ordered pack), plus per-ray
    int32 (box_tests, tri_tests) with with_stats: ray-box tests (two per
    internal node visited) and ray-triangle tests (every triangle of
    every leaf visited)."""
    ensure_kernel()
    accel, o, d, tmin, tmax = jax.lax.stop_gradient(
        (accel, o, d, tmin, tmax))
    n = o.shape[0]
    rays, n_pad = pack_rays(o, d, tmin, tmax, accel.block)
    out = (jax.ShapeDtypeStruct((n_pad,), jnp.float32),
           jax.ShapeDtypeStruct((n_pad,), jnp.int32),
           jax.ShapeDtypeStruct((n_pad,), jnp.int32),
           jax.ShapeDtypeStruct((n_pad,), jnp.int32))
    t, tid, box, tri = jax.ffi.ffi_call(TARGET, out,
                                        vmap_method="sequential")(
        rays, accel.nodes, accel.tris,
        any_hit=np.int32(any_hit), block=np.int32(accel.block),
        eps=np.float32(EPSILON),
        den_tiny=np.float32(_DEN_TINY), big=np.float32(_BIG))
    t, tid, box, tri = t[:n], tid[:n], box[:n], tri[:n]
    hit = t < _BIG
    h = Hit(t=t, prim_type=jnp.where(hit, PRIM_TRI, PRIM_NONE),
            prim_id=tid, hit=hit)
    if with_stats:
        return h, box, tri
    return h
