"""Wavefront OBJ loader with the reference's exact normal semantics.

Re-implements TriangleMeshLoad.cpp:114-311 in numpy (a C++ fast path
lives in csrc/ and is used automatically when built):

- vertices transformed by the CTM at load (TriangleMeshLoad.cpp:211)
- `vn` normals transformed by inverse-transpose CTM and normalized
  (TriangleMeshLoad.cpp:176-190)
- faces read as triangles (first three vertex tokens, matching the
  reference's `sscanf %s %s %s`, TriangleMeshLoad.cpp:222)
- faces without normal indices get a face normal cross(e1,e2)
  replicated per corner and flagged for fixing
  (TriangleMeshLoad.cpp:252-281)
- per-vertex neighbor-normal lists are then averaged (mean, then
  normalize) and written back to every *generated* normal only
  (TriangleMeshLoad.cpp:287-308) — this is what gives the bunny its
  smooth shading and must match for radiance parity.
"""

from __future__ import annotations

import ctypes
import numpy as np

_NATIVE = None          # cached ctypes lib (False = unavailable)


def _load_native():
    """Load (building if needed) the C++ loader from csrc/. Returns the
    ctypes lib or None; never raises — numpy fallback always works."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    try:
        from cse168_raytracer import native
        lib = native.load(native.CPU_LIB)
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_double)]
        for f in ("obj_num_vertices", "obj_num_normals",
                  "obj_num_texcoords", "obj_num_tris"):
            getattr(lib, f).restype = ctypes.c_int
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.obj_copy.argtypes = [ctypes.c_void_p] + \
            [np.ctypeslib.ndpointer(np.float32)] * 3 + \
            [np.ctypeslib.ndpointer(np.int32)] * 3
        lib.obj_free.argtypes = [ctypes.c_void_p]
        _NATIVE = lib
        return lib
    except Exception:
        _NATIVE = False
        return None


def _load_obj_native(lib, path: str, ctm: np.ndarray, nctm: np.ndarray):
    c = np.ascontiguousarray(ctm, np.float64)
    n = np.ascontiguousarray(nctm, np.float64)
    h = lib.obj_parse(path.encode(),
                      c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                      n.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if not h:
        raise FileNotFoundError(path)
    try:
        nv = lib.obj_num_vertices(h)
        nn = lib.obj_num_normals(h)
        nt = lib.obj_num_texcoords(h)
        ntri = lib.obj_num_tris(h)
        vertices = np.empty((max(nv, 1), 3), np.float32)
        normals = np.empty((max(nn, 1), 3), np.float32)
        texcoords = np.empty((max(nt, 1), 2), np.float32)
        tri_v = np.empty((max(ntri, 1), 3), np.int32)
        tri_n = np.empty((max(ntri, 1), 3), np.int32)
        tri_t = np.empty((max(ntri, 1), 3), np.int32)
        lib.obj_copy(h, vertices, normals, texcoords, tri_v, tri_n, tri_t)
    finally:
        lib.obj_free(h)
    return {
        "vertices": vertices[:nv].reshape(-1, 3),
        "normals": normals[:nn].reshape(-1, 3),
        "texcoords": texcoords[:nt].reshape(-1, 2),
        "tri_vidx": tri_v[:ntri].reshape(-1, 3),
        "tri_nidx": tri_n[:ntri].reshape(-1, 3),
        "tri_tidx": tri_t[:ntri].reshape(-1, 3),
    }


def _parse_face_token(tok: str) -> tuple[int, int, int]:
    """'v/t/n' -> (v, t, n), 0 where missing (atoi semantics,
    TriangleMeshLoad.cpp:82-111)."""
    parts = tok.split("/")
    v = int(parts[0]) if parts[0] else 0
    t = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    n = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return v, t, n


def load_obj(path: str, ctm: np.ndarray | None = None):
    """Load an OBJ file. Returns a dict of numpy arrays:

    vertices (V,3) f32, normals (N,3) f32, texcoords (TC,2) f32,
    tri_vidx/tri_nidx/tri_tidx (T,3) i32 (tidx = -1 when absent).
    """
    if ctm is None:
        ctm = np.eye(4, dtype=np.float64)
    ctm = np.asarray(ctm, dtype=np.float64)
    # normal transform: inverse-transpose (TriangleMeshLoad.cpp:176-178)
    nctm = np.linalg.inv(ctm).T

    lib = _load_native()
    if lib is not None:
        return _load_obj_native(lib, path, ctm, nctm)

    verts: list[tuple] = []
    normals: list[np.ndarray] = []
    texcoords: list[tuple] = []
    fix_normal: list[bool] = []
    tri_v = []
    tri_n = []
    tri_t = []
    # vertex -> list of neighboring normal indices (TriangleMeshLoad.cpp:162)
    neighbor_normals: dict[int, list[int]] = {}

    def xform_point(x, y, z):
        p = ctm @ np.array([x, y, z, 1.0])
        return p[:3]

    def xform_normal(x, y, z):
        n = nctm @ np.array([x, y, z, 0.0])
        n = n[:3]
        ln = np.linalg.norm(n)
        return n / ln if ln > 0 else n

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("vn"):
                parts = line[2:].split()
                normals.append(xform_normal(float(parts[0]), float(parts[1]),
                                            float(parts[2])))
                fix_normal.append(False)
            elif line.startswith("vt"):
                parts = line[2:].split()
                texcoords.append((float(parts[0]), float(parts[1])))
            elif line.startswith("v"):
                parts = line[1:].split()
                verts.append(xform_point(float(parts[0]), float(parts[1]),
                                         float(parts[2])))
            elif line.startswith("f"):
                toks = line[1:].split()
                if len(toks) < 3:
                    continue
                vtn = [_parse_face_token(t) for t in toks[:3]]
                vi = [x[0] - 1 for x in vtn]
                ti = [x[1] - 1 for x in vtn]
                ni = [x[2] - 1 for x in vtn]
                tri_v.append(vi)
                tri_t.append(ti if vtn[0][1] else [-1, -1, -1])
                if vtn[2][2]:  # normals supplied (reference checks last token's n)
                    tri_n.append(ni)
                    for c in range(3):
                        neighbor_normals.setdefault(vi[c], []).append(ni[c])
                else:
                    # generate face normal, replicated per corner
                    e1 = verts[vi[1]] - verts[vi[0]]
                    e2 = verts[vi[2]] - verts[vi[0]]
                    fn = np.cross(e1, e2)
                    ln = np.linalg.norm(fn)
                    fn = fn / ln if ln > 0 else fn
                    base = len(normals)
                    for c in range(3):
                        normals.append(fn.copy())
                        fix_normal.append(True)
                        neighbor_normals.setdefault(vi[c], []).append(base + c)
                    tri_n.append([base, base + 1, base + 2])

    normals_arr = (np.stack(normals) if normals
                   else np.zeros((0, 3), dtype=np.float64))
    fix = np.asarray(fix_normal, dtype=bool)

    # Average pass (TriangleMeshLoad.cpp:287-308): vertex average over ALL
    # neighbor normals, written back only to generated ("fix") entries.
    # Reference quirk: `Vector3 avg;` default-initializes to (0, 1, 2)
    # (Vector3.h:26-27), so the accumulated sum STARTS at (0,1,2) before
    # the neighbors are added — generated normals of low-valence
    # vertices are visibly polluted by it (verified against the
    # headless reference on cornell_box_2.obj: wall vertex normals come
    # out at normalize((0,1,2) + 2*(1,0,0)) = (0.67, 0.33, 0.67)).
    # The /= count before normalize() cancels out; the offset does not.
    for _vi, nlist in neighbor_normals.items():
        avg = np.array([0.0, 1.0, 2.0]) + normals_arr[nlist].sum(axis=0)
        ln = np.linalg.norm(avg)
        if ln > 0:
            avg = avg / ln
        for nidx in nlist:
            if fix[nidx]:
                normals_arr[nidx] = avg

    return {
        "vertices": np.asarray(verts, dtype=np.float32).reshape(-1, 3),
        "normals": normals_arr.astype(np.float32),
        "texcoords": np.asarray(texcoords, dtype=np.float32).reshape(-1, 2),
        "tri_vidx": np.asarray(tri_v, dtype=np.int32).reshape(-1, 3),
        "tri_nidx": np.asarray(tri_n, dtype=np.int32).reshape(-1, 3),
        "tri_tidx": np.asarray(tri_t, dtype=np.int32).reshape(-1, 3),
    }


def make_ctm(translate=(0.0, 0.0, 0.0), rot_y: float = 0.0,
             scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """CTM = translate @ rotateY(rot_y radians) @ scale, matching
    addModel (Utility.cpp:14-20, column-vector Matrix4x4 ctor)."""
    if np.isscalar(scale):
        scale = (scale, scale, scale)
    s = np.diag([scale[0], scale[1], scale[2], 1.0])
    a = float(rot_y)
    r = np.array([[np.cos(a), 0, np.sin(a), 0],
                  [0, 1, 0, 0],
                  [-np.sin(a), 0, np.cos(a), 0],
                  [0, 0, 0, 1.0]])
    t = np.eye(4)
    t[:3, 3] = translate
    return t @ r @ s
