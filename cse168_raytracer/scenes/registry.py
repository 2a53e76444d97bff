"""Scene registry: the reference's make*Scene() functions as data.

Every builder reproduces the exact numeric camera/light/material
parameters of its reference counterpart (citations inline) so renders
can be compared numerically. Missing large assets (sponza.obj, the HDR
environment maps, FlowerCenter.obj, WaterDropsMany.obj — stripped from
the reference snapshot, .MISSING_LARGE_BLOBS) get documented
substitutes.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np

from cse168_raytracer.config import PI, RenderConfig
from cse168_raytracer.models.geometry import (make_plane_pool,
                                              make_sphere_pool,
                                              pack_triangles)
from cse168_raytracer.models.lights import (LIGHT_DIRECTIONAL_AREA,
                                            LIGHT_POINT, LIGHT_SQUARE)
from cse168_raytracer.models.materials import (MaterialBuilder,
                                               TEX_CELLULAR, TEX_CHECKER,
                                               TEX_CLOUD,
                                               TEX_FLOWER_CENTER,
                                               TEX_IMAGE, TEX_LEAF,
                                               TEX_PETAL, TEX_STEM,
                                               TEX_STONE)
from cse168_raytracer.models.obj import load_obj
from cse168_raytracer.models.scene import make_scene
from cse168_raytracer.models.textures import (build_cellular_texture,
                                              load_image_texture,
                                              make_environment)
from cse168_raytracer.render.camera import make_camera

# The upstream C++ repository's assets (models/*.obj, gfx/*) are not
# part of this repository; scenes built from them need a checkout of it,
# found at $CSE168_REFERENCE_DIR (default: ./reference beside the
# package). The procedural scenes below build from this repository alone.
REF_DIR = os.environ.get(
    "CSE168_REFERENCE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference"))
REF_MODELS = os.path.join(REF_DIR, "models")
REF_GFX = os.path.join(REF_DIR, "gfx")

INF = float("inf")

# CloudTexture parameter rows (scale, cloudSize, density, sharpness,
# ambient, shadowThreshold, shadowMagnitude, shadowSharpness)
CLOUD_PARAMS_A3 = (3.0, 0.1, 0.2, 50.0, 0.4, 0.35, 0.5, 0.3)  # main.cpp:33-41


# ---------------------------------------------------------------------------
# Reference transform helpers
# ---------------------------------------------------------------------------

def translate(x, y, z):
    """assignment2.cpp:464-470 (column-4 translation)."""
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def scale(x, y, z):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


def rotate(angle_deg, x, y, z):
    """assignment2.cpp:484-511 — the reference does NOT normalize the
    axis; the formula is applied to raw (x, y, z). Row-major `set`."""
    rad = angle_deg * (PI / 180.0)
    x2, y2, z2 = x * x, y * y, z * z
    c = math.cos(rad)
    cinv = 1 - c
    s = math.sin(rad)
    xy, xz, yz = x * y, x * z, y * z
    xs, ys, zs = x * s, y * s, z * s
    xzc, xyc, yzc = xz * cinv, xy * cinv, yz * cinv
    return np.array([
        [x2 + c * (1 - x2), xyc + zs, xzc - ys, 0],
        [xyc - zs, y2 + c * (1 - y2), yzc + xs, 0],
        [xzc + ys, yzc - xs, z2 + c * (1 - z2), 0],
        [0, 0, 0, 1.0]])


def model_ctm(position=(0, 0, 0), rot_y=0.0, scl=(1, 1, 1)):
    """addModel / addFlowerModel CTM = trans * rotY * scale
    (Utility.cpp:14-20, assignment3.cpp:17-23)."""
    rot = np.array([[math.cos(rot_y), 0, math.sin(rot_y), 0],
                    [0, 1, 0, 0],
                    [-math.sin(rot_y), 0, math.cos(rot_y), 0],
                    [0, 0, 0, 1.0]])
    return translate(*position) @ rot @ scale(*scl)


def single_triangle(v1, v2, v3, n=(0, 1, 0)):
    """TriangleMesh::createSingleTriangle floor helper
    (assignment2.cpp:53-66)."""
    return {
        "vertices": np.asarray([v1, v2, v3], np.float32),
        "normals": np.asarray([n, n, n], np.float32),
        "texcoords": np.zeros((0, 2), np.float32),
        "tri_vidx": np.asarray([[0, 1, 2]], np.int32),
        "tri_nidx": np.asarray([[0, 1, 2]], np.int32),
        "tri_tidx": np.asarray([[-1, -1, -1]], np.int32),
    }


def ref_obj(name, ctm=None):
    return load_obj(os.path.join(REF_MODELS, name), ctm)


def _mesh(v, f, normals=None):
    """OBJ-loader-style dict from vertices (V, 3) and faces (F, 3);
    without per-vertex normals, face normals are replicated per corner
    (the loader's generated-normal layout)."""
    v = np.asarray(v, np.float32)
    f = np.asarray(f, np.int32)
    if normals is None:
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        normals = np.repeat(n, 3, axis=0)
        nidx = np.arange(f.shape[0] * 3, dtype=np.int32).reshape(-1, 3)
    else:
        nidx = f
    return {"vertices": v, "normals": np.asarray(normals, np.float32),
            "texcoords": np.zeros((0, 2), np.float32),
            "tri_vidx": f, "tri_nidx": nidx,
            "tri_tidx": np.full_like(f, -1)}


def _apply_ctm(mesh, ctm):
    """Transform a mesh dict like the OBJ loader does: points by the
    CTM, normals by its inverse transpose, renormalized
    (TriangleMeshLoad.cpp:176-211)."""
    ctm = np.asarray(ctm, np.float64)
    v = mesh["vertices"].astype(np.float64)
    v = v @ ctm[:3, :3].T + ctm[:3, 3]
    n = mesh["normals"].astype(np.float64) @ np.linalg.inv(ctm[:3, :3])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return dict(mesh, vertices=v.astype(np.float32),
                normals=n.astype(np.float32))


def torus_knot(p=2, q=3, n_u=96, n_v=16, tube=0.25, ctm=None):
    """A (p, q) torus-knot tube of 2 * n_u * n_v triangles with smooth
    per-vertex normals (unit knot: the curve stays within radius 1 of
    its center, |z| <= 1/3), optionally placed by a model CTM. The
    in-repository stand-in for the upstream meshes: curved, self-
    occluding, and a few thousand triangles at the defaults."""
    u = 2 * np.pi * np.arange(n_u) / n_u
    v = 2 * np.pi * np.arange(n_v) / n_v

    def curve(t):
        r = (2 + np.cos(q * t)) / 3
        return np.stack([r * np.cos(p * t), r * np.sin(p * t),
                         -np.sin(q * t) / 3], axis=-1)

    c = curve(u)
    tan = curve(u + 1e-4) - curve(u - 1e-4)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    ring = np.stack([2 * np.cos(p * u) / 3, 2 * np.sin(p * u) / 3,
                     np.zeros_like(u)], axis=-1)
    w = c - ring
    nrm = w - np.sum(w * tan, axis=-1, keepdims=True) * tan
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    bin_ = np.cross(tan, nrm)
    dirs = (np.cos(v)[None, :, None] * nrm[:, None, :]
            + np.sin(v)[None, :, None] * bin_[:, None, :])   # (U, V, 3)
    verts = (c[:, None, :] + tube * dirs).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a = i * n_v + j
    b = ((i + 1) % n_u) * n_v + j
    c2 = ((i + 1) % n_u) * n_v + (j + 1) % n_v
    d = i * n_v + (j + 1) % n_v
    faces = np.concatenate([np.stack([a, b, c2], -1).reshape(-1, 3),
                            np.stack([a, c2, d], -1).reshape(-1, 3)])
    mesh = _mesh(verts, faces, normals=dirs.reshape(-1, 3))
    return mesh if ctm is None else _apply_ctm(mesh, ctm)


def quad_grid(p0, du, dv, nu, nv):
    """A planar rectangle p0 + s*du + t*dv (s, t in [0, 1]) split into
    nu x nv quads (2 * nu * nv triangles, face normal du x dv)."""
    p0, du, dv = (np.asarray(x, np.float64) for x in (p0, du, dv))
    s, t = np.meshgrid(np.arange(nu + 1) / nu, np.arange(nv + 1) / nv,
                       indexing="ij")
    verts = (p0 + s[..., None] * du + t[..., None] * dv).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * (nv + 1) + j
    b = (i + 1) * (nv + 1) + j
    faces = np.concatenate([np.stack([a, b, b + 1], -1).reshape(-1, 3),
                            np.stack([a, b + 1, a + 1], -1).reshape(-1, 3)])
    return _mesh(verts, faces)


def _cloud_env(bg=(0.0, 0.0, 0.0), rotation=(0.0, 0.0)):
    return make_environment(cloud_params=CLOUD_PARAMS_A3, rotation=rotation,
                            bg_color=bg)


# ---------------------------------------------------------------------------
# Scene builders
# ---------------------------------------------------------------------------

def scene_sphere(cfg: RenderConfig):
    """A1makeSphereScene (assignment1.cpp:383-430): Lambert(1) sphere —
    center (0,1,2) via the reference's Vector3 default-ctor quirk
    (Vector3.h:26-27, setCenter never called) — radius 1.5, floor
    triangle at y=-1.5, point light (-3,15,3) 500W. BASELINE config #1."""
    mb = MaterialBuilder()
    white = mb.phong(kd=(1, 1, 1))
    tris = pack_triangles([(single_triangle((0, -1.5, 10), (10, -1.5, -10),
                                            (-10, -1.5, -10)), white)])
    spheres = make_sphere_pool([(0.0, 1.0, 2.0)], [1.5], [white])
    lights = [dict(kind=LIGHT_POINT, position=(-3, 15, 3),
                   color=(1, 1, 1), wattage=500.0)]
    cam = make_camera(eye=(-2, 1, 5), look_at=(0, 0, 0), fov=45,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, spheres=spheres,
                               materials=mb.build(), lights=lights)
    return scene, static, cam, cfg


def scene_teapot(cfg: RenderConfig):
    """makeTeapotScene (assignment2.cpp:24-70). BASELINE A2 bench."""
    mb = MaterialBuilder()
    white = mb.phong(kd=(1, 1, 1))
    teapot = ref_obj("teapot.obj")
    floor = single_triangle((-10, 0, -10), (0, 0, 10), (10, 0, -10))
    tris = pack_triangles([(teapot, white), (floor, white)])
    lights = [dict(kind=LIGHT_POINT, position=(10, 10, 10),
                   color=(1, 1, 1), wattage=700.0)]
    cam = make_camera(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, materials=mb.build(), lights=lights)
    return scene, static, cam, cfg


def scene_bunny1(cfg: RenderConfig):
    """makeBunny1Scene (assignment2.cpp:74-119)."""
    mb = MaterialBuilder()
    white = mb.phong(kd=(1, 1, 1))
    bunny = ref_obj("bunny.obj")
    floor = single_triangle((-100, 0, -100), (0, 0, 100), (100, 0, -100))
    tris = pack_triangles([(bunny, white), (floor, white)])
    lights = [dict(kind=LIGHT_POINT, position=(10, 20, 10),
                   color=(1, 1, 1), wattage=1000.0)]
    cam = make_camera(eye=(0, 5, 15), look_at=(0, 0, 0), fov=45,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, materials=mb.build(), lights=lights)
    return scene, static, cam, cfg


_BUNNY20_XFORMS: Optional[list] = None


def _bunny20_xforms():
    """The 20 CTMs of makeBunny20Scene (assignment2.cpp:147-317).
    `xform *= M` is `xform = xform * M` (column-vector convention)."""
    global _BUNNY20_XFORMS
    if _BUNNY20_XFORMS is not None:
        return _BUNNY20_XFORMS
    eye = np.eye(4)
    x2 = eye @ rotate(110, 0, 1, 0) @ scale(.6, 1, 1.1)
    seqs = []
    for base in (eye, x2):
        seqs += [
            base @ scale(0.3, 2.0, 0.7) @ translate(-1, .4, .3) @ rotate(25, .3, .1, .6),
            base @ scale(.6, 1.2, .9) @ translate(7.6, .8, .6),
            base @ translate(.7, 0, -2) @ rotate(120, 0, .6, 1),
            base @ translate(3.6, 3, -1),
            base @ translate(-2.4, 2, 3) @ scale(1, .8, 2),
            base @ translate(5.5, -.5, 1) @ scale(1, 2, 1),
            base @ rotate(15, 0, 0, 1) @ translate(-4, -.5, -6) @ scale(1, 2, 1),
            base @ rotate(60, 0, 1, 0) @ translate(5, .1, 3),
            base @ translate(-3, .4, 6) @ rotate(-30, 0, 1, 0),
            base @ translate(3, 0.5, -2) @ rotate(180, 0, 1, 0) @ scale(1.5, 1.5, 1.5),
        ]
    _BUNNY20_XFORMS = seqs
    return seqs


def scene_bunny20(cfg: RenderConfig):
    """makeBunny20Scene (assignment2.cpp:124-338)."""
    mb = MaterialBuilder()
    white = mb.phong(kd=(1, 1, 1))
    meshes = [(ref_obj("bunny.obj", xf), white) for xf in _bunny20_xforms()]
    floor = single_triangle((-100, 0, -100), (0, 0, 100), (100, 0, -100))
    meshes.append((floor, white))
    tris = pack_triangles(meshes)
    lights = [dict(kind=LIGHT_POINT, position=(10, 20, 10),
                   color=(1, 1, 1), wattage=1000.0)]
    cam = make_camera(eye=(0, 5, 15), look_at=(0, 0, 0), fov=45,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, materials=mb.build(), lights=lights)
    return scene, static, cam, cfg


def scene_cornell(cfg: RenderConfig):
    """makeCornellScene (assignment2.cpp:374-442): 4 cornell meshes +
    WaterDrops glass, point light (2.5,4.9,-1) 160W. BASELINE config #2
    path traces this at depth 4."""
    mb = MaterialBuilder()
    m1 = mb.phong(kd=(1, 1, 1))
    m2 = mb.phong(kd=(1, 0, 0))
    m3 = mb.phong(kd=(0, 1, 0))
    m4 = mb.phong(kd=(1, 1, 1))
    water = mb.phong(kd=(1, 1, 1), kt=(1, 1, 1), shininess=5, ior=1.5)
    meshes = [(ref_obj("cornell_box_1.obj"), m1),
              (ref_obj("cornell_box_2.obj"), m2),
              (ref_obj("cornell_box_3.obj"), m3),
              (ref_obj("cornell_box_4.obj"), m4),
              (ref_obj("WaterDrops.obj", translate(-2, -0.5, 0)), water)]
    tris = pack_triangles(meshes)
    lights = [dict(kind=LIGHT_POINT, position=(2.5, 4.9, -1),
                   color=(1, 1, 1), wattage=160.0)]
    cam = make_camera(eye=(2.5, 3, 3), look_at=(2.5, 2.5, 0), fov=90,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, materials=mb.build(), lights=lights)
    return scene, static, cam, cfg


def scene_photon_cornell(cfg: RenderConfig):
    """The golden harness's makePhotonCornellScene (injected by
    tools/golden_harness/patch_main.py): makeCornellScene geometry with
    the point light swapped for a DirectionalAreaLight (radius 1.5 at
    (2.5, 4.5, -1) aimed straight down, 50 W) — the only light type the
    reference emits photons from (Scene.cpp:368,430), so this scene
    exercises the photon-mapped radiance path end to end
    (irradiance_estimate added at every diffuse hit,
    Scene.cpp:286-299). Comparable with the reference only
    statistically (photon emission is stochastic on both sides)."""
    mb = MaterialBuilder()
    m1 = mb.phong(kd=(1, 1, 1))
    m2 = mb.phong(kd=(1, 0, 0))
    m3 = mb.phong(kd=(0, 1, 0))
    m4 = mb.phong(kd=(1, 1, 1))
    water = mb.phong(kd=(1, 1, 1), kt=(1, 1, 1), shininess=5, ior=1.5)
    meshes = [(ref_obj("cornell_box_1.obj"), m1),
              (ref_obj("cornell_box_2.obj"), m2),
              (ref_obj("cornell_box_3.obj"), m3),
              (ref_obj("cornell_box_4.obj"), m4),
              (ref_obj("WaterDrops.obj", translate(-2, -0.5, 0)), water)]
    tris = pack_triangles(meshes)
    lights = [dict(kind=LIGHT_DIRECTIONAL_AREA,
                   position=(2.5, 4.5, -1), normal=(0, -1, 0),
                   radius=1.5, color=(1, 1, 1), wattage=50.0)]
    cam = make_camera(eye=(2.5, 3, 3), look_at=(2.5, 2.5, 0), fov=90,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, materials=mb.build(),
                               lights=lights)
    return scene, static, cam, cfg


def scene_knot(cfg: RenderConfig):
    """makeTeapotScene's stage (assignment2.cpp:24-70: floor triangle,
    camera, 700 W point light) with a 3,072-triangle torus knot standing
    where the teapot was: the mesh scene that builds from this
    repository alone."""
    mb = MaterialBuilder()
    white = mb.phong(kd=(1, 1, 1))
    knot = torus_knot(ctm=model_ctm(position=(0, 1.35, 0), rot_y=0.3))
    floor = single_triangle((-10, 0, -10), (0, 0, 10), (10, 0, -10))
    tris = pack_triangles([(knot, white), (floor, white)])
    lights = [dict(kind=LIGHT_POINT, position=(10, 10, 10),
                   color=(1, 1, 1), wattage=700.0)]
    cam = make_camera(eye=(0, 3, 6), look_at=(0, 0, 0), fov=45,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, materials=mb.build(), lights=lights)
    return scene, static, cam, cfg


def _cornell_proxy_meshes(m_white, m_red, m_green, m_back, m_glass):
    """A 5x5x5 open-front box (white floor and ceiling, red left wall,
    green right wall, white back wall) with a glass torus knot inside:
    the cornell scene's layout from procedural meshes."""
    walls = [
        (quad_grid((0, 0, -5), (0, 0, 5), (5, 0, 0), 8, 8), m_white),
        (quad_grid((0, 5, -5), (5, 0, 0), (0, 0, 5), 8, 8), m_white),
        (quad_grid((0, 0, -5), (0, 5, 0), (0, 0, 5), 8, 8), m_red),
        (quad_grid((5, 0, -5), (0, 0, 5), (0, 5, 0), 8, 8), m_green),
        (quad_grid((0, 0, -5), (5, 0, 0), (0, 5, 0), 8, 8), m_back),
    ]
    glass = torus_knot(n_u=64, n_v=12,
                       ctm=model_ctm(position=(2.5, 1.6, -2.2), rot_y=0.5,
                                     scl=(1.2, 1.2, 1.2)))
    return walls + [(glass, m_glass)]


def scene_cornell_proxy(cfg: RenderConfig):
    """makeCornellScene's camera, materials and 160 W point light
    (assignment2.cpp:374-442) over procedural geometry: the cornell
    walls as subdivided quads and a glass torus knot (kt=1, ior 1.5)
    in place of WaterDrops.obj. Material order matches `cornell`, so
    the glass is material 4."""
    mb = MaterialBuilder()
    m1 = mb.phong(kd=(1, 1, 1))
    m2 = mb.phong(kd=(1, 0, 0))
    m3 = mb.phong(kd=(0, 1, 0))
    m4 = mb.phong(kd=(1, 1, 1))
    water = mb.phong(kd=(1, 1, 1), kt=(1, 1, 1), shininess=5, ior=1.5)
    tris = pack_triangles(_cornell_proxy_meshes(m1, m2, m3, m4, water))
    lights = [dict(kind=LIGHT_POINT, position=(2.5, 4.9, -1),
                   color=(1, 1, 1), wattage=160.0)]
    cam = make_camera(eye=(2.5, 3, 3), look_at=(2.5, 2.5, 0), fov=90,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, materials=mb.build(), lights=lights)
    return scene, static, cam, cfg


def _make_sponza_substitute():
    """sponza.obj was stripped from the snapshot (.MISSING_LARGE_BLOBS).
    Substitute: a procedurally generated two-story colonnaded atrium
    with a similar triangle count profile (arcaded walls, floor, pillar
    grid) so the BVH/traversal workload is comparable. Documented
    substitute — NOT the Crytek geometry."""
    rng = np.random.RandomState(0)
    verts = []
    tris = []

    def add_box(cx, cy, cz, sx, sy, sz):
        base = len(verts)
        for dx in (-sx, sx):
            for dy in (-sy, sy):
                for dz in (-sz, sz):
                    verts.append((cx + dx, cy + dy, cz + dz))
        faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),
                 (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
                 (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
        for f in faces:
            tris.append((base + f[0], base + f[1], base + f[2]))

    # floor slab + two long walls + pillar colonnade (2 stories)
    add_box(0, -0.1, 0, 12, 0.1, 6)
    add_box(0, 4, 6.2, 12, 4, 0.2)
    add_box(0, 4, -6.2, 12, 4, 0.2)
    add_box(-12.2, 4, 0, 0.2, 4, 6)
    add_box(12.2, 4, 0, 0.2, 4, 6)
    for story in (0, 1):
        y0 = 1.2 + story * 2.6
        for i in range(-5, 6):
            for zs in (-4.5, 4.5):
                add_box(2.2 * i, y0, zs, 0.25, 1.2, 0.25)
                add_box(2.2 * i, y0 + 1.35, zs, 0.45, 0.12, 0.45)
    # clutter spheres of boxes to roughen the workload
    for _ in range(120):
        x, z = rng.uniform(-11, 11), rng.uniform(-5.5, 5.5)
        s = rng.uniform(0.1, 0.5)
        add_box(x, s, z, s, s, s)

    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.int32)
    # face normals, replicated per corner (loader-style generated normals)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    normals = np.repeat(n, 3, axis=0)
    nidx = np.arange(f.shape[0] * 3, dtype=np.int32).reshape(-1, 3)
    return {"vertices": v, "normals": normals.astype(np.float32),
            "texcoords": np.zeros((0, 2), np.float32),
            "tri_vidx": f, "tri_nidx": nidx,
            "tri_tidx": np.full_like(f, -1)}


def _make_sponza_proxy(target_tris: int = 160_000):
    """A sponza-SHAPED benchmark interior: two-story colonnaded atrium
    with round fluted columns, arch rings, a coffered roof open over the
    central court and floor clutter, ~160k triangles, rendered from
    INSIDE — built so
    the traversal workload profile approaches the real sponza's
    interior-occlusion numbers (the reference measured 10.33
    triangle tests/ray there vs 1.17 for bunny,
    writeup/A2/Readme.tex:95-98). NOT the Crytek geometry: sponza.obj
    is stripped from the snapshot; this is the documented stand-in
    for the rays/sec-at-sponza headline metric (BASELINE.md)."""
    verts = []
    tris = []

    def quad(a, b, c, d):
        base = len(verts)
        verts.extend([a, b, c, d])
        tris.append((base, base + 1, base + 2))
        tris.append((base, base + 2, base + 3))

    def grid_wall(p0, du, dv, nu, nv, hole=None):
        """Subdivided planar wall: p0 + u*du + v*dv, (nu x nv) quads,
        leaving out the quads whose center satisfies `hole`."""
        p0 = np.asarray(p0, np.float64)
        du = np.asarray(du, np.float64) / nu
        dv = np.asarray(dv, np.float64) / nv
        for i in range(nu):
            for j in range(nv):
                a = p0 + i * du + j * dv
                if hole is not None and hole(a + (du + dv) / 2):
                    continue
                quad(tuple(a), tuple(a + du), tuple(a + du + dv),
                     tuple(a + dv))

    def cylinder(cx, cz, y0, y1, r, seg=24, rings=6, flute=0.0):
        """Fluted column shaft: seg x rings quads."""
        ys = np.linspace(y0, y1, rings + 1)
        for k in range(rings):
            for i in range(seg):
                a0 = 2 * np.pi * i / seg
                a1 = 2 * np.pi * (i + 1) / seg
                r0 = r * (1 + flute * np.cos(8 * a0))
                r1 = r * (1 + flute * np.cos(8 * a1))
                quad((cx + r0 * np.cos(a0), ys[k], cz + r0 * np.sin(a0)),
                     (cx + r1 * np.cos(a1), ys[k], cz + r1 * np.sin(a1)),
                     (cx + r1 * np.cos(a1), ys[k + 1],
                      cz + r1 * np.sin(a1)),
                     (cx + r0 * np.cos(a0), ys[k + 1],
                      cz + r0 * np.sin(a0)))

    def arch(cx, cz, y, r, width, seg=16):
        """Half-torus arch ring between two columns (axis along x)."""
        for i in range(seg):
            a0 = np.pi * i / seg
            a1 = np.pi * (i + 1) / seg
            for zs in (-width / 2, width / 2):
                quad((cx + r * np.cos(a0), y + r * np.sin(a0), cz + zs),
                     (cx + r * np.cos(a1), y + r * np.sin(a1), cz + zs),
                     (cx + (r - 0.15) * np.cos(a1),
                      y + (r - 0.15) * np.sin(a1), cz + zs),
                     (cx + (r - 0.15) * np.cos(a0),
                      y + (r - 0.15) * np.sin(a0), cz + zs))

    def box(cx, cy, cz, sx, sy, sz):
        base = len(verts)
        for dx in (-sx, sx):
            for dy in (-sy, sy):
                for dz in (-sz, sz):
                    verts.append((cx + dx, cy + dy, cz + dz))
        for f in [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),
                  (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
                  (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]:
            tris.append((base + f[0], base + f[1], base + f[2]))

    rng = np.random.RandomState(0)
    L, W, H = 14.0, 7.0, 9.0          # atrium half-length/width, height
    # floor / ceiling / end walls, subdivided so the BVH sees real leaf
    # structure everywhere rays travel
    grid_wall((-L, 0, -W), (2 * L, 0, 0), (0, 0, 2 * W), 56, 28)
    # the roof is open over the central court, as sponza's atrium is
    # open to the sky: the point light above it shines in
    grid_wall((-L, H, -W), (2 * L, 0, 0), (0, 0, 2 * W), 56, 28,
              hole=lambda c: abs(c[0]) < 0.6 * L and abs(c[2]) < 0.6 * W)
    grid_wall((-L, 0, -W), (0, H, 0), (2 * L, 0, 0), 24, 56)   # back z=-W
    grid_wall((-L, 0, W), (0, H, 0), (2 * L, 0, 0), 24, 56)    # front
    grid_wall((-L, 0, -W), (0, H, 0), (0, 0, 2 * W), 24, 28)
    grid_wall((L, 0, -W), (0, H, 0), (0, 0, 2 * W), 24, 28)
    # two stories of fluted columns with arch rings along both sides
    n_cols = 12
    xs_c = np.linspace(-L + 1.4, L - 1.4, n_cols)
    for zi, zc in enumerate((-W + 1.6, W - 1.6)):
        for story, (y0, y1) in enumerate(((0.0, 3.4), (4.2, 7.2))):
            for x in xs_c:
                cylinder(x, zc, y0, y1, 0.38, seg=28, rings=8,
                         flute=0.06)
                box(x, y1 + 0.15, zc, 0.55, 0.15, 0.55)   # capital
                box(x, y0 + 0.08 if story else 0.08, zc,
                    0.5, 0.08, 0.5)                        # plinth
            # arches spanning neighboring columns
            span = xs_c[1] - xs_c[0]
            for x in (xs_c[:-1] + span / 2):
                arch(x, zc, (3.4, 7.2)[story], span / 2 - 0.1, 0.5,
                     seg=14)
        # second-story walkway slab
        box(0, 3.9, zc, L, 0.12, 1.3)
    # coffered ceiling beams
    for x in xs_c:
        box(x, H - 0.25, 0, 0.18, 0.25, W)
    for z in np.linspace(-W + 1, W - 1, 9):
        box(0, H - 0.45, z, L, 0.12, 0.18)
    # floor clutter: crates and debris at many scales
    while len(tris) < target_tris - 40:
        x = rng.uniform(-L + 1, L - 1)
        z = rng.uniform(-W + 1, W - 1)
        sc = rng.uniform(0.08, 0.45)
        box(x, sc, z, sc * rng.uniform(0.5, 1.5), sc,
            sc * rng.uniform(0.5, 1.5))

    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.int32)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    normals = np.repeat(n, 3, axis=0)
    nidx = np.arange(f.shape[0] * 3, dtype=np.int32).reshape(-1, 3)
    return {"vertices": v, "normals": normals.astype(np.float32),
            "texcoords": np.zeros((0, 2), np.float32),
            "tri_vidx": f, "tri_nidx": nidx,
            "tri_tidx": np.full_like(f, -1)}


def scene_sponza_proxy(cfg: RenderConfig):
    """`sponza_proxy`: the ~160k-tri procedural atrium
    (_make_sponza_proxy) under makeSponzaScene's exact camera and
    light (assignment2.cpp:341-371: eye (8,1.5,1) -> (0,2.5,-1),
    fov 55, one 200 W point light at (0,10,0), Lambert white). The
    interior-occlusion benchmark scene for bench.py's sponza-class
    entry."""
    mb = MaterialBuilder()
    white = mb.phong(kd=(1, 1, 1))
    tris = pack_triangles([(_make_sponza_proxy(), white)])
    lights = [dict(kind=LIGHT_POINT, position=(0, 10.0, 0),
                   color=(1, 1, 1), wattage=200.0)]
    cam = make_camera(eye=(8, 1.5, 1), look_at=(0, 2.5, -1), fov=55,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, materials=mb.build(),
                               lights=lights)
    return scene, static, cam, cfg


def scene_sponza(cfg: RenderConfig):
    """makeSponzaScene (assignment2.cpp:342-371). sponza.obj is missing
    from the snapshot; uses a documented procedural substitute unless
    CSE168_SPONZA_OBJ points at a real sponza OBJ."""
    mb = MaterialBuilder()
    white = mb.phong(kd=(1, 1, 1))
    path = os.environ.get("CSE168_SPONZA_OBJ",
                          os.path.join(REF_MODELS, "sponza.obj"))
    if os.path.exists(path):
        obj = load_obj(path)
    else:
        if os.environ.get("CSE168_SPONZA_OBJ"):
            # an explicitly requested real sponza must not silently
            # degrade to the 2.5k-tri stand-in (a prior round's bench
            # honesty lesson)
            raise FileNotFoundError(
                f"CSE168_SPONZA_OBJ={path!r} does not exist")
        import sys as _sys
        print("[scene] sponza.obj stripped from the reference snapshot:"
              " using the 2,556-tri PROCEDURAL SUBSTITUTE (set"
              " CSE168_SPONZA_OBJ to a real sponza OBJ)",
              file=_sys.stderr)
        obj = _make_sponza_substitute()
    tris = pack_triangles([(obj, white)])
    lights = [dict(kind=LIGHT_POINT, position=(0, 10.0, 0),
                   color=(1, 1, 1), wattage=200.0)]
    cam = make_camera(eye=(8, 1.5, 1), look_at=(0, 2.5, -1), fov=55,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, materials=mb.build(), lights=lights)
    return scene, static, cam, cfg


def scene_sphere_texture(cfg: RenderConfig):
    """makeTestSphereTextureScene (assignment3.cpp:124-177): earth.jpg
    on TexturedSphere.obj, two 5000W point lights."""
    earth = load_image_texture(os.path.join(REF_GFX, "earth.jpg"))
    mb = MaterialBuilder()
    m = mb.textured(TEX_IMAGE, [], shininess=5, image_id=0)
    obj = ref_obj("TexturedSphere.obj", model_ctm())
    tris = pack_triangles([(obj, m)])
    lights = [dict(kind=LIGHT_POINT, position=(10, 10, 10),
                   color=(1, 1, 1), wattage=5000.0),
              dict(kind=LIGHT_POINT, position=(-10, 10, 10),
                   color=(1, 1, 1), wattage=5000.0)]
    cam = make_camera(eye=(-10, 4, 0), look_at=(0, 0, 0), fov=45,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(tris=tris, materials=mb.build(),
                               lights=lights, images=[earth])
    return scene, static, cam, cfg


def scene_texture_plane(cfg: RenderConfig):
    """makeTestTextureScene (assignment3.cpp:181-236): StemTexture plane."""
    mb = MaterialBuilder()
    m = mb.textured(TEX_STEM, [1.0])
    planes = make_plane_pool([(0, 0, 0)], [(0, 1, 0)], [m])
    lights = [dict(kind=LIGHT_POINT, position=(10, 10, 10),
                   color=(1, 1, 1), wattage=5000.0),
              dict(kind=LIGHT_POINT, position=(-10, 10, 10),
                   color=(1, 1, 1), wattage=5000.0)]
    cam = make_camera(eye=(-10, 4, 0), look_at=(0, 0, 0), fov=45,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(planes=planes, materials=mb.build(),
                               lights=lights)
    return scene, static, cam, cfg


def scene_cellular_plane(cfg: RenderConfig):
    """CellularTexture2D probe scene (the class is library-only in the
    reference, Texture.h:84-99 / Texture.cpp:219-354): a plane textured
    with a 1000-point 10x10-grid cellular texture, lit like
    makeTestTextureScene."""
    cell = build_cellular_texture(1000, grid_width=10, grid_height=10,
                                  seed=0)
    mb = MaterialBuilder()
    m = mb.textured(TEX_CELLULAR, [1.0], image_id=0)
    planes = make_plane_pool([(0, 0, 0)], [(0, 1, 0)], [m])
    lights = [dict(kind=LIGHT_POINT, position=(10, 10, 10),
                   color=(1, 1, 1), wattage=5000.0)]
    cam = make_camera(eye=(-10, 4, 0), look_at=(0, 0, 0), fov=45,
                      bg_color=(0, 0, 0.2))
    scene, static = make_scene(planes=planes, materials=mb.build(),
                               lights=lights, cellulars=[cell])
    return scene, static, cam, cfg


def scene_test_sphere(cfg: RenderConfig):
    """makeTestSphereScene (main.cpp:30-115): green Phong(ks=1) mirror
    sphere, checkerboard plane, CloudTexture environment, two point
    lights."""
    mb = MaterialBuilder()
    green = mb.phong(kd=(0, 1, 0), ks=(1, 1, 1), shininess=10, ior=1.5)
    checker = mb.textured(TEX_CHECKER, [1.0], color1=(1, 1, 1),
                          color2=(0, 0, 0))
    spheres = make_sphere_pool([(0, 0.5, 0)], [3.0], [green])
    planes = make_plane_pool([(0, -1, 0)], [(0, 1, 0)], [checker])
    lights = [dict(kind=LIGHT_POINT, position=(0, 5, -5),
                   color=(1, 1, 1), wattage=1000.0),
              dict(kind=LIGHT_POINT, position=(0, 5, -25),
                   color=(1, 1, 1), wattage=1500.0)]
    cam = make_camera(eye=(9, 1, 0), look_at=(0, 0, 0), fov=90,
                      bg_color=(1, 1, 1))
    scene, static = make_scene(spheres=spheres, planes=planes,
                               materials=mb.build(), lights=lights,
                               env=_cloud_env())
    return scene, static, cam, cfg


def scene_refract_spheres(cfg: RenderConfig):
    """makeScene2 (assignment1.cpp:169-237): 3x3 grid of refractive
    spheres with IOR sweep 1.0 + (3y+2x)/20, StoneTexture plane, 4
    point lights. HDR env (autumnforrest.hdr) missing -> cloud env."""
    mb = MaterialBuilder()
    stone = mb.textured(TEX_STONE, [3.0])
    centers, radii, mats = [], [], []
    for y in range(3):
        for x in range(3):
            centers.append((3 * (x - 1), 3 * y + 1.5, -9))
            radii.append(1.5)
            mats.append(mb.phong(kd=(0, 1, 2), ks=(0, 0, 0), kt=(1, 1, 1),
                                 shininess=10,
                                 ior=1.0 + (y * 3.0 + x * 2.0) / 20))
            # NOTE kd=(0,1,2): Vector3() default ctor quirk — the
            # reference passes Vector3() which is (0,1,2), then the
            # energy clamp (Phong.cpp:29-31) zeroes it against kt=1.
    spheres = make_sphere_pool(centers, radii, mats)
    planes = make_plane_pool([(0, -0.5, 0)], [(0, 1, 0)], [stone])
    lights = [dict(kind=LIGHT_POINT, position=(-2, 3, -6), wattage=30.0),
              dict(kind=LIGHT_POINT, position=(2, 4.5, -4), wattage=30.0),
              dict(kind=LIGHT_POINT, position=(0, 20, 0), wattage=1000.0),
              dict(kind=LIGHT_POINT, position=(0, 5, -4), wattage=30.0)]
    for l in lights:
        l["kind"] = LIGHT_POINT
        l["color"] = (1, 1, 1)
    ang = -PI
    cam = make_camera(eye=(0, 4, 2),
                      look_at=(0 + math.sin(ang), 4, 2 + math.cos(ang)),
                      fov=60, bg_color=(1, 1, 1))
    scene, static = make_scene(spheres=spheres, planes=planes,
                               materials=mb.build(), lights=lights,
                               env=_cloud_env())
    return scene, static, cam, cfg


def scene_petal(cfg: RenderConfig):
    """makeTestPetalScene (assignment3.cpp:35-122): the final flower
    scene. Petals2/Stem/Leaf OBJs are present; FlowerCenter.obj,
    WaterDropsMany.obj and the HDR env are missing from the snapshot —
    the flower center is substituted with a small sphere at the pivot
    and the env with the scene's own CloudTexture parameters."""
    mb = MaterialBuilder()
    petal = mb.textured(TEX_PETAL, [7.0, 0.0, 0.0, 0.0], shininess=500,
                        ior=1.5)
    stem = mb.textured(TEX_STEM, [30.0])
    leaf = mb.textured(TEX_LEAF, [1.0])
    center = mb.textured(TEX_FLOWER_CENTER, [1.1, -0.1, -0.35, 0.0])
    water = mb.phong(kd=(1, 1, 1), kt=(1, 1, 1), shininess=250, ior=1.33)
    meshes = [(ref_obj("Petals2.obj", model_ctm()), petal),
              (ref_obj("Stem.obj", model_ctm()), stem),
              (ref_obj("Leaf.obj", model_ctm()), leaf)]
    fc_path = os.path.join(REF_MODELS, "FlowerCenter.obj")
    if os.path.exists(fc_path):
        meshes.append((ref_obj("FlowerCenter.obj", model_ctm()), center))
        spheres = None
    else:
        spheres = make_sphere_pool([(-0.1, -0.35, 0.0)], [1.1], [center])
    wd_path = os.path.join(REF_MODELS, "WaterDropsMany.obj")
    if os.path.exists(wd_path):
        meshes.append((ref_obj("WaterDropsMany.obj", model_ctm()), water))
    tris = pack_triangles(meshes)
    lightn = -np.asarray((50.0, 50.0, 40.0))
    lightn = lightn / np.linalg.norm(lightn)
    lights = [dict(kind=LIGHT_DIRECTIONAL_AREA, position=(50, 50, 40),
                   normal=tuple(lightn), color=(1, 1, 1), wattage=4.0,
                   radius=7.0)]
    cam = make_camera(eye=(2, 4.4, 16.8), look_at=(3, 0.0, 4), fov=30,
                      bg_color=(0, 0, 0.2))
    env = _cloud_env(bg=(1, 1, 1),
                     rotation=(PI / 3 + 0.05, PI / 8))  # assignment3.cpp:51
    scene, static = make_scene(tris=tris, spheres=spheres,
                               materials=mb.build(), lights=lights, env=env)
    return scene, static, cam, cfg


def scene_spiral(cfg: RenderConfig):
    """makeSpiralScene (assignment1.cpp:8-76): 149 spheres on an
    Archimedean spiral, red Lambert plane, one green triangle with
    bent normals."""
    mb = MaterialBuilder()
    centers, radii, mats = [], [], []
    max_i, a = 150, 0.15
    for i in range(1, max_i):
        t = i / float(max_i)
        theta = 4 * PI * t
        r = a * theta
        centers.append((r * math.cos(theta), r * math.sin(theta),
                        2 * (2 * PI * a - r)))
        radii.append(r / 10)
        mats.append(mb.phong(kd=(1.0, t, i % 2)))
    red = mb.phong(kd=(1, 0, 0))
    green = mb.phong(kd=(0, 1, 0))
    spheres = make_sphere_pool(centers, radii, mats)
    planes = make_plane_pool([(0, -2, 0)], [(0, 1, 0)], [red])
    n2 = np.asarray((0.1, 0.1, -1.0)); n2 /= np.linalg.norm(n2)
    n3 = np.asarray((-0.1, -0.2, -1.0)); n3 /= np.linalg.norm(n3)
    tri = {
        "vertices": np.asarray([(0, 0, 0), (0, 3, 0), (5, 5, 0)], np.float32),
        "normals": np.asarray([(0, 0, -1), n2, n3], np.float32),
        "texcoords": np.zeros((0, 2), np.float32),
        "tri_vidx": np.asarray([[0, 1, 2]], np.int32),
        "tri_nidx": np.asarray([[0, 1, 2]], np.int32),
        "tri_tidx": np.asarray([[-1, -1, -1]], np.int32),
    }
    tris = pack_triangles([(tri, green)])
    lights = [dict(kind=LIGHT_POINT, position=(-3, 15, -15),
                   color=(1, 1, 1), wattage=1000.0)]
    cam = make_camera(eye=(0, 0, -5), look_at=(0, 0, 0), fov=45,
                      bg_color=(1, 1, 1))
    scene, static = make_scene(tris=tris, spheres=spheres, planes=planes,
                               materials=mb.build(), lights=lights)
    return scene, static, cam, cfg


def scene_scene1(cfg: RenderConfig):
    """makeScene1 (assignment1.cpp:82-166): three Phong spheres +
    teapot + red square backdrop, four point lights."""
    mb = MaterialBuilder()
    green = mb.phong(kd=(0, 1, 0))
    red = mb.phong(kd=(1, 0, 0), shininess=3, ior=1.5)
    blue = mb.phong(kd=(0, 0, 1), shininess=3, ior=1.5)
    white = mb.phong(kd=(1, 1, 1), shininess=3, ior=1.5)
    backdrop = mb.phong(kd=(1, 0, 0))
    spheres = make_sphere_pool([(-2, 2.5, -9), (2, 2.5, -9), (0, 4.5, -10)],
                               [1.5, 1.5, 1.5], [green, red, blue])
    meshes = [(ref_obj("teapot.obj", model_ctm((0, 0, -5))), white),
              (ref_obj("square.obj", model_ctm((0, 0, -8), 0.0,
                                               (6, 6, 6))), backdrop)]
    tris = pack_triangles(meshes)
    lights = [dict(kind=LIGHT_POINT, position=(-2, 3, -6), wattage=30.0),
              dict(kind=LIGHT_POINT, position=(2, 4.5, -6.5), wattage=30.0),
              dict(kind=LIGHT_POINT, position=(0, 20, 0), wattage=1000.0),
              dict(kind=LIGHT_POINT, position=(0, 5, -7), wattage=30.0)]
    for l in lights:
        l["kind"] = LIGHT_POINT
        l["color"] = (1, 1, 1)
    ang, pitch = -PI, -0.1
    cam = make_camera(eye=(0, 3, 2),
                      look_at=(0 + math.sin(ang), 3 + math.sin(pitch),
                               2 + math.cos(ang)),
                      fov=60, bg_color=(0, 0, 0))
    scene, static = make_scene(tris=tris, spheres=spheres,
                               materials=mb.build(), lights=lights)
    return scene, static, cam, cfg


SCENES: dict[str, Callable] = {
    "sphere": scene_sphere,
    "knot": scene_knot,
    "cornell_proxy": scene_cornell_proxy,
    "teapot": scene_teapot,
    "bunny1": scene_bunny1,
    "bunny20": scene_bunny20,
    "cornell": scene_cornell,
    "sponza_proxy": scene_sponza_proxy,
    "photon_cornell": scene_photon_cornell,
    "sponza": scene_sponza,
    "sphere_texture": scene_sphere_texture,
    "texture_plane": scene_texture_plane,
    "cellular_plane": scene_cellular_plane,
    "test_sphere": scene_test_sphere,
    "refract_spheres": scene_refract_spheres,
    "petal": scene_petal,
    "spiral": scene_spiral,
    "scene1": scene_scene1,
}


def build(name: str, cfg: Optional[RenderConfig] = None):
    """Build a named scene. Returns (Scene, SceneStatic, Camera,
    RenderConfig)."""
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; have {sorted(SCENES)}")
    if cfg is None:
        cfg = RenderConfig()
    return SCENES[name](cfg)
