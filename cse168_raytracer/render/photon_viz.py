"""Photon-map debug visualization — the -DVISUALIZE_PHOTON_MAP /
-DDEBUG_PHOTONS analog (Scene.cpp:405-409,586-591 injects a tiny sphere
per stored photon and re-renders; Scene.cpp:20-30 logs per-photon
traces).

Instead of mutating the scene and rebuilding the BVH, stored photon
positions are projected through the camera (the exact inverse of
eye_rays' image-plane mapping, Camera.cpp:103-161) and splatted as
colored dots over a rendered frame: GLOBAL map photons green, CAUSTIC
map photons red. Wired to `--visualize-photons PATH` in the CLI, which
also prints the per-level store counts (the DEBUG_PHOTONS bounce
ledger).
"""

from __future__ import annotations

import numpy as np

from cse168_raytracer.render.camera import Camera, camera_basis


def project_points(cam: Camera, pts: np.ndarray, width: int,
                   height: int) -> tuple[np.ndarray, np.ndarray]:
    """World points -> integer pixel coords (x, y) with y=0 the BOTTOM
    scanline (render_hdr's row convention). Returns (xy (N, 2) i32,
    visible (N,) bool)."""
    w_dir, u_dir, v_dir, top, right = camera_basis(cam, width, height)
    w_dir = np.asarray(w_dir, np.float64)
    u_dir = np.asarray(u_dir, np.float64)
    v_dir = np.asarray(v_dir, np.float64)
    top = float(top)
    right = float(right)
    left, bottom = -right, -top
    c = pts.astype(np.float64) - np.asarray(cam.eye, np.float64)
    z = c @ (-w_dir)                       # distance along the view dir
    vis = z > 1e-6
    zs = np.where(vis, z, 1.0)
    u = (c @ u_dir) / zs
    v = (c @ v_dir) / zs
    x = (u - left) / (right - left) * width - 0.5
    y = (v - bottom) / (top - bottom) * height - 0.5
    xi = np.round(x).astype(np.int64)
    yi = np.round(y).astype(np.int64)
    vis &= (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    return np.stack([xi, yi], axis=1), vis


def photon_overlay(img_u8: np.ndarray, cam: Camera, maps, width: int,
                   height: int) -> np.ndarray:
    """Splat stored photons over a rendered uint8 frame (row 0 =
    bottom). Global map -> green, caustic map -> red."""
    out = np.array(img_u8, np.uint8, copy=True)
    for grid, color in ((maps.global_map, (40, 255, 40)),
                        (maps.caustic_map, (255, 40, 40))):
        if grid is None:
            continue
        n = int(grid.n_valid)
        pos = np.asarray(grid.pos)[:n]
        # folded-overflow rows carry zero power; skip them like the
        # reference skips never-stored photons
        live = np.asarray(grid.power)[:n].sum(axis=1) > 0
        xy, vis = project_points(cam, pos[live], width, height)
        xy = xy[vis]
        out[xy[:, 1], xy[:, 0]] = np.asarray(color, np.uint8)
    return out
