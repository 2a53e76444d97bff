"""Pinhole/thin-lens camera as a pure batched ray generator.

Replaces Camera::eyeRay (Camera.cpp:103-161) — including the DOF mode
(-DDOF, Camera.cpp:135-148) — with a function over pixel-index arrays.
The reference caches the image-plane basis in function statics on first
call (Camera.cpp:106-125); here it is recomputed (cheap, fused by XLA).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cse168_raytracer.config import PI
from cse168_raytracer.core.sampling import uniform_disc
from cse168_raytracer.core.vecmath import safe_normalize
from cse168_raytracer.utils import pytree

DEG_TO_RAD = PI / 180.0
HALF_DEG_TO_RAD = DEG_TO_RAD / 2.0  # Camera.cpp:15


@pytree.dataclass
class Camera:
    eye: jax.Array       # (3,)
    view_dir: jax.Array  # (3,) unit (Camera.h:94-95 normalizes)
    up: jax.Array        # (3,)
    fov: jax.Array       # () degrees
    bg_color: jax.Array  # (3,) (stored on the camera in the reference)


def make_camera(eye, look_at, up=(0.0, 1.0, 0.0), fov=45.0,
                bg_color=(0.0, 0.0, 0.0)) -> Camera:
    eye = jnp.asarray(eye, jnp.float32)
    vd = safe_normalize(jnp.asarray(look_at, jnp.float32) - eye)
    return Camera(eye=eye, view_dir=vd, up=jnp.asarray(up, jnp.float32),
                  fov=jnp.asarray(fov, jnp.float32),
                  bg_color=jnp.asarray(bg_color, jnp.float32))


def camera_basis(cam: Camera, width: int, height: int):
    """Image-plane basis + extents (Camera.cpp:113-124)."""
    w_dir = safe_normalize(-cam.view_dir)
    u_dir = safe_normalize(jnp.cross(cam.up, w_dir))
    v_dir = jnp.cross(w_dir, u_dir)
    aspect = width / height
    top = jnp.tan(cam.fov * HALF_DEG_TO_RAD)
    right = aspect * top
    return w_dir, u_dir, v_dir, top, right


def eye_rays(cam: Camera, x: jax.Array, y: jax.Array, width: int,
             height: int, key=None, dof_aperture: float = 0.0,
             dof_focus: float = 0.0):
    """Generate one camera ray per (x, y) pixel index (any shape).

    key=None  -> deterministic rays through pixel centers (dx=dy=0.5,
                 Camera.cpp:127).
    key given -> jittered within the pixel (randomize=true).
    dof_aperture > 0 -> thin-lens: eye jittered on the aperture disc and
    directions re-aimed at the focus plane (Camera.cpp:135-148). DOF
    requires a key.
    Returns (origins (..., 3), directions (..., 3) unit).
    """
    w_dir, u_dir, v_dir, top, right = camera_basis(cam, width, height)
    left, bottom = -right, -top
    shape = x.shape
    xf = x.astype(jnp.float32)
    yf = y.astype(jnp.float32)
    if key is None:
        dx = dy = 0.5
    else:
        kj, kd = jax.random.split(key)
        j = jax.random.uniform(kj, shape + (2,))
        dx, dy = j[..., 0], j[..., 1]

    u = left + (right - left) * ((xf + dx) / width)     # Camera.cpp:157
    v = bottom + (top - bottom) * ((yf + dy) / height)  # Camera.cpp:158

    if dof_aperture > 0.0:
        assert key is not None, "DOF requires a random key"
        disc = uniform_disc(kd, dof_aperture, shape)
        new_eye = (cam.eye + disc[..., 0:1] * u_dir + disc[..., 1:2] * v_dir)
        focus_pt = cam.eye + cam.view_dir * dof_focus
        local_w = safe_normalize(-(focus_pt - new_eye))   # Camera.cpp:142-145
        o = new_eye
    else:
        o = jnp.broadcast_to(cam.eye, shape + (3,))
        local_w = w_dir

    d = safe_normalize(u[..., None] * u_dir + v[..., None] * v_dir - local_w)
    return o, d
