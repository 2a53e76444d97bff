"""Sampling transforms + functional RNG.

Replaces the reference's libc rand() utilities (Utility.h:13-95,
Ray.h:109-165) with jax.random key threading and analytic transforms
(rejection loops don't fit fixed-shape wavefront programs):

- cosine_hemisphere: the reference's phi = asin(sqrt(u)) polar draw
  (Ray.h:132) IS exact cosine-weighted sampling; we use the standard
  sqrt form which is the same distribution.
- glossy (Phong lobe): phi = acos(u^(1/(1+shininess))) (Ray.h:152),
  pdf (s+1)/(2 pi) cos^s.
- uniform sphere / hemisphere: replaces rejection sampling
  (Utility.h:53-80) with inverse-CDF transforms.
- concentric/uniform disc: replaces rejection sampleDisc (Utility.h:82-95).
All samplers are pure functions of a jax.random key and differentiable
w.r.t. any continuous parameters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cse168_raytracer.config import PI
from cse168_raytracer.core.vecmath import align_hemisphere, onb, safe_normalize


def cosine_hemisphere(key: jax.Array, n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Cosine-weighted direction about unit normal n. Returns (dir, pdf).

    Distribution identical to Ray.h:124-140: polar angle asin(sqrt(u1)),
    azimuth 2 pi u2, aligned to n. pdf = cos(theta)/pi.
    """
    shape = n.shape[:-1]
    u = jax.random.uniform(key, shape + (2,), dtype=n.dtype)
    phi_polar = jnp.arcsin(jnp.sqrt(u[..., 0]))       # Ray.h:132
    theta = 2.0 * PI * u[..., 1]                      # Ray.h:133
    d = align_hemisphere(n, theta, phi_polar)
    pdf = jnp.cos(phi_polar) / PI
    return d, pdf


def phong_lobe(key: jax.Array, axis: jax.Array, shininess: jax.Array):
    """Glossy direction about `axis` with Phong exponent `shininess`.

    Matches Ray.h:149-158: polar acos(u^(1/(1+s))), azimuth 2 pi u2.
    Returns (dir, cos_alpha) where cos_alpha = dot(dir-lobe axis angle).
    pdf = (s+1)/(2 pi) * cos_alpha^s.
    """
    shape = axis.shape[:-1]
    u = jax.random.uniform(key, shape + (2,), dtype=axis.dtype)
    # guard u=0 so u**(1/(1+s)) stays differentiable; s can be large
    u0 = jnp.clip(u[..., 0], 1e-12, 1.0)
    cos_alpha = u0 ** (1.0 / (1.0 + shininess))
    phi_polar = jnp.arccos(jnp.clip(cos_alpha, -1.0, 1.0))
    theta = 2.0 * PI * u[..., 1]
    d = align_hemisphere(axis, theta, phi_polar)
    return d, cos_alpha


def uniform_sphere(key: jax.Array, shape=(), dtype=jnp.float32) -> jax.Array:
    """Uniform direction on S2 (replaces sampleSphericalDirection,
    Utility.h:68-80) via inverse CDF."""
    u = jax.random.uniform(key, tuple(shape) + (2,), dtype=dtype)
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.clip(1.0 - z * z, 0.0, None))
    theta = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), z], axis=-1)


def uniform_hemisphere(key: jax.Array, n: jax.Array) -> jax.Array:
    """Uniform direction on the hemisphere around unit normal n
    (replaces sampleHemisphereDirection, Utility.h:53-65)."""
    d = uniform_sphere(key, n.shape[:-1], n.dtype)
    flip = jnp.sum(d * n, axis=-1, keepdims=True) < 0.0
    return jnp.where(flip, -d, d)


def uniform_disc(key: jax.Array, radius, shape=(), dtype=jnp.float32) -> jax.Array:
    """Uniform point on a disc of given radius; returns (..., 2).

    Replaces rejection sampleDisc (Utility.h:82-95) with the polar
    inverse-CDF transform (same distribution).
    """
    u = jax.random.uniform(key, tuple(shape) + (2,), dtype=dtype)
    r = radius * jnp.sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def cosine_hemisphere_about(key: jax.Array, n: jax.Array):
    """Cosine-weighted sample returning direction only (photon emission
    from area lights, SquareLight.h:41-48 uses the same asin(sqrt) draw)."""
    d, _ = cosine_hemisphere(key, n)
    return d


def stratified_grid_jitter(key: jax.Array, n_side: int, dtype=jnp.float32):
    """n_side^2 stratified 2D samples in [0,1)^2 (SquareLight.h:23-39)."""
    u = jax.random.uniform(key, (n_side, n_side, 2), dtype=dtype)
    ij = jnp.stack(jnp.meshgrid(jnp.arange(n_side), jnp.arange(n_side),
                                indexing="ij"), axis=-1).astype(dtype)
    return ((ij + u) / n_side).reshape(n_side * n_side, 2)


def sphere_surface_to_dir(n: jax.Array, key: jax.Array):
    """Tangent-frame helper kept for API symmetry."""
    t1, t2 = onb(n)
    d = uniform_sphere(key, n.shape[:-1], n.dtype)
    return safe_normalize(d[..., 0:1] * t1 + d[..., 1:2] * t2 + d[..., 2:3] * n)
