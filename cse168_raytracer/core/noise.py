"""Procedural noise as pure jnp functions (differentiable).

Replaces the vendored native libs:
- Perlin improved noise  (lib/include/Perlin.h:13-54, perm table
  lib/src/Perlin.cpp:3-38) — same permutation table, fade and gradient
  hash, so values match the reference bit-for-bit up to float order.
- Worley cellular noise  (lib/include/Worley.h, lib/src/Worley.cpp)
  — same per-cube Knuth LCG (702395077/915488749/2120969693 cube hash,
  churn 1402024253 x + 586950981), same Poisson count table and
  DENSITY_ADJUSTMENT=0.398150. We evaluate all 27 neighbor cubes
  branch-free with up to 5 masked candidate points per cube and use
  top_k instead of the reference's insertion sort + cube culling
  (Worley.cpp:214-295) — identical results, fixed-shape. The reference's
  3D path uses 64-bit `unsigned long` seeds on Linux (out-of-bounds
  reads of the 256-entry Poisson table — UB); we use the intended
  uint32 semantics, which is what its own 2D path and the Windows
  build do.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Ken Perlin's reference permutation (lib/src/Perlin.cpp:3-38), doubled.
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], dtype=np.int32)
_PERM2 = np.concatenate([_PERM, _PERM])

# Worley per-cube point count lookup (Worley.cpp:14-23).
_POISSON_COUNT = np.array([
    4, 3, 1, 1, 1, 2, 4, 2, 2, 2, 5, 1, 0, 2, 1, 2, 2, 0, 4, 3, 2, 1, 2, 1, 3, 2, 2, 4, 2, 2, 5, 1, 2, 3, 2, 2, 2, 2, 2, 3,
    2, 4, 2, 5, 3, 2, 2, 2, 5, 3, 3, 5, 2, 1, 3, 3, 4, 4, 2, 3, 0, 4, 2, 2, 2, 1, 3, 2, 2, 2, 3, 3, 3, 1, 2, 0, 2, 1, 1, 2,
    2, 2, 2, 5, 3, 2, 3, 2, 3, 2, 2, 1, 0, 2, 1, 1, 2, 1, 2, 2, 1, 3, 4, 2, 2, 2, 5, 4, 2, 4, 2, 2, 5, 4, 3, 2, 2, 5, 4, 3,
    3, 3, 5, 2, 2, 2, 2, 2, 3, 1, 1, 4, 2, 1, 3, 3, 4, 3, 2, 4, 3, 3, 3, 4, 5, 1, 4, 2, 4, 3, 1, 2, 3, 5, 3, 2, 1, 3, 1, 3,
    3, 3, 2, 3, 1, 5, 5, 4, 2, 2, 4, 1, 3, 4, 1, 5, 3, 3, 5, 3, 4, 3, 2, 2, 1, 1, 1, 1, 1, 2, 4, 5, 4, 5, 4, 2, 1, 5, 1, 1,
    2, 3, 3, 3, 2, 5, 2, 3, 3, 2, 0, 2, 1, 1, 4, 2, 1, 3, 2, 1, 2, 2, 3, 2, 5, 5, 3, 4, 5, 5, 2, 4, 4, 5, 3, 2, 2, 2, 1, 4,
    2, 3, 3, 4, 2, 5, 4, 2, 4, 2, 2, 2, 4, 5, 3, 2,
], dtype=np.int32)

DENSITY_ADJUSTMENT = 0.398150  # Worley.cpp:27
_MAX_PTS_PER_CUBE = 5          # max of the Poisson table


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    """Perlin gradient hash (Perlin.h:46-52), branch-free."""
    h = h & 15
    u = jnp.where(h < 8, x, y)
    v = jnp.where(h < 4, y, jnp.where((h == 12) | (h == 14), x, z))
    return jnp.where((h & 1) == 0, u, -u) + jnp.where((h & 2) == 0, v, -v)


def perlin(x: jax.Array, y: jax.Array, z: jax.Array) -> jax.Array:
    """Improved Perlin noise, batched elementwise (Perlin.h:16-40)."""
    perm = jnp.asarray(_PERM2)
    xi = jnp.floor(x).astype(jnp.int32) & 255
    yi = jnp.floor(y).astype(jnp.int32) & 255
    zi = jnp.floor(z).astype(jnp.int32) & 255
    xf = x - jnp.floor(x)
    yf = y - jnp.floor(y)
    zf = z - jnp.floor(z)
    u, v, w = _fade(xf), _fade(yf), _fade(zf)

    a = perm[xi] + yi
    aa = perm[a] + zi
    ab = perm[a + 1] + zi
    b = perm[xi + 1] + yi
    ba = perm[b] + zi
    bb = perm[b + 1] + zi

    def lerp(t, p, q):
        return p + t * (q - p)

    return lerp(w,
                lerp(v, lerp(u, _grad(perm[aa], xf, yf, zf),
                                _grad(perm[ba], xf - 1, yf, zf)),
                        lerp(u, _grad(perm[ab], xf, yf - 1, zf),
                                _grad(perm[bb], xf - 1, yf - 1, zf))),
                lerp(v, lerp(u, _grad(perm[aa + 1], xf, yf, zf - 1),
                                _grad(perm[ba + 1], xf - 1, yf, zf - 1)),
                        lerp(u, _grad(perm[ab + 1], xf, yf - 1, zf - 1),
                                _grad(perm[bb + 1], xf - 1, yf - 1, zf - 1))))


def perlin_turbulence(p: jax.Array, octaves: int = 4,
                      lacunarity: float = 2.0, gain: float = 0.5) -> jax.Array:
    """Sum of |perlin| octaves (used by the Stone/Cloud textures,
    Texture.cpp:358-440).

    The octave loop rides lax.scan so the perlin graph is traced ONCE
    per call site instead of `octaves` times: the petal/final scene
    inlines the procedural stack into every shading site of every
    unrolled bounce level, and the unrolled octaves multiplied that
    into a ~2-minute first jit (PERF.md); amp/freq walk along as scan
    inputs."""
    amps = gain ** np.arange(octaves, dtype=np.float32)
    freqs = lacunarity ** np.arange(octaves, dtype=np.float32)

    def body(acc, af):
        amp, freq = af
        return acc + amp * jnp.abs(perlin(p[..., 0] * freq,
                                          p[..., 1] * freq,
                                          p[..., 2] * freq)), None

    out, _ = jax.lax.scan(body, jnp.zeros(p.shape[:-1], dtype=p.dtype),
                          (jnp.asarray(amps), jnp.asarray(freqs)))
    return out


# ---------------------------------------------------------------------------
# Worley cellular noise
# ---------------------------------------------------------------------------

_LCG_MUL = np.uint32(1402024253)
_LCG_ADD = np.uint32(586950981)


def _churn(seed):
    return seed * _LCG_MUL + _LCG_ADD


def _cube_points_3d(cube_idx):
    """Feature points of one integer cube (Worley.cpp addSamples 3D).

    cube_idx: (..., 3) int32. Returns (count (...,), pts (...,5,3) in
    cube-local+cube coords, ids (...,5) uint32).
    """
    xi = cube_idx[..., 0].astype(jnp.uint32)
    yi = cube_idx[..., 1].astype(jnp.uint32)
    zi = cube_idx[..., 2].astype(jnp.uint32)
    seed = (np.uint32(702395077) * xi + np.uint32(915488749) * yi
            + np.uint32(2120969693) * zi)
    count = jnp.asarray(_POISSON_COUNT)[(seed >> 24).astype(jnp.int32)]
    seed = _churn(seed)
    pts = []
    ids = []
    for _ in range(_MAX_PTS_PER_CUBE):
        ids.append(seed)
        seed = _churn(seed)
        fx = (seed.astype(jnp.float32) + 0.5) * (1.0 / 4294967296.0)
        seed = _churn(seed)
        fy = (seed.astype(jnp.float32) + 0.5) * (1.0 / 4294967296.0)
        seed = _churn(seed)
        fz = (seed.astype(jnp.float32) + 0.5) * (1.0 / 4294967296.0)
        seed = _churn(seed)
        pts.append(jnp.stack([fx, fy, fz], axis=-1))
    pts = jnp.stack(pts, axis=-2) + cube_idx.astype(jnp.float32)[..., None, :]
    return count, pts, jnp.stack(ids, axis=-1)


def worley3(at: jax.Array, max_order: int = 2):
    """Worley F1..Fn for 3D points `at` (..., 3).

    Returns (F (..., n), delta (..., n, 3), ids (..., n) uint32), with
    F scaled so mean(F1)=1 exactly as the reference
    (Worley.cpp:287-293). Branch-free 27-cube evaluation.
    """
    p = DENSITY_ADJUSTMENT * at
    base = jnp.floor(p).astype(jnp.int32)
    offs = jnp.asarray(np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                            indexing="ij"), axis=-1
                                ).reshape(27, 3).astype(np.int32))
    cubes = base[..., None, :] + offs                     # (..., 27, 3)
    count, pts, ids = _cube_points_3d(cubes)              # (...,27) (...,27,5,3)
    delta = pts - p[..., None, None, :]                   # (...,27,5,3)
    d2 = jnp.sum(delta * delta, axis=-1)                  # (...,27,5)
    jmask = jnp.arange(_MAX_PTS_PER_CUBE, dtype=jnp.int32) < count[..., None]
    d2 = jnp.where(jmask, d2, 999999.9)

    flat_d2 = d2.reshape(*d2.shape[:-2], 27 * _MAX_PTS_PER_CUBE)
    flat_delta = delta.reshape(*delta.shape[:-3], 27 * _MAX_PTS_PER_CUBE, 3)
    flat_ids = ids.reshape(*ids.shape[:-2], 27 * _MAX_PTS_PER_CUBE)

    neg_top, top_idx = jax.lax.top_k(-flat_d2, max_order)
    f = jnp.sqrt(-neg_top) * (1.0 / DENSITY_ADJUSTMENT)
    dsel = jnp.take_along_axis(flat_delta, top_idx[..., None], axis=-2)
    dsel = dsel * (1.0 / DENSITY_ADJUSTMENT)
    isel = jnp.take_along_axis(flat_ids, top_idx, axis=-1)
    return f, dsel, isel


def _cube_points_2d(cube_idx):
    xi = cube_idx[..., 0].astype(jnp.uint32)
    yi = cube_idx[..., 1].astype(jnp.uint32)
    seed = np.uint32(702395077) * xi + np.uint32(915488749) * yi
    count = jnp.asarray(_POISSON_COUNT)[(seed >> 24).astype(jnp.int32)]
    seed = _churn(seed)
    pts = []
    ids = []
    for _ in range(_MAX_PTS_PER_CUBE):
        ids.append(seed)
        seed = _churn(seed)
        fx = (seed.astype(jnp.float32) + 0.5) * (1.0 / 4294967296.0)
        seed = _churn(seed)
        fy = (seed.astype(jnp.float32) + 0.5) * (1.0 / 4294967296.0)
        seed = _churn(seed)
        pts.append(jnp.stack([fx, fy], axis=-1))
    pts = jnp.stack(pts, axis=-2) + cube_idx.astype(jnp.float32)[..., None, :]
    return count, pts, jnp.stack(ids, axis=-1)


def worley2(at: jax.Array, max_order: int = 2):
    """Worley F1..Fn for 2D points `at` (..., 2). 9-cell evaluation."""
    p = DENSITY_ADJUSTMENT * at
    base = jnp.floor(p).astype(jnp.int32)
    offs = jnp.asarray(np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1],
                                            indexing="ij"), axis=-1
                                ).reshape(9, 2).astype(np.int32))
    cubes = base[..., None, :] + offs
    count, pts, ids = _cube_points_2d(cubes)
    delta = pts - p[..., None, None, :]
    d2 = jnp.sum(delta * delta, axis=-1)
    jmask = jnp.arange(_MAX_PTS_PER_CUBE, dtype=jnp.int32) < count[..., None]
    d2 = jnp.where(jmask, d2, 999999.9)

    flat_d2 = d2.reshape(*d2.shape[:-2], 9 * _MAX_PTS_PER_CUBE)
    flat_delta = delta.reshape(*delta.shape[:-3], 9 * _MAX_PTS_PER_CUBE, 2)
    flat_ids = ids.reshape(*ids.shape[:-2], 9 * _MAX_PTS_PER_CUBE)

    neg_top, top_idx = jax.lax.top_k(-flat_d2, max_order)
    f = jnp.sqrt(-neg_top) * (1.0 / DENSITY_ADJUSTMENT)
    dsel = jnp.take_along_axis(flat_delta, top_idx[..., None], axis=-2)
    dsel = dsel * (1.0 / DENSITY_ADJUSTMENT)
    isel = jnp.take_along_axis(flat_ids, top_idx, axis=-1)
    return f, dsel, isel
