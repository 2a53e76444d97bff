"""Wavefront shading: bump-mapped normals + Phong direct lighting (NEE).

Reproduces Phong::shade (Phong.cpp:44-161) and the bump-mapping block of
Scene::trace (Scene.cpp:232-266) over SoA wavefronts:

- per light: sample an origin, cast a shadow ray through the SAME
  closest-hit kernel with tMax = light distance, apply the reference's
  refractive-occluder attenuation (dot(N_occluder, l), Phong.cpp:98-113)
  instead of full blocking;
- point/square falloff 1/(4 pi^2 r^2) (Phong.cpp:140); directional-area
  beam test with constant 1/pi falloff (Phong.cpp:122-136);
- diffuse term  light_color * max(0, nDotL * falloff * wattage) *
  texColor * kd (the reference's kd^2 quirk for untextured materials is
  inherited because texColor == kd for TEX_CONSTANT);
- specular highlight max(0,min(1,dot(e,r)))^500 * falloff * wattage
  added as a scalar when shininess < infinity (Phong.cpp:149-156).

Bump mapping (Scene.cpp:234-263): central differences of bumpHeight2D
in UV perturb the normal via the reference's exact tangent construction,
then normalize. For materials with no bump map the heights are 0 and
this reduces to plain normalization of the interpolated normal — which
the reference relies on (Triangle normals are interpolated unnormalized,
Triangle.cpp:162).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cse168_raytracer.config import EPSILON
from cse168_raytracer.core.fastgather import select_component, take_rows
from cse168_raytracer.core.vecmath import safe_normalize
from cse168_raytracer.models.lights import nee_sample
from cse168_raytracer.models.materials import SHININESS_INF, is_refractive
from cse168_raytracer.models.scene import Scene, SceneStatic
from cse168_raytracer.models.textures import bump_height, diffuse_color
from cse168_raytracer.ops.intersect import closest_hit
from cse168_raytracer.ops.surface import Surface, make_surface


def trace_closest(scene: Scene, static: SceneStatic, o, d, tmin=0.0,
                  tmax=None, collect_stats: bool = False):
    """Scene::trace equivalent: closest hit + surface + bump-perturbed
    normal. Returns (Hit, Surface) with Surface.n normalized.

    collect_stats=True returns (Hit, Surface, (box_sum, tri_sum)) —
    the in-traversal -DSTATS counters summed over the wavefront as
    float32 scalars (f32: per-render totals overflow int32 at
    bunny20 scale)."""
    from cse168_raytracer.config import MIRO_TMAX
    if tmax is None:
        tmax = MIRO_TMAX
    counters = None
    if scene.accel is not None:
        from cse168_raytracer.ops.accel import scene_closest_hit
        res = scene_closest_hit(
            scene.accel, scene.tris, scene.spheres, scene.planes,
            o, d, tmin, tmax, blpatches=scene.blpatches,
            with_stats=collect_stats)
        if collect_stats:
            hit, box, tri = res
            counters = (jnp.sum(box.astype(jnp.float32)),
                        jnp.sum(tri.astype(jnp.float32)))
        else:
            hit = res
    else:
        hit = closest_hit(scene.tris, scene.spheres, scene.planes,
                          o, d, tmin, tmax, blpatches=scene.blpatches)
        if collect_stats:
            counters = (jnp.float32(0.0), jnp.float32(0.0))
    surf = make_surface(scene.tris, scene.spheres, scene.planes, o, d, hit,
                        blpatches=scene.blpatches)
    n = apply_bump(scene, static, surf)
    surf = surf._replace(n=n)
    if collect_stats:
        return hit, surf, counters
    return hit, surf


def apply_bump(scene: Scene, static: SceneStatic, surf: Surface):
    """Bump-map normal perturbation (Scene.cpp:234-263), or plain
    normalization when the scene has no bump maps."""
    n = surf.n
    if not static.any_bump:
        return safe_normalize(n)
    delta = 1e-4                                     # Scene.cpp:235
    mid, uv = surf.material_id, surf.uv
    du = jnp.array([delta, 0.0], n.dtype)
    dv = jnp.array([0.0, delta], n.dtype)
    kinds = static.texture_kinds
    u1 = bump_height(scene.materials, mid, uv - du, kinds)
    u2 = bump_height(scene.materials, mid, uv + du, kinds)
    v1 = bump_height(scene.materials, mid, uv - dv, kinds)
    v2 = bump_height(scene.materials, mid, uv + dv, kinds)
    dx = (u2 - u1) / (2 * delta)
    dy = (v2 - v1) / (2 * delta)
    # reference tangent construction (Scene.cpp:252-260): pick the
    # largest-component axis m, build randomVec with -n[m] in a rotated
    # slot, t1 = cross(N, randomVec)
    m = jnp.where(n[:, 1] > n[:, 0], 1, 0)
    m = jnp.where(n[:, 2] > select_component(n, m), 2, m)
    nm = select_component(n, m)
    rand_vec = jnp.stack([jnp.where(m == 2, -nm, 0.0),
                          jnp.where(m == 0, -nm, 0.0),
                          jnp.where(m == 1, -nm, 0.0)], axis=-1)
    t1 = jnp.cross(n, rand_vec)
    n_new = (n + dx[:, None] * jnp.cross(n, t1)
             - dy[:, None] * jnp.cross(n, jnp.cross(n, t1)))
    return safe_normalize(n_new)


def shade_direct(scene: Scene, static: SceneStatic, ray_d: jax.Array,
                 surf: Surface, key: jax.Array,
                 disable_shadows: bool = False,
                 light_samples: int = 1,
                 collect_stats: bool = False):
    """Phong::shade over a wavefront. ray_d: (N,3) incoming directions.

    Returns (N,3) direct radiance (zero where surf.hit is False), plus
    the texture diffuse color (reused by callers for photon RR) and an
    optional shadow-ray count for stats. collect_stats=True appends a
    4th return: (box_sum, tri_sum) f32 scalars summed over every
    shadow traversal (zeros for accels without in-traversal counters).

    light_samples > 1 runs the reference's per-light multi-sample loop
    (Phong.cpp:77-80, contribution scaled 1/samples Phong.cpp:145,153)
    with SquareLight origins stratified over the sample grid
    (SquareLight.h:23-39).
    """
    mats = scene.materials
    mid = surf.material_id
    tex_color = diffuse_color(mats, scene.images, mid, surf.uv, surf.p,
                              static.texture_kinds,
                              cellulars=scene.cellulars)
    kd = take_rows(mats.kd, mid)
    shininess = take_rows(mats.shininess, mid)
    n = surf.n
    e = -ray_d

    total = jnp.zeros_like(surf.p)
    n_shadow = 0
    box_sum = jnp.float32(0.0)
    tri_sum = jnp.float32(0.0)
    for li, si in [(li, si) for li in range(static.num_lights)
                   for si in range(light_samples)]:
        lk = jax.random.fold_in(jax.random.fold_in(key, li), si)
        s = nee_sample(scene.lights, li, surf.p, n, lk,
                       sample_idx=si, total_samples=light_samples)

        # shadow ray (Phong.cpp:91-114): origin P + l*eps, tMax = dist.
        # -DDISABLE_SHADOWS (Phong.cpp:91) skips the trace entirely.
        intensity = jnp.ones_like(s.dist)
        occluded = jnp.zeros(s.dist.shape, bool)
        if not disable_shadows:
            from cse168_raytracer.ops.accel import (scene_any_hit,
                                                    scene_closest_hit)
            sh_o = surf.p + s.l * EPSILON
            # suppress shadow work for lanes that missed the scene, for
            # backfacing lanes with no highlight term (their visible
            # contribution is zero either way, Phong.cpp:140-156), and
            # for lanes outside a directional light's beam
            could_shine = (s.n_dot_l > 0.0) | (shininess < SHININESS_INF)
            sh_live = surf.hit & could_shine & s.in_beam
            sh_tmax = jnp.where(sh_live, s.dist, -1.0)
            n_shadow += 1
            if scene.accel is not None and not static.any_refractive:
                # boolean occlusion suffices -> any-hit with early exit
                # (gradient-stopped inside scene_any_hit)
                if collect_stats:
                    occluded, sbox, stri = scene_any_hit(
                        scene.accel, scene.tris, scene.spheres,
                        scene.planes, sh_o, s.l, 0.0, sh_tmax,
                        blpatches=scene.blpatches, with_stats=True)
                    box_sum = box_sum + jnp.sum(sbox.astype(jnp.float32))
                    tri_sum = tri_sum + jnp.sum(stri.astype(jnp.float32))
                else:
                    occluded = scene_any_hit(scene.accel, scene.tris,
                                             scene.spheres, scene.planes,
                                             sh_o, s.l, 0.0, sh_tmax,
                                             blpatches=scene.blpatches)
            else:
                if scene.accel is not None:
                    sh_res = scene_closest_hit(
                        scene.accel, scene.tris, scene.spheres,
                        scene.planes, sh_o, s.l, 0.0, sh_tmax,
                        blpatches=scene.blpatches,
                        with_stats=collect_stats)
                    if collect_stats:
                        sh_hit, sbox, stri = sh_res
                        box_sum = box_sum + jnp.sum(
                            sbox.astype(jnp.float32))
                        tri_sum = tri_sum + jnp.sum(
                            stri.astype(jnp.float32))
                    else:
                        sh_hit = sh_res
                else:
                    sh_hit = closest_hit(scene.tris, scene.spheres,
                                         scene.planes, sh_o, s.l, 0.0,
                                         sh_tmax, blpatches=scene.blpatches)
                occluded = sh_hit.hit
                if static.any_refractive:
                    # refractive occluders attenuate instead of blocking
                    sh_surf = make_surface(scene.tris, scene.spheres,
                                           scene.planes, sh_o, s.l, sh_hit,
                                           blpatches=scene.blpatches)
                    occ_refr = is_refractive(mats, sh_surf.material_id)
                    occ_ndl = jnp.sum(safe_normalize(sh_surf.n) * s.l,
                                      axis=-1)
                    pass_through = occluded & occ_refr & (occ_ndl >= EPSILON)
                    intensity = jnp.where(pass_through, occ_ndl, intensity)
                    occluded = occluded & ~pass_through
        visible = ~occluded & s.in_beam

        # wattage / samples (Phong.cpp:145,153)
        w = scene.lights.wattage[li] / light_samples
        lcol = scene.lights.color[li]
        diff_term = jnp.maximum(0.0, s.n_dot_l * s.falloff * w)
        contrib = (lcol * diff_term[..., None] * tex_color * kd
                   * intensity[..., None])

        # specular highlight (Phong.cpp:149-156): scalar added to rgb
        r = -s.l + 2.0 * jnp.sum(s.l * n, axis=-1, keepdims=True) * n
        e_dot_r = jnp.clip(jnp.sum(e * r, axis=-1), 0.0, 1.0) ** 500
        highlight = jnp.maximum(0.0, e_dot_r * s.falloff * w)
        has_highlight = shininess < SHININESS_INF
        contrib = contrib + jnp.where(has_highlight, highlight, 0.0)[..., None]

        total = total + jnp.where(visible[..., None], contrib, 0.0)

    total = jnp.where(surf.hit[..., None], total, 0.0)
    if collect_stats:
        return total, tex_color, n_shadow, (box_sum, tri_sum)
    return total, tex_color, n_shadow
