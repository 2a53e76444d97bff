"""Wavefront integrator — the data-parallel replacement for the recursive
Scene::traceScene (Scene.cpp:270-346).

The reference recurses depth-first per pixel: shade, then follow a
reflection branch (weight ks), and for refractive materials BOTH a
Fresnel-reflection branch (weight kt*Rs when Rs > 0.01) and a
refraction branch (weight kt*(1-Rs)). Recursion depth TRACE_DEPTH.

Here each recursion level is a fixed-capacity SoA wavefront advanced
under lax.scan:

  state: (origin, dir, weight rgb, pixel id, alive)
  per level:  closest-hit -> NEE shading -> photon-map irradiance on
              diffuse hits -> env-map on miss, all scatter-added into a
              per-pixel radiance buffer; then each ray spawns up to two
              children:
                mirror child  w *= ks + kt*Rs*[Rs>0.01]   (merged: the
                  reference's separate ks-reflection and Fresnel-
                  reflection rays have the same direction in Whitted
                  mode — merging is exact; in path-traced mode it is a
                  1-sample estimate of the same sum)
                refract child w *= kt*(1-Rs)   (TIR falls back to the
                  mirror direction inside refract(), Ray.h:224-227)
              children are stream-compacted into the next level's pool
              (capacity C, overflow dropped and counted).

Path-tracing mode (-DPATH_TRACING) additionally importance-samples the
glossy Phong lobe about the mirror/refracted directions with exponent
`shininess` (Ray.h:149-158, 235-242). There is NO diffuse bounce for
camera rays in either mode — diffuse interreflection comes exclusively
from the photon map (Scene.cpp:286-299), exactly like the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from cse168_raytracer.config import EPSILON, RenderConfig
from cse168_raytracer.core.fastgather import take_rows
from cse168_raytracer.core.sampling import phong_lobe
from cse168_raytracer.core.vecmath import (fresnel_rs, reflect, refract,
                                           safe_normalize)
from cse168_raytracer.models.scene import Scene, SceneStatic
from cse168_raytracer.models.textures import env_lookup
from cse168_raytracer.ops.shading import shade_direct, trace_closest
from cse168_raytracer.render.camera import Camera, eye_rays


class Wavefront(NamedTuple):
    o: jax.Array        # (C, 3)
    d: jax.Array        # (C, 3)
    weight: jax.Array   # (C, 3)
    pixel: jax.Array    # (C,) i32
    alive: jax.Array    # (C,) bool


class RenderStats(NamedTuple):
    """On-device counters (Stats.h equivalents, SURVEY.md #29).

    box_tests / tri_tests are the -DSTATS traversal counters measured
    INSIDE the traversal across every walk the render did —
    closest-hit, shadow, and secondary alike (BVH.cpp:63-65,486-497
    accounting) — as f32 sums (int32 overflows at bunny20 totals).
    Zero unless cfg.collect_stats and the accel counts in-traversal
    (the cuda and bvh kinds).
    """
    primary_rays: jax.Array
    secondary_rays: jax.Array
    shadow_rays: jax.Array
    dropped_rays: jax.Array   # pool-overflow children (no ref equivalent)
    box_tests: jax.Array | float = 0.0
    tri_tests: jax.Array | float = 0.0


def _pad_wavefront(o, d, weight, pixel, capacity: int) -> Wavefront:
    n = o.shape[0]
    pad = capacity - n
    assert pad >= 0
    if pad:
        z3 = jnp.zeros((pad, 3), o.dtype)
        o = jnp.concatenate([o, z3])
        d = jnp.concatenate([d, jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0], o.dtype), (pad, 3))])
        weight = jnp.concatenate([weight, z3])
        pixel = jnp.concatenate([pixel, jnp.zeros((pad,), jnp.int32)])
    alive = jnp.arange(capacity) < n
    return Wavefront(o=o, d=d, weight=weight, pixel=pixel, alive=alive)


def _compact(cands: Wavefront, capacity: int):
    """Stream-compact alive candidate rays into a fresh pool.

    cands arrays have leading dim K >= capacity. Returns (Wavefront,
    dropped_count). Fixed shapes: scatter with mode='drop'.
    """
    alive = cands.alive
    idx = jnp.cumsum(alive.astype(jnp.int32)) - 1
    dest = jnp.where(alive & (idx < capacity), idx, capacity)
    dropped = jnp.sum((alive & (idx >= capacity)).astype(jnp.int32))

    def scat(x):
        init = jnp.zeros((capacity,) + x.shape[1:], x.dtype)
        return init.at[dest].set(x, mode="drop")

    slot_alive = jnp.arange(capacity) < jnp.sum(alive.astype(jnp.int32))
    d = scat(cands.d)
    d = jnp.where(slot_alive[:, None], d,
                  jnp.array([0.0, 0.0, 1.0], d.dtype))  # placeholder dir
    nw = Wavefront(o=scat(cands.o), d=d, weight=scat(cands.weight),
                   pixel=scat(cands.pixel.astype(jnp.int32)),
                   alive=slot_alive)
    return nw, dropped


def integrate(scene: Scene, static: SceneStatic, o: jax.Array, d: jax.Array,
              pixel: jax.Array, n_pixels: int, key: jax.Array,
              depth: int, path_tracing: bool,
              capacity: Optional[int] = None,
              collect_stats: bool = False,
              disable_shadows: bool = False,
              light_samples: int = 1,
              ray_order: bool = False):
    """Trace a primary wavefront to completion.

    o, d: (N, 3) primary rays; pixel: (N,) pixel ids in [0, n_pixels).
    Returns (radiance (n_pixels, 3) — SUM over the wavefront (caller
    divides by spp), RenderStats).

    ray_order=True returns radiance indexed by PRIMARY-RAY LANE (N, 3)
    instead (`pixel`/`n_pixels` ignored): the level-0 contribution — the
    bulk of the image — becomes an elementwise add instead of a 262k-row
    scatter; only child levels still scatter (into their primary ancestor's
    lane). The caller un-permutes once (render_hdr's block un-shuffle
    is a reshape+transpose).
    """
    n0 = o.shape[0]
    if capacity is None:
        capacity = n0 * (2 if static.any_refractive else 1)
    capacity = max(capacity, n0)

    if ray_order:
        n_pixels = n0
        pixel = jnp.arange(n0, dtype=jnp.int32)
    radiance = jnp.zeros((n_pixels, 3), jnp.float32)
    wf = _pad_wavefront(o, d, jnp.ones((n0, 3), jnp.float32),
                        pixel.astype(jnp.int32), capacity)

    shininess = scene.materials.shininess
    ior_t = scene.materials.ior
    ks_t = scene.materials.ks
    kt_t = scene.materials.kt

    def _live_level(carry, level_key, first: bool = False):
        wf, radiance, sec, shad, drop, boxt, trit = carry
        # dead lanes get tmax < tmin: every slab test fails, so whole
        # blocks are culled for tiles of dead rays (front-packed pools
        # make those tiles contiguous)
        from cse168_raytracer.config import MIRO_TMAX
        lane_tmax = jnp.where(wf.alive, MIRO_TMAX, -1.0)
        if collect_stats:
            hit, surf, (cbox, ctri) = trace_closest(
                scene, static, wf.o, wf.d, tmax=lane_tmax,
                collect_stats=True)
            boxt = boxt + cbox
            trit = trit + ctri
        else:
            hit, surf = trace_closest(scene, static, wf.o, wf.d,
                                      tmax=lane_tmax)
        live_hit = wf.alive & hit.hit
        k_shade, k_lobe1, k_lobe2 = jax.random.split(level_key, 3)

        if collect_stats:
            direct, _tex, n_sh, (sbox, stri) = shade_direct(
                scene, static, wf.d, surf, k_shade,
                disable_shadows=disable_shadows,
                light_samples=light_samples, collect_stats=True)
            boxt = boxt + sbox
            trit = trit + stri
        else:
            direct, _tex, n_sh = shade_direct(
                scene, static, wf.d, surf, k_shade,
                disable_shadows=disable_shadows,
                light_samples=light_samples)
        contrib = direct

        if scene.photons is not None:
            from cse168_raytracer.ops.photon import irradiance_estimate
            from cse168_raytracer.models.materials import is_diffuse
            diff_mask = is_diffuse(scene.materials, surf.material_id)
            irr = irradiance_estimate(scene.photons, surf.p, surf.n)
            contrib = contrib + jnp.where(diff_mask[:, None], irr, 0.0)

        # env on miss (Scene.cpp:338-342); camera rays never carry the
        # isDiffuse flag (Ray.h:119,137 is only set on photon bounces)
        env = env_lookup(scene.env, wf.d, jnp.zeros(capacity, bool))
        add = jnp.where(live_hit[:, None], contrib,
                        jnp.where(wf.alive[:, None], env, 0.0))
        if ray_order and first:
            # level-0 lanes [0:n0) ARE the primary rays: elementwise add
            radiance = radiance + (wf.weight * add)[:n_pixels]
        else:
            radiance = radiance.at[wf.pixel].add(wf.weight * add,
                                                 mode="drop")

        # ---- children ----
        # purely diffuse scenes never spawn children (the reference's
        # recursion just doesn't recurse past Phong::shade when ks and
        # kt are zero, Scene.cpp:302-336) — skip the Fresnel/compact
        # machinery statically
        if not (static.any_reflective or static.any_refractive):
            dead = Wavefront(o=wf.o, d=wf.d, weight=jnp.zeros_like(wf.weight),
                             pixel=wf.pixel,
                             alive=jnp.zeros_like(wf.alive))
            shad = shad + n_sh * jnp.sum(live_hit.astype(jnp.int32))
            return (dead, radiance, sec, shad, drop, boxt, trit)
        mid = surf.material_id
        n = surf.n
        ks = take_rows(ks_t, mid)
        kt = take_rows(kt_t, mid)
        ior = take_rows(ior_t, mid)
        shin = take_rows(shininess, mid)

        refl_flag = jnp.any(ks > 0, axis=-1)
        refr_flag = jnp.any(kt > 0, axis=-1)

        rs = fresnel_rs(wf.d, n, ior)
        mirror_w = (jnp.where(refl_flag[:, None], ks, 0.0)
                    + jnp.where((refr_flag & (rs > 0.01))[:, None],
                                kt * rs[:, None], 0.0))
        refr_d, _tir = refract(wf.d, n, ior)
        refr_w = jnp.where(refr_flag[:, None], kt * (1.0 - rs[:, None]), 0.0)

        mirror_d = safe_normalize(reflect(wf.d, n))
        if path_tracing:
            # glossy perturbation about each axis (Ray.h:149-158, 235-242)
            mirror_d, _ = phong_lobe(k_lobe1, mirror_d, shin)
            refr_d, _ = phong_lobe(k_lobe2, safe_normalize(refr_d), shin)
        else:
            refr_d = safe_normalize(refr_d)

        def child(dir_c, w_c):
            w = wf.weight * w_c
            return Wavefront(
                o=surf.p + dir_c * EPSILON,   # Ray.h:91/162/241 offset
                d=dir_c,
                weight=w,
                pixel=wf.pixel,
                alive=live_hit & jnp.any(w > 0, axis=-1),
            )

        c1 = child(mirror_d, mirror_w)
        c2 = child(refr_d, refr_w)
        cands = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), c1, c2)
        new_wf, dropped = _compact(cands, capacity)

        sec = sec + jnp.sum(new_wf.alive.astype(jnp.int32))
        shad = shad + n_sh * jnp.sum(live_hit.astype(jnp.int32))
        drop = drop + dropped
        return (new_wf, radiance, sec, shad, drop, boxt, trit)

    # Levels are UNROLLED in python, not lax.scan-ed: XLA conditionals
    # and scan carries copy the multi-MB radiance/wavefront buffers per
    # level, and scenes that
    # cannot spawn children statically collapse to ONE level here — the
    # reference's recursion simply not recursing (Scene.cpp:302-336).
    can_spawn = static.any_reflective or static.any_refractive
    n_levels = (depth + 1) if can_spawn else 1
    keys = jax.random.split(key, max(n_levels, 1))
    zero = jnp.int32(0)
    zf = jnp.float32(0.0)
    carry = (wf, radiance, zero, zero, zero, zf, zf)
    for li in range(n_levels):
        carry = _live_level(carry, keys[li], first=(li == 0))
    wf, radiance, sec, shad, drop, boxt, trit = carry

    stats = RenderStats(primary_rays=jnp.int32(n0), secondary_rays=sec,
                        shadow_rays=shad, dropped_rays=drop,
                        box_tests=boxt, tri_tests=trit)
    return radiance, stats


def render_hdr(scene: Scene, static: SceneStatic, cam: Camera,
               cfg: RenderConfig, key: jax.Array):
    """Scene::raytraceImage pre-tonemap phase (Scene.cpp:93-173).

    Returns ((H, W, 3) linear HDR radiance, RenderStats). Row 0 is the
    BOTTOM scanline (the reference's Image layout).
    """
    w, h = cfg.width, cfg.height
    n_pix = w * h
    # 16x8 pixel-block ray order: neighbouring rays (a tile, a warp)
    # cover compact pixel footprints instead of quarter-scanlines, so
    # they walk the same nodes. The per-pixel scatter by `pixel` id makes
    # the order transparent to the image. Built in numpy: shapes are
    # static and render_hdr may itself be traced.
    import numpy as np_
    ys_n, xs_n = np_.meshgrid(np_.arange(h), np_.arange(w), indexing="ij")
    xs_n = xs_n.reshape(-1)
    ys_n = ys_n.reshape(-1)
    order = np_.lexsort((xs_n % 16, ys_n % 8, xs_n // 16, ys_n // 8))
    xs = jnp.asarray(xs_n[order])
    ys = jnp.asarray(ys_n[order])
    pixel = (ys * w + xs).astype(jnp.int32)

    # ray-order accumulation: the block order enumerates (yb, xb, yi,
    # xi) lexicographically, so the ray->pixel un-permute is a pure
    # reshape+transpose — integrate() then never scatters for level 0
    ray_order = (h % 8 == 0) and (w % 16 == 0)

    def _unblock(rad):
        """(n_pix, 3) in block ray order -> (h*w, 3) in pixel order."""
        return (rad.reshape(h // 8, w // 16, 8, 16, 3)
                .transpose(0, 2, 1, 3, 4).reshape(h * w, 3))

    # row-tiled chunking (cfg.row_tile > 0): the 2.8M-lane final-scene
    # wavefront (2048x1365) would not fit; the block ray order makes
    # contiguous ray ranges row bands, so chunking is a reshape. The
    # radiance buffer stays full-frame (scatter-add per chunk).
    def _chunked(fn_one_chunk, chunk_key):
        rows = cfg.row_tile
        assert rows % 8 == 0, "row_tile must be a multiple of 8"
        cpx = w * rows
        n_chunks = -(-n_pix // cpx)
        assert n_chunks * cpx == n_pix, (
            f"height {h} not divisible by row_tile {rows}")
        xs_c = xs.reshape(n_chunks, cpx)
        ys_c = ys.reshape(n_chunks, cpx)
        px_c = pixel.reshape(n_chunks, cpx)

        def body(carry, chunk):
            rad, sec, shad, drop, boxt, trit = carry
            cxs, cys, cpix, ck = chunk
            r, st = fn_one_chunk(cxs, cys, cpix, ck)
            stats_c = (sec + st.secondary_rays, shad + st.shadow_rays,
                       drop + st.dropped_rays,
                       boxt + st.box_tests, trit + st.tri_tests)
            if ray_order:
                # chunks are contiguous ray ranges: stack, don't scatter
                return (rad,) + stats_c, r
            return (rad + r,) + stats_c, None

        keys = jax.random.split(chunk_key, n_chunks)
        zero = jnp.int32(0)
        zf = jnp.float32(0.0)
        rad0 = (jnp.zeros((0,), jnp.float32) if ray_order
                else jnp.zeros((n_pix, 3), jnp.float32))
        (rad, sec, shad, drop, boxt, trit), rs = jax.lax.scan(
            body, (rad0, zero, zero, zero, zf, zf),
            (xs_c, ys_c, px_c, keys))
        if ray_order:
            rad = rs.reshape(n_pix, 3)
        return rad, RenderStats(primary_rays=jnp.int32(n_pix),
                                secondary_rays=sec, shadow_rays=shad,
                                dropped_rays=drop, box_tests=boxt,
                                tri_tests=trit)

    sampled = cfg.path_tracing or cfg.dof
    if not sampled:
        if cfg.row_tile > 0:
            def one_chunk(cxs, cys, cpix, ck):
                o, d = eye_rays(cam, cxs, cys, w, h, key=None)
                return integrate(scene, static, o, d, cpix, n_pix, ck,
                                 cfg.trace_depth, path_tracing=False,
                                 collect_stats=cfg.collect_stats,
                                 disable_shadows=cfg.disable_shadows,
                                 light_samples=cfg.light_samples,
                                 ray_order=ray_order)
            radiance, stats = _chunked(one_chunk, key)
            if ray_order:
                radiance = _unblock(radiance)
            return radiance.reshape(h, w, 3), stats
        o, d = eye_rays(cam, xs, ys, w, h, key=None)
        radiance, stats = integrate(
            scene, static, o, d, pixel, n_pix, key,
            cfg.trace_depth, path_tracing=False,
            collect_stats=cfg.collect_stats,
            disable_shadows=cfg.disable_shadows,
            light_samples=cfg.light_samples,
            ray_order=ray_order)
        if ray_order:
            radiance = _unblock(radiance)
        return radiance.reshape(h, w, 3), stats

    spp = cfg.trace_samples

    def sample_body(carry, skey):
        acc, sec, shad, drop, boxt, trit = carry

        def one_chunk(cxs, cys, cpix, ck):
            k_cam, k_int = jax.random.split(ck)
            o, d = eye_rays(cam, cxs, cys, w, h, key=k_cam,
                            dof_aperture=cfg.dof_aperture if cfg.dof else 0.0,
                            dof_focus=cfg.dof_focus_plane)
            return integrate(scene, static, o, d, cpix, n_pix, k_int,
                             cfg.trace_depth,
                             path_tracing=cfg.path_tracing,
                             collect_stats=cfg.collect_stats,
                             disable_shadows=cfg.disable_shadows,
                             light_samples=cfg.light_samples,
                             ray_order=ray_order)

        if cfg.row_tile > 0:
            r, st = _chunked(one_chunk, skey)
        else:
            r, st = one_chunk(xs, ys, pixel, skey)
        return (acc + r, sec + st.secondary_rays, shad + st.shadow_rays,
                drop + st.dropped_rays, boxt + st.box_tests,
                trit + st.tri_tests), None

    keys = jax.random.split(key, spp)
    zero = jnp.int32(0)
    zf = jnp.float32(0.0)
    (acc, sec, shad, drop, boxt, trit), _ = jax.lax.scan(
        sample_body,
        (jnp.zeros((n_pix, 3), jnp.float32), zero, zero, zero, zf, zf),
        keys)
    stats = RenderStats(primary_rays=jnp.int32(n_pix * spp),
                        secondary_rays=sec, shadow_rays=shad,
                        dropped_rays=drop, box_tests=boxt,
                        tri_tests=trit)
    if ray_order:
        acc = _unblock(acc)
    return (acc / spp).reshape(h, w, 3), stats
