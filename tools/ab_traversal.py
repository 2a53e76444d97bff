"""Traversal A/B on the card: the CUDA kernel against what XLA makes of
the block sweep and the per-ray BVH walk.

For each accelerator kind, on sponza_proxy at bench.py's settings
(512x512, depth 4, 1 spp):
  * closest hit of the 262,144 eye rays alone;
  * any hit of their shadow rays (toward the point light) alone;
  * the jitted value_and_grad step over every material kd (the whole
    render: closest hit, shading, shadow rays, backward).
Kinds run in the order given, then again in reverse, in one process on
one card; both rounds are reported. `cuda` runs once per CUDA block
size in --blocks. Prints one line per measurement and writes everything
as JSON to --out.

    python tools/ab_traversal.py [--kinds cuda,block,bvh]
                                 [--blocks 128] [--out ab_traversal.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def steady(fn, *args, reps):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / reps


def measure(kind, raw, static, cam, cfg, reps, **opts):
    import jax
    import jax.numpy as jnp
    from cse168_raytracer.config import EPSILON, MIRO_TMAX
    from cse168_raytracer.ops.accel import (attach_accel, scene_any_hit,
                                            scene_closest_hit)
    from cse168_raytracer.render.camera import eye_rays
    from cse168_raytracer.render.integrator import render_hdr

    t0 = time.perf_counter()
    scene = attach_accel(raw, kind=kind, **opts)
    build_s = time.perf_counter() - t0
    w, h = cfg.width, cfg.height
    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    o, d = eye_rays(cam, xs.ravel(), ys.ravel(), w, h)

    closest = jax.jit(lambda s, o, d: scene_closest_hit(
        s.accel, s.tris, s.spheres, s.planes, o, d, 0.0, MIRO_TMAX))
    hit = closest(scene, o, d)
    p = o + jnp.where(hit.hit, hit.t, 0.0)[:, None] * d
    to_l = scene.lights.position[0][None, :] - p
    dist = jnp.linalg.norm(to_l, axis=-1)
    l = to_l / dist[:, None]
    so = p + l * EPSILON
    tmax = jnp.where(hit.hit, dist, -1.0)
    anyhit = jax.jit(lambda s, o, d, tm: scene_any_hit(
        s.accel, s.tris, s.spheres, s.planes, o, d, 0.0, tm))

    key = jax.random.key(0)

    def fwd(kd, s):
        s = s.replace(materials=s.materials._replace(kd=kd))
        return jnp.sum(render_hdr(s, static, cam, cfg, key)[0])

    step = jax.jit(jax.value_and_grad(fwd))
    c_first, c_ms = steady(closest, scene, o, d, reps=reps)
    a_first, a_ms = steady(anyhit, scene, so, l, tmax, reps=reps)
    s_first, s_ms = steady(step, scene.materials.kd, scene, reps=reps)
    return {"kind": kind, **opts, "accel_build_s": build_s,
            "closest_ms": c_ms * 1e3, "closest_first_s": c_first,
            "anyhit_ms": a_ms * 1e3, "anyhit_first_s": a_first,
            "step_ms": s_ms * 1e3, "step_first_s": s_first}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kinds", default="cuda,block,bvh")
    ap.add_argument("--blocks", default="128",
                    help="CUDA block sizes (rays per block) to time")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="ab_traversal.json")
    args = ap.parse_args()
    import jax
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.scenes import build
    from cse168_raytracer.utils.compile_cache import enable_compile_cache
    if jax.default_backend() != "gpu":
        sys.exit("ab_traversal measures the card; JAX found no GPU")
    enable_compile_cache()
    card = smi()
    raw, static, cam, cfg = build("sponza_proxy", RenderConfig(
        width=512, height=512, trace_depth=4))
    runs = []
    for kind in args.kinds.split(","):
        if kind == "cuda":
            runs += [(kind, {"block": int(b)})
                     for b in args.blocks.split(",")]
        else:
            runs.append((kind, {}))
    rows = []
    for rnd, order in enumerate((runs, runs[::-1])):
        for kind, opts in order:
            r = measure(kind, raw, static, cam, cfg, args.reps, **opts)
            r["round"] = rnd
            rows.append(r)
            name = kind + "".join(f" {k}={v}" for k, v in opts.items())
            print(f"[ab] round {rnd} {name:14s} closest {r['closest_ms']:9.3f}"
                  f" ms  any-hit {r['anyhit_ms']:9.3f} ms  fwd+bwd step "
                  f"{r['step_ms']:9.3f} ms  (first step call "
                  f"{r['step_first_s']:.1f} s, accel build "
                  f"{r['accel_build_s']:.2f} s)", flush=True)
    dev = jax.devices()[0]
    out = {"card": card, "device_kind": dev.device_kind,
           "scene": "sponza_proxy", "width": 512, "height": 512,
           "depth": 4, "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[ab] {card}", flush=True)


if __name__ == "__main__":
    main()
