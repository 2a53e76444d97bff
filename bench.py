"""Benchmark harness: rays/sec forward+backward at 1 spp (the
BASELINE.json north-star metric) on one GPU.

Default workload: sponza_proxy — the ~160k-tri procedural colonnaded
atrium rendered from INSIDE (scenes/registry), the interior-occlusion
workload class of the stripped sponza.obj (the reference measured 10.33
tri-tests/ray there vs 1.17 for bunny, writeup/A2/Readme.tex:95-98),
and the one full-size mesh scene that builds from this repository
alone. 512x512, trace depth 4, one shadow ray per hit, forward AND
backward (gradient w.r.t. every material kd).

vs_baseline compares against the reference's own +shadows number for
that scene (writeup/A2/Readme.tex:81-82 — forward only; ours times
forward+backward).

Prints ONE JSON line naming the device it ran on. It refuses to run
without a GPU: a CPU number is not a benchmark of this system.

Set CSE168_BENCH_SCENE=<name> to bench another scene (bunny1, bunny20
and sponza need the upstream meshes, see CSE168_REFERENCE_DIR).
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# writeup/A2/Readme.tex:80-87: 512^2 +shadows render times, SSE build,
# 16 threads (forward only)
BASELINE_SECONDS = {
    "teapot": 0.091089,
    "bunny1": 0.084176,
    "bunny20": 0.115115,
    "sponza": 0.166750,
    # the ~160k-tri procedural interior stand-in for the stripped
    # sponza.obj (scenes/registry._make_sponza_proxy): compared against
    # the reference's REAL-sponza number — the closest available
    # baseline for an interior-occlusion workload, not the same
    # geometry (documented in BASELINE.md)
    "sponza_proxy": 0.166750,
}
BASELINE_RAYS = 524288.0

WIDTH = HEIGHT = 512
DEPTH = 4


def bench_scene(scene_name: str) -> dict:
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.ops.accel import attach_accel
    from cse168_raytracer.render.integrator import render_hdr
    from cse168_raytracer.scenes import build

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, trace_depth=DEPTH)
    scene, static, cam, cfg = build(scene_name, cfg)
    t_build0 = time.time()
    scene = attach_accel(scene)
    build_s = time.time() - t_build0
    n_tris = int(np.asarray(scene.tris.valid).sum())
    key = jax.random.key(0)

    # scene is a jit ARGUMENT (not a closure): closed-over arrays would
    # become constants embedded in the compiled program
    def fwd_bwd(kd, scene):
        s = scene.replace(materials=scene.materials._replace(kd=kd))
        hdr, stats = render_hdr(s, static, cam, cfg, key)
        return jnp.sum(hdr), stats

    step = jax.jit(jax.value_and_grad(fwd_bwd, has_aux=True))

    # compile + warmup
    (val, stats), g = step(scene.materials.kd, scene)
    jax.block_until_ready(g)

    n_iter = 5
    t0 = time.time()
    for _ in range(n_iter):
        (val, stats), g = step(scene.materials.kd, scene)
    jax.block_until_ready(g)
    dt = (time.time() - t0) / n_iter

    # ray accounting matches the reference's A2 tables: primary + shadow
    rays = int(stats.primary_rays) + int(stats.shadow_rays) \
        + int(stats.secondary_rays)
    rays_per_sec = rays / dt

    base = BASELINE_RAYS / BASELINE_SECONDS.get(scene_name,
                                                BASELINE_SECONDS["bunny1"])
    dev = jax.devices()[0]
    entry = {
        "metric": f"{scene_name}_512_fwd+bwd_rays_per_sec_per_chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / base, 3),
        "n_tris": n_tris,
        "ms_per_step": round(dt * 1000, 2),
        "accel_build_s": round(build_s, 2),
        "accel": type(scene.accel).__name__,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(f"[bench] {rays} rays in {dt*1000:.1f} ms/step "
          f"(scene={scene_name}, {n_tris} tris, "
          f"backend={jax.default_backend()}, depth={DEPTH}, "
          f"build={build_s:.1f}s)",
          file=sys.stderr)
    return entry


def main():
    if jax.default_backend() != "gpu":
        sys.exit("bench.py measures the GPU; JAX found none "
                 f"(backend {jax.default_backend()!r})")
    from cse168_raytracer.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    print(json.dumps(bench_scene(os.environ.get("CSE168_BENCH_SCENE",
                                                "sponza_proxy"))))


if __name__ == "__main__":
    main()
