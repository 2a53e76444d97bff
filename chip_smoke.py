#!/usr/bin/env python3
"""Prove the tracer's main path on an NVIDIA GPU, end to end.

    python chip_smoke.py                # one card: phases 1-7
    python chip_smoke.py --four-cards   # four cards: sharded render and
                                        # training step, nothing else

Workload: `sponza_proxy` (the ~160k-triangle procedural atrium) at
bench.py's settings: 512x512, trace depth 4, 1 spp, the gradient of the
image sum with respect to every material kd.

Phases (one process; each prints one line, and any failure exits
non-zero before the result line):
  1 device   JAX's default backend is a GPU
  2 build    scenes.build + attach_accel("auto") picks the CUDA BVH;
             accelerator and kernel build times
  3 kernel   the gpu-marked tests of tests/test_cuda_bvh.py, in process
  4 parity   all 262,144 eye rays and their shadow rays: the kernel
             against the brute-force ops/intersect.py at full float32
  5 step     jitted value_and_grad at 512^2: first compile, steady
             ms/step; image and gradient against a brute-force render;
             a 64^2 render on the card against the same on the CPU
  6 cli      the CLI's own main(), in process, with --stats
  7 photons  build_photon_maps with 200k global photons and a 128^2
             photon render under a DirectionalAreaLight

The line before the last is the card's name and power limit as
nvidia-smi reports them; the last line is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

W = H = 512
DEPTH = 4

# --- tolerances (each with its reason) -------------------------------------
# Both sides run the same float32 acceptance rule on the same Pluecker
# operands, summed in another order (the kernel contracts into FMAs).
# Where both hit, t agrees to |dt| <= 1e-5 t + 1e-6 (the 1e-6: t =
# (o.n - A.n) / den cancels at the scene's coordinate scale, ~20 units,
# for hits a few 1e-3 from a shadow ray's origin); a differing triangle
# is a tie on a shared edge, so its t must agree too.
T_RTOL = 1e-5
T_ATOL = 1e-6
# A ray whose barycentrics sit within float32 rounding of the band's
# outer limit (EPSILON outside an edge) may be accepted on one side only.
# It then misses on the other side, or goes on to a farther surface (t
# disagrees). Every such disagreement must be this case: the triangle
# one side accepted has exact (float64) barycentrics within BOUNDARY_TOL
# of the limit (~16 float32 ulps of a barycentric near 1; no ray in
# the band's interior may disagree). All of them together stay under
# 1 - MASK_FRAC of the rays, and hit masks agree on MASK_FRAC.
MASK_FRAC = 0.9999
BOUNDARY_TOL = 1e-6
# Images: the golden-image criterion (>= 99.9% of tonemapped pixels
# within 2/255), as the reference-binary parity tests use it.
PIX_TOL, PIX_FRAC = 2, 0.999
# Gradients: the kd gradient of the whole image's sum, relative L2 (the
# same float32 sums over 262k pixels, in another order).
GRAD_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def pixels_close(a, b):
    """Fraction of tonemapped 8-bit channels within PIX_TOL."""
    import numpy as np
    from cse168_raytracer.render.tonemap import sigmoid_tonemap, to_bytes
    ia = np.asarray(to_bytes(sigmoid_tonemap(a))).astype(int)
    ib = np.asarray(to_bytes(sigmoid_tonemap(b))).astype(int)
    return float(np.mean(np.abs(ia - ib) <= PIX_TOL))


def rel_l2(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def timed(fn, *args, reps=10):
    """(first-call seconds, steady seconds per call) of a jitted fn."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, first, (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(n_cards):
    import jax
    check(jax.default_backend() == "gpu",
          f"JAX's default backend is {jax.default_backend()!r}, not gpu")
    devs = jax.devices()
    check(len(devs) >= n_cards, f"need {n_cards} GPU(s), JAX sees "
          f"{len(devs)}")
    return devs[0]


def phase_build():
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.ops import cuda_bvh
    from cse168_raytracer.ops.accel import attach_accel
    from cse168_raytracer.scenes import build
    t0 = time.perf_counter()
    cuda_bvh.ensure_kernel()
    kernel_s = time.perf_counter() - t0
    cfg = RenderConfig(width=W, height=H, trace_depth=DEPTH)
    raw, static, cam, cfg = build("sponza_proxy", cfg)
    t0 = time.perf_counter()
    scene = attach_accel(raw, kind="auto")
    accel_s = time.perf_counter() - t0
    check(isinstance(scene.accel, cuda_bvh.CudaBVH),
          f"auto picked {type(scene.accel).__name__}, not CudaBVH")
    n = int(scene.tris.valid.sum())
    return (raw, scene, static, cam, cfg,
            f"{n} tris, {scene.accel.n_nodes} nodes, stack "
            f"{scene.accel.stack_depth}; accel build {accel_s:.2f} s, "
            f"kernel build+load {kernel_s:.2f} s")


def phase_kernel_tests():
    import pytest

    class Tally:
        passed, failed, skipped = [], [], []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed.append(report.nodeid)
            elif report.failed:
                self.failed.append(report.nodeid)
            elif report.skipped:
                self.skipped.append(report.nodeid)

    tally = Tally()
    here = os.path.dirname(os.path.abspath(__file__))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          "-p", "no:randomly",
                          os.path.join(here, "tests", "test_cuda_bvh.py")],
                         plugins=[tally])
    check(rc == 0 and not tally.failed and not tally.skipped
          and len(tally.passed) >= 5,
          f"pytest rc={rc} passed={len(tally.passed)} "
          f"failed={tally.failed} skipped={tally.skipped}\n"
          + out.getvalue()[-3000:])
    return f"{len(tally.passed)} gpu tests passed"


def _band_margin(o, d, pack, rows):
    """Exact (float64) distance, in barycentric units, of each ray's
    crossing of triangle `rows` from the acceptance band's outer limit
    (min(beta, gamma, 1 - beta - gamma) = -EPSILON)."""
    import numpy as np
    from cse168_raytracer.config import EPSILON
    v0, e1, e2 = (np.asarray(a, np.float64)[rows]
                  for a in (pack.v0, pack.e1, pack.e2))
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    p = np.cross(d, e2)
    det = np.sum(e1 * p, -1)
    s = o - v0
    u = np.sum(s * p, -1) / det
    v = np.sum(d * np.cross(s, e1), -1) / det
    return np.abs(np.minimum(np.minimum(u, v), 1.0 - u - v) + EPSILON)


def _compare_hits(name, kern, brute, live, o, d, pack, exempt=None,
                  any_hit=False):
    """Check a kernel Hit against the brute-force Hit over `live` rays
    under the rules above. `exempt` rays are not compared. With any_hit
    only the masks are compared (an any-hit returns whichever hit it met
    first)."""
    import numpy as np
    kh, bh = np.asarray(kern.hit), np.asarray(brute.hit)
    kt, bt = np.asarray(kern.t), np.asarray(brute.t)
    ki, bi = np.asarray(kern.prim_id), np.asarray(brute.prim_id)
    if exempt is not None:
        live = live & ~exempt
    n = int(live.sum())
    flip = (kh != bh) & live
    agree = 1.0 - flip.sum() / max(n, 1)
    both = kh & bh & live
    far = both & (np.abs(kt - bt) > T_RTOL * np.abs(bt) + T_ATOL)
    if any_hit:
        far[:] = False
    same_far = int((far & (ki == bi)).sum())
    idx = np.nonzero(flip | far)[0]
    # the triangle one side accepted and the other did not
    accepted = np.where(flip[idx], np.where(kh[idx], ki[idx], bi[idx]),
                        np.where(kt[idx] < bt[idx], ki[idx], bi[idx]))
    margin = _band_margin(np.asarray(o)[idx], np.asarray(d)[idx], pack,
                          accepted)
    worst = float(margin.max()) if len(idx) else 0.0
    msg = (f"{name}: {n} rays, hit masks agree on {100 * agree:.4f}% "
           f"({int(flip.sum())} flips)")
    if not any_hit:
        msg += (f"; where both hit: same triangle "
                f"{float(np.mean(ki[both] == bi[both])):.6f}, t beyond "
                f"1e-5 t on {int(far.sum())} rays ({same_far} on the same "
                f"triangle)")
    msg += (f"; all {len(idx)} disagreements at the band's limit: "
            f"{worst <= BOUNDARY_TOL} (farthest {worst:.1e})")
    check(agree >= MASK_FRAC and same_far == 0 and worst <= BOUNDARY_TOL
          and len(idx) <= (1 - MASK_FRAC) * n, msg)
    return msg


def phase_parity(scene, cam, cfg):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from cse168_raytracer.config import EPSILON, MIRO_TMAX
    from cse168_raytracer.ops.cuda_bvh import cuda_closest_hit_triangles
    from cse168_raytracer.ops.intersect import intersect_triangles
    from cse168_raytracer.render.camera import eye_rays

    pack, accel = scene.tris, scene.accel
    ys, xs = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
    o, d = eye_rays(cam, xs.ravel(), ys.ravel(), W, H)
    chunk = min(16384, W * H)

    @jax.jit
    def brute(pack, o, d, tmax):
        n = o.shape[0]
        h = jax.lax.map(
            lambda a: intersect_triangles(pack, a[0], a[1], 0.0, a[2]),
            (o.reshape(n // chunk, chunk, 3), d.reshape(n // chunk, chunk, 3),
             tmax.reshape(n // chunk, chunk)))
        return jax.tree.map(lambda x: x.reshape(n), h)

    closest = jax.jit(lambda a, o, d, tmax: cuda_closest_hit_triangles(
        a, o, d, 0.0, tmax))
    anyhit = jax.jit(lambda a, o, d, tmax: cuda_closest_hit_triangles(
        a, o, d, 0.0, tmax, any_hit=True))

    tmax_eye = jnp.full((W * H,), MIRO_TMAX, jnp.float32)
    t0 = time.perf_counter()
    b_eye = jax.block_until_ready(brute(pack, o, d, tmax_eye))
    brute_s = time.perf_counter() - t0
    k_eye, _, eye_ms = timed(closest, accel, o, d, tmax_eye, reps=20)
    lines = [_compare_hits("eye closest", k_eye, b_eye,
                           np.ones(W * H, bool), o, d, pack)]

    # shadow rays toward the point light from every brute-force eye hit
    p = o + jnp.where(b_eye.hit, b_eye.t, 0.0)[:, None] * d
    to_l = scene.lights.position[0][None, :] - p
    dist = jnp.linalg.norm(to_l, axis=-1)
    l = to_l / dist[:, None]
    so = p + l * EPSILON
    tmax_sh = jnp.where(b_eye.hit, dist, -1.0)
    live = np.asarray(b_eye.hit)
    b_sh = jax.block_until_ready(brute(pack, so, l, tmax_sh))
    k_sh = closest(accel, so, l, tmax_sh)
    lines.append(_compare_hits("shadow closest", k_sh, b_sh, live, so, l,
                               pack))
    occ, _, any_ms = timed(anyhit, accel, so, l, tmax_sh, reps=20)
    # a first hit within 1e-5 t of tmax is inside or outside the shadow
    # interval by rounding alone
    bt, tm = np.asarray(b_sh.t), np.asarray(tmax_sh)
    near_tmax = np.asarray(b_sh.hit) & (np.abs(bt - tm) <= T_RTOL * bt)
    lines.append(_compare_hits("shadow any-hit", occ, b_sh, live, so, l,
                               pack, exempt=near_tmax, any_hit=True)
                 + f"; {int((live & near_tmax).sum())} rays within 1e-5 t "
                   f"of tmax exempt")
    _, box, tri = jax.jit(lambda a, o, d, tmax: cuda_closest_hit_triangles(
        a, o, d, 0.0, tmax, with_stats=True))(accel, o, d, tmax_eye)
    lines.append(f"times: kernel closest {eye_ms * 1e3:.3f} ms ({W * H:,} eye "
                 f"rays; per ray {float(np.mean(box)) / 2:.2f} internal "
                 f"visits, {float(np.mean(tri)):.2f} triangle tests), "
                 f"kernel any-hit {any_ms * 1e3:.3f} ms (shadow rays), "
                 f"brute force {brute_s:.1f} s per pass incl. compile")
    return lines


def _step_fn(static, cam, cfg):
    """jit(value_and_grad) of the image sum over the kd table."""
    import jax
    import jax.numpy as jnp
    from cse168_raytracer.render.integrator import render_hdr
    key = jax.random.key(0)

    def fwd(kd, scene):
        s = scene.replace(materials=scene.materials._replace(kd=kd))
        hdr, stats = render_hdr(s, static, cam, cfg, key)
        return jnp.sum(hdr), hdr

    return jax.jit(jax.value_and_grad(fwd, has_aux=True))


def phase_step(raw, scene, static, cam, cfg):
    import jax
    import numpy as np
    from cse168_raytracer.ops.accel import attach_accel
    from cse168_raytracer.render.integrator import render_hdr

    step = _step_fn(static, cam, cfg)
    kd = scene.materials.kd
    ((_, hdr), g), first, steady = timed(step, kd, scene, reps=5)
    hdr, g = np.asarray(hdr), np.asarray(g)
    check(np.isfinite(hdr).all() and np.isfinite(g).all(),
          "non-finite image or gradient")
    check(hdr.shape == (H, W, 3) and hdr.max() > 0, "image is black")
    check(np.abs(g).sum() > 0, "the kd gradient is zero")
    # brute force: the same scene with no accelerator (every ray tests
    # every triangle through ops/intersect.py)
    (_, hdr_b), g_b = jax.block_until_ready(step(kd, raw))
    hdr_b, g_b = np.asarray(hdr_b), np.asarray(g_b)
    frac = pixels_close(hdr, hdr_b)
    gerr = rel_l2(g, g_b)
    msg = (f"first call {first:.1f} s, steady {steady * 1e3:.3f} ms/step; "
           f"vs brute force: {frac * 100:.4f}% pixels within 2/255, "
           f"kd-gradient rel L2 {gerr:.2e}")
    check(frac >= PIX_FRAC and gerr <= GRAD_RTOL, msg)

    # the same 64^2 render on the card and on the CPU
    cfg64 = cfg.replace(width=64, height=64)
    key = jax.random.key(0)
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))
    on_gpu = np.asarray(render(scene, static, cam, cfg64, key)[0])
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        s_cpu = attach_accel(jax.device_put(raw, cpu), kind="block")
        on_cpu = np.asarray(render(s_cpu, static, jax.device_put(cam, cpu),
                                   cfg64, jax.device_put(key, cpu))[0])
    frac64 = pixels_close(on_gpu, on_cpu)
    msg64 = f"64^2 card vs CPU: {frac64 * 100:.4f}% pixels within 2/255"
    check(frac64 >= PIX_FRAC, msg64)
    return [msg, msg64]


def phase_cli():
    import re
    from cse168_raytracer import cli

    real_stderr = sys.stderr

    class Tee(io.StringIO):
        def write(self, s):
            real_stderr.write(s)
            return super().write(s)

    err = Tee()
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "sponza_proxy.png")
        with contextlib.redirect_stderr(err):
            rc = cli.main(["render", "--scene", "sponza_proxy", "--width",
                           str(W), "--height", str(H), "--depth",
                           str(DEPTH), "--stats", "--out", out])
        check(rc == 0, f"cli.main returned {rc}")
        with open(out, "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n", "no PNG written")
    text = err.getvalue()
    box = re.search(r"ray-box\s+tests/ray:\s+([0-9.]+)", text)
    tri = re.search(r"ray-tri\s+tests/ray:\s+([0-9.]+)", text)
    check(box and tri and float(box.group(1)) > 0
          and float(tri.group(1)) > 0,
          "the CLI printed no in-traversal counters")
    return (f"rc 0, PNG written, ray-box {box.group(1)} / ray-tri "
            f"{tri.group(1)} tests per ray")


def phase_photons(raw, scene_name="sponza_proxy", size=128,
                  photons=200_000):
    import jax
    import numpy as np
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.models.lights import LIGHT_DIRECTIONAL_AREA
    from cse168_raytracer.models.scene import make_scene
    from cse168_raytracer.ops.accel import attach_accel
    from cse168_raytracer.ops.photon import build_photon_maps
    from cse168_raytracer.render.integrator import render_hdr
    from cse168_raytracer.scenes import build

    # the atrium lit by the one emitter the reference traces photons
    # from (Scene.cpp:368,430): a downward DirectionalAreaLight
    cfg = RenderConfig(width=size, height=size, trace_depth=DEPTH,
                       photons_per_light=photons,
                       caustic_photons_per_light=0)
    _, _, cam, cfg = build(scene_name, cfg)
    light = [dict(kind=LIGHT_DIRECTIONAL_AREA, position=(0.0, 8.6, 0.0),
                  normal=(0.0, -1.0, 0.0), radius=6.0, color=(1, 1, 1),
                  wattage=200.0)]
    scene, static = make_scene(tris=raw.tris, materials=raw.materials,
                               lights=light)
    scene = attach_accel(scene)
    t0 = time.perf_counter()
    maps, st = build_photon_maps(scene, static, cfg, jax.random.key(7),
                                 return_stats=True)
    build_s = time.perf_counter() - t0
    scene = scene.replace(photons=maps)
    render = jax.jit(render_hdr, static_argnames=("static", "cfg"))
    hdr = np.asarray(render(scene, static, cam, cfg, jax.random.key(0))[0])
    g = st["global"]
    msg = (f"{g['stored']} global photons stored of {g['emitted']} emitted "
           f"in {build_s:.1f} s; {size}^2 render max {hdr.max():.4g}, mean "
           f"{hdr.mean():.4g}")
    check(g["stored"] >= photons, msg)
    check(np.isfinite(hdr).all() and hdr.max() > 0, msg)
    return msg


def phase_four_cards(scene_name="sponza_proxy", size=W, depth=DEPTH,
                     kind="auto", n=4):
    """render_hdr_sharded over an n-card mesh against the one-card
    render, and one train_step_sharded gradient against the one-card
    gradient of the same loss."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.ops.accel import attach_accel
    from cse168_raytracer.parallel.sharding import (make_mesh,
                                                    render_hdr_sharded,
                                                    train_step_sharded)
    from cse168_raytracer.render.integrator import render_hdr
    from cse168_raytracer.scenes import build

    cfg = RenderConfig(width=size, height=size, trace_depth=depth)
    scene, static, cam, cfg = build(scene_name, cfg)
    scene = attach_accel(scene, kind=kind)
    mesh = make_mesh(n)
    key = jax.random.key(0)
    one = jax.jit(lambda s: render_hdr(s, static, cam, cfg, key)[0])
    many = jax.jit(lambda s: render_hdr_sharded(s, static, cam, cfg, key,
                                                mesh))
    hdr1, first1, ms1 = timed(one, scene, reps=3)
    hdrn, firstn, msn = timed(many, scene, reps=3)
    frac = pixels_close(np.asarray(hdrn), np.asarray(hdr1))
    lines = [f"render {size}^2: 1 card {ms1 * 1e3:.2f} ms, {n} cards "
             f"{msn * 1e3:.2f} ms; {frac * 100:.4f}% pixels within 2/255"]
    check(frac >= PIX_FRAC, lines[-1])

    target = 0.5 * hdr1
    params = (scene.materials.kd, scene.materials.ks, scene.materials.kt)

    def loss_one(ps):
        kd, ks, kt = ps
        s = scene.replace(materials=scene.materials._replace(
            kd=kd, ks=ks, kt=kt))
        return jnp.mean((render_hdr(s, static, cam, cfg, key)[0]
                         - target) ** 2)

    loss1, g_one = jax.jit(jax.value_and_grad(loss_one))(params)
    g_one = [np.asarray(x, np.float64) for x in g_one]
    # a step that moves the largest parameter by 0.1, so the gradient
    # read back from the update, (p - p') / lr, keeps ~6 digits
    lr = 0.1 / max(float(np.abs(g).max()) for g in g_one)
    step = jax.jit(lambda s: train_step_sharded(s, static, cam, cfg, key,
                                                mesh, target, lr=lr))
    new_scene, loss = step(scene)
    new = (new_scene.materials.kd, new_scene.materials.ks,
           new_scene.materials.kt)
    g_many = [(np.asarray(p, np.float64) - np.asarray(q, np.float64)) / lr
              for p, q in zip(params, new)]
    errs = [rel_l2(a, b) if np.linalg.norm(b) > 0 else
            float(np.abs(a).max()) for a, b in zip(g_many, g_one)]
    lines.append(f"train step: loss {float(loss):.6g} ({n} cards) vs "
                 f"{float(loss1):.6g} (1 card); gradient rel L2 kd/ks/kt "
                 + "/".join(f"{e:.2e}" for e in errs))
    check(all(e <= GRAD_RTOL for e in errs) and np.isfinite(float(loss))
          and abs(float(loss) - float(loss1)) <= 1e-4 * abs(float(loss1)),
          lines[-1])
    return lines


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded render and training step "
                         "on four cards")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    try:
        import jax
        from cse168_raytracer.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        log(f"[smoke] FAIL setup: {e}")
        return 2
    try:
        dev = phase_device(n_cards)
    except (PhaseError, RuntimeError) as e:
        log(f"[smoke] FAIL 1 device: {e}")
        return 1
    enable_compile_cache()
    log(f"[smoke] PASS 1 device: {dev.platform} {dev.device_kind}, "
        f"{len(jax.devices())} visible")

    t_all = time.perf_counter()
    try:
        if args.four_cards:
            for line in phase_four_cards(n=n_cards):
                log(f"[smoke] PASS four-cards: {line}")
        else:
            raw, scene, static, cam, cfg, msg = phase_build()
            log(f"[smoke] PASS 2 build: {msg}")
            log(f"[smoke] PASS 3 kernel: {phase_kernel_tests()}")
            for line in phase_parity(scene, cam, cfg):
                log(f"[smoke] PASS 4 parity: {line}")
            for line in phase_step(raw, scene, static, cam, cfg):
                log(f"[smoke] PASS 5 step: {line}")
            log(f"[smoke] PASS 6 cli: {phase_cli()}")
            log(f"[smoke] PASS 7 photons: {phase_photons(raw)}")
    except PhaseError as e:
        log(f"[smoke] FAIL: {e}")
        return 1
    log(f"[smoke] all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
