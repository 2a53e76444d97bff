"""Command-line entry point (replaces main.cpp's headless NO_GFX path:
pick a scene, render, write the image; main.cpp:185-235).

Usage:
    python -m cse168_raytracer.cli render --scene sponza_proxy \
        --width 512 --height 512 --out out.png
    python -m cse168_raytracer.cli render --scene cornell_proxy \
        --path-tracing --spp 16 --depth 4 --out cornell.png
    python -m cse168_raytracer.cli scenes      # list scenes
"""

from __future__ import annotations

import argparse
import sys
import time


def _cmd_scenes(_args) -> int:
    from cse168_raytracer.scenes import SCENES
    for name in sorted(SCENES):
        print(name)
    return 0


def _cmd_render(args) -> int:
    # multi-host join must precede any other JAX call (backend init)
    from cse168_raytracer.parallel import distributed as dist
    proc = dist.init_multihost(args.coordinator, args.num_processes,
                               args.process_id)

    import jax
    import numpy as np

    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.render.image_io import write_image
    from cse168_raytracer.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from cse168_raytracer.render.integrator import render_hdr
    from cse168_raytracer.render.tonemap import to_bytes, tonemap
    from cse168_raytracer.scenes import build

    cfg = RenderConfig(
        width=args.width, height=args.height,
        trace_depth=args.depth, trace_samples=args.spp,
        path_tracing=args.path_tracing, dof=args.dof,
        disable_shadows=args.no_shadows,
        photons_per_light=args.photons,
        caustic_photons_per_light=args.caustic_photons,
        light_samples=args.light_samples,
        row_tile=args.row_tile,
        collect_stats=args.stats, seed=args.seed)

    t0 = time.time()
    scene, static, cam, cfg = build(args.scene, cfg)
    print(f"[scene] built {args.scene} in {time.time() - t0:.2f}s "
          f"({scene.tris.num_tris} padded tris)", file=sys.stderr)

    if args.accel:
        from cse168_raytracer.ops.accel import attach_accel
        t0 = time.time()
        scene = attach_accel(scene)
        print(f"[accel] built in {time.time() - t0:.2f}s", file=sys.stderr)

    if cfg.photons_per_light > 0 and not args.no_photon_map:
        from cse168_raytracer.ops.photon import build_photon_maps
        t0 = time.time()
        photons, ph_stats = build_photon_maps(scene, static, cfg,
                                              jax.random.key(cfg.seed + 7),
                                              return_stats=True)
        scene = scene.replace(photons=photons)
        print(f"[photons] traced in {time.time() - t0:.2f}s", file=sys.stderr)
        if args.stats or args.visualize_photons:
            for name, st in ph_stats.items():
                lvl = st.get("stored_per_level")
                lvl_s = (" per-level=" + "/".join(map(str, lvl))
                         if lvl else "")
                print(f"[stats] photons {name}: emitted={st['emitted']} "
                      f"stored={st['stored']} bounces={st['bounces']}"
                      f"{lvl_s}", file=sys.stderr)

    key = jax.random.key(cfg.seed)
    if args.sharded or jax.process_count() > 1:
        from cse168_raytracer.parallel.sharding import render_hdr_sharded
        mesh = dist.global_mesh()
        print(f"[mesh] {mesh.size} devices over {jax.process_count()} "
              f"process(es)", file=sys.stderr)
        if cfg.height % mesh.size != 0:
            print(f"error: --height {cfg.height} must be divisible by "
                  f"the device count ({mesh.size}) for row sharding",
                  file=sys.stderr)
            return 2
        render = jax.jit(lambda s, c, k: render_hdr_sharded(
            s, static, c, cfg, k, mesh))
        t0 = time.time()
        hdr = jax.block_until_ready(render(scene, cam, key))
        print(f"[render] sharded compile+run {time.time() - t0:.2f}s",
              file=sys.stderr)
        if args.bench:
            # steady-state timing costs a full second render: opt-in
            t0 = time.time()
            hdr = jax.block_until_ready(render(scene, cam, key))
            print(f"[render] steady-state {time.time() - t0:.3f}s",
                  file=sys.stderr)
        img_np = dist.gather_image(hdr)
        if proc == 0:
            img = to_bytes(tonemap(jax.numpy.asarray(img_np), args.tonemap))
            write_image(args.out, np.asarray(img))
            print(f"[out] wrote {args.out}", file=sys.stderr)
        return 0
    if args.progressive:
        from cse168_raytracer.render.progressive import render_progressive
        t0 = time.time()
        hdr = render_progressive(scene, static, cam, cfg, key,
                                 checkpoint_path=args.checkpoint,
                                 checkpoint_every=args.checkpoint_every)
        stats = None
        print(f"[render] progressive {cfg.trace_samples} spp "
              f"in {time.time() - t0:.2f}s", file=sys.stderr)
    else:
        render = jax.jit(render_hdr, static_argnames=("static", "cfg"))
        t0 = time.time()
        hdr, stats = jax.block_until_ready(
            render(scene, static, cam, cfg, key))
        t_compile_and_run = time.time() - t0
        t0 = time.time()
        hdr, stats = jax.block_until_ready(
            render(scene, static, cam, cfg, key))
        t_steady = time.time() - t0
        print(f"[render] compile+run {t_compile_and_run:.2f}s, "
              f"steady-state {t_steady:.3f}s", file=sys.stderr)
    if args.stats and stats is not None:
        n_rays = (int(stats.primary_rays) + int(stats.secondary_rays)
                  + int(stats.shadow_rays))
        print(f"[stats] primary={int(stats.primary_rays)} "
              f"secondary={int(stats.secondary_rays)} "
              f"shadow={int(stats.shadow_rays)} "
              f"dropped={int(stats.dropped_rays)}", file=sys.stderr)
        # A2-style table (Stats.cpp:15-27, writeup/A2/Readme.tex:90-107)
        # from the -DSTATS counters measured INSIDE the traversal across
        # the WHOLE render (closest + shadow + secondary rays)
        boxt = float(stats.box_tests)
        trit = float(stats.tri_tests)
        if boxt > 0 or trit > 0:
            leaf = getattr(scene.accel, "leaf_size", "?")
            print("[stats] ----- traversal (in-traversal, full render) "
                  "-----", file=sys.stderr)
            print(f"[stats] ray-box   tests/ray: {boxt / n_rays:8.2f}",
                  file=sys.stderr)
            print(f"[stats] ray-tri   tests/ray: {trit / n_rays:8.2f}"
                  f"   [<= {leaf} tris/leaf]", file=sys.stderr)
        elif scene.accel is not None:
            # accels without in-traversal counters: approximate with the
            # separate primary-ray block pass (ops/stats.py)
            import jax.numpy as jnp
            from cse168_raytracer.ops.stats import traversal_stats
            from cse168_raytracer.render.camera import eye_rays
            ys, xs = jnp.meshgrid(jnp.arange(cfg.height),
                                  jnp.arange(cfg.width), indexing="ij")
            o, d = eye_rays(cam, xs.ravel(), ys.ravel(), cfg.width,
                            cfg.height)
            ts = jax.jit(traversal_stats)(scene.accel, o, d)
            print("[stats] ----- traversal (approx, primary rays) -----",
                  file=sys.stderr)
            print(f"[stats] ray-box   tests/ray: "
                  f"{float(ts.box_tests_per_ray):8.2f}", file=sys.stderr)
            print(f"[stats] ray-tri   tests/ray: "
                  f"{float(ts.tri_tests_per_ray):8.2f}", file=sys.stderr)

    img = to_bytes(tonemap(hdr, args.tonemap))
    write_image(args.out, np.asarray(img))
    print(f"[out] wrote {args.out}", file=sys.stderr)
    if args.visualize_photons:
        # -DVISUALIZE_PHOTON_MAP analog (Scene.cpp:405-409,586-591):
        # stored photons splatted over the frame through the camera
        if scene.photons is None:
            print("[viz] no photon maps built (use --photons N)",
                  file=sys.stderr)
        else:
            from cse168_raytracer.render.photon_viz import \
                photon_overlay
            ov = photon_overlay(np.asarray(img), cam, scene.photons,
                                cfg.width, cfg.height)
            write_image(args.visualize_photons, ov)
            print(f"[viz] wrote {args.visualize_photons} "
                  f"(global=green, caustic=red)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="miro",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("scenes", help="list available scenes")

    r = sub.add_parser("render", help="render a scene")
    r.add_argument("--scene", required=True)
    r.add_argument("--width", type=int, default=512)
    r.add_argument("--height", type=int, default=512)
    r.add_argument("--depth", type=int, default=10,
                   help="TRACE_DEPTH (Miro.h:13)")
    r.add_argument("--spp", type=int, default=1,
                   help="samples per pixel (TRACE_SAMPLES in PT/DOF mode)")
    r.add_argument("--path-tracing", action="store_true",
                   help="-DPATH_TRACING mode")
    r.add_argument("--dof", action="store_true", help="-DDOF mode")
    r.add_argument("--row-tile", type=int, default=0,
                   help="rows per wavefront chunk (bounds memory for "
                        "final-scene-size renders; 0 = whole frame)")
    r.add_argument("--light-samples", type=int, default=1,
                   help="NEE samples per light (SquareLight soft "
                        "shadows; Phong.cpp:65-80)")
    r.add_argument("--no-shadows", action="store_true",
                   help="-DDISABLE_SHADOWS")
    r.add_argument("--accel", action="store_true", default=True,
                   help="attach the platform's accelerator: the CUDA "
                        "BVH walk on GPUs, the block sweep on CPUs "
                        "(default on)")
    r.add_argument("--no-accel", dest="accel", action="store_false")
    r.add_argument("--photons", type=int, default=0,
                   help="photons per light (0 disables photon mapping)")
    r.add_argument("--caustic-photons", type=int, default=0)
    r.add_argument("--no-photon-map", action="store_true")
    r.add_argument("--stats", action="store_true", help="-DSTATS counters")
    r.add_argument("--bench", action="store_true",
                   help="time a second steady-state render (sharded path)")
    r.add_argument("--visualize-photons", default=None, metavar="PATH",
                   help="write a photon-overlay PNG "
                        "(-DVISUALIZE_PHOTON_MAP analog)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--sharded", action="store_true",
                   help="shard pixel rows over all devices (single- or "
                        "multi-host)")
    r.add_argument("--coordinator", default=None,
                   help="host:port of process 0 for jax.distributed "
                        "multi-host jobs")
    r.add_argument("--num-processes", type=int, default=None)
    r.add_argument("--process-id", type=int, default=None)
    r.add_argument("--tonemap", choices=("sigmoid", "normalized", "none"),
                   default="sigmoid",
                   help="sigmoid = current reference (Scene.cpp:89); "
                        "normalized = A2-era golden-image curve")
    r.add_argument("--progressive", action="store_true",
                   help="sample-by-sample accumulation with checkpointing")
    r.add_argument("--checkpoint", default=None,
                   help="render-state .npz path for --progressive resume")
    r.add_argument("--checkpoint-every", type=int, default=16)
    r.add_argument("--out", default="out.png")

    v = sub.add_parser("view", help="progressive preview: refreshes the "
                       "output image after every sample batch (headless "
                       "analog of the reference's GLUT window, "
                       "MiroWindow.cpp)")
    v.add_argument("--scene", required=True)
    v.add_argument("--width", type=int, default=256)
    v.add_argument("--height", type=int, default=256)
    v.add_argument("--depth", type=int, default=5)
    v.add_argument("--spp", type=int, default=64)
    v.add_argument("--path-tracing", action="store_true")
    v.add_argument("--tonemap", choices=("sigmoid", "normalized", "none"),
                   default="sigmoid")
    v.add_argument("--out", default="preview.png")

    w = sub.add_parser("window", help="interactive viewer (MiroWindow "
                       "analog: drag to orbit, wasd/qz to move, r/g to "
                       "toggle raytrace vs fast preview, i to dump PPM)")
    w.add_argument("--scene", required=True)
    w.add_argument("--width", type=int, default=256)
    w.add_argument("--height", type=int, default=256)
    w.add_argument("--depth", type=int, default=5)
    w.add_argument("--tonemap", choices=("sigmoid", "normalized", "none"),
                   default="sigmoid")

    args = p.parse_args(argv)
    if args.cmd == "scenes":
        return _cmd_scenes(args)
    if args.cmd == "view":
        return _cmd_view(args)
    if args.cmd == "window":
        return _cmd_window(args)
    return _cmd_render(args)


def _cmd_window(args) -> int:
    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.ops.accel import attach_accel
    from cse168_raytracer.render.viewer import InteractiveViewer
    from cse168_raytracer.scenes import build

    cfg = RenderConfig(width=args.width, height=args.height,
                       trace_depth=args.depth)
    scene, static, cam, cfg = build(args.scene, cfg)
    scene = attach_accel(scene)
    InteractiveViewer(scene, static, cam, cfg,
                      tonemap_kind=args.tonemap).main_loop()
    return 0


def _cmd_view(args) -> int:
    import jax
    import numpy as np

    from cse168_raytracer.config import RenderConfig
    from cse168_raytracer.ops.accel import attach_accel
    from cse168_raytracer.render.image_io import write_image
    from cse168_raytracer.render.progressive import render_progressive
    from cse168_raytracer.render.tonemap import to_bytes, tonemap
    from cse168_raytracer.scenes import build

    cfg = RenderConfig(width=args.width, height=args.height,
                       trace_depth=args.depth, trace_samples=args.spp,
                       path_tracing=args.path_tracing)
    scene, static, cam, cfg = build(args.scene, cfg)
    scene = attach_accel(scene)

    def on_batch(done, est):
        img = to_bytes(tonemap(est.reshape(cfg.height, cfg.width, 3),
                               args.tonemap))
        write_image(args.out, np.asarray(img))
        print(f"\r[view] {done}/{cfg.trace_samples} spp -> {args.out}",
              end="", file=sys.stderr)

    render_progressive(scene, static, cam, cfg, jax.random.key(0),
                       on_batch=on_batch)
    print(file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
