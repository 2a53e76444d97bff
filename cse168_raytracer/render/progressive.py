"""Progressive (resumable) path-traced rendering.

Drives the wavefront integrator in sample batches, accumulating a
running HDR estimate, checkpointing every `checkpoint_every` batches
(utils/checkpoint.py) so multi-hour renders survive preemption — the
failure-recovery capability SURVEY.md §5 flags as absent upstream.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from cse168_raytracer.config import RenderConfig
from cse168_raytracer.render.camera import Camera, eye_rays
from cse168_raytracer.render.integrator import integrate
from cse168_raytracer.utils import console
from cse168_raytracer.utils.checkpoint import (load_render_state,
                                               save_render_state)


def render_progressive(scene, static, cam: Camera, cfg: RenderConfig,
                       key: jax.Array,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 16,
                       on_batch: Optional[Callable] = None):
    """Render cfg.trace_samples jittered samples/pixel, one sample per
    device pass, resuming from checkpoint_path if present.

    Returns (H, W, 3) HDR radiance (mean over samples).
    """
    w, h = cfg.width, cfg.height
    n_pix = w * h
    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    xs = xs.reshape(-1)
    ys = ys.reshape(-1)
    pixel = (ys * w + xs).astype(jnp.int32)

    @jax.jit
    def one_sample(skey):
        k_cam, k_int = jax.random.split(skey)
        o, d = eye_rays(cam, xs, ys, w, h, key=k_cam,
                        dof_aperture=cfg.dof_aperture if cfg.dof else 0.0,
                        dof_focus=cfg.dof_focus_plane)
        r, _ = integrate(scene, static, o, d, pixel, n_pix, k_int,
                         cfg.trace_depth, path_tracing=cfg.path_tracing,
                         disable_shadows=cfg.disable_shadows)
        return r

    accum = jnp.zeros((n_pix, 3), jnp.float32)
    done = 0
    if checkpoint_path:
        state = load_render_state(checkpoint_path)
        if state is not None:
            accum, done, key = state
            console.info("[progressive] resumed at %d/%d samples",
                         done, cfg.trace_samples)

    while done < cfg.trace_samples:
        key, sk = jax.random.split(key)
        accum = accum + one_sample(sk)
        done += 1
        if on_batch is not None:
            on_batch(done, accum / done)
        if checkpoint_path and (done % checkpoint_every == 0
                                or done == cfg.trace_samples):
            jax.block_until_ready(accum)
            save_render_state(checkpoint_path, accum, done, key)
    return (accum / max(done, 1)).reshape(h, w, 3)
