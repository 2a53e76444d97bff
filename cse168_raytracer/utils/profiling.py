"""Phase timing + device profiling.

The reference brackets preCalc/BVH/photon/render phases with
getTime() deltas (Utility.cpp:32-48, Scene.cpp:54-82,108,175,206).
Equivalent here: wall-clock spans that block_until_ready their outputs,
plus optional jax.profiler trace capture for xprof.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax

from cse168_raytracer.utils import console

_SPANS: dict[str, float] = {}


@contextlib.contextmanager
def phase(name: str, result=None, log: bool = True):
    """Time a named phase. If `result` is a callable, it is invoked at
    exit and its return value block_until_ready'd so device work is
    included in the span."""
    t0 = time.time()
    try:
        yield
    finally:
        if result is not None:
            jax.block_until_ready(result() if callable(result) else result)
        dt = time.time() - t0
        _SPANS[name] = _SPANS.get(name, 0.0) + dt
        if log:
            console.debug("[%s] %.3fs", name, dt)


def spans() -> dict[str, float]:
    return dict(_SPANS)


def reset() -> None:
    _SPANS.clear()


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """jax.profiler trace capture (view with xprof/tensorboard).
    No-op when logdir is None."""
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
