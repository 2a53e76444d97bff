"""cse168_raytracer — a differentiable ray/path tracer in JAX.

A from-scratch JAX/XLA framework with the capabilities of the CSE168
C++ reference tracer (Whitted ray tracing, Monte-Carlo path tracing,
photon mapping, BVH acceleration, procedural + image textures, HDR
environment maps, depth of field), re-designed for accelerators:

- SoA scene pytrees instead of virtual-dispatch object graphs
- wavefront (per-bounce queue) integration instead of recursion
- batched Pluecker-form ray-triangle tests instead of per-ray SSE
  packets (reference SSE.h, BVH.cpp:341-435)
- on NVIDIA GPUs, a one-thread-per-ray CUDA walk of a binned-SAH BVH
  (csrc/bvh_trace.cu through the XLA FFI); elsewhere Morton-clustered
  triangle blocks + AABB stream culling (reference BVH.cpp:438-658)
- fixed-radius hashed-grid photon gather instead of a kd-tree kNN
  (reference PhotonMap.cpp:152-243)
- jax.random key threading instead of racy libc rand()
- shard_map pixel-tile / photon-batch sharding over a device mesh
  instead of OpenMP threads (reference Scene.cpp:112-115)
"""

__version__ = "0.1.0"

from cse168_raytracer.config import RenderConfig  # noqa: F401
