"""Test configuration: run on the CPU with 8 virtual devices so the
multi-device sharding logic is exercised without a multi-GPU host
(xla_force_host_platform_device_count, per SURVEY.md §4).

The CPU is the default only when JAX has not been set up yet: on the
card, `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` (or
chip_smoke.py, which runs those tests in its own process) keeps the GPU.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

if "jax" not in sys.modules:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
