"""Test configuration: force an 8-device CPU mesh (SURVEY.md §4.5) and fp64.

Tests run on CPU so CI needs no accelerator: the virtual 8-device platform
exercises every shard_map/psum path, and x64 gives a tight numerical oracle
for the analytic-vs-autodiff and Schur-vs-dense equivalence tests. The
library itself is dtype-polymorphic; production runs on the GPU are f32.
Tests that need the card carry the ``gpu`` marker and skip here; run them on
a GPU machine with ``python -m pytest tests/ -m gpu`` (chip_smoke.py runs the
same checks at full size).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
