"""Test configuration: force a virtual 8-device CPU platform.

Tests need no accelerator: sharding tests run on an 8-device CPU mesh
via XLA's host-platform device-count override, per the
reference-derived test strategy (SURVEY.md section 4).  float64 is
enabled so physics goldens can be validated at full precision; compute
paths remain dtype-explicit, so float32 (device) behavior is tested by
passing dtype=jnp.float32.  The GPU path runs through chip_smoke.py and
bench.py on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Force the CPU backend before any backend is initialized, whatever
# JAX_PLATFORMS says, so a machine with a GPU runs the same tests.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
