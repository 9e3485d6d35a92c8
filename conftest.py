"""Root pytest bootstrap: an 8-device virtual CPU mesh for the sharded tests.

``XLA_FLAGS`` is read when JAX initialises its backends, so the device
count is set here, before any test module imports ``jax``. The suite runs
on the CPU (``JAX_PLATFORMS=cpu``); tests marked ``gpu`` skip there and run
on the card through ``chip_smoke.py``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
