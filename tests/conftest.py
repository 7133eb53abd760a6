import os

# Tests run on a virtual 8-device CPU mesh in float64 so that PZ containment
# and parity checks are exact.  `JAX_PLATFORMS=cuda python -m pytest -m gpu
# tests/` runs the `gpu`-marked tests on the card instead, with x64 off: a
# process that holds the GPU runs the float32 program under test.
ON_GPU = os.environ.get("JAX_PLATFORMS") == "cuda"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault(
        "XLA_FLAGS",
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
    )

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
