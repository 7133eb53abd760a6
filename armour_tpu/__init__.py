"""armour_tpu: receding-horizon safe planning and robust control for serial
manipulators (capabilities of roahmlab/armour, re-designed as one jitted
JAX/XLA program per planning step; it runs on an NVIDIA GPU)."""

__version__ = "0.1.0"

import jax as _jax

# Safety-critical set arithmetic: at default precision XLA may run float32
# matmuls on the GPU's tensor cores in TF32, which keeps 10 mantissa bits
# (~1e-3 relative) — far outside the 1e-4 reference-match tolerance and
# unsound for reachable-set containment.  Pin every dot (the PZ basis
# scatter, the link-center and torque-row evaluations, the Gauss-Newton H)
# to full float32.
_jax.config.update("jax_default_matmul_precision", "highest")
