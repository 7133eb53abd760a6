"""Worker: float32 reachable-set bands for the containment check, on the CPU.

Runs with x64 off (genuine float32, as on the GPU path) on the CPU backend.
Loads sampled (t_ind, k) pairs from an input .npz, builds the f32 bands
(crosscheck.f32_bands: JRS -> FK -> RNEA, sliced at the samples) at a given
float_slop and writes (center, radius) per group to an output .npz.
tests/test_f32_soundness.py checks float64 ground truth against them;
chip_smoke.py runs the same bands on the GPU.

This is the validation SURVEY.md section 7 hard part (2) calls for: interval
arithmetic without directed rounding is only sound with an outward slop
budget, and that budget must be measured, not guessed.

Usage: python scripts/f32_bands_worker.py IN.npz OUT.npz FLOAT_SLOP
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("JAX_ENABLE_X64", None)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp


def main():
    in_path, out_path, slop = sys.argv[1], sys.argv[2], float(sys.argv[3])
    data = np.load(in_path)

    from armour_tpu.config import ArmourConfig
    from armour_tpu.crosscheck import f32_bands
    from armour_tpu.models.kinova import kinova_gen3
    from armour_tpu.pz.basis import make_basis

    robot = kinova_gen3()
    cfg = ArmourConfig(num_time_steps=int(data["num_time_steps"]),
                       dtype=jnp.float32, float_slop=slop)
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    f32 = lambda name: jnp.asarray(data[name], jnp.float32)
    bands = jax.jit(lambda *a: f32_bands(*a, robot, cfg, basis))(
        f32("q0"), f32("qd0"), f32("qdd0"),
        jnp.asarray(data["t_inds"], jnp.int32), f32("ks"))
    out = {}
    for name, (c, r) in bands.items():
        out[f"{name}_c"] = np.asarray(c)
        out[f"{name}_r"] = np.asarray(r)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main()
