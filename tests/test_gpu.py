"""The float32 program on the GPU against float64 on the CPU, through the
same check functions chip_smoke.py runs (armour_tpu.crosscheck), at the
flagship configuration on two saved scenes.

These tests need a GPU and skip without one.  On the card:
    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
(tests/conftest.py then leaves JAX on the GPU with x64 off.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

N_SCENES = 2
N_SAMPLES = 64


@pytest.fixture(scope="module")
def gpu_reference():
    if jax.devices()[0].platform != "gpu" or jax.config.jax_enable_x64:
        pytest.skip("needs a GPU in a float32 process: "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    from armour_tpu import crosscheck as xc
    from armour_tpu.config import ArmourConfig
    from armour_tpu.models.kinova import kinova_gen3
    from armour_tpu.pz.basis import make_basis
    from armour_tpu.worlds import planning_instances

    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=jnp.float32)
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    scenes = planning_instances(robot, cfg, N_SCENES)
    samples = xc.band_samples(cfg, N_SAMPLES)
    with xc.Reference(scenes, samples) as ref:
        yield robot, cfg, basis, scenes, samples, ref


@pytest.mark.gpu
def test_gpu_stages_and_plans_match_f64(gpu_reference):
    from armour_tpu import crosscheck as xc
    from armour_tpu.planner import make_batch_planner

    robot, cfg, basis, scenes, _, ref = gpu_reference
    errs = xc.device_stage_errors(scenes, ref, robot, cfg, basis)
    assert all(v <= xc.STAGE_RTOL for v in errs.values()), errs
    out = make_batch_planner(robot, cfg)(*scenes)
    excess = xc.recheck_excess(out.k, out.feasible, ref, cfg)
    assert np.all(excess <= 0.0), excess


@pytest.mark.gpu
def test_gpu_f32_bands_contain_f64_truth(gpu_reference):
    from armour_tpu import crosscheck as xc

    robot, cfg, basis, _, samples, ref = gpu_reference
    margins = xc.device_band_margins(samples, ref, robot, cfg, basis)
    assert all(v <= 0.0 for v in margins.values()), margins
