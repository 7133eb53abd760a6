"""f32 containment soundness (SURVEY.md section 7 hard part (2)).

The device path runs the reachability pipeline in float32 without directed
rounding; soundness relies on the outward `float_slop` budget added to the
independent radius at every bilinear PZ op.  This test builds the f32 bands
in a genuine-f32 subprocess (x64 off, as on the GPU) at the DEFAULT config
slop and verifies float64 ground-truth samples stay inside them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from armour_tpu import crosscheck
from armour_tpu.config import ArmourConfig
from armour_tpu.models.kinova import kinova_gen3

ROBOT = kinova_gen3()
N_T = 16
# 32 samples keep the subprocess well under its wall cap even when the full
# suite loads every core; containment is a per-sample property, so fewer
# samples only reduce statistical coverage, not soundness of what is checked.
N_SAMPLES = 32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def f32_bands(tmp_path_factory):
    cfg = ArmourConfig(num_time_steps=N_T)
    samples = crosscheck.band_samples(cfg, N_SAMPLES)
    tmp = tmp_path_factory.mktemp("f32")
    in_path, out_path = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(in_path, q0=crosscheck.BAND_Q0, qd0=crosscheck.BAND_QD0,
             qdd0=crosscheck.BAND_QDD0, t_inds=samples["t_inds"],
             ks=samples["ks"], num_time_steps=N_T)
    env = dict(os.environ)
    env.pop("JAX_ENABLE_X64", None)
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "f32_bands_worker.py"),
         in_path, out_path, str(cfg.float_slop)],
        check=True, env=env, cwd=REPO, timeout=1800,
    )
    out = np.load(out_path)
    bands = {g: (out[f"{g}_c"], out[f"{g}_r"]) for g in crosscheck.BAND_GROUPS}
    return cfg, samples, bands


def test_default_float_slop_is_on():
    """Round-1 shipped float_slop=0.0 — the f32 outward-rounding budget must
    be enabled by default for the f32 device path to be sound."""
    assert ArmourConfig().float_slop > 0.0


@pytest.mark.slow
def test_f32_containment_of_f64_truth(f32_bands):
    cfg, samples, bands = f32_bands
    truth = crosscheck.f64_truth(
        crosscheck.BAND_Q0, crosscheck.BAND_QD0, crosscheck.BAND_QDD0,
        samples["t_inds"], samples["ks"], samples["s_frac"], ROBOT, cfg)
    worst = crosscheck.containment_margins(bands, truth)
    assert all(v <= 0.0 for v in worst.values()), (
        f"f32 bands must contain f64 truth with the default slop: {worst}")
