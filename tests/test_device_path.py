"""The device path's plumbing, checked on the CPU: compile cache location,
timing, the precision pin, the shared scene builder, the float64 guards,
the cross-check helpers, and chip_smoke.py (which must refuse the CPU, and
whose phases are rehearsed here at a tiny size)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import armour_tpu
from armour_tpu import crosscheck as xc
from armour_tpu.config import ArmourConfig
from armour_tpu.models.kinova import kinova_gen3
from armour_tpu.utils import cache
from armour_tpu.utils.timing import timed

REPO = Path(__file__).resolve().parents[1]
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture
def restore_cache_config():
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_env_dir_wins(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert cache.cache_dir() == tmp_path / "cc"
    assert cache.enable_persistent_cache() == tmp_path / "cc"
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
    assert (tmp_path / "cc").is_dir()


def test_default_cache_dir_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.cache_dir()
    assert path == REPO / ".jax_cache" == cache.cache_dir()
    assert path.is_absolute()
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_bad_cache_config_raises(monkeypatch, tmp_path, restore_cache_config):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(blocker))
    with pytest.raises(OSError):
        cache.enable_persistent_cache()


def test_timed_returns_output_and_positive_times():
    f = jax.jit(lambda x: x * 2.0)
    times, out = timed(f, jnp.arange(4.0), iters=3)
    assert len(times) == 3 and all(t > 0 for t in times)
    np.testing.assert_array_equal(np.asarray(out), [0.0, 2.0, 4.0, 6.0])


def test_matmul_precision_pinned_to_highest():
    assert armour_tpu.__version__
    assert jax.config.jax_default_matmul_precision == "highest"


def _run_smoke(cwd, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_chip_smoke_refuses_the_cpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "compile" not in proc.stdout
    assert "needs 1 GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_planning_instances_shapes():
    from armour_tpu.worlds import planning_instances

    cfg = ArmourConfig(dtype=jnp.float32)
    q0, qd0, qdd0, q_des, obs = planning_instances(kinova_gen3(), cfg, 2)
    assert q0.shape == qd0.shape == qdd0.shape == q_des.shape == (2, 7)
    assert obs.centers.shape == (2, cfg.max_obstacles, 3)
    assert obs.generators.shape == (2, cfg.max_obstacles, 3, 3)
    assert obs.mask.shape == (2, cfg.max_obstacles)
    # rows 0 and 1 are scenes with 13 and 16 obstacles
    np.testing.assert_array_equal(np.asarray(obs.mask).sum(axis=1), [13, 16])
    assert np.all(np.isfinite(np.asarray(q_des)))
    assert q_des.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(qd0), 0.0)


@pytest.mark.parametrize("helper", ["mass_eigenvalue_bracket",
                                    "certified_link_m_min",
                                    "certified_link_m_max", "f64_truth"])
def test_f64_helpers_refuse_float32(helper):
    from armour_tpu import certify, config

    robot = kinova_gen3()
    calls = {
        "mass_eigenvalue_bracket": lambda: config.mass_eigenvalue_bracket(robot),
        "certified_link_m_min": lambda: certify.certified_link_m_min(robot),
        "certified_link_m_max": lambda: certify.certified_link_m_max(robot),
        "f64_truth": lambda: xc.f64_truth(
            xc.BAND_Q0, xc.BAND_QD0, xc.BAND_QDD0, np.zeros(1, int),
            np.zeros((1, 7)), np.zeros(1), robot, ArmourConfig()),
    }
    with jax.enable_x64(False):
        with pytest.raises(RuntimeError, match="needs float64"):
            calls[helper]()


def test_relative_error_and_mask():
    ref = np.array([1.0, -2.0, 4.0, 1e-9])
    x = ref + np.array([0.0, 4e-4, 0.0, 1.0])
    assert xc.relative_error(x, ref) == pytest.approx(1.0 / 4.0)
    mask = np.array([True, True, True, False])
    assert xc.relative_error(x, ref, mask) == pytest.approx(1e-4)
    assert xc.relative_error(np.zeros(2), np.zeros(2)) == 0.0


def test_violation_excess_thresholds():
    cfg = ArmourConfig()
    viol = np.array([[0.0, 0.0, 0.0, 0.0],
                     [cfg.torque_violation_threshold * 2, -1.0, -1.0, -1.0],
                     [-1.0, cfg.collision_violation_threshold, -1.0, -1.0]])
    ex = xc.violation_excess(viol, cfg)
    assert ex[0] <= 0.0 and ex[1] > 0.0 and ex[2] == 0.0


def test_containment_margins():
    c = np.zeros((2, 3))
    r = np.full((2, 3), 0.5)
    bands = {g: (c, r) for g in xc.BAND_GROUPS}
    inside = {g: np.full((2, 3), 0.25) for g in xc.BAND_GROUPS}
    assert all(v == pytest.approx(-0.25)
               for v in xc.containment_margins(bands, inside).values())
    outside = dict(inside, fk=np.full((2, 3), 0.75))
    assert xc.containment_margins(bands, outside)["fk"] == pytest.approx(0.25)


def test_hyp_conditioned_masks_parallel_pairs():
    from armour_tpu.collision import N_COMB, _COMBS, pad_obstacles
    from armour_tpu.kinematics import LinkFRS

    # one time step, one link: identity shape generators and equal radii are
    # parallel to the axis-aligned obstacle generators pairwise
    frs = LinkFRS(center_coef=jnp.zeros((1, 1, 3, 4)),
                  shape_gens=jnp.eye(3)[None, None] * 0.1,
                  radius=jnp.full((1, 1, 3), 0.01))
    obs = pad_obstacles(np.zeros((1, 3)), np.eye(3)[None] * 0.2, 1,
                        jnp.float64)
    mask = np.asarray(xc.hyp_conditioned(frs, obs))[:, 0]
    assert mask.shape == (N_COMB,)
    axis = np.array([0, 1, 2] * 3)       # axis of each of the 9 generators
    parallel = axis[_COMBS[:, 0]] == axis[_COMBS[:, 1]]
    np.testing.assert_array_equal(mask, ~parallel)


REHEARSAL = """
import json, chip_smoke
report = chip_smoke.run_one_card(
    cfg_overrides=dict(num_time_steps=8, max_obstacles=20, screen_k=256),
    n_scenes=2, batch=3, n_samples=16, loop_worlds=2, loop_iters=2, reps=1)
print(json.dumps(report))
"""


def test_chip_smoke_phases_rehearsal_on_cpu():
    """chip_smoke.py's one-card phases end to end at a tiny size on the CPU
    (the GPU check is the only part skipped), in a float32 process with x64
    off as on the card."""
    import json

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(v <= xc.STAGE_RTOL for v in report["stage_errors"].values())
    assert report["recheck_worst"] <= 0.0
    assert all(v <= 0.0 for v in report["containment"].values())
    assert report["loop_violations"] == 0


def test_busy_union_merges_overlaps():
    from armour_tpu.utils.timing import busy_union

    assert busy_union([]) == 0
    assert busy_union([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert busy_union([(3, 4), (0, 1)]) == 2
