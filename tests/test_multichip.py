"""Multi-device sharding dry runs on the virtual 8-device CPU mesh
(SURVEY.md section 4 level v)."""

import jax
import numpy as np
import pytest



@pytest.mark.slow
def test_dryrun_multichip():
    """The FULL flagship planning step sharded over 8 devices on 16 saved
    scenes (what __graft_entry__.dryrun_multichip runs on GPUs)."""
    import __graft_entry__ as ge

    robot, cfg = ge._flagship()
    _, out, summary = ge.sharded_run(jax.devices()[:8], robot, cfg, 16)
    assert int(summary["n_total"]) == 16
    assert int(summary["n_feasible"]) == int(np.sum(np.asarray(out.feasible)))


def test_sharded_planner_matches_one_device():
    """chip_smoke.py --cards 4 at a tiny size: the sharded planner over four
    devices agrees with the one-device batch planner on the same rows."""
    import chip_smoke

    chip_smoke.run_four_cards(
        jax.devices()[:4], n_scenes=4,
        cfg_overrides=dict(num_time_steps=8, max_obstacles=24, screen_k=128))
