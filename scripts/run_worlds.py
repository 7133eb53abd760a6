"""Closed-loop benchmark over saved worlds (kinova_run_100_worlds.m).

Usage: python scripts/run_worlds.py [world_dir] [n_worlds] [results.json] [mode]

Default mode runs every world in lockstep on one device
(batch_sim.run_trials_batched); mode "serial" runs the per-world loop
(identical outcomes, much slower); mode "budget" first calibrates the
solver iteration budget to the measured reachset time at batch 1
(planner.make_realtime_planner, armour_main.cu:227-229 semantics) and runs
the batched suite at that profile, recording the calibration in the
results JSON.
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import glob
import json

import jax.numpy as jnp

from armour_tpu.config import ArmourConfig
from armour_tpu.experiments import (run_world_suite, run_world_suite_batched,
                                    summarize)
from armour_tpu.models.kinova import kinova_gen3
from armour_tpu.utils.cache import enable_persistent_cache


def main():
    enable_persistent_cache()
    world_dir = sys.argv[1] if len(sys.argv) > 1 else "saved_worlds/random"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    out = sys.argv[3] if len(sys.argv) > 3 else "results_worlds.json"
    mode = sys.argv[4] if len(sys.argv) > 4 else "batched"
    paths = sorted(glob.glob(f"{world_dir}/*.csv"))
    if n:
        paths = paths[:n]
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=jnp.float32)
    if mode == "serial":
        results = run_world_suite(paths, robot, cfg, results_path=out)
    elif mode == "budget":
        import dataclasses

        from armour_tpu.planner import make_realtime_planner

        _, calib = make_realtime_planner(robot, cfg, verbose=True)
        cfg = dataclasses.replace(
            cfg, solver_outer_iters=calib["outer_iters"],
            solver_cull_after=min(cfg.solver_cull_after,
                                  max(calib["outer_iters"] - 1, 0)))
        results = run_world_suite_batched(
            paths, robot, cfg, results_path=out,
            extra_stats={"budget_calibration": calib, "budget_mode": True})
    else:
        # acceptance configuration: config-RRT*-first guidance for blocked
        # worlds, no rescue solver (the rescue profile cost 3 goals net on
        # the cluttered scenes)
        results = run_world_suite_batched(paths, robot, cfg, results_path=out,
                                          rescue_solver=False, guidance="auto")
    print(json.dumps(summarize(results), indent=1))


if __name__ == "__main__":
    main()
