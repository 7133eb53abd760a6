"""Benchmark: safe planning solves per second on one GPU.

Measures the full planning iteration (JRS -> PZ FK/RNEA -> obstacle
hyperplanes -> NLP solve) on CONTESTED instances: the saved-world benchmark
scenes (13-40 obstacles) with waypoints from the end-effector RRT* HLP
(worlds.planning_instances) — the problems the closed-loop suite solves,
not synthetic pushed-away obstacles.  Every call is timed to
jax.block_until_ready.  Without a GPU it exits non-zero.

Prints the device, the card's name and power limit, then ONE JSON line:
  value / solves_per_s : batch throughput of the full planning step
  latency_batch1_ms    : single-solve latency — the real-time criterion
                         (must be < 500 ms; armour_main.cu:227-229 budget)
  reachset_ms / solver_ms : jit-prefix split of the batch step (the
                         reference couples its Ipopt budget to measured
                         reachset time, armour_main.cu:227)
  feasible             : how many of the scene instances admit a plan
                         (reported separately from throughput; infeasible
                         instances cost the same wall time)
  vs_baseline          : solves/s divided by the reference's hard real-time
                         rate of 2 solves/s/robot = how many real-time
                         robots one card serves.
"""

import functools
import json
import os

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from armour_tpu.config import ArmourConfig
    from armour_tpu.models.kinova import kinova_gen3
    from armour_tpu.planner import make_batch_planner, make_planner, reachset_cost
    from armour_tpu.pz.basis import make_basis
    from armour_tpu.utils.cache import enable_persistent_cache
    from armour_tpu.utils.device import card_name_and_power_limit, require_gpu
    from armour_tpu.utils.timing import timed
    from armour_tpu.worlds import planning_instances

    devices = require_gpu()
    enable_persistent_cache()
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=jnp.float32)
    batch = int(os.environ.get("ARMOUR_BENCH_BATCH", "64"))
    args = planning_instances(robot, cfg, batch)

    # --- batch throughput ---
    step = make_batch_planner(robot, cfg)
    times, out = timed(step, *args)
    dt = min(times)
    solves_per_s = batch / dt
    n_feasible = int(np.sum(np.asarray(out.feasible)))

    # --- batch-1 latency (the real-time criterion) + p99 over instances ---
    step1 = make_planner(robot, cfg)
    instances = [jax.tree.map(lambda x: x[i], args)
                 for i in range(min(48, batch))]
    dt1 = min(timed(step1, *instances[0], iters=10)[0])
    lats = [timed(step1, *ai, iters=1, warmup=0)[0][0] for ai in instances]
    lat_p99 = float(np.percentile(lats, 99))
    lat_p50 = float(np.percentile(lats, 50))

    # --- reachset vs solver split (jit-prefix timing at the same batch) ---
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    prefix = functools.partial(reachset_cost, robot=robot, cfg=cfg, basis=basis)
    reachsets_only = jax.jit(lambda *a: jax.vmap(prefix)(*a).sum())
    dt_rs = min(timed(reachsets_only, *args)[0])

    # --- real-time budget semantics (armour_main.cu:227-229): the solver's
    # wall-time allowance per solve is 0.5*DURATION - t_reachsets - 0.05 s,
    # with t_reachsets MEASURED at batch 1 (the deployment shape) ---
    dt_rs1 = min(timed(reachsets_only,
                       *jax.tree.map(lambda x: x[:1], args))[0])
    solver_budget_s = 0.5 * cfg.duration - dt_rs1 - 0.05
    solver1_s = max(dt1 - dt_rs1, 0.0)

    d = devices[0]
    result = {
        "metric": "planning_solves_per_s",
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / 2.0, 2),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices)},
        "card": card_name_and_power_limit(),
        "batch": batch,
        "feasible": n_feasible,
        "latency_ms_per_batch": round(dt * 1e3, 2),
        "latency_batch1_ms": round(dt1 * 1e3, 2),
        "latency_p50_ms": round(lat_p50 * 1e3, 2),
        "latency_p99_ms": round(lat_p99 * 1e3, 2),
        "realtime_ok": bool(lat_p99 < 0.5),
        "reachset_ms": round(dt_rs * 1e3, 2),
        "solver_ms": round((dt - dt_rs) * 1e3, 2),
        "reachset_batch1_ms": round(dt_rs1 * 1e3, 2),
        "solver_budget_ms": round(solver_budget_s * 1e3, 2),
        "budget_ok": bool(solver1_s <= solver_budget_s),
        "instances": "saved_worlds/random + EE-RRT* waypoints",
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
