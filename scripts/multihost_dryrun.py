"""Multi-host dryrun: the sharded planner over a 2-process jax.distributed
mesh (4+4 virtual CPU devices), validating that the worlds-axis sharding and
the psum summary compile and execute across a process boundary —
BASELINE.json's "1 chip / 1 host / >= 2 hosts" axis without real hardware
(SURVEY.md section 5, distributed backend).

Usage:
  python scripts/multihost_dryrun.py              # parent: spawns 2 workers
  python scripts/multihost_dryrun.py worker <i>   # worker process i

The parent writes MULTIHOST.json at the repo root with the global summary
reported by process 0.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = 47123
N_PROC = 2
DEV_PER_PROC = 4
W = 16          # worlds, sharded 8 per process / 2 per device


def worker(pid: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=N_PROC,
        process_id=pid,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from armour_tpu.collision import pad_obstacles
    from armour_tpu.config import ArmourConfig
    from armour_tpu.models.kinova import kinova_gen3
    from armour_tpu.parallel.batch import (make_mesh, make_sharded_planner,
                                           make_sharded_summary)

    assert jax.process_count() == N_PROC
    assert len(jax.devices()) == N_PROC * DEV_PER_PROC, len(jax.devices())

    robot = kinova_gen3()
    # tiny shapes: this validates sharding + cross-process collectives, not
    # throughput (the driver's dryrun_multichip covers flagship shapes)
    cfg = ArmourConfig(dtype=jnp.float32, num_time_steps=16, max_obstacles=4,
                       screen_k=256, solver_outer_iters=2, solver_inner_iters=2)
    mesh = make_mesh()
    step = make_sharded_planner(robot, cfg, mesh)
    summ = make_sharded_summary(mesh)

    # deterministic global inputs; each process materialises its local shard
    rng = np.random.default_rng(0)
    q0_g = rng.uniform(-0.5, 0.5, (W, robot.num_factors)).astype(np.float32)
    wp_g = (q0_g + 0.04).astype(np.float32)
    zeros_g = np.zeros_like(q0_g)
    c = np.array([[0.6, 0.6, 0.6], [-0.6, -0.5, 0.8]])
    g = np.stack([np.diag([0.05] * 3)] * 2)
    obs1 = pad_obstacles(c, g, cfg.max_obstacles, cfg.dtype)
    obs_g = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x)[None], (W,) + x.shape), obs1)

    sharding = NamedSharding(mesh, P("worlds"))

    def dist(x):
        return jax.make_array_from_process_local_data(
            sharding, np.ascontiguousarray(
                x[pid * (W // N_PROC): (pid + 1) * (W // N_PROC)]))

    args = (dist(q0_g), dist(zeros_g), dist(zeros_g), dist(wp_g),
            jax.tree.map(dist, obs_g))
    res = step(*args)
    out = summ(res.feasible, res.cost)
    out = jax.tree.map(lambda x: np.asarray(x).item(), out)
    if pid == 0:
        payload = {
            "processes": jax.process_count(),
            "devices": len(jax.devices()),
            "worlds": W,
            **out,
        }
        with open(os.path.join(REPO, "MULTIHOST.json"), "w") as f:
            json.dump(payload, f, indent=1)
        print(json.dumps(payload))


def parent():
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={DEV_PER_PROC}")
    env.pop("JAX_PLATFORMS", None)   # workers pin cpu via jax.config
    procs = [
        subprocess.Popen([sys.executable, __file__, "worker", str(i)],
                         env=env, cwd=REPO)
        for i in range(N_PROC)
    ]
    codes = [p.wait(timeout=900) for p in procs]
    assert all(c == 0 for c in codes), codes
    with open(os.path.join(REPO, "MULTIHOST.json")) as f:
        payload = json.load(f)
    assert payload["processes"] == N_PROC
    assert payload["devices"] == N_PROC * DEV_PER_PROC
    print("multihost dryrun ok:", payload)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]))
    else:
        parent()
