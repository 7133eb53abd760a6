"""Stage-level profiler for the planning step (GPU only).

Replaces the round-2/3 scratch one-offs with one maintained tool:

  python benchmarks/profile_stages.py [batch]        # jit-prefix stage split
  python benchmarks/profile_stages.py [batch] solver # solver config sweep

Prefix timing: each row adds one pipeline stage under jit, so the delta
between consecutive rows is that stage's cost at the given batch (the same
technique bench.py uses for its reachset/solver split).  Solver sweep: the
full plan step at several (outer x inner x seeds x cull) settings on the
same contested scene instances as bench.py.  Every time ends in
jax.block_until_ready.
"""

import dataclasses
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from armour_tpu.collision import build_hyperplanes, screen_collision
from armour_tpu.config import ArmourConfig
from armour_tpu.dynamics import torque_frs
from armour_tpu.jrs import build_jrs
from armour_tpu.kinematics import forward_occupancy, reduce_links
from armour_tpu.planner import make_batch_planner
from armour_tpu.pz.basis import make_basis
from armour_tpu.models.kinova import kinova_gen3
from armour_tpu.utils.cache import enable_persistent_cache
from armour_tpu.utils.device import require_gpu
from armour_tpu.utils.timing import timed as _timed
from armour_tpu.worlds import planning_instances


def timed(fn, *args, iters=5):
    return min(_timed(fn, *args, iters=iters)[0])


def stage_split(cfg, robot, args, batch):
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)

    def upto(stage):
        # every prefix CONSUMES all outputs computed so far, or XLA
        # dead-code-eliminates the earlier stages and deltas go negative
        def one(q0, qd0, qdd0, o):
            acc = 0.0
            jrs = build_jrs(q0, qd0, qdd0, robot, cfg, basis)
            acc += jrs.traj.q0.sum()
            if stage == "jrs":
                return acc
            links = forward_occupancy(jrs, robot, cfg, basis)
            frs = reduce_links(links, basis)
            acc += frs.radius.sum()
            if stage == "fk":
                return acc
            tq = torque_frs(jrs, robot, cfg, basis)
            acc += tq.torque_radius.sum()
            if stage == "rnea":
                return acc
            hyp = build_hyperplanes(frs, o)
            acc += hyp.delta.sum()
            if stage == "hyp":
                return acc
            sc = screen_collision(hyp, o, frs, cfg.screen_k,
                                  cfg.screen_obstacle_quota)
            return acc + sc.d.sum()

        return jax.jit(lambda q0, qd0, qdd0, q_des, o:
                       jax.vmap(one)(q0, qd0, qdd0, o).sum())

    prev = 0.0
    for stage in ("jrs", "fk", "rnea", "hyp", "screen"):
        dt = timed(upto(stage), *args)
        print(f"{stage:8s} cum {dt * 1e3:8.2f} ms   delta {(dt - prev) * 1e3:8.2f} ms "
              f"({batch / dt:7.1f} inst/s)", flush=True)
        prev = dt


def solver_sweep(cfg0, robot, args, batch):
    for outer, inner, seeds, cull, keep in [
        (8, 6, 4, 0, 2),     # round-3 default, no cull
        (8, 6, 4, 2, 2),     # current default
        (6, 4, 4, 2, 2),
        (6, 4, 4, 1, 2),
        (4, 4, 4, 1, 2),
        (8, 6, 2, 0, 2),
        (6, 6, 4, 2, 1),
    ]:
        cfg = dataclasses.replace(
            cfg0, solver_outer_iters=outer, solver_inner_iters=inner,
            solver_seeds=seeds, solver_cull_after=cull, solver_keep_seeds=keep)
        step = make_batch_planner(robot, cfg)
        dt = timed(step, *args)
        out = step(*args)
        nf = int(np.sum(np.asarray(out.feasible)))
        print(f"outer={outer} inner={inner} seeds={seeds} cull@{cull}->"
              f"{keep}: {dt * 1e3:8.2f} ms  {batch / dt:7.1f} solves/s  "
              f"feasible {nf}/{batch}", flush=True)


def main():
    require_gpu()
    enable_persistent_cache()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    mode = sys.argv[2] if len(sys.argv) > 2 else "stages"
    cfg = ArmourConfig(dtype=jnp.float32)
    robot = kinova_gen3()
    args = planning_instances(robot, cfg, batch)
    if mode == "solver":
        solver_sweep(cfg, robot, args, batch)
    else:
        stage_split(cfg, robot, args, batch)


if __name__ == "__main__":
    main()
