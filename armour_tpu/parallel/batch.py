"""Scale-out: shard batched planning over a device mesh.

The reference is a single-process single-robot system (SURVEY.md section
2.3); the scale axis here is pure data parallelism over independent planning
problems (worlds x initial states x waypoints).  We lay a 1-D 'worlds' mesh
axis over the devices, shard every per-world input on that axis, and let
each device run the fully-fused planning step on its shard — zero
collectives in the forward path; summary statistics reduce with a single
psum.  The planning step needs no communication, so the mesh follows the
algorithm alone: one axis, whatever links join the devices.

For multi-host runs call jax.distributed.initialize() first; the same code
then spans hosts (the mesh enumerates all global devices).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..collision import ObstacleSet
from ..config import ArmourConfig
from ..planner import plan_step
from ..pz.basis import make_basis
from ..robot import RobotModel


def make_mesh(devices=None, axis: str = "worlds") -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis,))


def make_sharded_planner(robot: RobotModel, cfg: ArmourConfig, mesh: Mesh,
                         axis: str = "worlds"):
    """Compile a planner over [W, ...] world-sharded inputs.

    Returns step(q0, qd0, qdd0, q_des, obs) -> SolveResult with every output
    sharded along the worlds axis.  W must be divisible by mesh size.
    """
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)

    def local_step(q0, qd0, qdd0, q_des, obs):
        fn = lambda a, b, c, d, o: plan_step(a, b, c, d, o, robot, cfg, basis)
        return jax.vmap(fn)(q0, qd0, qdd0, q_des, obs)

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_summary(mesh: Mesh, axis: str = "worlds"):
    """psum-reduced fleet summary of a sharded SolveResult."""

    def local(feasible, cost):
        n_feas = jax.lax.psum(jnp.sum(feasible.astype(jnp.int32)), axis)
        total = jax.lax.psum(jnp.asarray(feasible.shape[0], jnp.int32), axis)
        cost_sum = jax.lax.psum(jnp.sum(jnp.where(feasible, cost, 0.0)), axis)
        return {
            "n_feasible": n_feas,
            "n_total": total,
            "mean_feasible_cost": cost_sum / jnp.maximum(n_feas, 1),
        }

    return jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=(P(axis), P(axis)),
            out_specs=P(), check_vma=False,
        )
    )


def stack_obstacles(obs_list) -> ObstacleSet:
    return jax.tree.map(lambda *xs: jnp.stack(xs), *obs_list)


def run_sharded(devices, robot: RobotModel, cfg: ArmourConfig, args):
    """One sharded planning step over a 1-D mesh of `devices` on the
    [W, ...] inputs `args` (W divisible by the device count), plus its psum
    summary.  Returns (SolveResult, summary dict)."""
    mesh = make_mesh(devices)
    out = make_sharded_planner(robot, cfg, mesh)(*args)
    summary = make_sharded_summary(mesh)(out.feasible, out.cost)
    return out, jax.block_until_ready(summary)
