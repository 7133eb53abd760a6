"""The receding-horizon planner: one planning step as a single jitted program.

Replaces the reference's whole armour_main.cu process (file-based IPC +
OpenMP reachset loop + CUDA collision kernels + Ipopt): JRS construction,
PZ FK/RNEA, obstacle hyperplanes and the NLP solve all live in ONE jitted
function — no host round-trips inside a step (SURVEY.md section 2.3).

make_planner returns a compiled step; make_batch_planner vmaps it over
worlds, so one device solves many independent planning problems per step
(parallel/batch.py shards that axis over several devices).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from .collision import ObstacleSet, build_hyperplanes, screen_collision
from .config import ArmourConfig
from .dynamics import torque_frs
from .jrs import build_jrs
from .kinematics import forward_occupancy, reduce_links
from .nlp import PlanProblem, SolveResult, solve
from .pz.basis import make_basis
from .robot import RobotModel


def build_problem(q0, qd0, qdd0, q_des, obs: ObstacleSet, robot: RobotModel,
                  cfg: ArmourConfig, basis):
    """The reachset prefix of a planning step: JRS -> PZ FK/RNEA ->
    obstacle hyperplanes -> screened rows.  Returns (jrs, PlanProblem)."""
    jrs = build_jrs(q0, qd0, qdd0, robot, cfg, basis)
    links = forward_occupancy(jrs, robot, cfg, basis)
    frs = reduce_links(links, basis)
    torque = torque_frs(jrs, robot, cfg, basis)
    hyp = build_hyperplanes(frs, obs)
    screened = screen_collision(hyp, obs, frs, cfg.screen_k,
                                cfg.screen_obstacle_quota)
    if cfg.grasp_constraints:
        from .grasp import GraspParams, grasp_frs

        grasp = grasp_frs(
            jrs, robot, cfg, basis,
            GraspParams(mu=cfg.grasp_mu,
                        support_radius=cfg.grasp_support_radius,
                        normal_axis=cfg.grasp_normal_axis),
        )
    else:
        grasp = None
    prob = PlanProblem(
        traj=jrs.traj,
        q_des=jnp.asarray(q_des, cfg.dtype),
        torque=torque,
        frs=frs,
        hyp=hyp,
        obs=obs,
        screened=screened,
        grasp=grasp,
    )
    return jrs, prob


def plan_step(q0, qd0, qdd0, q_des, obs: ObstacleSet, robot: RobotModel,
              cfg: ArmourConfig, basis, k0=None) -> SolveResult:
    """One full planning iteration (armour_main.cu main() equivalent).
    cfg.traj_family='armtd' routes to the constant-acceleration comparison
    pipeline (armtd_main.cu equivalent) — same downstream FK/RNEA/collision/
    NLP, different trajectory family."""
    if cfg.traj_family == "armtd":
        from .armtd import plan_step_armtd

        return plan_step_armtd(q0, qd0, q_des, obs, robot, cfg, basis, k0=k0)
    _, prob = build_problem(q0, qd0, qdd0, q_des, obs, robot, cfg, basis)
    return solve(prob, robot, cfg, basis, k0=k0)


def reachset_cost(q0, qd0, qdd0, q_des, obs: ObstacleSet, robot: RobotModel,
                  cfg: ArmourConfig, basis):
    """The reachset prefix alone, reduced to a scalar that consumes the
    torque bounds and the screened rows (so XLA keeps every stage); timed
    against the full step to split reachset from solver time."""
    _, prob = build_problem(q0, qd0, qdd0, q_des, obs, robot, cfg, basis)
    return prob.torque.torque_radius.sum() + prob.screened.d.sum()


def make_planner(robot: RobotModel, cfg: ArmourConfig):
    """Compile a single-world planning step: (q0, qd0, qdd0, q_des, obs) ->
    SolveResult."""
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)

    @jax.jit
    def step(q0, qd0, qdd0, q_des, obs: ObstacleSet):
        return plan_step(q0, qd0, qdd0, q_des, obs, robot, cfg, basis)

    return step


def make_batch_planner(robot: RobotModel, cfg: ArmourConfig):
    """Compile a planner vmapped over a leading worlds axis."""
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)

    @jax.jit
    def step(q0, qd0, qdd0, q_des, obs: ObstacleSet):
        fn = lambda a, b, c, d, o: plan_step(a, b, c, d, o, robot, cfg, basis)
        return jax.vmap(fn)(q0, qd0, qdd0, q_des, obs)

    return step


def strong_config(cfg: ArmourConfig) -> ArmourConfig:
    """The rescue/acceptance solver profile: full iteration budget + deep
    screening (see batch_sim.run_trials_batched rescue_solver)."""
    import dataclasses

    return dataclasses.replace(
        cfg, solver_outer_iters=max(cfg.solver_outer_iters, 8),
        solver_inner_iters=max(cfg.solver_inner_iters, 6),
        solver_cull_after=2, solver_keep_seeds=2,
        solver_alphas=(1.0, 0.25, 0.0625, 0.015625),
        screen_k=max(cfg.screen_k, 4096))


def make_rescue_planner(robot: RobotModel, cfg: ArmourConfig):
    """Single-world planner at the strong profile, for infeasible-plan
    retries in the serial closed loop."""
    return make_planner(robot, strong_config(cfg))


def make_realtime_planner(robot: RobotModel, cfg: ArmourConfig,
                          example_args=None, time_buffer: float = 0.05,
                          min_outer: int = 2, verbose: bool = False):
    """Budget-respecting planner (armour_main.cu:227-229 semantics).

    The reference allocates the solver `0.5*DURATION - t_reachsets - 0.05` s
    of wall time per solve and lets Ipopt stop on the clock.  A jitted device
    program cannot watch the clock, so the budget is enforced at COMPILE
    CALIBRATION time instead: measure the reachset prefix, derive the solver
    budget, then lower solver_outer_iters until the measured full step fits
    `t_reachsets + budget`.  Returns (step_fn, calibration_dict).

    example_args: (q0, qd0, qdd0, q_des, obs) used for timing; defaults to a
    synthetic two-obstacle scene.
    """
    import dataclasses

    import numpy as np

    from .utils.timing import timed

    if example_args is None:
        from .collision import pad_obstacles

        rng = np.random.default_rng(0)
        q0 = jnp.asarray(rng.uniform(-0.5, 0.5, robot.num_factors), cfg.dtype)
        c = np.array([[0.6, 0.6, 0.6], [-0.6, -0.5, 0.8]])
        g = np.stack([np.diag([0.05] * 3)] * 2)
        example_args = (q0, jnp.zeros_like(q0), jnp.zeros_like(q0), q0 + 0.04,
                        pad_obstacles(c, g, cfg.max_obstacles, cfg.dtype))

    basis = make_basis(robot.num_factors, cfg.max_poly_degree)

    def mean_time(fn):
        return float(np.mean(timed(fn, *example_args)[0]))

    reachsets_only = jax.jit(functools.partial(
        reachset_cost, robot=robot, cfg=cfg, basis=basis))

    t_rs = mean_time(reachsets_only)
    budget = 0.5 * cfg.duration - t_rs - time_buffer
    deadline = t_rs + budget

    outer = cfg.solver_outer_iters
    chosen = None
    while outer >= min_outer:
        cfg_i = dataclasses.replace(cfg, solver_outer_iters=outer,
                                    solver_cull_after=min(
                                        cfg.solver_cull_after, max(outer - 1, 0)))
        step_i = make_planner(robot, cfg_i)
        dt = mean_time(step_i)
        if verbose:
            print(f"realtime calibration: outer={outer} step={dt * 1e3:.1f} ms "
                  f"(deadline {deadline * 1e3:.1f} ms)")
        chosen = (step_i, {"t_reachsets_s": t_rs, "budget_s": budget,
                           "outer_iters": outer, "step_s": dt,
                           "fits_budget": dt <= deadline})
        if dt <= deadline:
            break
        outer -= 1
    return chosen
