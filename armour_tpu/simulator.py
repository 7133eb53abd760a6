"""Closed-loop simulation: plant dynamics, tracking rollout, safety oracles,
and the receding-horizon driver.

JAX equivalent of uarmtd_agent.m (plant + ode15s integration),
simulator_armtd.m (loop + safety checks) and kinova_world_static.m collision
checking:

  * plant: qdd = M(q)^-1 (u - C(q,qd)qd - g(q)) with TRUE (perturbed)
    inertial parameters + transmission inertia (uarmtd_agent.m:360-399),
  * integrator: fixed-step RK4 with zero-order-hold control at 1 kHz in one
    lax.scan (replaces ode15s; SURVEY.md section 7 S7),
  * oracles per move: exact OBB-vs-AABB link/obstacle separation (replaces
    mesh patch intersection), torque limits, ultimate bound, joint limits
    (simulator_armtd.m:238-267 semantics — all four must never fire),
  * receding-horizon loop: plan -> move(t_plan) -> checks, with the braking
    fallback on infeasible plans and a stop counter
    (simulator_armtd.m:188-198).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .collision import ObstacleSet
from .config import ArmourConfig
from .controller import (althoff_control, nominal_passivity_control,
                         robust_control)
from .rnea_numeric import coriolis_gravity, forward_kinematics, mass_matrix
from .robot import RobotModel
from .trajectory import PlanRef, advance_plan, desired_state, initial_plan
from .worlds import World, goal_check, straight_line_waypoint, world_goal_check


@dataclasses.dataclass
class TrueParams:
    """The plant's actual inertial parameters (within the modeled interval)."""

    mass: jnp.ndarray     # [J]
    inertia: jnp.ndarray  # [J, 3, 3]
    com: jnp.ndarray      # [J, 3]


jax.tree_util.register_dataclass(
    TrueParams, data_fields=["mass", "inertia", "com"], meta_fields=[])


def sample_true_params(robot: RobotModel, rng: np.random.Generator,
                       scale: Optional[float] = None) -> TrueParams:
    """Random (or worst-case if scale given) true params within +-uncertainty
    (load_robot_params.m uncertain_mass_range semantics; COM scaled by one
    factor per link like get_inertial_params.m:212)."""
    if scale is None:
        sm = rng.uniform(-1, 1, robot.num_joints)
        si = rng.uniform(-1, 1, robot.num_joints)
        sc = rng.uniform(-1, 1, robot.num_joints)
    else:
        sm = np.full(robot.num_joints, scale)
        si = np.full(robot.num_joints, scale)
        sc = np.full(robot.num_joints, scale)
    mass = robot.mass * (1.0 + robot.mass_uncertainty * sm)
    inertia = robot.inertia * (1.0 + robot.inertia_uncertainty * si)[:, None, None]
    com = robot.com * (1.0 + robot.com_uncertainty * sc)[:, None]
    return TrueParams(mass=jnp.asarray(mass), inertia=jnp.asarray(inertia),
                      com=jnp.asarray(com))


def make_rollout(robot: RobotModel, cfg: ArmourConfig, control_dt: float = 1e-3,
                 substeps: int = 2, controller: str = "robust",
                 measurement_noise: float = 0.0, noise_seed: int = 0,
                 move_mode: str = "integrate"):
    """Compile the tracking rollout: integrate the true plant under the
    low-level controller for t_move seconds.  Returns states + logs for
    oracles.

    controller: "robust" (CBF, default), "nominal" (passivity ablation,
    uarmtd_nominal_passivity_LLC.m) or "althoff" (PI-adaptive comparison,
    robust_controller.cpp:112-128).
    measurement_noise: stddev of white noise added to the state the
    controller MEASURES (plant integrates the true state;
    uarmtd_agent.m:300-312 uses 1e-4).
    move_mode: "integrate" (full ODE, default) or "direct" — the agent
    teleports along the reference with zero input
    (uarmtd_agent.m:468-477; fast planner-only regression mode)."""

    n_ctrl = int(round(cfg.t_plan / control_dt))

    if move_mode == "direct":

        @jax.jit
        def rollout_direct(q, qd, ref: PlanRef, tp: TrueParams):
            def step(carry, i):
                t = (i + 1) * control_dt
                q_des, qd_des, _ = desired_state(ref, t, cfg)
                log = {"q": q_des, "qd": qd_des, "u": jnp.zeros_like(q_des),
                       "q_des": q_des, "qd_des": qd_des}
                return carry, log

            _, logs = jax.lax.scan(step, None, jnp.arange(n_ctrl))
            qf, qdf, _ = desired_state(ref, cfg.t_plan, cfg)
            return qf, qdf, logs

        return rollout_direct

    assert move_mode == "integrate", move_mode

    def step(carry, i):
        q, qd, ref, tp, e_acc, key = carry
        t = i * control_dt
        q_des, qd_des, qdd_des = desired_state(ref, t, cfg)
        q_m, qd_m = q, qd
        if measurement_noise:
            key, k1, k2 = jax.random.split(key, 3)
            q_m = q + measurement_noise * jax.random.normal(k1, q.shape, q.dtype)
            qd_m = qd + measurement_noise * jax.random.normal(k2, qd.shape, qd.dtype)
        if controller == "robust":
            u, tau, v = robust_control(robot, cfg, q_m, qd_m, q_des, qd_des, qdd_des)
        elif controller == "nominal":
            u = nominal_passivity_control(robot, cfg, q_m, qd_m, q_des, qd_des, qdd_des)
        elif controller == "althoff":
            u, tau, v, e_acc = althoff_control(
                robot, cfg, q_m, qd_m, q_des, qd_des, qdd_des, e_acc, control_dt)
        else:
            raise ValueError(controller)

        # M(q) varies slowly; evaluate once per 1 ms control step (the bias
        # term is re-evaluated at every RK4 stage)
        M = mass_matrix(robot, q, mass=tp.mass, inertia=tp.inertia, com=tp.com)
        M_inv = jnp.linalg.inv(M)

        def ode(state):
            qq, qqd = state
            bias = coriolis_gravity(robot, qq, qqd, mass=tp.mass,
                                    inertia=tp.inertia, com=tp.com)
            qdd = M_inv @ (u - bias)
            return qqd, qdd

        h = control_dt / substeps
        for _ in range(substeps):
            k1 = ode((q, qd))
            k2 = ode((q + 0.5 * h * k1[0], qd + 0.5 * h * k1[1]))
            k3 = ode((q + 0.5 * h * k2[0], qd + 0.5 * h * k2[1]))
            k4 = ode((q + h * k3[0], qd + h * k3[1]))
            q = q + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
            qd = qd + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])

        log = {
            "q": q, "qd": qd, "u": u,
            "q_des": q_des, "qd_des": qd_des,
        }
        return (q, qd, ref, tp, e_acc, key), log

    @jax.jit
    def rollout(q, qd, ref: PlanRef, tp: TrueParams):
        key = jax.random.PRNGKey(noise_seed)
        e_acc = jnp.zeros((), q.dtype)
        (q, qd, _, _, _, _), logs = jax.lax.scan(
            lambda c, i: step(c, i), (q, qd, ref, tp, e_acc, key), jnp.arange(n_ctrl)
        )
        return q, qd, logs

    return rollout


# ---------------------------------------------------------------------------
# safety oracles (simulator_armtd.m:238-267)
# ---------------------------------------------------------------------------


def obb_obb_separated(center_a, axes_a, half_a, center_b, axes_b, half_b):
    """Exact OBB vs OBB separating-axis test, batched.  center_* [..., 3],
    axes_* [..., 3, 3] (COLUMNS = unit box axes), half_* [..., 3].
    True = disjoint.  15 candidate axes: 3 of A, 3 of B, 9 cross products."""
    d = center_b - center_a

    def _proj(axes, half, L):
        # half-extent of the box along direction L: sum_i half_i |axis_i . L|
        return jnp.sum(half * jnp.abs(jnp.einsum("...ai,...a->...i", axes, L)), axis=-1)

    seps = []
    cand = [axes_a[..., :, i] for i in range(3)] + [axes_b[..., :, j] for j in range(3)]
    for i in range(3):
        for j in range(3):
            cand.append(jnp.cross(axes_a[..., :, i], axes_b[..., :, j]))
    for L in cand:
        norm = jnp.linalg.norm(L, axis=-1, keepdims=True)
        Ln = jnp.where(norm > 1e-9, L / jnp.where(norm > 1e-9, norm, 1.0), 0.0)
        valid = norm[..., 0] > 1e-9
        ra = _proj(axes_a, half_a, Ln)
        rb = _proj(axes_b, half_b, Ln)
        seps.append(valid & (jnp.abs(jnp.sum(d * Ln, axis=-1)) > ra + rb))
    return jnp.any(jnp.stack(seps, axis=-1), axis=-1)


def obstacle_axes_halves(generators):
    """Unit axes [O, 3, 3] (columns) + half extents [O, 3] of box-zonotope
    obstacles from their generator matrix (columns = generators).  Handles
    rotated boxes exactly; degenerate (zero) generators get a default axis so
    the SAT stays valid (projection radius 0)."""
    g = jnp.moveaxis(generators, -1, -2)                 # [O, 3(gen), 3(coord)]
    half = jnp.linalg.norm(g, axis=-1)                   # [O, 3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=generators.dtype), g.shape)
    axes = jnp.where(half[..., None] > 1e-12, g / jnp.maximum(half[..., None], 1e-12), eye)
    return jnp.moveaxis(axes, -1, -2), half              # columns = axes


def make_oracles(robot: RobotModel, cfg: ArmourConfig):
    """Compile the per-move safety checks over logged trajectories."""

    link_c = jnp.asarray(robot.link_center)
    link_h = jnp.asarray(robot.link_generators)

    @jax.jit
    def check(logs, obs: ObstacleSet):
        q = logs["q"]                       # [N, F]
        qd = logs["qd"]
        u = logs["u"]
        R_w, p_w, centers = forward_kinematics(robot, q)   # [N, J, 3, 3] etc.
        box_c = centers                                     # world box centers
        # full OBB axes/halves from the obstacle generator matrix: rotated
        # boxes are handled exactly (round-1 oracle used diag(|G|), silently
        # dropping off-diagonal generators)
        obs_axes, obs_half = obstacle_axes_halves(obs.generators)
        sep = obb_obb_separated(
            box_c[:, :, None, :],
            R_w[:, :, None, :, :],
            jnp.broadcast_to(link_h[None, :, None, :], box_c[:, :, None, :].shape),
            obs.centers[None, None, :, :],
            obs_axes[None, None, :, :, :],
            obs_half[None, None, :, :],
        )                                                   # [N, J, O]
        collision = jnp.any(~sep & obs.mask[None, None, :])

        tl = jnp.asarray(robot.torque_limits, q.dtype)
        torque_exceeded = jnp.any(jnp.abs(u) > tl[None, :])

        ub = cfg.ub
        pos_err = jnp.abs(q - logs["q_des"])
        vel_err = jnp.abs(qd - logs["qd_des"])
        bound_exceeded = jnp.any(pos_err > ub.qe) | jnp.any(vel_err > ub.qde)

        pos_lb = jnp.asarray(robot.position_limits_lb, q.dtype)
        pos_ub = jnp.asarray(robot.position_limits_ub, q.dtype)
        sl = jnp.asarray(robot.speed_limits, q.dtype)
        joint_exceeded = (
            jnp.any(q < pos_lb[None, :]) | jnp.any(q > pos_ub[None, :])
            | jnp.any(jnp.abs(qd) > sl[None, :])
        )
        return {
            "collision": collision,
            "torque_exceeded": torque_exceeded,
            "ultimate_bound_exceeded": bound_exceeded,
            "joint_limit_exceeded": joint_exceeded,
        }

    return check


# ---------------------------------------------------------------------------
# receding-horizon driver (simulator_armtd.m run loop)
# ---------------------------------------------------------------------------


VIOL_GROUPS = ("torque", "collision", "state", "grasp")


@dataclasses.dataclass
class TrialSummary:
    goal_reached: bool
    collision: bool
    torque_exceeded: bool
    ultimate_bound_exceeded: bool
    joint_limit_exceeded: bool
    infeasible_plans: int
    iterations: int
    planning_times: list
    stuck: bool
    # --- per-trial attribution (VERDICT r3 #2): which constraint group had
    # the max violation on each infeasible plan, and goal-distance progress
    blocked_counts: dict = dataclasses.field(default_factory=dict)
    goal_distance_final: float = float("nan")
    goal_distance_min: float = float("nan")
    # plans this trial recovered via the strong-profile rescue solver
    rescued_plans: int = 0


def run_trial(
    world: World,
    robot: RobotModel,
    cfg: ArmourConfig,
    planner_step,
    obs: ObstacleSet,
    true_params: TrueParams,
    max_iterations: int = 100,
    stop_threshold: int = 4,
    lookahead: float = 1.0,      # robot_arm_generic_planner.m:21
    verbose: bool = False,
    rollout=None,
    oracles=None,
    hlp=None,
    trace_path: Optional[str] = None,
    trace_stride: int = 10,
    stall_window: int = 25,
    stall_progress: float = 0.05,
    rescue_step=None,
    max_fallback_regrows: int = 50,
) -> TrialSummary:
    """One closed-loop trial on one world (kinova_run_100_worlds.m per-world
    loop).  planner_step = make_planner(robot, cfg) output.  Pass precompiled
    rollout/oracles when running many trials (they are world-independent).
    hlp: optional waypoint generator with .get_waypoint(q) (see hlp.py);
    defaults to the straight-line HLP like uarmtd_planner.m:53.
    trace_path: write a .npz replay trace (kinova_replay_trial.m equivalent;
    scripts/replay_trial.py renders it): actual/reference joint trajectories
    and inputs subsampled by trace_stride control steps, per-plan k and
    waypoints, world geometry, and the safety flags."""
    import time as _time

    rollout = rollout if rollout is not None else make_rollout(robot, cfg)
    oracles = oracles if oracles is not None else make_oracles(robot, cfg)
    # warm-up compile outside the timed loop (see batch_sim) — including the
    # rescue profile, whose first in-loop invocation would otherwise charge
    # its full jit compile to that iteration's planning time
    _q0w = jnp.asarray(world.start, cfg.dtype)
    _zw = jnp.zeros_like(_q0w)
    jax.block_until_ready(
        planner_step(_q0w, _zw, _zw, _q0w, obs))
    if rescue_step is not None:
        jax.block_until_ready(
            rescue_step(_q0w, _zw, _zw, _q0w, obs))
    trace = {"q": [], "qd": [], "u": [], "q_des": [], "qd_des": [],
             "k": [], "waypoint": [], "feasible": []} if trace_path else None

    dt_ref = cfg.dtype
    q = jnp.asarray(world.start, dt_ref)
    qd = jnp.zeros_like(q)
    ref = initial_plan(world.start, dt_ref)
    flags = {
        "collision": False, "torque_exceeded": False,
        "ultimate_bound_exceeded": False, "joint_limit_exceeded": False,
    }
    infeasible = 0
    stop_count = 0
    rescued = 0
    plan_times = []
    goal = False
    it = 0
    blocked_counts: dict = {}
    gd_min = float("inf")
    gd = float("nan")

    def _goal_distance(qq):
        d = np.mod(np.asarray(qq) - world.goal + np.pi, 2 * np.pi) - np.pi
        return float(np.linalg.norm(d))

    # stall -> config-RRT* fallback (same policy as batch_sim: reroute when
    # goal progress stagnates for stall_window iterations or the second
    # consecutive plan fails)
    fallback_hlp = None
    fallback_count = 0
    stall_ref = float("inf")
    stall_iters = 0
    retreat = np.asarray(world.start, float)   # last feasible plan start

    for it in range(max_iterations):
        # plan from the REFERENCE state at the end of the last move
        # (uarmtd_planner.m:81 reads agent reference, not measured state)
        q0, qd0, qdd0 = desired_state(ref, cfg.t_plan, cfg)
        if stop_count > 0:
            # braking after an infeasible plan: retreat toward the last
            # certifiable plan-start state (see batch_sim)
            waypoint = retreat
        elif fallback_hlp is not None:
            waypoint = fallback_hlp.get_waypoint(np.asarray(q0))
        elif hlp is not None:
            waypoint = hlp.get_waypoint(np.asarray(q0))
        else:
            waypoint = straight_line_waypoint(np.asarray(q0), world.goal, lookahead,
                                              continuous=robot.continuous_joints)
        t0 = _time.perf_counter()
        res = planner_step(q0, qd0, qdd0, jnp.asarray(waypoint, dt_ref), obs)
        k = np.asarray(res.k)
        if rescue_step is not None and not np.all(np.isfinite(k)):
            # strong-profile retry before accepting the braking fallback
            # (see batch_sim.run_trials_batched rescue_solver)
            res = rescue_step(q0, qd0, qdd0, jnp.asarray(waypoint, dt_ref), obs)
            k = np.asarray(res.k)
            if np.all(np.isfinite(k)):
                rescued += 1
        plan_times.append(_time.perf_counter() - t0)

        if np.all(np.isfinite(k)):
            stop_count = 0
            retreat = np.asarray(q0, float)
        else:
            infeasible += 1
            stop_count += 1
            grp = VIOL_GROUPS[int(np.argmax(np.asarray(res.viol)))]
            blocked_counts[grp] = blocked_counts.get(grp, 0) + 1
        ref = advance_plan(ref, jnp.asarray(k, dt_ref), q0, qd0, qdd0, cfg)

        q, qd, logs = rollout(q, qd, ref, true_params)
        gd = _goal_distance(q)
        gd_min = min(gd_min, gd)
        if gd_min < stall_ref - stall_progress:
            stall_ref = gd_min
            stall_iters = 0
        else:
            stall_iters += 1
        # regrow cap (parity with batch_sim.max_fallback_regrows): default
        # high — quality outranks the host seconds (a low cap of 6 cost a
        # hard scenario its late-regrow recovery); lower it for
        # throughput-bound runs
        if fallback_count < max_fallback_regrows and (
                stall_iters >= stall_window
                or (stop_count == 2 and fallback_count == 0)):
            from .hlp import ConfigRRTStarHLP

            fallback_count += 1
            fallback_hlp = ConfigRRTStarHLP(
                world, robot, buffer=0.08 + 0.04 * (fallback_count - 1),
                seed=7919 * fallback_count)
            stall_iters = 0
            if verbose:
                print(f"iter {it}: stalled at gd={gd:.2f} -> "
                      f"config-RRT* fallback #{fallback_count}")
        checks = jax.tree.map(bool, oracles(logs, obs))
        if trace is not None:
            for name in ("q", "qd", "u", "q_des", "qd_des"):
                trace[name].append(np.asarray(logs[name])[::trace_stride])
            trace["k"].append(k)
            trace["waypoint"].append(np.asarray(waypoint))
            trace["feasible"].append(bool(np.all(np.isfinite(k))))
        for name in flags:
            flags[name] = flags[name] or checks[name]
        if verbose:
            print(f"iter {it}: feasible={np.all(np.isfinite(k))} q={np.asarray(q).round(2)} checks={checks}")
        if any(flags.values()):
            break
        if world_goal_check(world, np.asarray(q), robot):
            goal = True
            break
        if stop_count >= stop_threshold:
            break

    summary = TrialSummary(
        goal_reached=goal,
        infeasible_plans=infeasible,
        iterations=it + 1,
        planning_times=plan_times,
        stuck=(stop_count >= stop_threshold),
        blocked_counts=blocked_counts,
        goal_distance_final=gd,
        goal_distance_min=(gd_min if np.isfinite(gd_min) else float("nan")),
        rescued_plans=rescued,
        **flags,
    )
    if trace is not None:
        np.savez_compressed(
            trace_path,
            **{name: np.stack(trace[name]) for name in
               ("q", "qd", "u", "q_des", "qd_des", "k", "waypoint")},
            feasible=np.asarray(trace["feasible"]),
            start=np.asarray(world.start), goal=np.asarray(world.goal),
            obstacle_centers=np.asarray(world.obstacle_centers),
            obstacle_generators=np.asarray(world.obstacle_generators),
            trace_dt=float(1e-3 * trace_stride),
            robot_name=robot.name,
            flags=np.asarray([summary.collision, summary.torque_exceeded,
                              summary.ultimate_bound_exceeded,
                              summary.joint_limit_exceeded,
                              summary.goal_reached, summary.stuck]),
        )
    return summary
