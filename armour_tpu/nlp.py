"""Batched trajectory-optimization NLP (replaces Ipopt + MA97).

The problem (NLPclass.cu:46-54): n = F variables k in [-1,1]^F;
  cost = COST_SCALE * sum_j wrap(q_plan_j(k) - q_des_j)^2   (wrap on
    continuous joints; NLPclass.cu:207-267)
  subject to
    torque:    |u_nom_j(k, t)| <= torque_limit_j - torque_radius(j, t)
    collision: g_col(k) <= 0 for every (time, link, obstacle)
    state:     position/velocity extrema over the whole trajectory within
               limits shrunk by the ultimate bounds (NLPclass.cu:136-162)

With only F=7 variables and a dense cheap-to-evaluate constraint set, a
fixed-iteration augmented-Lagrangian method with a projected Gauss-Newton
inner loop maps well onto one jitted program: every constraint row is a polynomial
evaluation, the KKT system is FxF, and the whole solve is one jitted
lax.fori_loop — batched over worlds with vmap/shard_map.

Feasibility is re-checked explicitly against the reference's violation
thresholds at the end (finalize_solution semantics, NLPclass.cu:422-538);
infeasible -> NaN k (caller falls back to braking, uarmtd_planner.m:910-921).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from . import bezier
from .collision import (BIG, Hyperplanes, ObstacleSet, ScreenedCollision,
                        collision_constraints, eval_link_poly_grads,
                        eval_link_polys, screened_constraint_grads,
                        screened_constraints)
from .config import ArmourConfig
from .dynamics import TorqueFRS
from .jrs import TrajectoryCoeffs
from .kinematics import LinkFRS
from .pz.basis import KBasis
from .robot import RobotModel


def wrap_to_pi(x):
    return jnp.mod(x + jnp.pi, 2.0 * jnp.pi) - jnp.pi


# ---------------------------------------------------------------------------
# cost (NLPclass.cu:207-267)
# ---------------------------------------------------------------------------


def plan_cost(k, traj: TrajectoryCoeffs, q_des, robot: RobotModel, cfg: ArmourConfig):
    k_act = k * traj.k_scale
    if traj.family == "armtd":
        tp = cfg.t_plan
        q_plan = traj.q0 + traj.qd0 * tp + 0.5 * k_act * tp * tp
    else:
        s_plan = cfg.t_plan / cfg.duration
        q_plan = bezier.q_des(traj.q0, traj.Tqd0, traj.TTqdd0, k_act, s_plan)
    diff = q_plan - q_des
    cont = jnp.asarray(robot.continuous_joints)
    diff = jnp.where(cont, wrap_to_pi(diff), diff)
    return cfg.cost_scale * jnp.sum(diff * diff)


# ---------------------------------------------------------------------------
# state-limit extrema over the whole trajectory (Trajectory.cu:256-540)
# ---------------------------------------------------------------------------


def _collect_extrema(vals, valid, roots, v0, v1):
    """min/max over {t=0, t=1} plus interior roots restricted to [0, 1]."""
    lo = jnp.minimum(v0, v1)
    hi = jnp.maximum(v0, v1)
    for v, ok, r in zip(vals, valid, roots):
        inside = ok & (0.0 <= r) & (r <= 1.0) & jnp.isfinite(r) & jnp.isfinite(v)
        lo = jnp.where(inside, jnp.minimum(lo, v), lo)
        hi = jnp.where(inside, jnp.maximum(hi, v), hi)
    return lo, hi


def joint_position_extrema(k, traj: TrajectoryCoeffs, cfg: ArmourConfig):
    """(q_min, q_max) [F] over the trajectory and their dk gradients [F]
    (diagonal; envelope theorem at interior roots makes the gradient
    ds^3(6s^2-15s+10) * k_range at the critical time)."""
    if traj.family == "armtd":
        from .armtd import armtd_position_extrema

        return armtd_position_extrema(k, traj, cfg)
    k_range = traj.k_scale
    k_act = k * k_range
    q0, Tqd0, TTqdd0 = traj.q0, traj.Tqd0, traj.TTqdd0

    e2, e3, valid = bezier.q_extrema_in_k(Tqd0, TTqdd0, k_act)
    v0 = bezier.q_des(q0, Tqd0, TTqdd0, k_act, jnp.zeros_like(k))
    v1 = bezier.q_des(q0, Tqd0, TTqdd0, k_act, jnp.ones_like(k))
    v2 = bezier.q_des(q0, Tqd0, TTqdd0, k_act, e2)
    v3 = bezier.q_des(q0, Tqd0, TTqdd0, k_act, e3)

    def dq_dk(s):
        return s**3 * (6.0 * s**2 - 15.0 * s + 10.0)

    cands = jnp.stack([v0, v1, v2, v3])      # [4, F]
    grads = jnp.stack([jnp.zeros_like(k), jnp.ones_like(k), dq_dk(e2), dq_dk(e3)])
    inside = jnp.stack(
        [
            jnp.ones_like(k, dtype=bool),
            jnp.ones_like(k, dtype=bool),
            valid & (0.0 <= e2) & (e2 <= 1.0) & jnp.isfinite(e2) & jnp.isfinite(v2),
            valid & (0.0 <= e3) & (e3 <= 1.0) & jnp.isfinite(e3) & jnp.isfinite(v3),
        ]
    )
    cands_lo = jnp.where(inside, cands, BIG)
    cands_hi = jnp.where(inside, cands, -BIG)
    i_lo = jnp.argmin(cands_lo, axis=0)
    i_hi = jnp.argmax(cands_hi, axis=0)
    q_min = jnp.take_along_axis(cands_lo, i_lo[None], axis=0)[0]
    q_max = jnp.take_along_axis(cands_hi, i_hi[None], axis=0)[0]
    g_min = jnp.take_along_axis(grads, i_lo[None], axis=0)[0] * k_range
    g_max = jnp.take_along_axis(grads, i_hi[None], axis=0)[0] * k_range
    return q_min, q_max, g_min, g_max


def joint_velocity_extrema(k, traj: TrajectoryCoeffs, cfg: ArmourConfig):
    """(qd_min, qd_max) [F] and dk gradients (Trajectory.cu:399-540)."""
    if traj.family == "armtd":
        from .armtd import armtd_velocity_extrema

        return armtd_velocity_extrema(k, traj, cfg)
    k_range = traj.k_scale
    k_act = k * k_range
    q0, Tqd0, TTqdd0 = traj.q0, traj.Tqd0, traj.TTqdd0
    dur = cfg.duration

    e2, e3, valid = bezier.qd_extrema_in_k(Tqd0, TTqdd0, k_act)
    v0 = bezier.qd_des(q0, Tqd0, TTqdd0, k_act, jnp.zeros_like(k))
    v1 = bezier.qd_des(q0, Tqd0, TTqdd0, k_act, jnp.ones_like(k))
    v2 = bezier.qd_des(q0, Tqd0, TTqdd0, k_act, e2)
    v3 = bezier.qd_des(q0, Tqd0, TTqdd0, k_act, e3)

    def dqd_dk(s):
        return 30.0 * s**2 * (s - 1.0) ** 2

    cands = jnp.stack([v0, v1, v2, v3])
    grads = jnp.stack([jnp.zeros_like(k), jnp.zeros_like(k), dqd_dk(e2), dqd_dk(e3)])
    inside = jnp.stack(
        [
            jnp.ones_like(k, dtype=bool),
            jnp.ones_like(k, dtype=bool),
            valid & (0.0 <= e2) & (e2 <= 1.0) & jnp.isfinite(e2) & jnp.isfinite(v2),
            valid & (0.0 <= e3) & (e3 <= 1.0) & jnp.isfinite(e3) & jnp.isfinite(v3),
        ]
    )
    cands_lo = jnp.where(inside, cands, BIG)
    cands_hi = jnp.where(inside, cands, -BIG)
    i_lo = jnp.argmin(cands_lo, axis=0)
    i_hi = jnp.argmax(cands_hi, axis=0)
    qd_min = jnp.take_along_axis(cands_lo, i_lo[None], axis=0)[0] / dur
    qd_max = jnp.take_along_axis(cands_hi, i_hi[None], axis=0)[0] / dur
    g_min = jnp.take_along_axis(grads, i_lo[None], axis=0)[0] * k_range / dur
    g_max = jnp.take_along_axis(grads, i_hi[None], axis=0)[0] * k_range / dur
    return qd_min, qd_max, g_min, g_max


# ---------------------------------------------------------------------------
# constraint assembly: one-sided c(k) <= 0 stack
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PlanProblem:
    """Everything the solver needs, precomputed once per plan.

    grasp: optional k-sliceable contact-constraint rows (grasp.GraspFRS);
    None (the default) omits them from the stack entirely."""

    traj: TrajectoryCoeffs
    q_des: jnp.ndarray
    torque: TorqueFRS
    frs: LinkFRS
    hyp: Hyperplanes
    obs: ObstacleSet
    screened: ScreenedCollision
    grasp: object = None


def constraint_stack(k, prob: PlanProblem, robot: RobotModel, cfg: ArmourConfig,
                     basis: KBasis, with_grad: bool = True):
    """All inequality constraints c(k) <= 0 and (optionally) their Jacobian.

    Ordering: [torque_hi; torque_lo; collision; pos_min_lo; pos_min_hi;
    pos_max_lo; pos_max_hi; vel_min_lo; vel_min_hi; vel_max_lo; vel_max_hi].
    """
    dt = k.dtype
    phi = basis.phi(k)
    dphi = basis.dphi(k) if with_grad else None
    ub = cfg.ub
    tl = jnp.asarray(robot.torque_limits, dt)
    cs, Js = [], []

    F = k.shape[0]
    if not cfg.turn_off_input_constraints:
        T = prob.torque.u_coef.shape[0]
        uc = prob.torque.u_coef.reshape(-1, phi.shape[0])                # [T*F, B]
        u = (uc @ phi).reshape(T, -1)                                    # [T, F]
        hi = tl[None, :] - prob.torque.torque_radius
        cs += [(u - hi).reshape(-1), (-u - hi).reshape(-1)]
        if with_grad:
            du = uc @ dphi                                               # [T*F, F]
            Js += [du, -du]

    if prob.grasp is not None:
        T = prob.grasp.g_coef.shape[0]
        gc = prob.grasp.g_coef.reshape(-1, phi.shape[0])             # [T*3, B]
        g_grasp = gc @ phi + prob.grasp.g_rad.reshape(-1)
        cs.append(g_grasp)
        if with_grad:
            Js.append(gc @ dphi)

    p_all = eval_link_polys(prob.frs, phi)
    tau = cfg.smooth_tau if cfg.smooth_obstacle_constraints else 0.0
    g_col, grad_p = screened_constraints(prob.screened, p_all, smooth_tau=tau)
    # search margin: plan with extra clearance; certification (max_violations)
    # stays exact.  Padded rows sit at -BIG, far below any margin.
    cs.append(g_col + cfg.collision_search_margin)
    if with_grad:
        dp_all = eval_link_poly_grads(prob.frs, dphi)
        Js.append(screened_constraint_grads(prob.screened, grad_p, dp_all))

    q_min, q_max, gq_min, gq_max = joint_position_extrema(k, prob.traj, cfg)
    qd_min, qd_max, gd_min, gd_max = joint_velocity_extrema(k, prob.traj, cfg)
    # margin-tightened bounds: give the f32 ALM headroom so a boundary
    # optimum still satisfies the TRUE limits checked in max_violations
    m = cfg.state_limit_margin
    pos_lb = jnp.asarray(robot.position_limits_lb, dt) + ub.qe + m
    pos_ub = jnp.asarray(robot.position_limits_ub, dt) - ub.qe - m
    vel_ub = jnp.asarray(robot.speed_limits, dt) - ub.qde - m

    eye = jnp.eye(F, dtype=dt)
    for val, grad in ((q_min, gq_min), (q_max, gq_max)):
        cs += [pos_lb - val, val - pos_ub]
        if with_grad:
            Js += [-grad[:, None] * eye, grad[:, None] * eye]
    for val, grad in ((qd_min, gd_min), (qd_max, gd_max)):
        cs += [-vel_ub - val, val - vel_ub]
        if with_grad:
            Js += [-grad[:, None] * eye, grad[:, None] * eye]

    c = jnp.concatenate(cs)
    if with_grad:
        return c, jnp.concatenate(Js, axis=0)
    return c, None


def max_violations(k, prob: PlanProblem, robot: RobotModel, cfg: ArmourConfig,
                   basis: KBasis):
    """Per-group max violation for the finalize_solution feasibility check
    (NLPclass.cu:446-538)."""
    dt = k.dtype
    phi = basis.phi(k)
    ub = cfg.ub
    tl = jnp.asarray(robot.torque_limits, dt)

    if cfg.turn_off_input_constraints:
        # TURN_OFF_INPUT_CONSTRAINTS removes torque rows from the NLP *and*
        # from the finalize_solution re-check (Parameters.h / NLPclass.cu)
        v_torque = jnp.asarray(-BIG, dt)
    else:
        T = prob.torque.u_coef.shape[0]
        u = (prob.torque.u_coef.reshape(-1, phi.shape[0]) @ phi).reshape(T, -1)
        hi = tl[None, :] - prob.torque.torque_radius
        v_torque = jnp.max(jnp.abs(u) - hi)

    if prob.grasp is None:
        v_grasp = jnp.asarray(-BIG, dt)
    else:
        g_grasp = (prob.grasp.g_coef.reshape(-1, phi.shape[0]) @ phi
                   + prob.grasp.g_rad.reshape(-1))
        v_grasp = jnp.max(g_grasp)

    p_all = eval_link_polys(prob.frs, phi)
    g_col = collision_constraints(prob.hyp, prob.obs, p_all)
    v_col = jnp.max(g_col)

    q_min, q_max, _, _ = joint_position_extrema(k, prob.traj, cfg)
    qd_min, qd_max, _, _ = joint_velocity_extrema(k, prob.traj, cfg)
    pos_lb = jnp.asarray(robot.position_limits_lb, dt) + ub.qe
    pos_ub = jnp.asarray(robot.position_limits_ub, dt) - ub.qe
    vel_ub = jnp.asarray(robot.speed_limits, dt) - ub.qde
    v_state = jnp.max(
        jnp.stack(
            [
                jnp.max(pos_lb - q_min), jnp.max(q_min - pos_ub),
                jnp.max(pos_lb - q_max), jnp.max(q_max - pos_ub),
                jnp.max(-vel_ub - qd_min), jnp.max(qd_min - vel_ub),
                jnp.max(-vel_ub - qd_max), jnp.max(qd_max - vel_ub),
            ]
        )
    )
    return v_torque, v_col, v_state, v_grasp


def is_feasible(k, prob: PlanProblem, robot: RobotModel, cfg: ArmourConfig,
                basis: KBasis):
    v_torque, v_col, v_state, v_grasp = max_violations(k, prob, robot, cfg, basis)
    return (
        (v_torque <= cfg.torque_violation_threshold)
        & (v_col <= cfg.collision_violation_threshold)
        & (v_state <= 1e-6)
        & (v_grasp <= cfg.grasp_violation_threshold)
    )


# ---------------------------------------------------------------------------
# augmented-Lagrangian solver with projected Gauss-Newton inner steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SolveResult:
    """viol: per-group max violations [torque, collision, state, grasp] at
    the returned candidate (the feasible k, or the best attempt when
    infeasible) — the per-trial attribution the suite records so a stuck
    outcome names the constraint group that blocked it (VERDICT r3 #2)."""

    k: jnp.ndarray
    feasible: jnp.ndarray
    cost: jnp.ndarray
    viol: jnp.ndarray


jax.tree_util.register_dataclass(
    SolveResult, data_fields=["k", "feasible", "cost", "viol"], meta_fields=[]
)


def _stack_thresholds(prob: PlanProblem, robot: RobotModel, cfg: ArmourConfig,
                      dt) -> jnp.ndarray:
    """Per-row violation thresholds matching constraint_stack's ordering,
    used by the best-feasible-iterate proxy check."""
    F = prob.q_des.shape[-1]
    parts = []
    if not cfg.turn_off_input_constraints:
        T = prob.torque.u_coef.shape[0]
        parts.append(jnp.full((2 * T * F,), cfg.torque_violation_threshold, dt))
    if prob.grasp is not None:
        Tg = prob.grasp.g_coef.shape[0]
        parts.append(jnp.full((3 * Tg,), cfg.grasp_violation_threshold, dt))
    K = prob.screened.row.shape[0]
    parts.append(jnp.full((K,), cfg.collision_violation_threshold, dt))
    # state rows in the stack are margin-TIGHTENED, so accepting a violation
    # up to margin/2 against them still leaves margin/2 slack vs the TRUE
    # limits that is_feasible re-checks
    parts.append(jnp.full((8 * F,), 0.5 * cfg.state_limit_margin, dt))
    return jnp.concatenate(parts)


def solve(prob: PlanProblem, robot: RobotModel, cfg: ArmourConfig, basis: KBasis,
          k0=None) -> SolveResult:
    """Jittable multi-start ALM solve.  Returns k (NaN if infeasible,
    mirroring the reference's braking-fallback contract,
    armour_main.cu:324-332).

    The constraint landscape is nonconvex (obstacle walls cut the k-box), so
    a single ALM descent can park in a poor basin while half the box is
    feasible (observed on the 100-world suite).  cfg.solver_seeds starts are
    run as ONE vmapped program — k=0 (the continue/rest plan), the
    waypoint-directed k (clipped wrap(q_des - q0)/k_range), and +-0.5 of it
    — and the best feasible result wins."""
    dt = prob.q_des.dtype
    F = prob.q_des.shape[-1]

    if k0 is None:
        # waypoint-directed seed: the k whose trajectory ENDS at q_des
        # (bezier end state q0 + k_act; armtd: reachable displacement ~
        # qd0*tp + 0.5 k tp^2 — same direction heuristic works)
        diff = prob.q_des - prob.traj.q0
        cont = jnp.asarray(robot.continuous_joints)
        diff = jnp.where(cont, wrap_to_pi(diff), diff)
        k_wp = jnp.clip(diff / prob.traj.k_scale, -1.0, 1.0).astype(dt)
        seeds = [jnp.zeros((F,), dt), k_wp, 0.5 * k_wp, -0.5 * k_wp]
        n_seeds = max(1, cfg.solver_seeds)
        if n_seeds > len(seeds):
            # extend with scaled waypoint directions so solver_seeds > 4
            # actually adds starts instead of silently capping at 4
            extra = [(0.25 + 0.75 * j / max(1, n_seeds - len(seeds))) *
                     (-1.0 if j % 2 else 1.0) * k_wp
                     for j in range(n_seeds - len(seeds))]
            seeds = seeds + extra
        seeds = jnp.stack(seeds[:n_seeds])
    else:
        seeds = jnp.asarray(k0, dt)[None]

    n_seeds = seeds.shape[0]
    cull_after = int(getattr(cfg, "solver_cull_after", 0))
    keep = int(getattr(cfg, "solver_keep_seeds", 2))
    init, run_outer, finalize, cull_score = _alm_phases(prob, robot, cfg, basis)

    if 0 < cull_after < cfg.solver_outer_iters and 0 < keep < n_seeds:
        # Phase A on all seeds, cull to the `keep` most promising (feasible
        # best-cost first, else lowest merit), phase B on the survivors —
        # most of the outer budget is spent on a fraction of the starts
        # (VERDICT r3 #3: the 4-seed multi-start dominated solve time).
        carry = jax.vmap(init)(seeds)
        carry = jax.vmap(lambda c: run_outer(c, cull_after))(carry)
        score = jax.vmap(cull_score)(carry)
        idx = jnp.argsort(score)[:keep]
        carry = jax.tree.map(lambda x: x[idx], carry)
        carry = jax.vmap(
            lambda c: run_outer(c, cfg.solver_outer_iters - cull_after))(carry)
        results = jax.vmap(finalize)(carry)
    else:
        carry = jax.vmap(init)(seeds)
        carry = jax.vmap(lambda c: run_outer(c, cfg.solver_outer_iters))(carry)
        results = jax.vmap(finalize)(carry)

    # best feasible across starts; else the lowest-cost (infeasible) one
    cost_rank = jnp.where(results.feasible, results.cost, jnp.inf)
    any_feas = jnp.any(results.feasible)
    i = jnp.where(any_feas, jnp.argmin(cost_rank), jnp.argmin(results.cost))
    return SolveResult(k=results.k[i], feasible=results.feasible[i],
                       cost=results.cost[i], viol=results.viol[i])


def _alm_phases(prob: PlanProblem, robot: RobotModel, cfg: ArmourConfig,
                basis: KBasis):
    """The ALM descent split into (init, run_outer, finalize, cull_score)
    closures over a carry (k, lam, rho, best_k, best_cost), so the
    multi-start driver can run a short phase on every seed, cull, and spend
    the remaining outer budget on the survivors.

    Semantics per phase match the round-3 single-shot solver: best-feasible
    tracking at every line-search candidate and a final feasibility pull-in
    (Ipopt's "best feasible point under budget", NLPclass.cu:422-538)."""
    dt = prob.q_des.dtype
    F = prob.q_des.shape[-1]

    cost_fn = lambda kk: plan_cost(kk, prob.traj, prob.q_des, robot, cfg)
    cost_grad = jax.grad(cost_fn)
    thr = _stack_thresholds(prob, robot, cfg, dt)
    rho0 = jnp.asarray(10.0, dt)
    # the cost is quadratic in k up to the (piecewise-constant) wrap shift,
    # so its Hessian is constant — hoist it out of the inner loop
    Hc = jax.hessian(cost_fn)(jnp.zeros((F,), dt))

    def clip_big(c):
        # padded/degenerate constraint rows sit at -BIG; keep them inert
        return jnp.maximum(c, -1e6)

    def penalty(cc, lam, rho):
        return jnp.sum(jnp.where(lam + rho * cc > 0, (lam + rho * cc) ** 2, 0.0)) / (2 * rho)

    def track_best(kk, cc, best_k, best_cost):
        """Fold a candidate into the best-feasible tracker (cc = its already-
        computed clipped stack)."""
        feas = jnp.all(cc <= thr)
        cost_kk = cost_fn(kk)
        better = feas & (cost_kk < best_cost)
        return jnp.where(better, kk, best_k), jnp.where(better, cost_kk, best_cost)

    def init(k0):
        k = jnp.asarray(k0, dt)
        c0, _ = constraint_stack(k, prob, robot, cfg, basis, with_grad=False)
        lam = jnp.zeros((c0.shape[0],), dt)
        # seed the best-feasible tracker with the INITIAL iterate: a feasible
        # warm start (k=0 is the rest/continue plan) must never be lost to an
        # inner loop that wanders infeasible (Ipopt likewise falls back to
        # its best feasible iterate, NLPclass.cu:446-538)
        feas0 = jnp.all(clip_big(c0) <= thr)
        best_cost = jnp.where(feas0, cost_fn(k), jnp.asarray(jnp.inf, dt))
        return (k, lam, rho0, k, best_cost)

    def inner_step(carry, lam, rho):
        # ONE constraint-stack pass yields c, Jc AND the current merit m0
        # (the reference re-slices everything per Ipopt iteration too,
        # NLPclass.cu:304-315; round-1 did 5 stack passes per inner step)
        k, best_k, best_cost = carry
        c, Jc = constraint_stack(k, prob, robot, cfg, basis, with_grad=True)
        c = clip_big(c)
        act = (lam + rho * c) > 0.0                       # active set
        w = jnp.where(act, rho, 0.0)
        lam_eff = jnp.where(act, lam + rho * c, 0.0)
        g = cost_grad(k) + Jc.T @ lam_eff                 # [F]
        H = (Jc.T * w) @ Jc + Hc + 1e-3 * jnp.eye(F, dtype=dt)
        # H is SPD (Gauss-Newton + PSD cost Hessian + regularizer)
        chol = jax.scipy.linalg.cho_factor(H)
        step = jax.scipy.linalg.cho_solve(chol, g)

        m0 = cost_fn(k) + penalty(c, lam, rho)
        best_k, best_cost = track_best(k, c, best_k, best_cost)

        def try_alpha(alpha):
            kk = jnp.clip(k - alpha * step, -1.0, 1.0)
            cc = clip_big(constraint_stack(kk, prob, robot, cfg, basis, with_grad=False)[0])
            return kk, cost_fn(kk) + penalty(cc, lam, rho), cc

        # geometric backtracking ladder: from a feasible iterate with a
        # blocked full step (obstacle wall across the descent direction) a
        # SMALL enough alpha always reduces the merit (cost falls linearly,
        # penalty stays 0 while feasible); with only {1.0, 0.2} both trials
        # could land past the wall and the solver froze at its seed
        # (observed: k=0 returned while 50% of the k-box was feasible)
        alphas = jnp.asarray(cfg.solver_alphas, dt)
        kks, merits, ccs = jax.vmap(try_alpha)(alphas)
        # every line-search candidate is also a best-feasible candidate —
        # transiently-feasible iterates must not be lost (a boundary optimum
        # is typically approached from the infeasible side, so the final
        # iterate alone often fails the threshold check by epsilon)
        for a in range(alphas.shape[0]):
            best_k, best_cost = track_best(kks[a], ccs[a], best_k, best_cost)
        best = jnp.argmin(merits)
        k_new = jnp.where(merits[best] < m0, kks[best], k)
        return (k_new, best_k, best_cost)

    def outer(i, carry):
        k, lam, rho, best_k, best_cost = carry
        k, best_k, best_cost = jax.lax.fori_loop(
            0, cfg.solver_inner_iters,
            lambda j, kk: inner_step(kk, lam, rho), (k, best_k, best_cost)
        )
        c, _ = constraint_stack(k, prob, robot, cfg, basis, with_grad=False)
        c = clip_big(c)
        # proxy feasibility on the (already computed) stack; the screened
        # collision subset can miss an active row, so the winner is re-checked
        # against the FULL constraint set below — soundness is unaffected
        best_k, best_cost = track_best(k, c, best_k, best_cost)
        lam = jnp.maximum(lam + rho * c, 0.0)
        rho = jnp.minimum(rho * 2.0, 1e6)
        return (k, lam, rho, best_k, best_cost)

    def run_outer(carry, n: int):
        return jax.lax.fori_loop(0, n, outer, carry)

    def cull_score(carry):
        """Rank a seed after phase A: feasible seeds by their best cost,
        infeasible ones pushed behind by their current total violation."""
        k, lam, rho, best_k, best_cost = carry
        c, _ = constraint_stack(k, prob, robot, cfg, basis, with_grad=False)
        v = jnp.sum(jnp.maximum(clip_big(c) - thr, 0.0))
        has_best = jnp.isfinite(best_cost)
        return jnp.where(has_best, best_cost, 1e6 + v + cost_fn(k))

    def finalize(carry):
        k, lam, rho, best_k, best_cost = carry
        return _finalize(prob, robot, cfg, basis, k, best_k, best_cost,
                         cost_fn, thr, clip_big, track_best)

    return init, run_outer, finalize, cull_score


def _finalize(prob, robot, cfg, basis, k, best_k, best_cost, cost_fn, thr,
              clip_big, track_best) -> SolveResult:
    # feasibility pull-in: when the ALM terminates epsilon-OUTSIDE the
    # feasible set (boundary optimum approached from the infeasible side),
    # bisect along [best_k, k] for the deepest feasible point instead of
    # falling back to the (often much costlier) best_k — without this, a
    # blocked-but-feasible problem degenerates to returning the k=0 seed
    # forever and the closed loop freezes in place.
    def pull_in(lo_k, hi_k):
        def body(j, seg):
            lo, hi = seg
            mid = 0.5 * (lo + hi)
            cc = clip_big(constraint_stack(mid, prob, robot, cfg, basis,
                                           with_grad=False)[0])
            ok = jnp.all(cc <= thr)
            return (jnp.where(ok, mid, lo), jnp.where(ok, hi, mid))

        lo, _ = jax.lax.fori_loop(0, 6, body, (lo_k, hi_k))
        return lo

    c_end, _ = constraint_stack(k, prob, robot, cfg, basis, with_grad=False)
    end_feas = jnp.all(clip_big(c_end) <= thr)
    have_seed = jnp.isfinite(best_cost)
    pulled = pull_in(jnp.where(have_seed, best_k, k), k)
    k_pull = jnp.where(~end_feas & have_seed, pulled, k)
    cc_pull = clip_big(constraint_stack(k_pull, prob, robot, cfg, basis,
                                        with_grad=False)[0])
    best_k, best_cost = track_best(k_pull, cc_pull, best_k, best_cost)

    def viol_vec(kk):
        v_t, v_c, v_s, v_g = max_violations(kk, prob, robot, cfg, basis)
        return jnp.stack([v_t, v_c, v_s, v_g])

    def viol_feasible(v):
        return (
            (v[0] <= cfg.torque_violation_threshold)
            & (v[1] <= cfg.collision_violation_threshold)
            & (v[2] <= 1e-6)
            & (v[3] <= cfg.grasp_violation_threshold)
        )

    v_final = viol_vec(k)
    v_best = viol_vec(best_k)
    feas_final = viol_feasible(v_final)
    feas_best = viol_feasible(v_best) & jnp.isfinite(best_cost)
    cost_final = cost_fn(k)
    use_best = feas_best & ((~feas_final) | (best_cost < cost_final))
    k_sel = jnp.where(use_best, best_k, k)
    feasible = feas_final | feas_best
    cost = jnp.where(use_best, best_cost, cost_final)
    k_out = jnp.where(feasible, k_sel, jnp.nan)
    viol = jnp.where(use_best, v_best, v_final)
    return SolveResult(k=k_out, feasible=feasible, cost=cost, viol=viol)
