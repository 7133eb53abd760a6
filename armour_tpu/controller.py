"""Robust passivity/CBF low-level controller.

JAX twin of uarmtd_robust_CBF_LLC.m:58-189 and the mex
RobustController (kinova_robust_controllers_mex/src/robust_controller.cpp:
129-167):

    r       = (qd_des - qd) + Kr (q_des - q)
    qd_ref  = qd_des + Kr (q_des - q);  qdd_ref = qdd_des + Kr (qd_des - qd)
    tau     = RNEA(q, qd, qd_ref, qdd_ref; nominal params)
    rho     = sup |r|^T |disturbance|           (interval disturbance)
    V       = sup 0.5 r^T M_int(q) r            (interval Lyapunov)
    h       = V_max - V;  lambda = max(0, (-alpha h + rho) / ||r||^2)
    u       = tau + lambda r

Interval quantities: RNEA is LINEAR in each link's (mass, inertia), so the
interval disturbance/Lyapunov bounds are computed exactly from per-link
sensitivity evaluations (14 extra batched RNEA calls) instead of the mex's
directed interval arithmetic — a tighter (hence still sound) bound, and a
shape XLA vectorizes trivially.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .config import ArmourConfig
from .rnea_numeric import rnea
from .robot import RobotModel


def _perturbation_taus(robot: RobotModel, q, qd, qd_aux, qdd):
    """tau contribution of each link's +-uncertainty direction, exploiting
    linearity of RNEA in (mass_i, inertia_i).  Returns [2J, ..., F]."""
    J = robot.num_joints

    # one batched RNEA over all 2J perturbation directions: gravity scales
    # with the perturbed mass, so set_gravity=True on the mass block gives
    # the full (dynamic + gravity) sensitivity of each link's mass; inertia
    # directions carry no mass so gravity contributes nothing there and the
    # same batched call (set_gravity=True) remains exact.
    mass_dirs = jnp.diag(jnp.asarray(robot.mass) * robot.mass_uncertainty)      # [J, J]
    mass_b = jnp.concatenate([mass_dirs, jnp.zeros((J, J))], axis=0)            # [2J, J]
    inertia_dirs = (
        jnp.eye(J)[:, :, None, None] * jnp.asarray(robot.inertia)[None]
        * robot.inertia_uncertainty
    )                                                                            # [J, J, 3, 3]
    inertia_b = jnp.concatenate([jnp.zeros_like(inertia_dirs), inertia_dirs], axis=0)

    bq = jnp.broadcast_to(q, (2 * J,) + q.shape)
    bqd = jnp.broadcast_to(qd, (2 * J,) + qd.shape)
    bqa = jnp.broadcast_to(qd_aux, (2 * J,) + qd_aux.shape)
    bqdd = jnp.broadcast_to(qdd, (2 * J,) + qdd.shape)
    return rnea(robot, bq, bqd, bqa, bqdd, mass=mass_b, inertia=inertia_b,
                set_gravity=True, include_armature=False)


def robust_control(robot: RobotModel, cfg: ArmourConfig, q, qd, q_des, qd_des, qdd_des):
    """Control input u = tau_nominal + robust term (LLC semantics above)."""
    ub = cfg.ub
    err = q_des - q
    derr = qd_des - qd
    qd_ref = qd_des + ub.k_r * err
    qdd_ref = qdd_des + ub.k_r * derr
    r = derr + ub.k_r * err

    tau = rnea(robot, q, qd, qd_ref, qdd_ref)

    # interval disturbance bound via per-link sensitivities
    pert = _perturbation_taus(robot, q, qd, qd_ref, qdd_ref)       # [2J, F]
    dist_sup = jnp.sum(jnp.abs(pert), axis=0)                      # [F]
    rho = jnp.abs(r) @ dist_sup

    # interval Lyapunov: V = 0.5 r^T M(q) r with M from rnea(qdd=r, no grav).
    # M here MUST include the transmission (motor) inertia: the plant is
    # (M_links + diag(armature)) qdd + ... = u, and the reference's passRNEA
    # adds transI*qdd inside the Lyapunov interval RNEA too (rnea.cpp
    # backward pass; robust_controller.cpp:129-167).  Excluding it made
    # V_sup underestimate the true V by 0.5 r^T diag(armature) r — armature
    # dominates lambda_min (8.0 vs 3e-4 on the Kinova) — so the CBF fired
    # too late and ||r|| escaped eps (round-3 ultimate-bound violations).
    z = jnp.zeros_like(q)
    v_nom = 0.5 * r @ rnea(robot, q, z, z, r, set_gravity=False, include_armature=True)
    v_pert = _perturbation_taus(robot, q, z, z, r)                 # [2J, F]
    v_sup = v_nom + 0.5 * jnp.sum(jnp.abs(v_pert @ r), axis=0)
    h = ub.v_max - v_sup

    r_sq = jnp.sum(r * r)
    lam = jnp.maximum(0.0, (-ub.alpha * h + rho) / jnp.maximum(r_sq, 1e-12))
    v = lam * r
    u = tau + jnp.where(r_sq > 0, v, 0.0)
    return u, tau, v


def nominal_passivity_control(robot: RobotModel, cfg: ArmourConfig,
                              q, qd, q_des, qd_des, qdd_des):
    """Ablation controller: nominal passivity RNEA only
    (uarmtd_nominal_passivity_LLC.m:26-65)."""
    ub = cfg.ub
    qd_ref = qd_des + ub.k_r * (q_des - q)
    qdd_ref = qdd_des + ub.k_r * (qd_des - qd)
    return rnea(robot, q, qd, qd_ref, qdd_ref)


@dataclasses.dataclass(frozen=True)
class AlthoffGains:
    """PI-adaptive gains of the Giusti–Althoff comparison controller
    (uarmtd_robust_CBF_LLC.m:11-13 defaults)."""

    kp: tuple = (28.1037, 28.1037)
    ki: tuple = (4.0, 4.0)
    max_error: float = 1e-5


ALTHOFF_DEFAULT = AlthoffGains()


def althoff_control(robot: RobotModel, cfg: ArmourConfig, q, qd,
                    q_des, qd_des, qdd_des, e_acc, dt,
                    gains: AlthoffGains = ALTHOFF_DEFAULT):
    """Giusti–Althoff PI-adaptive robust comparison controller
    (robust_controller.cpp:112-128, method "Ultimate Robust Performance
    Control of Rigid Robot Manipulators using Interval Arithmetic"):

        phi(t)   = Kp[0] + Ki[0] * E(t)
        kappa(t) = Kp[1] + Ki[1] * E(t)
        u        = tau_nominal + (kappa(t) ||bound|| + phi(t)) r

    where bound is the per-joint interval-disturbance sup and E(t)
    accumulates the tracking-error norm while it exceeds max_error.
    Returns (u, tau, v, e_acc_new); thread e_acc through the rollout."""
    ub = cfg.ub
    err = q_des - q
    derr = qd_des - qd
    qd_ref = qd_des + ub.k_r * err
    qdd_ref = qdd_des + ub.k_r * derr
    r = derr + ub.k_r * err

    tau = rnea(robot, q, qd, qd_ref, qdd_ref)
    pert = _perturbation_taus(robot, q, qd, qd_ref, qdd_ref)       # [2J, F]
    bound = jnp.sum(jnp.abs(pert), axis=0)                         # [F]
    bound_norm = jnp.linalg.norm(bound)

    state_err = jnp.sqrt(jnp.sum(err * err) + jnp.sum(derr * derr))
    e_acc_new = e_acc + jnp.where(state_err > gains.max_error,
                                  state_err * dt, 0.0)
    phi_t = gains.kp[0] + gains.ki[0] * e_acc_new
    kappa_t = gains.kp[1] + gains.ki[1] * e_acc_new
    v = (kappa_t * bound_norm + phi_t) * r
    return tau + v, tau, v, e_acc_new
