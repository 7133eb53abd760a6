"""PZ recursive Newton-Euler (passivity form) and the robust torque bound.

JAX equivalent of KinematicsDynamics::rnea (Dynamics.cu:83-181): the
forward recursion propagates angular velocity w, auxiliary velocity w_aux,
acceleration wdot and linear acceleration through the chain in BPZ tensors
batched over all time steps; the backward recursion accumulates wrenches and
reads off the joint torque along the motion axis, plus armature and damping
terms.  Called twice — nominal and interval inertial parameters — to obtain
the disturbance PZ, from which the robust-input bound and total control input
radius are assembled exactly as in armour_main.cu:171-210.

Compilation structure: both recursions are lax.scan over the joint axis with
the four per-joint rotations fused into ONE stacked matrix-matrix PZ product
(w | w_aux | wdot | linear_acc as columns), so the traced program contains a
single chain body instead of 7 unrolled copies — an order of magnitude less
HLO for the same math.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .config import ArmourConfig
from .jrs import JRS
from .pz import bpz
from .pz.basis import KBasis, error_layout
from .pz.bpz import BPZ
from .robot import RobotModel


def _stack_joint_axis(p: BPZ) -> BPZ:
    """[T, J, ...] -> [J, T, ...] for scanning over joints."""
    return BPZ(
        coef=jnp.moveaxis(p.coef, 1, 0),
        egen=jnp.moveaxis(p.egen, 1, 0),
        rad=jnp.moveaxis(p.rad, 1, 0),
    )


def _embed(a: BPZ, e: jnp.ndarray) -> BPZ:
    """Scalar PZ [T] times one-hot axis vector e [3] -> vector PZ [T, 3]
    (addOneDimPZ with a data-driven axis, PZsparse.cu:489-506)."""
    return BPZ(
        coef=e[:, None] * a.coef[..., None, :],
        egen=e[:, None] * a.egen[..., None, :],
        rad=jnp.abs(e) * a.rad[..., None],
    )


def _col_stack(ps) -> BPZ:
    """Stack vector PZs [T, 3] as columns of a matrix PZ [T, 3, n]."""
    return BPZ(
        coef=jnp.stack([p.coef for p in ps], axis=-2),
        egen=jnp.stack([p.egen for p in ps], axis=-2),
        rad=jnp.stack([p.rad for p in ps], axis=-1),
    )


def _col(p: BPZ, j: int) -> BPZ:
    return BPZ(coef=p.coef[..., j, :], egen=p.egen[..., j, :], rad=p.rad[..., j])


def _inertial_pzs(robot: RobotModel, basis: KBasis, dtype, sets):
    """Stacked mass, inertia and COM PZs over parameter sets [J, P, ...]
    (Dynamics.cu:30-41; COM interval per urdf_utils/get_inertial_params.m:212
    — the whole COM vector scaled by a multiplicative range com*(1+-delta)).

    sets: tuple of "nom" / "int" — P = len(sets) parameter variants that are
    pushed through ONE shared kinematic recursion (the reference runs the
    entire RNEA twice, armour_main.cu:128-136; the forward kinematic pass is
    mass-independent so sharing it is exact)."""
    mass = jnp.asarray(robot.mass, dtype)
    inertia = jnp.asarray(robot.inertia, dtype)
    com = jnp.asarray(robot.com, dtype)
    z = 0.0
    mrads = jnp.stack([
        robot.mass_uncertainty * jnp.abs(mass) if s == "int" else jnp.zeros_like(mass)
        for s in sets], axis=1)                                       # [J, P]
    irads = jnp.stack([
        robot.inertia_uncertainty * jnp.abs(inertia) if s == "int"
        else jnp.zeros_like(inertia) for s in sets], axis=1)          # [J, P, 3, 3]
    crads = jnp.stack([
        robot.com_uncertainty * jnp.abs(com) if (s == "int" and robot.com_uncertainty)
        else jnp.zeros_like(com) for s in sets], axis=1)              # [J, P, 3]
    P = len(sets)
    mass_pz = bpz.from_interval(
        jnp.broadcast_to(mass[:, None], (mass.shape[0], P)), mrads, basis)
    inertia_pz = bpz.from_interval(
        jnp.broadcast_to(inertia[:, None], (inertia.shape[0], P, 3, 3)), irads, basis)
    com_pz = bpz.from_interval(
        jnp.broadcast_to(com[:, None], (com.shape[0], P, 3)), crads, basis)
    return mass_pz, inertia_pz, com_pz


def rnea_pz(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis,
            uncertain: bool, set_gravity: bool = True) -> BPZ:
    """PZ RNEA torque u [T, F] (Dynamics.cu:83-181)."""
    u = rnea_pz_sets(jrs, robot, cfg, basis,
                     sets=("int" if uncertain else "nom",),
                     set_gravity=set_gravity)
    return BPZ(coef=u.coef[0], egen=u.egen[0], rad=u.rad[0])


def rnea_pz_sets(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis,
                 sets=("nom", "int"), set_gravity: bool = True,
                 wrench_at: int | None = None):
    """PZ RNEA torque u [P, T, F] over P parameter sets sharing one kinematic
    forward pass (Dynamics.cu:83-181; armour_main.cu:128-136 runs nominal and
    interval back-to-back — the w/w_aux/wdot/lin_acc recursion is identical
    in both, so evaluating it once is exact and ~40% cheaper)."""
    dt = cfg.dtype
    T = cfg.num_time_steps
    J = robot.num_joints
    F = robot.num_factors
    P = len(sets)
    slop = cfg.float_slop
    trans = jnp.asarray(robot.trans, dt)         # [J+1, 3]
    com = jnp.asarray(robot.com, dt)             # [J, 3]
    mass_pz, inertia_pz, com_pz = _inertial_pzs(robot, basis, dt, sets)
    # COM uncertainty path is only traced when enabled (the Kinova flagship
    # and the reference's benchmarks run with com_range=[1,1], i.e. off)
    com_uncertain = bool(robot.com_uncertainty and any(s == "int" for s in sets))

    # one-hot motion axes + revolute mask (axes[i] != 0 and i < F)
    e_axis = jnp.zeros((J, 3), dt)
    rev = jnp.zeros((J,), dt)
    for i in range(J):
        if robot.axes[i] != 0 and i < F:
            sgn = 1.0 if robot.axes[i] > 0 else -1.0
            e_axis = e_axis.at[i, abs(int(robot.axes[i])) - 1].set(sgn)
            rev = rev.at[i].set(1.0)

    Rt_j = _stack_joint_axis(jrs.Rt)             # [J, T, 3, 3]
    R_j = _stack_joint_axis(jrs.R)               # [J+1, T, 3, 3]
    qd_j = _stack_joint_axis(jrs.qd)             # [J?, T] (F == J assumed for
    qda_j = _stack_joint_axis(jrs.qda)           #  actuated prefix)
    qdda_j = _stack_joint_axis(jrs.qdda)

    def pad_factors(p: BPZ) -> BPZ:
        if F == J:
            return p
        padw = [(0, J - F)] + [(0, 0)] * (p.coef.ndim - 1)
        return BPZ(
            coef=jnp.pad(p.coef, padw), egen=jnp.pad(p.egen, padw),
            rad=jnp.pad(p.rad, padw[:-1]),
        )

    qd_j, qda_j, qdda_j = pad_factors(qd_j), pad_factors(qda_j), pad_factors(qdda_j)

    w0 = bpz.zeros((T, 3), basis, dt)
    lin0 = bpz.zeros((T, 3), basis, dt)
    if set_gravity:
        lin0 = BPZ(
            coef=lin0.coef.at[:, 2, 0].set(robot.gravity), egen=lin0.egen, rad=lin0.rad
        )

    def fwd_body(carry, inp):
        w, w_aux, wdot, lin_acc = carry
        rt, qd_i, qda_i, qdda_i, m_i, I_i, com_pz_i, trans_i, com_i, e_i, rev_i = inp

        acc_arg = bpz.add(
            lin_acc,
            bpz.add(
                bpz.cross_pz_const(wdot, trans_i),
                bpz.cross(w, bpz.cross_pz_const(w_aux, trans_i), basis, slop),
            ),
        )
        # fused rotation of (w | w_aux | wdot | acc) (Dynamics.cu lines 13-16);
        # rotation PZs are degree<=1 in k -> linear-operand fast path
        stacked = _col_stack([w, w_aux, wdot, acc_arg])        # [T, 3, 4]
        rotated = bpz.matmul_linear(rt, stacked, basis, slop)
        w, w_aux, wdot, lin_acc = (_col(rotated, j) for j in range(4))

        qd_vec = _embed(bpz.scale(qd_i, rev_i), e_i)
        w = bpz.add(w, qd_vec)
        wdot = bpz.add(wdot, bpz.cross(w_aux, qd_vec, basis, slop))
        wdot = bpz.add(wdot, _embed(bpz.scale(qdda_i, rev_i), e_i))
        w_aux = bpz.add(w_aux, _embed(bpz.scale(qda_i, rev_i), e_i))

        # link force / moment (Dynamics.cu lines 23-29); the P parameter-set
        # axis rides as a leading broadcast dim: kinematics [T, 3] x params
        # [P, 1, 1] -> F_i/N_i [P, T, 3]
        if com_uncertain:
            # com_pz_i [P, 3] -> [P, 1, 3] to broadcast against [T, 3]
            com_b = BPZ(coef=com_pz_i.coef[:, None], egen=com_pz_i.egen[:, None],
                        rad=com_pz_i.rad[:, None])
            f_arg = bpz.add(
                lin_acc,
                bpz.add(
                    bpz.cross(wdot, com_b, basis, slop),
                    bpz.cross(w, bpz.cross(w_aux, com_b, basis, slop), basis, slop),
                ),
            )
        else:
            f_arg = bpz.add(
                lin_acc,
                bpz.add(
                    bpz.cross_pz_const(wdot, com_i),
                    bpz.cross(w, bpz.cross_pz_const(w_aux, com_i), basis, slop),
                ),
            )
        # mass/inertia are pure interval PZs (from_interval, Dynamics.cu:30-41)
        # -> exact interval-operand products, no pair-table expansion.
        # interval_operand folds any egen/non-constant coef into the radius,
        # so a future non-interval operand stays sound instead of silently
        # dropping uncertainty.  m [P] -> [P, 1, 1]; I [P, 3, 3] -> [P, 1, 3, 3]
        m_c, m_r = bpz.interval_operand(m_i)
        F_i = bpz.mul_interval(m_c[:, None, None], m_r[:, None, None],
                               f_arg, slop)
        I_c, I_r = bpz.interval_operand(I_i)
        Iw = bpz.matmul_interval(I_c[:, None], I_r[:, None],
                                 _col_stack([wdot, w]), slop)
        N_i = bpz.add(_col(Iw, 0), bpz.cross(w_aux, _col(Iw, 1), basis, slop))
        return (w, w_aux, wdot, lin_acc), (F_i, N_i)

    fwd_inputs = (
        Rt_j, qd_j, qda_j, qdda_j, mass_pz, inertia_pz, com_pz,
        trans[:J], com, e_axis, rev,
    )
    _, (F_all, N_all) = jax.lax.scan(fwd_body, (w0, w0, w0, lin0), fwd_inputs)

    # backward recursion (Dynamics.cu:160-181), scanned in reverse
    def bwd_body(carry, inp):
        f, n = carry
        (r_ip1, F_i, N_i, qd_i, qdda_i, com_pz_i, trans_ip1, com_i, e_i, rev_i,
         arm_i, damp_i) = inp
        rot = bpz.matmul_linear(r_ip1, _col_stack([f, n]), basis, slop)
        rf, rn = _col(rot, 0), _col(rot, 1)
        if com_uncertain:
            com_b = BPZ(coef=com_pz_i.coef[:, None], egen=com_pz_i.egen[:, None],
                        rad=com_pz_i.rad[:, None])
            com_cross_F = bpz.cross(com_b, F_i, basis, slop)
        else:
            com_cross_F = bpz.cross_const(com_i, F_i)
        n_new = bpz.add(
            bpz.add(N_i, rn),
            bpz.add(com_cross_F, bpz.cross_const(trans_ip1, rf)),
        )
        f_new = bpz.add(rf, F_i)
        u_axis = BPZ(
            coef=jnp.einsum("a,...am->...m", e_i, n_new.coef),
            egen=jnp.einsum("a,...am->...m", e_i, n_new.egen),
            rad=jnp.einsum("a,...a->...", jnp.abs(e_i), n_new.rad),
        )
        u_i = bpz.add(u_axis, bpz.scale(qdda_i, arm_i * rev_i))
        u_i = bpz.add(u_i, bpz.scale(qd_i, damp_i * rev_i))
        return (f_new, n_new), (u_i, f_new, n_new)

    R_ip1 = BPZ(coef=R_j.coef[1:], egen=R_j.egen[1:], rad=R_j.rad[1:])
    bwd_inputs = (
        R_ip1, F_all, N_all, qd_j, qdda_j, com_pz, trans[1:],
        com, e_axis, rev, jnp.asarray(robot.armature, dt), jnp.asarray(robot.damping, dt),
    )
    (_, _), (u_all, f_all, n_all) = jax.lax.scan(
        bwd_body,
        (bpz.zeros((P, T, 3), basis, dt), bpz.zeros((P, T, 3), basis, dt)),
        bwd_inputs, reverse=True,
    )
    # u_all is [J, P, T]; keep the actuated prefix as [P, T, F]
    u = BPZ(
        coef=jnp.moveaxis(u_all.coef[:F], 0, 2),
        egen=jnp.moveaxis(u_all.egen[:F], 0, 2),
        rad=jnp.moveaxis(u_all.rad[:F], 0, 2),
    )
    if wrench_at is None:
        return u
    # joint wrench (f, n) at a chain index [P, T, 3] — the contact wrench
    # when that joint attaches a grasped payload (Dynamics_sav.cu:17-20,
    # 891-896 f_c/n_c semantics: the wrench transmitted to body `wrench_at`)
    j = wrench_at
    f_c = BPZ(coef=f_all.coef[j], egen=f_all.egen[j], rad=f_all.rad[j])
    n_c = BPZ(coef=n_all.coef[j], egen=n_all.egen[j], rad=n_all.rad[j])
    return u, f_c, n_c


@dataclasses.dataclass
class TorqueFRS:
    """Reduced nominal torque + total control-input radius for the NLP."""

    u_coef: jnp.ndarray         # [T, F, B] sliceable nominal torque k-poly
    torque_radius: jnp.ndarray  # [T, F] total input PZ radius (robust bound
                                # + nominal radius + friction)


jax.tree_util.register_dataclass(
    TorqueFRS, data_fields=["u_coef", "torque_radius"], meta_fields=[]
)


def torque_frs(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis) -> TorqueFRS:
    """Nominal torque PZ + robust input radius (armour_main.cu:128-210)."""
    u_both = rnea_pz_sets(jrs, robot, cfg, basis, sets=("nom", "int"))
    u_nom = BPZ(coef=u_both.coef[0], egen=u_both.egen[0], rad=u_both.rad[0])
    u_int = BPZ(coef=u_both.coef[1], egen=u_both.egen[1], rad=u_both.rad[1])
    disturbance = bpz.sub(u_int, u_nom)

    # interval hull of the disturbance per (T, F)
    d_c, d_r = bpz.to_interval(disturbance)
    d_lo, d_hi = d_c - d_r, d_c + d_r
    d_max = jnp.maximum(jnp.abs(d_lo), jnp.abs(d_hi))

    ub = cfg.ub
    # rho_max upper bound = sqrt(sum_i max(lo^2, hi^2))  (armour_main.cu:175-190)
    rho_sq = jnp.sum(jnp.maximum(d_lo * d_lo, d_hi * d_hi), axis=1)  # [T]
    rho_max = jnp.sqrt(rho_sq)

    u_nom_red = bpz.reduce_(u_nom)

    torque_radius = (
        ub.alpha * (ub.m_max - ub.m_min) * ub.eps
        + 0.5 * d_max
        + 0.5 * rho_max[:, None]
        + u_nom_red.rad
        + jnp.asarray(robot.friction[: robot.num_factors], cfg.dtype)[None, :]
    )
    return TorqueFRS(u_coef=u_nom_red.coef, torque_radius=torque_radius)
