"""Online joint reachable sets (JRS) for the Bezier trajectory family.

JAX equivalent of BezierCurve::makePolyZono (Trajectory.cu:63-254) and
the MATLAB create_jrs_online.m: for every time sub-interval of the horizon,
bound the k-independent part of q/qd/qdd by closed-form extrema, bound the
k coefficient over the sub-interval, take a 1st-order Taylor expansion of
cos/sin with an interval Lagrange remainder, and inject the controller
tracking-error generators (qe/qde/qdae/qddae).  Everything is built as dense
BPZ tensors over [T, J] in one shot — the reference's 128-iteration OpenMP
loop becomes broadcasted tensor arithmetic.

Each cos/sin PZ has exactly: center + (k_i coefficient) + (dedicated error
generator), mirroring the 2-monomial structure of the reference.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import bezier
from .config import ArmourConfig
from .pz import interval as iv
from .pz.basis import KBasis, error_layout
from .pz.bpz import BPZ
from .robot import RobotModel

SQRT3_6 = float(np.sqrt(3.0) / 6.0)
QDD_K_DEP_MAXIMA = 0.5 - SQRT3_6  # Trajectory.h:7
QDD_K_DEP_MINIMA = 0.5 + SQRT3_6  # Trajectory.h:8


@dataclasses.dataclass
class TrajectoryCoeffs:
    """Initial-state-dependent scalars shared by JRS, cost and extrema.

    family: 'bernstein' (degree-5 Bezier, the ARMOUR trajectory) or 'armtd'
    (constant acceleration + braking, the original ARMTD baseline).
    k_scale: actual parameter range per joint; static cfg.k_range for
    bernstein, the velocity-adaptive g_k for armtd (create_jrs_online.m:77).
    """

    q0: jnp.ndarray      # [F]
    qd0: jnp.ndarray     # [F]
    qdd0: jnp.ndarray    # [F]
    Tqd0: jnp.ndarray    # [F] qd0 * duration
    TTqdd0: jnp.ndarray  # [F] qdd0 * duration^2
    k_scale: jnp.ndarray  # [F]
    family: str = dataclasses.field(default="bernstein", metadata=dict(static=True))


@dataclasses.dataclass
class JRS:
    """Per-time-step PZs of the desired trajectory."""

    R: BPZ        # [T, J+1, 3, 3] joint rotations (last = identity)
    Rt: BPZ       # [T, J, 3, 3] transposes
    qd: BPZ       # [T, F]
    qda: BPZ      # [T, F] auxiliary velocity (qdae error var)
    qdda: BPZ     # [T, F] auxiliary acceleration
    traj: TrajectoryCoeffs


jax.tree_util.register_dataclass(
    TrajectoryCoeffs,
    data_fields=["q0", "qd0", "qdd0", "Tqd0", "TTqdd0", "k_scale"],
    meta_fields=["family"],
)
jax.tree_util.register_dataclass(
    JRS, data_fields=["R", "Rt", "qd", "qda", "qdda", "traj"], meta_fields=[]
)


def _bound_k_indep(fn, extrema_fn, Tqd0, TTqdd0, q0, s_lb, s_ub, duration=None):
    """Bound fn(s) over [s_lb, s_ub] using endpoint values + interior critical
    points (Trajectory.cu:80-99 pattern).  Shapes: s [T, 1], params [F]."""
    kwargs = {} if duration is None else {"duration": duration}
    v_lb = fn(q0, Tqd0, TTqdd0, s_lb, **kwargs)
    v_ub = fn(q0, Tqd0, TTqdd0, s_ub, **kwargs)
    lo = jnp.minimum(v_lb, v_ub)
    hi = jnp.maximum(v_lb, v_ub)
    e1, e2 = extrema_fn(Tqd0, TTqdd0)
    for e in (e1, e2):
        ve = fn(q0, Tqd0, TTqdd0, e, **kwargs)
        inside = (s_lb < e) & (e < s_ub) & jnp.isfinite(e) & jnp.isfinite(ve)
        lo = jnp.where(inside, jnp.minimum(lo, ve), lo)
        hi = jnp.where(inside, jnp.maximum(hi, ve), hi)
    return lo, hi


def _rot_pattern(axis: int, c, s, dtype):
    """Axis rotation matrix from (cos, sin) entries, generator form
    (zeros elsewhere; PZsparse.cu:212-259 makeRotationMatrix)."""
    z = jnp.zeros_like(c)
    if axis == 1:
        rows = [[z, z, z], [z, c, -s], [z, s, c]]
    elif axis == 2:
        rows = [[c, z, s], [z, z, z], [-s, z, c]]
    elif axis == 3:
        rows = [[c, -s, z], [s, c, z], [z, z, z]]
    else:
        raise ValueError(axis)
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2).astype(dtype)


def _one_hot(idx: int, n: int, dtype):
    return jnp.zeros((n,), dtype=dtype).at[idx].set(1.0)



def trig_taylor_pz(qc, Rq, kd_scaled):
    """First-order Taylor of cos/sin about qc with interval Lagrange remainder
    (Trajectory.cu:104-134).  qc: center angle; Rq: k-independent radius
    (incl. tracking error); kd_scaled: k coefficient (already scaled to the
    actual parameter range).  Returns (cos_c, cos_k, cos_e, sin_c, sin_k,
    sin_e): centers, k-linear coefficients and error-generator radii."""
    W = Rq + jnp.abs(kd_scaled)
    q_rad = iv.sym(Rq)
    J_int = (qc - W, qc + W)
    pow_term = (jnp.zeros_like(W), W * W)

    cosJ = iv.cos(J_int)
    rem_cos = iv.add(
        iv.scale(q_rad, -jnp.sin(qc)),
        iv.scale(iv.mul(cosJ, pow_term), -0.5),
    )
    cos_c = jnp.cos(qc) + iv.center(rem_cos)
    cos_k = -kd_scaled * jnp.sin(qc)
    cos_e = iv.radius(rem_cos)

    sinJ = iv.sin(J_int)
    rem_sin = iv.add(
        iv.scale(q_rad, jnp.cos(qc)),
        iv.scale(iv.mul(sinJ, pow_term), -0.5),
    )
    sin_c = jnp.sin(qc) + iv.center(rem_sin)
    sin_k = kd_scaled * jnp.cos(qc)
    sin_e = iv.radius(rem_sin)
    return cos_c, cos_k, cos_e, sin_c, sin_k, sin_e


def assemble_rotations(robot, cos_c, cos_k, cos_e, sin_c, sin_k, sin_e,
                       basis: KBasis, dt):
    """Rotation PZs R [T, J+1, 3, 3] and their transposes from per-joint
    cos/sin PZ data (Trajectory.cu:136-153,244-253)."""
    T = cos_c.shape[0]
    J = robot.num_joints
    F = robot.num_factors
    B = basis.size
    E = error_layout(basis.nf)["size"]
    lay = error_layout(basis.nf)
    lin = basis.lin_idx
    rotm = jnp.asarray(robot.rot_mats, dt)
    zerosT = jnp.zeros((T,), dt)
    R_coef, R_egen = [], []
    for i in range(J):
        axis = int(robot.axes[i])
        coef_i = jnp.zeros((T, 3, 3, B), dt)
        egen_i = jnp.zeros((T, 3, 3, E), dt)
        if axis == 0 or i >= F:
            ctr = rotm[i] @ jnp.eye(3, dtype=dt)
            coef_i = coef_i.at[..., 0].set(jnp.broadcast_to(ctr, (T, 3, 3)))
        else:
            sign = 1.0 if axis > 0 else -1.0  # reversed joints rotate by -q
            axis = abs(axis)
            rot_c = _rot_pattern(axis, cos_c[:, i], sign * sin_c[:, i], dt)
            eye_axis = jnp.zeros((3, 3), dt).at[axis - 1, axis - 1].set(1.0)
            ctr = jnp.einsum("ab,tbc->tac", rotm[i], rot_c + eye_axis)
            coef_i = coef_i.at[..., 0].set(ctr)
            kmat = jnp.einsum(
                "ab,tbc->tac", rotm[i],
                _rot_pattern(axis, cos_k[:, i], sign * sin_k[:, i], dt),
            )
            coef_i = coef_i.at[..., int(lin[i])].set(kmat)
            cmat = jnp.einsum("ab,tbc->tac", rotm[i], _rot_pattern(axis, cos_e[:, i], zerosT, dt))
            smat = jnp.einsum("ab,tbc->tac", rotm[i], _rot_pattern(axis, zerosT, sin_e[:, i], dt))
            egen_i = egen_i.at[..., lay["cosqe"].start + i].set(cmat)
            egen_i = egen_i.at[..., lay["sinqe"].start + i].set(smat)
        R_coef.append(coef_i)
        R_egen.append(egen_i)

    coef_id = jnp.zeros((T, 3, 3, B), dt).at[..., 0].set(
        jnp.broadcast_to(jnp.eye(3, dtype=dt), (T, 3, 3))
    )
    R_coef.append(coef_id)
    R_egen.append(jnp.zeros((T, 3, 3, E), dt))

    R = BPZ(
        coef=jnp.stack(R_coef, axis=1),
        egen=jnp.stack(R_egen, axis=1),
        rad=jnp.zeros((T, J + 1, 3, 3), dt),
    )
    Rt = BPZ(
        coef=jnp.swapaxes(R.coef[:, :J], 2, 3),
        egen=jnp.swapaxes(R.egen[:, :J], 2, 3),
        rad=jnp.swapaxes(R.rad[:, :J], 2, 3),
    )
    return R, Rt


def make_velocity_pz(center, kcoef, ecoef, egroup_name: str, basis: KBasis, dt):
    """[T, F] velocity/acceleration PZ: center + k_i + dedicated error var."""
    T, F = center.shape
    B = basis.size
    lay = error_layout(basis.nf)
    E = lay["size"]
    lin = basis.lin_idx
    k_onehot = jnp.stack([_one_hot(int(lin[i]), B, dt) for i in range(F)])
    e0 = _one_hot(0, B, dt)
    coef = center[..., None] * e0 + kcoef[..., None] * k_onehot
    eg = jnp.zeros((T, F, E), dt)
    idx = np.arange(F) + lay[egroup_name].start
    eg = eg.at[:, np.arange(F), idx].set(ecoef)
    return BPZ(coef=coef, egen=eg, rad=jnp.zeros((T, F), dt))


def build_jrs(q0, qd0, qdd0, robot: RobotModel, cfg: ArmourConfig, basis: KBasis) -> JRS:
    """Build the online JRS for one initial state.  q0/qd0/qdd0: [F]."""
    dt = cfg.dtype
    T = cfg.num_time_steps
    F = robot.num_factors
    J = robot.num_joints
    E = error_layout(basis.nf)["size"]
    lay = error_layout(basis.nf)
    B = basis.size
    dur = cfg.duration
    ub = cfg.ub

    q0 = jnp.asarray(q0, dt)
    qd0 = jnp.asarray(qd0, dt)
    qdd0 = jnp.asarray(qdd0, dt)
    Tqd0 = qd0 * dur
    TTqdd0 = qdd0 * dur * dur
    traj = TrajectoryCoeffs(
        q0=q0, qd0=qd0, qdd0=qdd0, Tqd0=Tqd0, TTqdd0=TTqdd0,
        k_scale=jnp.asarray(cfg.k_range, dt), family="bernstein",
    )

    ds = 1.0 / T
    s_lb = (jnp.arange(T, dtype=dt) * ds)[:, None]        # [T, 1]
    s_ub = s_lb + ds
    assert len(cfg.k_range) == F, (
        f"cfg.k_range has {len(cfg.k_range)} entries but the robot has "
        f"{F} actuated joints; use ArmourConfig.for_robot(robot, ...)"
    )
    k_range = jnp.asarray(cfg.k_range, dt)                # [F]

    # ---- Part 1: q_des -> cos/sin PZs (Trajectory.cu:79-145) ----
    kd_lb = s_lb**3 * (6.0 * s_lb**2 - 15.0 * s_lb + 10.0)
    kd_ub = s_ub**3 * (6.0 * s_ub**2 - 15.0 * s_ub + 10.0)
    kd_center = (kd_ub + kd_lb) * 0.5                      # [T, 1] (unscaled)
    kd_radius = (kd_ub - kd_lb) * 0.5 * k_range            # [T, F]

    ki_lo, ki_hi = _bound_k_indep(
        bezier.q_des_k_indep, bezier.q_des_k_indep_extrema, Tqd0, TTqdd0, q0, s_lb, s_ub
    )
    ki_radius = (ki_hi - ki_lo) * 0.5
    qc = (ki_hi + ki_lo) * 0.5                             # [T, F]

    Rq = kd_radius + ki_radius + ub.qe                     # q_des interval radius
    cos_c, cos_k, cos_e, sin_c, sin_k, sin_e = trig_taylor_pz(
        qc, Rq, kd_center * k_range
    )

    # ---- Part 2: qd_des / qda_des (Trajectory.cu:155-195) ----
    v_lb = 30.0 * s_lb**2 * (s_lb - 1.0) ** 2 / dur
    v_ub = 30.0 * s_ub**2 * (s_ub - 1.0) ** 2 / dur
    v_lo = jnp.minimum(v_lb, v_ub)
    v_hi = jnp.maximum(v_lb, v_ub)
    vd_center = (v_hi + v_lo) * 0.5 * k_range              # [T, F]
    vd_radius = (v_hi - v_lo) * 0.5 * k_range

    vi_lo, vi_hi = _bound_k_indep(
        bezier.qd_des_k_indep, bezier.qd_des_k_indep_extrema, Tqd0, TTqdd0, q0,
        s_lb, s_ub, duration=dur,
    )
    vi_radius = (vi_hi - vi_lo) * 0.5
    qd_center = (vi_hi + vi_lo) * 0.5

    qd_e = vd_radius + vi_radius + ub.qde
    qda_e = vd_radius + vi_radius + ub.qdae

    # ---- Part 3: qdda_des (Trajectory.cu:197-241) ----
    def acc(s):
        return 60.0 * s * (2.0 * s**2 - 3.0 * s + 1.0) / (dur * dur)

    t_lb = acc(s_lb)
    t_ub = acc(s_ub)
    aA = acc(jnp.asarray(QDD_K_DEP_MAXIMA, dt))
    aB = acc(jnp.asarray(QDD_K_DEP_MINIMA, dt))
    in_reg1 = s_ub <= QDD_K_DEP_MAXIMA
    in_reg2 = (~in_reg1) & (s_lb <= QDD_K_DEP_MAXIMA)
    in_reg3 = (~in_reg1) & (~in_reg2) & (s_ub <= QDD_K_DEP_MINIMA)
    in_reg4 = (~in_reg1) & (~in_reg2) & (~in_reg3) & (s_lb <= QDD_K_DEP_MINIMA)
    a_lo = jnp.where(
        in_reg1, t_lb,
        jnp.where(in_reg2, jnp.minimum(t_lb, t_ub),
                  jnp.where(in_reg3, t_ub, jnp.where(in_reg4, aB, t_lb))),
    )
    a_hi = jnp.where(
        in_reg1, t_ub,
        jnp.where(in_reg2, aA,
                  jnp.where(in_reg3, t_lb, jnp.where(in_reg4, jnp.maximum(t_lb, t_ub), t_ub))),
    )
    ad_center = (a_hi + a_lo) * 0.5 * k_range
    ad_radius = (a_hi - a_lo) * 0.5 * k_range

    ai_lo, ai_hi = _bound_k_indep(
        bezier.qdd_des_k_indep, bezier.qdd_des_k_indep_extrema, Tqd0, TTqdd0, q0,
        s_lb, s_ub, duration=dur,
    )
    ai_radius = (ai_hi - ai_lo) * 0.5
    qdd_center = (ai_hi + ai_lo) * 0.5
    qdda_e = ad_radius + ai_radius + ub.qddae

    # ---- assemble BPZ tensors via shared helpers ----
    qd_pz = make_velocity_pz(qd_center, vd_center, qd_e, "qde", basis, dt)
    qda_pz = make_velocity_pz(qd_center, vd_center, qda_e, "qdae", basis, dt)
    qdda_pz = make_velocity_pz(qdd_center, ad_center, qdda_e, "qddae", basis, dt)
    R, Rt = assemble_rotations(
        robot, cos_c, cos_k, cos_e, sin_c, sin_k, sin_e, basis, dt
    )

    return JRS(R=R, Rt=Rt, qd=qd_pz, qda=qda_pz, qdda=qdda_pz, traj=traj)
