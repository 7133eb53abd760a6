"""Grasp / contact extension: end-effector contact wrench PZs and the
waiter's-tray contact constraints.

JAX equivalent of the reference's Dynamics_sav.cu work-in-progress
(f_c_{nom,int} / n_c_{nom,int} contact force/moment PZs at the end effector,
Dynamics_sav.cu:17-20,891-896; the `grasp_constraints_flag` placeholder in
uarmtd_planner.m:539-542 never materialized).  Here the wrench PZs come from
the shared PZ-RNEA backward recursion (dynamics.rnea_pz_sets(wrench_at=j)),
and the three classical frictional-contact conditions are provided as
k-sliceable constraint rows:

  separation:  -f_n <= 0                 (contact force pushes, never pulls)
  slipping:    ||f_t||^2 - mu^2 f_n^2 <= 0
  tipping:     ||n_t||^2 - r^2  f_n^2 <= 0  (moment arm within support disc)

with f decomposed along the contact normal in the payload frame.  All three
are polynomial in the wrench components, so their PZ interval bounds give
sound constraints over the whole (k, error) set; the NLP-facing evaluation
slices them at k like every other row.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .config import ArmourConfig
from .dynamics import rnea_pz_sets
from .jrs import JRS
from .pz import bpz
from .pz.basis import KBasis
from .pz.bpz import BPZ
from .robot import RobotModel


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ContactWrenchFRS:
    """Contact wrench PZs at the grasp joint, nominal + interval params."""

    f_nom: BPZ  # [T, 3]
    n_nom: BPZ  # [T, 3]
    f_int: BPZ  # [T, 3]
    n_int: BPZ  # [T, 3]


def contact_wrench_frs(jrs: JRS, robot: RobotModel, cfg: ArmourConfig,
                       basis: KBasis, contact_joint: int | None = None) -> ContactWrenchFRS:
    """Wrench transmitted to the payload body (defaults to the last chain
    link) for nominal and interval inertial parameters
    (Dynamics_sav.cu f_c/n_c)."""
    j = robot.num_joints - 1 if contact_joint is None else contact_joint
    _, f_c, n_c = rnea_pz_sets(jrs, robot, cfg, basis, sets=("nom", "int"),
                               wrench_at=j)
    pick = lambda p, i: BPZ(coef=p.coef[i], egen=p.egen[i], rad=p.rad[i])
    return ContactWrenchFRS(
        f_nom=pick(f_c, 0), n_nom=pick(n_c, 0),
        f_int=pick(f_c, 1), n_int=pick(n_c, 1),
    )


@dataclasses.dataclass(frozen=True)
class GraspParams:
    """Contact model: friction coefficient and support-disc radius
    (waiter's-tray conditions)."""

    mu: float = 0.5
    support_radius: float = 0.05
    normal_axis: int = 2  # contact normal in the payload frame


def _contact_constraint_pzs(w: ContactWrenchFRS, params: GraspParams,
                            basis: KBasis, cfg: ArmourConfig):
    """The three contact-condition PZs (sep, slip, tip), each [T], built in
    PZ arithmetic from the INTERVAL wrench PZs so the containment guarantee
    carries through the (quadratic) constraint polynomials.  Quadratic terms
    whose k-degree exceeds the basis cap are outward-rounded into the
    independent radius by bpz.mul — sound, only conservative."""
    a = params.normal_axis
    t_axes = [i for i in range(3) if i != a]
    slop = cfg.float_slop

    def comp(p: BPZ, i: int) -> BPZ:
        return BPZ(coef=p.coef[..., i, :], egen=p.egen[..., i, :], rad=p.rad[..., i])

    f_n = comp(w.f_int, a)
    f_t = [comp(w.f_int, i) for i in t_axes]
    n_t = [comp(w.n_int, i) for i in t_axes]

    sq = lambda p: bpz.mul(p, p, basis, slop)
    # separation: -f_n <= 0   (contact force pushes, never pulls)
    sep = bpz.neg(f_n)
    # slipping: f_tx^2 + f_ty^2 - mu^2 f_n^2 <= 0
    slip = bpz.add(sq(f_t[0]), sq(f_t[1]))
    slip = bpz.add(slip, bpz.scale(sq(f_n), -params.mu ** 2))
    # tipping: n_tx^2 + n_ty^2 - r^2 f_n^2 <= 0
    tip = bpz.add(sq(n_t[0]), sq(n_t[1]))
    tip = bpz.add(tip, bpz.scale(sq(f_n), -params.support_radius ** 2))
    return sep, slip, tip


def grasp_constraint_intervals(w: ContactWrenchFRS, params: GraspParams,
                               basis: KBasis, cfg: ArmourConfig):
    """Sound interval bounds of the three contact constraints over the whole
    (k, error) set: per-time upper bounds (g <= 0 safe).  Used by tests and
    offline verification; the planner uses the k-sliceable grasp_frs rows."""
    sep, slip, tip = _contact_constraint_pzs(w, params, basis, cfg)

    def upper(p: BPZ):
        c, r = bpz.to_interval(p)
        return c + r

    return upper(sep), upper(slip), upper(tip)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GraspFRS:
    """k-sliceable grasp constraint rows for the NLP (same recipe as the
    torque rows: slice the constraint PZ at k, keep the error-generator +
    independent radius as an outward buffer)."""

    g_coef: jnp.ndarray  # [T, 3, B] k-poly coefficients (sep, slip, tip)
    g_rad: jnp.ndarray   # [T, 3]    non-k radius (error gens + independent)


def grasp_frs(jrs: JRS, robot: RobotModel, cfg: ArmourConfig, basis: KBasis,
              params: GraspParams, contact_joint: int | None = None) -> GraspFRS:
    """Planner-facing grasp rows: g(k) = g_coef . phi(k) + g_rad <= 0 is a
    sound constraint for every t (Dynamics_sav.cu:17-20,891-896 wrench PZs +
    uarmtd_planner.m:539-542 grasp_constraints_flag intent, materialized)."""
    w = contact_wrench_frs(jrs, robot, cfg, basis, contact_joint)
    sep, slip, tip = _contact_constraint_pzs(w, params, basis, cfg)
    rows = [bpz.reduce_(p) for p in (sep, slip, tip)]
    return GraspFRS(
        g_coef=jnp.stack([p.coef for p in rows], axis=1),
        g_rad=jnp.stack([p.rad for p in rows], axis=1),
    )
