"""Single typed configuration for the whole framework.

The reference scatters its knobs across three uncoordinated layers
(compile-time macros in Parameters.h, MATLAB name-value args, script-top
user parameter blocks; see reference kinova_planner_realtime/Parameters.h and
kinova_src/scripts/kinova_run_100_worlds.m:19-98).  Cross-layer consistency
there is manual and fragile (k_range vs g_k_bernstein, V_max vs ultimate
bound constants, n_t 128 vs 96 readback).  Here ONE dataclass derives every
dependent constant, so they cannot drift.

Reference parity notes (file:line refer to the reference repo):
  - DURATION / NUM_TIME_STEPS / k_range: Parameters.h:14-21
  - SIMPLIFY_THRESHOLD: Parameters.h:10
  - obstacle caps: Parameters.h:26-29
  - violation thresholds: Parameters.h:38-41
  - cost scale: Parameters.h:44
  - ultimate bound constants: KinovaWithoutGripperInfo.h:102-112 and
    uarmtd_robust_CBF_LLC.m:6-12,37-41
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class UltimateBound:
    """Tracking-error ultimate bound of the robust CBF controller.

    eps = sqrt(2 V_max / M_min) (uarmtd_robust_CBF_LLC.m:37-41).  The four
    derived radii qe/qde/qdae/qddae are exactly the extra generator radii
    injected into the JRS (Trajectory.cu:97,176,185,237).
    """

    alpha: float = 10.0
    v_max: float = 1e-2
    m_max: float = 15.79635774
    m_min: float = 5.095620491878957
    k_r: float = 5.0  # Kr gain

    @property
    def eps(self) -> float:
        return math.sqrt(2.0 * self.v_max / self.m_min)

    @property
    def qe(self) -> float:
        return self.eps / self.k_r

    @property
    def qde(self) -> float:
        return 2.0 * self.eps

    @property
    def qdae(self) -> float:
        return self.eps

    @property
    def qddae(self) -> float:
        return 2.0 * self.k_r * self.eps


@dataclasses.dataclass(frozen=True)
class ArmourConfig:
    """Planner + reachability + solver configuration."""

    # --- trajectory / reachable sets (Parameters.h:14-21) ---
    duration: float = 1.0
    t_plan: float = 0.5            # cost evaluated at t_plan; replan period
    num_time_steps: int = 128      # must be even (qd bounding trick)
    k_range: Tuple[float, ...] = tuple([math.pi / 48] * 7)
    # trajectory family: 'bernstein' (degree-5 Bezier, ARMOUR) or 'armtd'
    # (constant-acceleration comparison baseline, armtd_main.cu /
    # uarmtd_planner.m:234-331).  Selects the planner pipeline AND the
    # closed-loop reference evaluation, so the whole suite stack runs either
    # family from one switch.
    traj_family: str = "bernstein"

    # --- PZ arithmetic ---
    simplify_threshold: float = 5e-4   # Parameters.h:10
    max_poly_degree: int = 3           # total degree cap of tracked k-monomials
    # outward slop added to independent radii at every bilinear op to cover
    # non-directed floating point rounding (SURVEY.md section 7); relative.
    # Measured (scripts/f32_bands_worker.py, 128 Monte-Carlo samples of the
    # f32 JRS/FK/RNEA pipeline vs f64 ground truth): worst containment MARGIN
    # at slop=0 is 6.6e-2 m (FK) / 5.4 N*m (torque) — i.e. the Taylor +
    # interval radii already dwarf f32 rounding by ~3 orders of magnitude.
    # 1e-6 (~8x f32 eps per bilinear op) is kept on as insurance; it changes
    # the bands by < 1e-4 relative.  CI: tests/test_f32_soundness.py.
    float_slop: float = 1e-6

    # --- obstacles (Parameters.h:26-29) ---
    max_obstacles: int = 40
    obstacle_generators: int = 3

    # --- feasibility thresholds (Parameters.h:38-41) ---
    collision_violation_threshold: float = 1e-4
    torque_violation_threshold: float = 1e-2
    # extra clearance (m) the SOLVER demands on collision rows; the final
    # certification check stays at the exact threshold.  Without it the
    # optimizer legally grazes obstacle surfaces, and the next plan's
    # slightly larger moving-state FRS goes infeasible -> braking ratchets
    # the arm against the wall until even k=0 cannot be certified (observed
    # as consecutive-infeasible 'stuck' trials on the world suite).
    collision_search_margin: float = 0.005
    # smooth obstacle-constraint ablation (uarmtd_planner.m:711-731 duality
    # variant): sound shifted-softmax over hyperplanes instead of the hard
    # max; tau is the smoothing temperature in meters
    smooth_obstacle_constraints: bool = False
    smooth_tau: float = 0.01

    # --- cost (Parameters.h:44, NLPclass.cu:225-231) ---
    cost_scale: float = 10.0

    # --- solver (replaces Ipopt; armour_main.cu:246-253) ---
    # Iteration budget chosen on the contested bench + 20-world closed-loop
    # quality gate: (outer 4 x inner 3, 4 seeds culled to 2 after 1 outer)
    # matched the goal rate of an 8x6x4 solver.  Its cost on the GPU is not
    # measured yet.  The reference converges in tens of Ipopt iterations on
    # the same problems (NLPclass.cu:272-397).
    solver_outer_iters: int = 4        # augmented-Lagrangian outer updates
    solver_inner_iters: int = 3        # projected-Newton inner steps
    solver_seeds: int = 4              # multi-start ALM descents (vmapped)
    # seed culling: after `solver_cull_after` outer iterations keep only the
    # `solver_keep_seeds` most promising starts for the remaining budget
    # (0 disables).  The full 4-seed descent dominated round-3 solve time;
    # phase A costs cull_after/outer_iters of it, survivors the rest.
    solver_cull_after: int = 1
    solver_keep_seeds: int = 2
    # geometric backtracking ladder of the inner line search (see nlp.py)
    solver_alphas: Tuple[float, ...] = (1.0, 0.25, 0.03125)
    # screened collision rows in the solver hot loop.  Soundness never
    # depended on K (the finalize check evaluates ALL rows, collision.py
    # ScreenedCollision) — but CLOSED-LOOP QUALITY does: 1024 rows cost 9
    # goals on the 100-world suite (77 -> 68), and a strong-profile rescue
    # at 4096 could NOT recover them (68 goals; rescue recovered 61 plans
    # but 0 net goals) — the fast profile's accepted-but-poorer plans steer
    # worlds into wedged states over the 500-iteration horizon.  4096 is
    # the acceptance profile; its cost against 1024 on the GPU is not
    # measured yet.
    screen_k: int = 4096
    # per-obstacle row quota inside the screen (collision.screen_collision):
    # reserve this many best rows for EVERY obstacle before the global
    # top-K fill, so clutter near the current state cannot starve the
    # obstacles along the waypoint direction.  0 = pure global top-K.
    screen_obstacle_quota: int = 0
    solver_tol: float = 1e-4
    turn_off_input_constraints: bool = False
    # state-limit rows are tightened by this margin INSIDE the solver only;
    # the finalize feasibility check stays at the true limits.  The ALM's
    # terminal constraint violation is ~1e-5 in f32, so without headroom a
    # boundary-optimal iterate lands epsilon OUTSIDE the true bounds and the
    # whole plan is rejected (-> spurious braking/stuck).  1e-4 rad is 3
    # orders of magnitude below k_range; the returned plan satisfies the TRUE
    # limits with margin-minus-epsilon slack, so soundness is unchanged.
    state_limit_margin: float = 1e-4

    # --- grasp / contact constraints (Dynamics_sav.cu f_c/n_c wrench PZs +
    # uarmtd_planner.m:539-542 grasp_constraints_flag; off by default like
    # the reference's never-enabled placeholder) ---
    grasp_constraints: bool = False
    grasp_mu: float = 0.5               # contact friction coefficient
    grasp_support_radius: float = 0.05  # support-disc radius (tray tipping)
    grasp_normal_axis: int = 2          # contact normal in the payload frame
    grasp_violation_threshold: float = 1e-4

    # --- controller / ultimate bound ---
    ub: UltimateBound = dataclasses.field(default_factory=UltimateBound)

    # --- numerics ---
    dtype: jnp.dtype = jnp.float32

    def __post_init__(self):
        assert self.num_time_steps % 2 == 0, "NUM_TIME_STEPS must be even"

    @property
    def ds(self) -> float:
        return 1.0 / self.num_time_steps

    @classmethod
    def for_robot(cls, robot, derive_ub: bool = True, **overrides) -> "ArmourConfig":
        """Config with per-factor knobs sized to the robot (the default
        k_range tuple is for the 7-DOF flagship).

        By default the UltimateBound mass-matrix eigenvalue constants are
        re-derived for the robot (the Kinova defaults from
        KinovaWithoutGripperInfo.h:102-112 under-cover heavier arms like the
        KUKA; advisor round-1 finding).  Pass derive_ub=False or an explicit
        ub= override to skip.
        """
        if "k_range" not in overrides:
            overrides["k_range"] = tuple([math.pi / 48] * robot.num_factors)
        if derive_ub and "ub" not in overrides:
            overrides["ub"] = derive_ultimate_bound(robot)
        return cls(**overrides)


def mass_eigenvalue_bracket(robot, n_samples: int = 512, seed: int = 0,
                            margin: float = 0.1, refine_steps: int = 12):
    """(m_min, m_max) bracket of lambda(M(q)) over the joint-limit box.

    HEURISTIC, not certified: random sampling over-estimates the true
    minimum, so the worst samples are refined by projected gradient descent
    on lambda_min(M(q)) (ascent for lambda_max) and the result is shrunk /
    grown by `margin`.  If the true global minimum lies more than `margin`
    below the refined sample minimum, eps under-covers the tracking error —
    the closed-loop `ultimate_bound_exceeded` oracle (simulator.py) is the
    runtime backstop that would catch such a miss.  A certified bound
    (interval Gershgorin over the box) is gratuitously loose for
    near-singular wrist configurations; the margin + oracle pairing is the
    deliberate trade."""
    import jax
    import numpy as np

    from .rnea_numeric import mass_matrix

    require_x64("mass_eigenvalue_bracket")
    rng = np.random.default_rng(seed)
    lo = np.maximum(np.asarray(robot.position_limits_lb), -math.pi)
    hi = np.minimum(np.asarray(robot.position_limits_ub), math.pi)
    qs = rng.uniform(lo, hi, (n_samples, robot.num_factors))
    lo_j, hi_j = jnp.asarray(lo), jnp.asarray(hi)

    def eig_ends(q):
        e = jnp.linalg.eigvalsh(mass_matrix(robot, q))
        return e[..., 0], e[..., -1]

    def refine(q0, sign):
        # PGD on sign * lambda_end; gradient via the Rayleigh quotient of the
        # frozen extremal eigenvector (avoids differentiating through eigh)
        def body(_, q):
            M = mass_matrix(robot, q)
            _, V = jnp.linalg.eigh(M)
            v = jax.lax.stop_gradient(V[..., 0] if sign < 0 else V[..., -1])
            g = jax.grad(lambda qq: v @ mass_matrix(robot, qq) @ v)(q)
            return jnp.clip(q - sign * 0.1 * g, lo_j, hi_j)

        q = jax.lax.fori_loop(0, refine_steps, body, q0)
        a, b = eig_ends(q)
        return a if sign < 0 else b

    @jax.jit
    def bracket(qs):
        e_lo, e_hi = jax.vmap(eig_ends)(qs)
        worst_lo = qs[jnp.argsort(e_lo)[:8]]
        worst_hi = qs[jnp.argsort(-e_hi)[:8]]
        r_lo = jax.vmap(lambda q: refine(q, -1))(worst_lo)
        r_hi = jax.vmap(lambda q: refine(q, +1))(worst_hi)
        return (jnp.minimum(e_lo.min(), r_lo.min()),
                jnp.maximum(e_hi.max(), r_hi.max()))

    m_lo, m_hi = bracket(jnp.asarray(qs, jnp.float64))
    m_min = float(m_lo) * (1.0 - margin)
    m_max = float(m_hi) * (1.0 + margin)
    assert m_min > 0.0, "mass matrix must be positive definite"
    return m_min, m_max


def derive_ultimate_bound(robot, v_max: float = None, alpha: float = 10.0,
                          k_r: float = 5.0, n_samples: int = 512,
                          seed: int = 0, margin: float = 0.1,
                          qde_fraction: float = 0.4,
                          use_cache: bool = True,
                          return_provenance: bool = False) -> UltimateBound:
    """Per-robot UltimateBound (the reference hardcodes the Kinova's
    M_min/M_max, KinovaWithoutGripperInfo.h:103-112;
    kinova_run_100_worlds.m:96).

    V_max is a CONTROLLER DESIGN KNOB, not a constant
    (uarmtd_robust_CBF_LLC.m:6-12 exposes it; scripts set 1e-2 or 5e-5).
    eps = sqrt(2 V_max / m_min) explodes as m_min -> 0 (the Panda reaches
    m_min ~ 1e-3 near wrist singularities), so deriving eps from a fixed
    V_max renders every velocity constraint infeasible (qde = 2 eps above
    the speed limit).  Instead eps is chosen first —

        eps = min( sqrt(2 * 1e-2 / m_min),               # reference default
                   qde_fraction * min(speed_limits) / 2 ) # qde headroom cap

    — and V_max co-derived as 0.5 * m_min * eps^2.  On the Kinova
    (m_min ~ 5.1) the cap is inactive and this reproduces the reference's
    V_max = 1e-2, eps ~ 0.0627.  Pass an explicit v_max to pin it (old
    behavior).  Results are cached per robot name in models/ub_cache.json
    (scripts/derive_ub_cache.py regenerates)."""
    if use_cache and v_max is None:
        cached = _ub_cache().get(_ub_cache_key(robot, alpha, k_r, n_samples,
                                               seed, margin, qde_fraction))
        if cached is not None:
            fields = {f.name for f in dataclasses.fields(UltimateBound)}
            ub = UltimateBound(**{k: v for k, v in cached.items()
                                  if k in fields})
            return (ub, cached.get("provenance")) if return_provenance else ub

    m_min, m_max = mass_eigenvalue_bracket(robot, n_samples, seed, margin)
    # CERTIFIED lower bound (certify.py): armature Weyl bound + interval
    # branch-and-bound on the link part.  Always sound (certified <= true
    # lambda_min <= any sampled value); prefer it over the sampled heuristic
    # whenever it is competitive — for the Kinova the armature bound alone
    # (8.03) beats both the sampled bracket and the reference's own
    # hardcoded 5.0956 (kinova_run_100_worlds.m:96), giving a SMALLER sound
    # eps.  When interval conservatism makes the certified bound much weaker
    # than the sampled evidence (zero-armature arms near singularities), keep
    # the sampled heuristic — the closed-loop ultimate_bound oracle remains
    # the runtime backstop, as before.
    from .certify import certified_m_min

    m_sampled = m_min
    m_cert = certified_m_min(robot, max_boxes=600)
    certified = m_cert >= 0.6 * m_min
    if certified:
        m_min = m_cert
    if v_max is None:
        eps = min(math.sqrt(2.0 * 1e-2 / m_min),
                  qde_fraction * float(min(robot.speed_limits)) / 2.0)
        v_max = 0.5 * m_min * eps * eps
    ub = UltimateBound(alpha=alpha, v_max=v_max, m_max=m_max, m_min=m_min,
                       k_r=k_r)
    # provenance consumed by scripts/derive_ub_cache.py: whether the m_min
    # that eps rests on is the CERTIFIED bound (certify.py) or the sampled
    # heuristic (waived robots; see ub_cache.json waiver notes + the
    # closed-loop ultimate_bound oracle backstop).  m_max_cert is the
    # certified UPPER bound crosscheck: the sampled bracket decides (as in
    # the reference), but for the flagship the certified value sits within
    # 13% of it, bounding how far the heuristic can be wrong.
    from .certify import certified_m_max

    ub_provenance = {"certified": bool(certified), "m_cert": float(m_cert),
                     "m_min_sampled": float(m_sampled),
                     "m_max_cert": float(certified_m_max(robot)),
                     "m_max_sampled": float(m_max)}
    return (ub, ub_provenance) if return_provenance else ub


def _ub_cache_key(robot, alpha, k_r, n_samples, seed, margin, qde_fraction):
    return (f"{robot.name}|a{alpha}|kr{k_r}|n{n_samples}|s{seed}|m{margin}"
            f"|f{qde_fraction}")


def _ub_cache() -> dict:
    global _UB_CACHE
    if _UB_CACHE is None:
        import json
        from pathlib import Path

        p = Path(__file__).parent / "models" / "ub_cache.json"
        _UB_CACHE = json.loads(p.read_text()) if p.exists() else {}
    return _UB_CACHE


_UB_CACHE = None


def require_x64(what: str) -> None:
    """Refuse to run a bound that is only sound in float64 without x64:
    jnp.float64 silently becomes float32 when x64 is off (as it is on the
    GPU path), which would weaken the result without telling anyone."""
    import jax

    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            f"{what} needs float64: enable jax_enable_x64 (on the CPU "
            "backend, as tests/conftest.py does)")


DEFAULT_CONFIG = ArmourConfig()
