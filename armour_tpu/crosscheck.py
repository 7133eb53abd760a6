"""Cross-checks of the float32 device path against float64 on the CPU.

The planner runs in float32 on the GPU.  These checks hold it to the same
code run in float64 on the CPU backend, in a child process, so that the
process holding the GPU never turns x64 on (which would change the program
under test):

  - stage outputs (JRS, FK and torque radii, hyperplane d and delta) agree
    within a relative 1e-4, the constraint-match criterion of BASELINE.md;
  - every k the device calls feasible is re-checked in float64 against the
    full constraint set (nlp.max_violations);
  - float64 samples of the desired trajectory, its nominal torques and its
    link centers lie inside the float32 reachable-set bands built at the
    default float_slop.

chip_smoke.py and the `gpu` tests run these checks.  The child is
`python -m armour_tpu.crosscheck IN.npz OUT_DIR` (see reference_worker).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from . import bezier, rnea_numeric
from .collision import (_COMBS, ObstacleSet, buffered_generators,
                        pair_cross)
from .config import ArmourConfig, require_x64
from .dynamics import rnea_pz
from .jrs import build_jrs
from .kinematics import forward_occupancy, reduce_links
from .nlp import max_violations
from .planner import build_problem, plan_step
from .pz import bpz

STAGE_RTOL = 1e-4
# A hyperplane's normal is the normalised cross product of two generators, so
# its float32 direction error grows as 1/sin(angle between them): rows of
# near-parallel pairs are ill-conditioned (any normal gives a sound
# halfspace there, but f32 and f64 pick different ones).  d and delta are
# compared on rows whose pair is at least this far from parallel, where the
# float32 direction error stays below ~1e-5.
HYP_MIN_SINE = 1e-2
STAGES = ("jrs_radius", "fk_radius", "torque_radius", "hyp_d", "hyp_delta")
BAND_GROUPS = ("qd", "qdda", "u", "fk")
# a moving initial state for the containment samples (nonzero velocity and
# acceleration exercise every Taylor and interval term of the JRS)
BAND_Q0 = np.array([0.6543, -0.0876, -0.4837, -1.2278, -1.5735, -1.0720, 0.0])
BAND_QD0 = np.array([0.1, -0.2, 0.15, 0.3, -0.1, 0.05, 0.2])
BAND_QDD0 = np.array([0.3, 0.1, -0.2, 0.1, 0.2, -0.1, 0.0])

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# what is compared
# ---------------------------------------------------------------------------


def stage_outputs(q0, qd0, qdd0, q_des, obs: ObstacleSet, robot, cfg, basis):
    """The arrays the stage comparison reads, for one planning instance."""
    jrs, prob = build_problem(q0, qd0, qdd0, q_des, obs, robot, cfg, basis)
    return stages_of(jrs, prob)


def stages_of(jrs, prob) -> dict:
    def radius(p):
        return jnp.sum(jnp.abs(p.egen), axis=-1) + p.rad

    return {
        "jrs_radius": jnp.stack([radius(jrs.qd), radius(jrs.qda),
                                 radius(jrs.qdda)]),
        "fk_radius": prob.frs.radius,
        "torque_radius": prob.torque.torque_radius,
        "hyp_d": prob.hyp.d,
        "hyp_delta": prob.hyp.delta,
    }


def hyp_conditioned(frs, obs: ObstacleSet) -> jnp.ndarray:
    """[C, N] mask of hyperplane rows whose generator pair is at least
    HYP_MIN_SINE from parallel."""
    G = buffered_generators(frs, obs)                        # [3, 9, N]
    cr = pair_cross(G)                                       # [3, C, N]
    norm = jnp.sqrt(jnp.sum(G * G, axis=0))                  # [9, N]
    lens = norm[_COMBS[:, 0]] * norm[_COMBS[:, 1]]           # [C, N]
    sine = jnp.sqrt(jnp.sum(cr * cr, axis=0))
    return sine >= HYP_MIN_SINE * lens


def relative_error(x, ref, mask=None) -> float:
    """max |x - ref| / max |ref| (the max-norm relative error) over the
    entries `mask` selects (all by default)."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    if mask is not None:
        x, ref = x[mask], ref[mask]
    scale = np.max(np.abs(ref), initial=0.0)
    err = np.max(np.abs(x - ref), initial=0.0)
    return float(err / scale) if scale > 0 else float(err)


def stage_errors(device: dict, reference: dict) -> dict:
    """Worst relative error of each stage over every instance; hyperplane
    rows only where reference["hyp_conditioned"] holds."""
    mask = reference["hyp_conditioned"]
    return {name: relative_error(device[name], reference[name],
                                 mask if name.startswith("hyp_") else None)
            for name in STAGES}


def violation_excess(viol, cfg: ArmourConfig):
    """How far each row's [torque, collision, state, grasp] max violations
    go beyond the feasibility thresholds (nlp.is_feasible); <= 0 is sound."""
    thr = np.array([cfg.torque_violation_threshold,
                    cfg.collision_violation_threshold, 1e-6,
                    cfg.grasp_violation_threshold])
    return np.max(np.asarray(viol, np.float64) - thr, axis=-1)


def f32_bands(q0, qd0, qdd0, t_inds, ks, robot, cfg, basis) -> dict:
    """Reachable-set bands (center, radius) at sampled (time cell, k):
    velocity, auxiliary acceleration, nominal torque and link centers.
    Jittable; t_inds [S], ks [S, F]."""
    jrs = build_jrs(q0, qd0, qdd0, robot, cfg, basis)
    frs = reduce_links(forward_occupancy(jrs, robot, cfg, basis), basis)
    u_nom = rnea_pz(jrs, robot, cfg, basis, uncertain=False)
    phis = jax.vmap(basis.phi)(jnp.asarray(ks, cfg.dtype))       # [S, B]
    out = {}
    for name, arr in (("qd", jrs.qd), ("qdda", jrs.qdda), ("u", u_nom)):
        pz = bpz.BPZ(arr.coef[t_inds], arr.egen[t_inds], arr.rad[t_inds])
        out[name] = bpz.slice_at(pz, phis[:, None, :])
    fk_c = jnp.einsum("sjab,sb->sja", frs.center_coef[t_inds], phis)
    fk_r = (jnp.sum(jnp.abs(frs.shape_gens[t_inds]), axis=-1)
            + frs.radius[t_inds])
    out["fk"] = (fk_c, fk_r)
    return out


def f64_truth(q0, qd0, qdd0, t_inds, ks, s_frac, robot, cfg) -> dict:
    """float64 ground truth at each sample: the desired trajectory at time
    (t_ind + s_frac) / T with parameter k, its nominal RNEA torque and the
    link centers."""
    require_x64("f64_truth")
    ds = 1.0 / cfg.num_time_steps
    s = (np.asarray(t_inds) + np.asarray(s_frac)) * ds
    k_act = np.asarray(ks) * np.asarray(cfg.k_range)
    Tqd0 = np.asarray(qd0) * cfg.duration
    TTqdd0 = np.asarray(qdd0) * cfg.duration ** 2

    def one(k, si):
        q = bezier.q_des(q0, Tqd0, TTqdd0, k, si)
        qd = bezier.qd_des(q0, Tqd0, TTqdd0, k, si) / cfg.duration
        qdd = bezier.qdd_des(q0, Tqd0, TTqdd0, k, si) / cfg.duration ** 2
        tau = rnea_numeric.rnea(robot, q, qd, qd, qdd)
        _, _, centers = rnea_numeric.forward_kinematics(robot, q)
        return {"qd": qd, "qdda": qdd, "u": tau, "fk": centers}

    out = jax.jit(jax.vmap(one))(jnp.asarray(k_act, jnp.float64),
                                 jnp.asarray(s, jnp.float64))
    return {k: np.asarray(v) for k, v in out.items()}


def containment_margins(bands: dict, truth: dict) -> dict:
    """max(|truth - center| - radius) per group; <= 0 means contained."""
    return {name: float(np.max(np.abs(truth[name] - np.asarray(bands[name][0], np.float64))
                               - np.asarray(bands[name][1], np.float64)))
            for name in BAND_GROUPS}


def band_samples(cfg: ArmourConfig, n: int, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    return {"t_inds": rng.integers(0, cfg.num_time_steps, n).astype(np.int32),
            "ks": rng.uniform(-1.0, 1.0, (n, 7)),
            "s_frac": rng.uniform(0.0, 1.0, n)}


# ---------------------------------------------------------------------------
# the checks, run on the default device against a Reference
# ---------------------------------------------------------------------------


def device_stage_errors(scenes, ref: "Reference", robot, cfg, basis) -> dict:
    """Stage outputs of `scenes` ([B]-batched planning inputs) on the device
    against the float64 reference: worst relative error per stage."""
    device = jax.jit(jax.vmap(
        lambda *a: stage_outputs(*a, robot, cfg, basis)))(*scenes)
    return stage_errors(device, ref.wait_for("stages"))


def recheck_excess(k, feasible, ref: "Reference", cfg) -> np.ndarray:
    """float64 excess over the thresholds of each device-feasible plan k
    [B, F] on the full constraint set (<= 0 is sound)."""
    feasible = np.asarray(feasible, bool)
    ks = np.where(feasible[:, None], np.asarray(k), 0.0)
    return violation_excess(ref.recheck(ks)["viol"], cfg)[feasible]


def device_band_margins(samples: dict, ref: "Reference", robot, cfg,
                        basis) -> dict:
    """float32 bands built on the device at the BAND_* state against the
    reference's float64 truth: worst margin per group (<= 0 contained)."""
    bands = jax.jit(lambda q0, qd0, qdd0, t, k: f32_bands(
        q0, qd0, qdd0, t, k, robot, cfg, basis))(
            *(jnp.asarray(x, jnp.float32)
              for x in (BAND_Q0, BAND_QD0, BAND_QDD0)),
            jnp.asarray(samples["t_inds"]),
            jnp.asarray(samples["ks"], jnp.float32))
    stages = ref.wait_for("stages")
    truth = {g: stages[f"truth_{g}"] for g in BAND_GROUPS}
    return containment_margins(jax.tree.map(np.asarray, bands), truth)


# ---------------------------------------------------------------------------
# the float64 child
# ---------------------------------------------------------------------------


def _obs_arrays(obs: ObstacleSet) -> dict:
    return {"obs_centers": np.asarray(obs.centers),
            "obs_generators": np.asarray(obs.generators),
            "obs_mask": np.asarray(obs.mask)}


class Reference:
    """The float64 CPU side, in a child process started early so that its
    compiles overlap the device's.

    inputs: the (q0, qd0, qdd0, q_des, obs) rows the device plans, with a
    leading batch axis; samples: band_samples().  cfg_overrides: ArmourConfig
    fields other than dtype (the flagship defaults when empty)."""

    def __init__(self, inputs, samples: dict, cfg_overrides: dict = None):
        self._dir = tempfile.TemporaryDirectory(prefix="armour_f64_")
        self.dir = Path(self._dir.name)
        q0, qd0, qdd0, q_des, obs = inputs
        np.savez(self.dir / "in.npz", q0=np.asarray(q0), qd0=np.asarray(qd0),
                 qdd0=np.asarray(qdd0), q_des=np.asarray(q_des),
                 **_obs_arrays(obs), **samples,
                 cfg=json.dumps(cfg_overrides or {}))
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "armour_tpu.crosscheck",
             str(self.dir / "in.npz"), str(self.dir)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=str(REPO), env=env)
        self._seen = set()
        self._loaded = {}

    def wait_for(self, tag: str) -> dict:
        """Block until the child has written `tag`.npz; return its arrays."""
        while tag not in self._seen:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"float64 reference exited (rc={self.proc.wait()}) "
                    f"before writing {tag}")
            self._seen.add(line.strip())
        if tag not in self._loaded:
            self._loaded[tag] = dict(np.load(self.dir / f"{tag}.npz"))
        return self._loaded[tag]

    def recheck(self, ks) -> dict:
        """float64 max violations [B, 4] of the device's ks [B, F]."""
        np.save(self.dir / "ks.npy", np.asarray(ks))
        self.proc.stdin.write("ks.npy\n")
        self.proc.stdin.flush()
        return self.wait_for("recheck")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._dir.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def reference_worker(in_path: str, out_dir: str) -> None:
    """Child main: float64 on the CPU backend.

    Writes OUT_DIR/stages.npz (stage arrays and band truth), then
    OUT_DIR/plans.npz (the float64 planner's k, feasible, cost), printing
    the tag after each; then reads one line from stdin naming an .npy of
    ks [B, F] under OUT_DIR and writes OUT_DIR/recheck.npz (viol [B, 4])."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # a shared persistent cache can hold CPU executables built for another
    # host's instruction set; the reference compiles its own
    jax.config.update("jax_enable_compilation_cache", False)
    from .models.kinova import kinova_gen3
    from .pz.basis import make_basis

    data = np.load(in_path)
    out = Path(out_dir)
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=jnp.float64, **json.loads(str(data["cfg"])))
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    f64 = lambda name: jnp.asarray(data[name], jnp.float64)
    obs = ObstacleSet(centers=f64("obs_centers"),
                      generators=f64("obs_generators"),
                      mask=jnp.asarray(data["obs_mask"]))
    args = (f64("q0"), f64("qd0"), f64("qdd0"), f64("q_des"), obs)

    def problem(q0, qd0, qdd0, q_des, o):
        jrs, prob = build_problem(q0, qd0, qdd0, q_des, o, robot, cfg, basis)
        return prob, dict(stages_of(jrs, prob),
                          hyp_conditioned=hyp_conditioned(prob.frs, o))

    probs, stages = jax.jit(jax.vmap(problem))(*args)
    truth = f64_truth(BAND_Q0, BAND_QD0, BAND_QDD0, data["t_inds"],
                      data["ks"], data["s_frac"], robot, cfg)
    np.savez(out / "stages.npz", **{k: np.asarray(v) for k, v in stages.items()},
             **{f"truth_{k}": v for k, v in truth.items()})
    print("stages", flush=True)

    plan = jax.jit(jax.vmap(
        lambda a, b, c, d, o: plan_step(a, b, c, d, o, robot, cfg, basis)))
    res = plan(*args)
    np.savez(out / "plans.npz", k=np.asarray(res.k),
             feasible=np.asarray(res.feasible), cost=np.asarray(res.cost))
    print("plans", flush=True)

    name = sys.stdin.readline().strip()
    ks = jnp.asarray(np.load(out / name), jnp.float64)
    viol = jax.jit(jax.vmap(
        lambda k, p: jnp.stack(max_violations(k, p, robot, cfg, basis))))(
            ks, probs)
    np.savez(out / "recheck.npz", viol=np.asarray(viol))
    print("recheck", flush=True)


if __name__ == "__main__":
    reference_worker(sys.argv[1], sys.argv[2])
