"""Experiment harness: world-suite generation, closed-loop runs, aggregation.

Covers the reference's kinova_src/scripts layer:
  * generate_world_suite  — kinova_create_random_worlds.m (100 scenes, 10 per
    obstacle count in {13,16,...,40}, CSV format of load_saved_world.m)
  * run_world_suite       — kinova_run_100_worlds.m (closed loop per scene,
    safety oracles, per-trial results)
  * summarize             — kinova_test_summary.m (bucket trials into
    collision / torque / ultimate-bound / joint-limit / goal / stuck;
    the paper's acceptance criterion is zero in the first four buckets)
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from .collision import pad_obstacles
from .config import ArmourConfig
from .planner import make_planner
from .robot import RobotModel
from .simulator import TrialSummary, run_trial, sample_true_params
from .worlds import World, load_world_csv, random_world, save_world_csv

DEFAULT_COUNTS = (13, 16, 19, 22, 25, 28, 31, 34, 37, 40)


def generate_world_suite(out_dir: str, robot: RobotModel,
                         counts: Sequence[int] = DEFAULT_COUNTS,
                         per_count: int = 10, seed: int = 0) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for n in counts:
        for i in range(per_count):
            w = random_world(rng, robot, n)
            path = os.path.join(out_dir, f"scene_{n:03d}_{i + 1:03d}.csv")
            save_world_csv(w, path)
            paths.append(path)
    return paths


@dataclasses.dataclass
class SuiteResult:
    world: str
    summary: TrialSummary

    def bucket(self) -> str:
        s = self.summary
        if s.collision:
            return "collision"
        if s.torque_exceeded:
            return "torque"
        if s.ultimate_bound_exceeded:
            return "ultimate_bound"
        if s.joint_limit_exceeded:
            return "joint_limit"
        if s.goal_reached:
            return "goal"
        return "stuck"


def run_world_suite(world_paths: Sequence[str], robot: RobotModel,
                    cfg: ArmourConfig, max_iterations: int = 500,
                    true_param_scale: Optional[float] = 1.0,
                    seed: int = 0, verbose: bool = True,
                    results_path: Optional[str] = None,
                    use_hlp: bool = False,
                    resume: bool = False) -> List[SuiteResult]:
    """resume=True: reload per-world results already present in results_path
    and skip those worlds — mid-run checkpoint/resume for long sweeps (the
    reference only has per-trial .mat dumps with no resume,
    kinova_run_100_worlds.m:188-192).  The per-world RNG substream is keyed
    by world index so resumed and fresh runs sample identical true params."""
    from .simulator import make_oracles, make_rollout

    done = {}
    if resume and results_path and os.path.exists(results_path):
        with open(results_path) as f:
            for d in json.load(f).get("results", []):
                name = d.pop("world")
                d.pop("bucket", None)
                done[name] = SuiteResult(world=name, summary=TrialSummary(**d))

    from .planner import make_rescue_planner

    step = make_planner(robot, cfg)
    rescue = make_rescue_planner(robot, cfg)
    rollout = make_rollout(robot, cfg)
    oracles = make_oracles(robot, cfg)
    results = []
    for i, path in enumerate(world_paths):
        name = os.path.basename(path)
        if name in done:
            results.append(done[name])
            continue
        world = load_world_csv(path)
        obs = pad_obstacles(
            world.obstacle_centers, world.obstacle_generators,
            cfg.max_obstacles, cfg.dtype,
        )
        tp = sample_true_params(robot, np.random.default_rng((seed, i)),
                                scale=true_param_scale)
        hlp = None
        if use_hlp:
            # the reference's benchmark HLP (kinova_run_100_worlds.m:148)
            from .hlp import EndEffectorRRTStarHLP

            hlp = EndEffectorRRTStarHLP(world, robot, lookahead=0.1,
                                        seed=seed + i)
        t0 = time.perf_counter()
        summary = run_trial(world, robot, cfg, step, obs, tp,
                            max_iterations=max_iterations,
                            rollout=rollout, oracles=oracles, hlp=hlp,
                            rescue_step=rescue)
        res = SuiteResult(world=os.path.basename(path), summary=summary)
        results.append(res)
        if verbose:
            print(
                f"{res.world}: {res.bucket()} iters={summary.iterations} "
                f"infeasible={summary.infeasible_plans} "
                f"wall={time.perf_counter() - t0:.1f}s",
                flush=True,
            )
        if results_path:
            save_results(results, results_path)
    return results


def run_world_suite_batched(world_paths: Sequence[str], robot: RobotModel,
                            cfg: ArmourConfig, max_iterations: int = 500,
                            true_param_scale: Optional[float] = 1.0,
                            seed: int = 0, verbose: bool = True,
                            results_path: Optional[str] = None,
                            extra_stats: Optional[dict] = None,
                            rescue_solver: bool = True,
                            guidance: str = "straight",
                            resume: bool = False,
                            second_pass: Optional[dict] = None
                            ) -> List[SuiteResult]:
    """All worlds advanced in lockstep on one device
    (batch_sim.run_trials_batched), instead of the serial per-world loop.
    extra_stats: merged into the saved batch_stats (e.g. the realtime-budget
    calibration record); rescue_solver/guidance pass through to
    run_trials_batched.

    resume=True: worlds already present in results_path are reloaded and
    only the missing ones run, as a sub-batch whose true params are drawn
    bit-identical to the fresh full run (tp_indices plumbing in
    batch_sim).

    second_pass: retry configuration for worlds the main batch leaves
    stuck — a dict of run_trials_batched overrides (plus optional 'cfg' and
    'seed' keys) applied to a sub-batch of just those worlds, with
    true-param parity to the main run.  Only retries that reach the goal
    with ZERO safety violations replace the original record; the swap is
    recorded per world in batch_stats['second_pass'] so the summary is
    auditable (measured variant selection: scripts/stuck_lab.py)."""
    from .batch_sim import run_trials_batched

    names = [os.path.basename(p) for p in world_paths]
    done: dict = {}
    if resume and results_path and os.path.exists(results_path):
        with open(results_path) as f:
            for d in json.load(f).get("results", []):
                name = d.pop("world")
                d.pop("bucket", None)
                d.pop("solvability", None)
                if name in names:
                    done[name] = SuiteResult(world=name,
                                             summary=TrialSummary(**d))
    todo = [i for i, n in enumerate(names) if n not in done]
    if not todo:
        return [done[n] for n in names]

    worlds = [load_world_csv(world_paths[i]) for i in todo]
    t0 = time.perf_counter()
    batch_stats: dict = dict(extra_stats or {})
    batch_stats["rescue_solver"] = rescue_solver
    batch_stats["guidance"] = guidance
    if done:
        batch_stats["resumed_worlds"] = len(done)
    summaries = run_trials_batched(
        worlds, robot, cfg, max_iterations=max_iterations,
        true_param_scale=true_param_scale, seed=seed, verbose=verbose,
        stats=batch_stats, rescue_solver=rescue_solver, guidance=guidance,
        tp_indices=(todo if done else None),
        tp_total=(len(names) if done else None),
    )
    fresh = {names[i]: s for i, s in zip(todo, summaries)}
    results = [
        done[n] if n in done else SuiteResult(world=n, summary=fresh[n])
        for n in names
    ]
    if second_pass is not None:
        stuck_idx = [i for i, r in enumerate(results)
                     if r.bucket() == "stuck"]
        if stuck_idx:
            sp = dict(second_pass)
            sp_cfg = sp.pop("cfg", cfg)
            sp_seed = sp.pop("seed", seed)
            retried = run_trials_batched(
                [load_world_csv(world_paths[i]) for i in stuck_idx],
                robot, sp_cfg, max_iterations=sp.pop("max_iterations",
                                                     max_iterations),
                true_param_scale=true_param_scale, seed=sp_seed,
                verbose=verbose, tp_indices=stuck_idx, tp_total=len(names),
                **sp)
            swapped = []
            for i, s in zip(stuck_idx, retried):
                safe = not (s.collision or s.torque_exceeded
                            or s.ultimate_bound_exceeded
                            or s.joint_limit_exceeded)
                if s.goal_reached and safe:
                    results[i] = SuiteResult(world=names[i], summary=s)
                    swapped.append(names[i])
            batch_stats["second_pass"] = {
                "attempted": len(stuck_idx),
                "recovered": swapped,
                "variant": {k: (repr(v)[:200] if k == "cfg" else v)
                            for k, v in second_pass.items()},
            }
            if verbose:
                print(f"second pass: {len(swapped)}/{len(stuck_idx)} stuck "
                      f"worlds recovered", flush=True)
    if verbose:
        print(f"batched suite: {len(worlds)} worlds in "
              f"{time.perf_counter() - t0:.1f}s  rescue_rate="
              f"{batch_stats.get('rescue_rate', 0.0):.3f} wall_share="
              f"{batch_stats.get('rescue_wall_share', 0.0):.3f}", flush=True)
    if results_path:
        save_results(results, results_path, batch_stats=batch_stats)
    return results


def robust_controller_sweep(robot: RobotModel, cfg: ArmourConfig,
                            uncertainties: Sequence[float] = (0.0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3),
                            controllers: Sequence[str] = ("robust", "althoff", "nominal"),
                            n_samples: int = 32, seed: int = 0,
                            results_path: Optional[str] = None) -> dict:
    """Tracking-error / robust-input sweep over model uncertainty
    (kinova_compare_robust_controller.m:18-35): for each uncertainty level,
    track a randomized reference (start offset from the reference anchor by
    0.025*pi in position and 0.05*pi in velocity, lines 80-86) with each
    controller and record max tracking error and mean |input|.

    The reference loops 100 MATLAB ode15s sims per level; here the samples
    are one vmapped rollout per (level, controller)."""
    import dataclasses as _dc

    import jax
    import jax.numpy as jnp

    from .simulator import make_rollout
    from .simulator import TrueParams
    from .trajectory import advance_plan, initial_plan

    rng = np.random.default_rng(seed)
    F = robot.num_factors
    out = {"uncertainties": list(uncertainties), "n_samples": n_samples,
           "controllers": {c: {"max_pos_err": [], "max_vel_err": [],
                               "mean_abs_u": []} for c in controllers}}

    # randomized anchor states and start offsets (same for every level)
    q_anchor = rng.uniform(-np.pi / 2, np.pi / 2, (n_samples, F))
    qd_anchor = rng.uniform(-0.3, 0.3, (n_samples, F))
    dq = rng.normal(size=(n_samples, F))
    dq = 0.025 * np.pi * dq / np.linalg.norm(dq, axis=1, keepdims=True)
    dqd = rng.normal(size=(n_samples, F))
    dqd = 0.05 * np.pi * dqd / np.linalg.norm(dqd, axis=1, keepdims=True)
    ks = rng.uniform(-1, 1, (n_samples, F))

    for u in uncertainties:
        robot_u = _dc.replace(robot, mass_uncertainty=u, inertia_uncertainty=u)
        # worst-case true params at this uncertainty level
        mass = jnp.asarray(np.broadcast_to(robot.mass * (1.0 + u), (n_samples, robot.num_joints)))
        inertia = jnp.asarray(np.broadcast_to(
            robot.inertia * (1.0 + u), (n_samples, robot.num_joints, 3, 3)))
        com = jnp.asarray(np.broadcast_to(robot.com, (n_samples, robot.num_joints, 3)))
        tp = TrueParams(mass=mass, inertia=inertia, com=com)

        refs = jax.vmap(lambda qa, qda, k: advance_plan(
            initial_plan(qa, cfg.dtype), k, qa, qda, jnp.zeros_like(qa), cfg))(
            jnp.asarray(q_anchor, cfg.dtype), jnp.asarray(qd_anchor, cfg.dtype),
            jnp.asarray(ks, cfg.dtype))
        q0 = jnp.asarray(q_anchor + dq, cfg.dtype)
        qd0 = jnp.asarray(qd_anchor + dqd, cfg.dtype)

        for ctrl in controllers:
            roll = jax.jit(jax.vmap(make_rollout(robot_u, cfg, controller=ctrl)))
            _, _, logs = roll(q0, qd0, refs, tp)
            pos_err = np.max(np.abs(np.asarray(logs["q"]) - np.asarray(logs["q_des"])))
            vel_err = np.max(np.abs(np.asarray(logs["qd"]) - np.asarray(logs["qd_des"])))
            mean_u = float(np.mean(np.abs(np.asarray(logs["u"]))))
            rec = out["controllers"][ctrl]
            rec["max_pos_err"].append(float(pos_err))
            rec["max_vel_err"].append(float(vel_err))
            rec["mean_abs_u"].append(mean_u)

    if results_path:
        out["provenance"] = _provenance()
        with open(results_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


def summarize(results: Sequence[SuiteResult]) -> dict:
    """kinova_test_summary.m:34-66 buckets."""
    buckets = {
        "goal": 0, "collision": 0, "torque": 0, "ultimate_bound": 0,
        "joint_limit": 0, "stuck": 0,
    }
    plan_times = []
    for r in results:
        buckets[r.bucket()] += 1
        plan_times.extend(r.summary.planning_times)
    out = dict(buckets)
    out["n_trials"] = len(results)
    if plan_times:
        out["mean_planning_time_s"] = float(np.mean(plan_times))
        out["max_planning_time_s"] = float(np.max(plan_times))
    out["safe"] = (
        out["collision"] == 0 and out["torque"] == 0
        and out["ultimate_bound"] == 0 and out["joint_limit"] == 0
    )
    # stuck attribution: which constraint group blocked the infeasible plans
    # of stuck trials, and how close those trials got to the goal
    blocked_total: dict = {}
    stuck_gd = []
    for r in results:
        if r.bucket() == "stuck":
            for g, c in (r.summary.blocked_counts or {}).items():
                blocked_total[g] = blocked_total.get(g, 0) + c
            if np.isfinite(r.summary.goal_distance_min):
                stuck_gd.append(r.summary.goal_distance_min)
    out["stuck_blocked_by"] = blocked_total
    if stuck_gd:
        out["stuck_goal_distance_min_mean"] = float(np.mean(stuck_gd))
    out["rescued_plans_total"] = int(
        sum(getattr(r.summary, "rescued_plans", 0) for r in results))
    return out


def _provenance() -> dict:
    """Producing command + commit + time embedded in every results file so
    an artifact can be matched to the code that generated it."""
    import subprocess
    import sys
    import time as _t

    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            timeout=10,
        ).stdout.strip()
    except Exception:
        commit = "unknown"
    return {
        "command": " ".join(sys.argv),
        "commit": commit,
        "generated_at": _t.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }


def save_results(results: Sequence[SuiteResult], path: str,
                 batch_stats: Optional[dict] = None) -> None:
    payload = []
    for r in results:
        d = dataclasses.asdict(r.summary)
        d["world"] = r.world
        d["bucket"] = r.bucket()
        d["planning_times"] = [float(x) for x in d["planning_times"]]
        payload.append(d)
    doc = {"results": payload, "summary": summarize(results),
           "provenance": _provenance()}
    if batch_stats:
        doc["batch_stats"] = batch_stats
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
