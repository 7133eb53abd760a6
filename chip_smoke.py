"""Smoke run of the planner on the GPU, at the flagship width.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # the sharded planner over four cards
                                     # and its one-card comparison, only

Flagship: Kinova Gen3 (7 DOF), ArmourConfig(dtype=float32) defaults (128
time steps, 40 obstacles, 4096 screened rows, 4x3 ALM with 4 seeds culled
to 2), real scenes from saved_worlds with EE-RRT* waypoints.

One card, in order:
  1. device: platform, kind, count, the card's name and power limit; no GPU
     is a failure (there is no CPU fallback);
  2. compile the flagship plan_step at batch 1 and batch 64;
  3. plan 8 scenes (13-40 obstacles); compare the stage outputs with the
     same code in float64 on the CPU (a child process), re-check every
     feasible k in float64 against the full constraint set, and print the
     feasible counts of both;
  4. the batch-64 planner; its first 8 rows must match phase 3;
  5. float64 samples inside the float32 reachable-set bands on the device;
  6. the closed loop (batch_sim) on 8 reference worlds, 20 iterations, with
     zero oracle violations;
  7. batch-1 p50/p99 and the batch-64 step time (information only).
The last line is {"ok": true, "device": {...}}; any failed check exits
non-zero before it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

N_SCENES = 8
BATCH = 64
N_BAND_SAMPLES = 128
LOOP_WORLDS = 8
LOOP_ITERS = 20
LATENCY_REPS = 5
K_ATOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rows(inputs, sel):
    import jax

    return jax.tree.map(lambda x: x[sel], inputs)


def compile_step(fn, args, label: str):
    """AOT-compile fn at args; print compile seconds and memory analysis."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    dt = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    sizes = " ".join(f"{f.replace('_size_in_bytes', '')}="
                     f"{getattr(mem, f, 'n/a')}" for f in fields)
    print(f"compile {label}: {dt:.2f} s; memory_analysis: {sizes}", flush=True)
    return compiled


def same_plans(k_a, feas_a, k_b, feas_b) -> tuple:
    """(feasibility identical, worst |k_a - k_b| over feasible rows)."""
    feas_a, feas_b = np.asarray(feas_a), np.asarray(feas_b)
    same_feas = bool(np.array_equal(feas_a, feas_b))
    both = feas_a & feas_b
    dk = float(np.max(np.abs(np.asarray(k_a)[both] - np.asarray(k_b)[both]),
                      initial=0.0))
    return same_feas, dk


def run_one_card(cfg_overrides=None, n_scenes=N_SCENES, batch=BATCH,
                 n_samples=N_BAND_SAMPLES, loop_worlds=LOOP_WORLDS,
                 loop_iters=LOOP_ITERS, reps=LATENCY_REPS, card=""):
    """Phases 2-7 on jax.devices()[0]; cfg_overrides shrink the flagship
    config for rehearsals.  Returns a dict of the phase results."""
    import jax
    import jax.numpy as jnp

    from armour_tpu import crosscheck as xc
    from armour_tpu.batch_sim import run_trials_batched
    from armour_tpu.config import ArmourConfig
    from armour_tpu.models.kinova import kinova_gen3
    from armour_tpu.planner import plan_step
    from armour_tpu.pz.basis import make_basis
    from armour_tpu.utils.timing import device_trace, timed
    from armour_tpu.worlds import (load_world_csv, planning_instances,
                                   saved_world_paths)

    overrides = dict(cfg_overrides or {})
    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=jnp.float32, **overrides)
    basis = make_basis(robot.num_factors, cfg.max_poly_degree)
    report = {}

    def fn(q0, qd0, qdd0, q_des, obs):
        return plan_step(q0, qd0, qdd0, q_des, obs, robot, cfg, basis)

    inputs = planning_instances(robot, cfg, batch)
    scenes = rows(inputs, slice(0, n_scenes))
    samples = xc.band_samples(cfg, n_samples)
    with xc.Reference(scenes, samples, overrides) as ref:
        # -- 2. compile ---------------------------------------------------
        step1 = compile_step(fn, rows(inputs, 0), "plan_step batch 1")
        step_b = compile_step(jax.vmap(fn), inputs, f"plan_step batch {batch}")

        # -- 3. plan and compare ------------------------------------------
        res1 = [step1(*rows(scenes, i)) for i in range(n_scenes)]
        k1 = np.stack([np.asarray(r.k) for r in res1])
        feas1 = np.array([bool(r.feasible) for r in res1])
        errs = xc.device_stage_errors(scenes, ref, robot, cfg, basis)
        share = ref.wait_for("stages")["hyp_conditioned"].mean()
        print("stage rel. error vs f64 (max-norm): " + " ".join(
            f"{k}={v:.3e}" for k, v in errs.items())
            + f" (hyperplane rows compared: {share:.4f} of all)", flush=True)
        check(all(v <= xc.STAGE_RTOL for v in errs.values()),
              f"stage outputs differ from f64 by more than {xc.STAGE_RTOL}: {errs}")
        excess = xc.recheck_excess(k1, feas1, ref, cfg)
        worst = float(np.max(excess, initial=-np.inf))
        print(f"f64 re-check of {int(feas1.sum())} device-feasible plans: "
              f"worst excess over thresholds {worst:.3e}", flush=True)
        check(bool(np.all(excess <= 0.0)),
              f"device-feasible plans violate in f64: {excess}")
        plans64 = ref.wait_for("plans")
        print(f"feasible: device f32 {int(feas1.sum())}/{n_scenes}, "
              f"cpu f64 {int(plans64['feasible'].sum())}/{n_scenes}; "
              f"rows that differ: "
              f"{np.flatnonzero(feas1 != plans64['feasible']).tolist()}",
              flush=True)
        report.update(stage_errors=errs, recheck_worst=worst,
                      feasible_device=int(feas1.sum()),
                      feasible_f64=int(plans64["feasible"].sum()))

        # -- 4. batch ----------------------------------------------------
        out_b = step_b(*inputs)
        same, dk = same_plans(np.asarray(out_b.k)[:n_scenes],
                              np.asarray(out_b.feasible)[:n_scenes], k1, feas1)
        print(f"batch {batch}: {int(np.sum(np.asarray(out_b.feasible)))}/{batch} "
              f"feasible; rows 0-{n_scenes - 1} vs batch 1: feasibility "
              f"{'identical' if same else 'DIFFERS'}, max |dk| {dk:.3e}",
              flush=True)
        check(same and dk <= K_ATOL, "batch planner disagrees with batch 1")

        # -- 5. f32 containment ------------------------------------------
        margins = xc.device_band_margins(samples, ref, robot, cfg, basis)
        print(f"f32 bands vs {n_samples} f64 samples (float_slop="
              f"{cfg.float_slop}), worst margin (<= 0 contained): " + " ".join(
                  f"{k}={v:.3e}" for k, v in margins.items()), flush=True)
        check(all(v <= 0.0 for v in margins.values()),
              f"f64 samples outside the f32 bands: {margins}")
        report["containment"] = margins

    # -- 6. closed loop ----------------------------------------------------
    worlds = [load_world_csv(p)
              for p in saved_world_paths("reference")[:loop_worlds]]
    t0 = time.perf_counter()
    trials = run_trials_batched(worlds, robot, cfg, max_iterations=loop_iters,
                                rescue_solver=False, guidance="auto")
    loop_s = time.perf_counter() - t0
    flags = ("collision", "torque_exceeded", "ultimate_bound_exceeded",
             "joint_limit_exceeded")
    n_viol = sum(int(getattr(t, f)) for t in trials for f in flags)
    print(f"closed loop: {loop_worlds} reference worlds x {loop_iters} "
          f"iterations in {loop_s:.1f} s (compiles included): goal "
          f"{sum(t.goal_reached for t in trials)}, stuck "
          f"{sum(t.stuck for t in trials)}, oracle violations {n_viol}",
          flush=True)
    check(n_viol == 0, "closed-loop oracles reported violations")
    report["loop_violations"] = n_viol

    # -- 7. timings (information, not a benchmark) -------------------------
    lat = []
    for i in range(n_scenes):
        lat += timed(step1, *rows(scenes, i), iters=reps)[0]
    t_b = timed(step_b, *inputs, iters=reps)[0]
    p50, p99 = np.percentile(lat, [50, 99])
    print(f"timing [{card}]: batch 1 p50 {p50 * 1e3:.2f} ms p99 "
          f"{p99 * 1e3:.2f} ms over {len(lat)} calls; batch {batch} median "
          f"{np.median(t_b) * 1e3:.2f} ms", flush=True)
    tr = device_trace(step1, *rows(scenes, 0), steps=reps)
    if "idle_share" in tr:
        print(f"batch 1 device trace over {reps} steps [{card}]: "
              f"{tr['events'] // reps} kernels/step, kernel window "
              f"{tr['window_ns'] / 1e6:.3f} ms, busy {tr['busy_ns'] / 1e6:.3f} "
              f"ms, idle share {tr['idle_share']:.4f}; top kernels: "
              + "; ".join(f"{n} {t / 1e6:.3f} ms" for n, t in tr["top"]),
              flush=True)
    else:
        print(f"batch 1 device trace: idle share not measured (no GPU "
              f"kernel events); trace lines: {tr['lines']}", flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak device memory: {stats.get('peak_bytes_in_use', 'n/a')} bytes",
          flush=True)
    report.update(p50_s=float(p50), p99_s=float(p99),
                  batch_s=float(np.median(t_b)))
    return report


def run_four_cards(devices, n_scenes=N_SCENES, cfg_overrides=None):
    """The sharded planner over a 1-D mesh of the given devices and its
    psum summary, against the one-card batch planner on the same rows, at
    the same per-card batch."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from armour_tpu.config import ArmourConfig
    from armour_tpu.models.kinova import kinova_gen3
    from armour_tpu.planner import make_batch_planner

    robot = kinova_gen3()
    cfg = ArmourConfig(dtype=jnp.float32, **(cfg_overrides or {}))
    args, out, summary = ge.sharded_run(devices, robot, cfg, n_scenes)
    # One card plans the same rows at the per-card batch: XLA compiles a
    # different program for each batch size, and the ALM's fixed iterations
    # amplify their f32 rounding differences (max |dk| 1.1e-3 between one
    # batch of 8 and batches of 2 on an H100), which says nothing about the
    # sharding under test.
    per = n_scenes // len(devices)
    one = make_batch_planner(robot, cfg)
    res = [one(*jax.device_put(rows(args, slice(i, i + per)), devices[0]))
           for i in range(0, n_scenes, per)]
    same, dk = same_plans(out.k, out.feasible,
                          np.concatenate([np.asarray(r.k) for r in res]),
                          np.concatenate([np.asarray(r.feasible) for r in res]))
    print(f"{len(devices)} cards: {int(summary['n_feasible'])}/"
          f"{int(summary['n_total'])} feasible; vs one card: feasibility "
          f"{'identical' if same else 'DIFFERS'}, max |dk| {dk:.3e}",
          flush=True)
    check(int(summary["n_total"]) == n_scenes, "psum summary lost rows")
    check(same and dk <= K_ATOL, "sharded planner disagrees with one card")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()

    from armour_tpu.utils.cache import enable_persistent_cache
    from armour_tpu.utils.device import card_name_and_power_limit, require_gpu

    devices = require_gpu(args.cards)
    card = card_name_and_power_limit()
    print(f"compile cache: {enable_persistent_cache()}", flush=True)
    if args.cards == 4:
        run_four_cards(devices[:4])
    else:
        run_one_card(card=card)
    print(f"wall: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
