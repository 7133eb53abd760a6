"""Regenerate armour_tpu/models/ub_cache.json — per-robot UltimateBound
constants (mass-matrix eigenvalue bracket + co-derived V_max/eps).

The derivation (config.derive_ultimate_bound) costs a few seconds of jit +
eigensolve per robot; caching keeps ArmourConfig.for_robot() instant.
Run after changing zoo_data.json or the derivation itself:

    python scripts/derive_ub_cache.py
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

# run on the host CPU in float64: the eigenvalue bracket and the certified
# bounds need f64 (config.require_x64)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from armour_tpu.config import _ub_cache_key, derive_ultimate_bound  # noqa: E402
from armour_tpu.models import zoo  # noqa: E402
from armour_tpu.models.kinova import kinova_gen3  # noqa: E402


WAIVER = (
    "m_min is the SAMPLED heuristic, not certified: this arm's URDF carries "
    "no transmission/rotor inertia, so lambda_min(M) ~ 1e-3 is dominated by "
    "the bare wrist-link inertia and is nearly FLAT over the joint box "
    "(flatness evidence: sampled_min vs sampled_p05/p50 below), which makes "
    "sampling low-variance but puts a certified-positive interval bound out "
    "of reach (the B&B enclosure certifies 0).  Backstop: the closed-loop "
    "ultimate_bound oracle (simulator.py) checks the realized tracking "
    "error on every move."
)


def _flatness(r, n=4096, seed=1):
    """min / 5th pct / median of sampled lambda_min(M): near-equal values
    mean the minimum is achieved on a flat manifold, so the sampled bound
    has low variance (the waiver's quantitative evidence)."""
    import numpy as np

    from armour_tpu import rnea_numeric

    rng = np.random.default_rng(seed)
    lo = np.maximum(r.position_limits_lb, -3.141592653589793)
    hi = np.minimum(r.position_limits_ub, 3.141592653589793)
    qs = rng.uniform(lo, hi, (n, r.num_factors))
    import jax.numpy as jnp

    M = np.asarray(rnea_numeric.mass_matrix(r, jnp.asarray(qs, jnp.float64)))
    ev = np.linalg.eigvalsh(M)[..., 0]
    return {"sampled_min": float(ev.min()),
            "sampled_p05": float(np.percentile(ev, 5)),
            "sampled_p50": float(np.percentile(ev, 50)),
            "n_samples": n}


def main():
    out = {}
    robots = [kinova_gen3()] + [zoo.load_zoo_robot(n) for n in zoo.list_robots()]
    for r in robots:
        t0 = time.perf_counter()
        ub, prov = derive_ultimate_bound(r, use_cache=False,
                                         return_provenance=True)
        dt = time.perf_counter() - t0
        if not prov["certified"]:
            prov["waiver"] = WAIVER
            prov["flatness"] = _flatness(r)
        key = _ub_cache_key(r, 10.0, 5.0, 512, 0, 0.1, 0.4)
        out[key] = {**dataclasses.asdict(ub), "provenance": prov}
        print(f"{r.name}: m_min={ub.m_min:.4g} "
              f"({'CERTIFIED' if prov['certified'] else 'sampled/waived'}) "
              f"m_max={ub.m_max:.4g} v_max={ub.v_max:.4g} eps={ub.eps:.4g} "
              f"qde={ub.qde:.4g} "
              f"min_speed={float(min(r.speed_limits)):.4g}  [{dt:.1f}s]")

    p = Path(__file__).resolve().parent.parent / "armour_tpu" / "models" / "ub_cache.json"
    p.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {p}")


if __name__ == "__main__":
    main()
