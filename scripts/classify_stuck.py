"""Attach solvability verdicts to the stuck trials of a suite results file.

Usage: python scripts/classify_stuck.py results_worlds.json saved_worlds/random

Pure-geometry offline oracle (no device, no planner under test): see
armour_tpu/solvability.py for the verdict classes.
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import json


def main():
    results = sys.argv[1] if len(sys.argv) > 1 else "results_worlds.json"
    world_dir = sys.argv[2] if len(sys.argv) > 2 else "saved_worlds/random"
    from armour_tpu.models.kinova import kinova_gen3
    from armour_tpu.solvability import annotate_results

    hist = annotate_results(results, world_dir, kinova_gen3())
    print(json.dumps({"stuck_solvability": hist}))


if __name__ == "__main__":
    main()
