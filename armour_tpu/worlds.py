"""World loading, random world generation, and goal checking.

Covers load_saved_world.m (CSV scene format: row 1 start, row 2 goal, row 3
NaN separator, rows 4+ obstacle center xyz + side lengths, generators =
diag(side/2), box_obstacle_zonotope.m:22-26) and the rejection-sampled random
scene generator of kinova_create_random_worlds.m / kinova_world_static.m.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .robot import RobotModel

SAVED_WORLDS = Path(__file__).resolve().parents[1] / "saved_worlds"


@dataclasses.dataclass
class World:
    """goal_type: 'configuration' (default) checks the wrapped config-space
    norm against goal_radius; 'end_effector_location' checks the workspace
    distance of the EE to goal_in_workspace (kinova_world_static.m:417-446).
    For the EE mode, `goal` remains a configuration whose EE realises the
    workspace goal (used by HLP guidance); the CHECK is purely workspace."""

    start: np.ndarray            # [F]
    goal: np.ndarray             # [F]
    obstacle_centers: np.ndarray     # [n, 3]
    obstacle_generators: np.ndarray  # [n, 3, 3]
    goal_type: str = "configuration"
    goal_in_workspace: np.ndarray = None   # [3], EE mode only
    goal_radius: float = None              # defaults per goal_type

    @property
    def num_obstacles(self) -> int:
        return self.obstacle_centers.shape[0]


def load_world_csv(path: str) -> World:
    """Parse the reference's saved-world CSV format (load_saved_world.m)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(x) if x.lower() != "nan" else np.nan for x in line.split(",")])
    start = np.asarray(rows[0][:7])
    goal = np.asarray(rows[1][:7])
    centers, gens = [], []
    for r in rows[3:]:
        c = np.asarray(r[:3])
        side = np.asarray(r[3:6])
        if np.any(np.isnan(c)) or np.any(np.isnan(side)):
            continue
        centers.append(c)
        gens.append(np.diag(side / 2.0))
    return World(
        start=start,
        goal=goal,
        obstacle_centers=np.asarray(centers).reshape(-1, 3),
        obstacle_generators=np.asarray(gens).reshape(-1, 3, 3),
    )


def save_world_csv(world: World, path: str) -> None:
    with open(path, "w") as f:
        f.write(",".join(f"{x:.6g}" for x in world.start) + "\n")
        f.write(",".join(f"{x:.6g}" for x in world.goal) + "\n")
        f.write(",".join(["NaN"] * 7) + "\n")
        for c, g in zip(world.obstacle_centers, world.obstacle_generators):
            side = 2.0 * np.diag(g)
            f.write(",".join(f"{x:.6g}" for x in (*c, *side)) + "\n")


def _arm_sphere_centers(robot: RobotModel, q: np.ndarray) -> np.ndarray:
    """Link box centers along the arm (pure numpy FK: world generation is a
    host-side utility and must not pay device dispatch)."""
    fk_r = np.eye(3)
    fk_t = np.zeros(3)
    out = []
    for i in range(robot.num_joints):
        fk_t = fk_t + fk_r @ robot.trans[i]
        axis = int(robot.axes[i])
        R = np.eye(3)
        if axis != 0 and i < robot.num_factors:
            th = q[i] * (1.0 if axis > 0 else -1.0)
            c, si = np.cos(th), np.sin(th)
            a = abs(axis) - 1
            if a == 0:
                R = np.array([[1, 0, 0], [0, c, -si], [0, si, c]])
            elif a == 1:
                R = np.array([[c, 0, si], [0, 1, 0], [-si, 0, c]])
            else:
                R = np.array([[c, -si, 0], [si, c, 0], [0, 0, 1]])
        fk_r = fk_r @ robot.rot_mats[i] @ R
        out.append(fk_t + fk_r @ robot.link_center[i])
    return np.asarray(out)


def _aabb_clearance(point: np.ndarray, centers: np.ndarray, sides: np.ndarray) -> np.ndarray:
    """Distance from point to each axis-aligned box surface (negative inside)."""
    d = np.abs(point[None, :] - centers) - sides / 2.0
    outside = np.linalg.norm(np.maximum(d, 0.0), axis=1)
    inside = np.minimum(np.max(d, axis=1), 0.0)
    return outside + inside


def random_world(
    rng: np.random.Generator,
    robot: RobotModel,
    n_obstacles: int,
    obstacle_size_range: Tuple[float, float] = (0.01, 0.5),
    workspace_radius: float = 1.0,
    min_clearance: float = 0.15,
    max_tries: int = 200,
    ensure_solvable: bool = False,
) -> World:
    """Rejection-sampled random scene (kinova_create_random_worlds.m /
    kinova_world_static.m:151-305 behavior): random collision-free start and
    goal configurations, obstacles placed to keep clearance from both.

    ensure_solvable: additionally reject scenes with no unpadded
    configuration-space path from start to goal (solvability oracle,
    armour_tpu/solvability.py) — the reference's generator samples
    obstacles only around the two anchor poses, which can still seal the
    goal behind clutter at high obstacle counts; the plain rejection
    sampler cannot see that.  Costs seconds per scene; intended for suite
    (re)generation, not hot paths."""
    lb = np.where(robot.position_limits_lb < -100, -np.pi, robot.position_limits_lb)
    ub = np.where(robot.position_limits_ub > 100, np.pi, robot.position_limits_ub)

    start = rng.uniform(lb, ub)
    goal = rng.uniform(lb, ub)
    pts = np.concatenate(
        [_arm_sphere_centers(robot, start), _arm_sphere_centers(robot, goal)], axis=0
    )

    centers, gens = [], []
    tries = 0
    while len(centers) < n_obstacles and tries < max_tries * n_obstacles:
        tries += 1
        c = rng.uniform(-workspace_radius, workspace_radius, 3)
        c[2] = rng.uniform(0.1, workspace_radius)  # above the floor
        side = rng.uniform(*obstacle_size_range, 3)
        clear = min(
            float(np.min(_aabb_clearance(p, c[None], side[None]))) for p in pts
        )
        if clear > min_clearance:
            centers.append(c)
            gens.append(np.diag(side / 2.0))
    world = World(
        start=start,
        goal=goal,
        obstacle_centers=np.asarray(centers).reshape(-1, 3),
        obstacle_generators=np.asarray(gens).reshape(-1, 3, 3),
    )
    if ensure_solvable:
        from .solvability import classify_world

        v = classify_world(world, robot, seed=int(rng.integers(1 << 31)),
                           max_nodes=2000)
        if v["verdict"] in ("static_blocked", "no_path_found",
                            "frs_blocked_start", "frs_blocked_goal"):
            # provably (or high-confidence) impossible: resample the scene
            return random_world(rng, robot, n_obstacles, obstacle_size_range,
                                workspace_radius, min_clearance, max_tries,
                                ensure_solvable=True)
    return world


def goal_check(q: np.ndarray, goal: np.ndarray, goal_radius: float = np.pi / 30) -> bool:
    """Configuration-space goal test (kinova_world_static.goal_check,
    goal_type 'configuration')."""
    d = np.mod(q - goal + np.pi, 2 * np.pi) - np.pi
    return bool(np.linalg.norm(d) <= goal_radius)


def world_goal_check(world: World, q: np.ndarray, robot=None) -> bool:
    """Dispatch on world.goal_type (kinova_world_static.m:417-446):
    'configuration' -> wrapped config norm; 'end_effector_location' ->
    workspace EE distance to world.goal_in_workspace (default radius
    0.05 m)."""
    if world.goal_type == "configuration":
        r = world.goal_radius if world.goal_radius is not None else np.pi / 30
        return goal_check(q, world.goal, r)
    if world.goal_type == "end_effector_location":
        from .hlp import ee_position

        assert robot is not None, "EE goal mode needs the robot model"
        target = (world.goal_in_workspace if world.goal_in_workspace is not None
                  else ee_position(robot, np.asarray(world.goal, float)))
        r = world.goal_radius if world.goal_radius is not None else 0.05
        d = np.linalg.norm(ee_position(robot, np.asarray(q, float)) - target)
        return bool(d <= r)
    raise ValueError(f"goal type {world.goal_type} is not supported")


def straight_line_waypoint(q: np.ndarray, goal: np.ndarray, lookahead: float = 0.3,
                           continuous=None) -> np.ndarray:
    """Straight-line HLP (robot_arm_straight_line_HLP.m:45-57): step toward
    the goal.  ONLY continuous (full-rotate) joints take the wrapped angular
    difference (line 50 applies angdiff to full_rotate_joints alone); a
    LIMITED joint must use the plain difference — wrapping it points the
    waypoint through the joint-limit wall and wedges the arm against the
    limit (observed as consecutive infeasible plans in the 100-world suite).
    continuous: bool mask [F]; None (legacy) wraps every joint."""
    d = goal - q
    wrapped = np.mod(d + np.pi, 2 * np.pi) - np.pi
    if continuous is None:
        d = wrapped
    else:
        d = np.where(np.asarray(continuous, bool), wrapped, d)
    dist = np.linalg.norm(d)
    if dist <= lookahead:
        return q + d
    return q + d * (lookahead / dist)


def saved_world_paths(suite: str = "random") -> List[str]:
    """Sorted scene files of saved_worlds/<suite> ('random': 100 scenes,
    10 each at 13, 16, ..., 40 obstacles; 'reference': the reference's own
    100 scenes)."""
    paths = sorted(str(p) for p in (SAVED_WORLDS / suite).glob("*.csv"))
    if not paths:
        raise FileNotFoundError(f"no saved worlds under {SAVED_WORLDS / suite}")
    return paths


def planning_instances(robot: RobotModel, cfg, batch: int):
    """Inputs of `batch` planning steps on the saved random scenes:
    (q0, qd0, qdd0, q_des, obs), each with a leading [batch] axis and the
    obstacles padded to cfg.max_obstacles.

    The arm starts at rest at the scene's start; the waypoint comes from the
    end-effector RRT* HLP (lookahead 0.1, kinova_run_100_worlds.m settings)
    seeded by the row index.  Row i takes scene 13*i mod 100, so the first
    8 rows span 13 to 40 obstacles and the first 100 rows are distinct."""
    import jax
    import jax.numpy as jnp

    from .collision import pad_obstacles
    from .hlp import EndEffectorRRTStarHLP

    paths = saved_world_paths("random")
    worlds = [load_world_csv(paths[(13 * i) % len(paths)]) for i in range(batch)]
    q0 = np.stack([w.start for w in worlds])
    wps = np.stack([
        EndEffectorRRTStarHLP(w, robot, lookahead=0.1, seed=i)
        .get_waypoint(w.start)
        for i, w in enumerate(worlds)
    ])
    obs = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[pad_obstacles(w.obstacle_centers, w.obstacle_generators,
                        cfg.max_obstacles, cfg.dtype) for w in worlds],
    )
    zeros = jnp.zeros(q0.shape, cfg.dtype)
    return (jnp.asarray(q0, cfg.dtype), zeros, zeros,
            jnp.asarray(wps, cfg.dtype), obs)
