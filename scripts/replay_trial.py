"""Replay a recorded closed-loop trial (kinova_replay_trial.m equivalent).

Usage:
    python scripts/replay_trial.py trace.npz [out_prefix] [n_frames]

Reads the .npz written by simulator.run_trial(trace_path=...) and renders:
  * <out_prefix>_replay.png  — a grid of 3-D frames: obstacles, the actual
    arm skeleton (solid) vs the reference arm (dashed), start/goal EE marks;
    the frame closest to the first safety violation (if any) is highlighted
    (robot_arm_agent.m:1146-1210 plotting layer equivalent).
  * <out_prefix>_errors.png  — tracking error / input / violation timeline.

Also prints the first violating instant per oracle, so a failed trial can be
inspected without re-running anything.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import matplotlib  # noqa: E402

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from armour_tpu.config import ArmourConfig  # noqa: E402
from armour_tpu.models.kinova import kinova_gen3  # noqa: E402
from armour_tpu.rnea_numeric import forward_kinematics  # noqa: E402
from armour_tpu.simulator import obb_obb_separated, obstacle_axes_halves  # noqa: E402


def load_robot(name: str):
    if name == "kinova_gen3_7dof":
        return kinova_gen3()
    from armour_tpu.models import zoo

    return zoo.load_zoo_robot(name)


def box_edges(center, half, R=None):
    """12 edges of a box for wireframe plotting; R columns = axes."""
    s = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    corners = s * half[None, :]
    if R is not None:
        corners = corners @ R.T
    corners = corners + center[None, :]
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    return [(corners[a], corners[b]) for a, b in edges]


def first_violations(robot, cfg, q, qd, u, q_des, qd_des, obs_c, obs_g):
    """Index of the first violating sample per oracle (None if clean),
    recomputed from the logged trajectories (simulator_armtd.m:238-267)."""
    N = q.shape[0]
    R_w, p_w, centers = forward_kinematics(robot, jnp.asarray(q))
    R_w, centers = np.asarray(R_w), np.asarray(centers)
    link_h = np.asarray(robot.link_generators)
    oa, oh = obstacle_axes_halves(jnp.asarray(obs_g.reshape(-1, 3, 3)))
    sep = np.asarray(obb_obb_separated(
        jnp.asarray(centers)[:, :, None, :],
        jnp.asarray(R_w)[:, :, None, :, :],
        jnp.broadcast_to(jnp.asarray(link_h)[None, :, None, :],
                         centers[:, :, None, :].shape),
        jnp.asarray(obs_c.reshape(-1, 3))[None, None, :, :],
        oa[None, None], oh[None, None],
    ))
    hit = ~sep.all(axis=(1, 2))
    out = {}
    tl = np.asarray(robot.torque_limits)[: robot.num_factors]
    checks = {
        "collision": hit,
        "torque": (np.abs(u) > tl[None, :]).any(axis=1),
        "ultimate_bound": ((np.abs(q - q_des) > cfg.ub.qe)
                           | (np.abs(qd - qd_des) > cfg.ub.qde)).any(axis=1),
        "joint_limit": (
            (q < np.asarray(robot.position_limits_lb)[None, :]).any(axis=1)
            | (q > np.asarray(robot.position_limits_ub)[None, :]).any(axis=1)
            | (np.abs(qd) > np.asarray(robot.speed_limits)[None, :]).any(axis=1)
        ),
    }
    for name, mask in checks.items():
        idx = np.flatnonzero(mask)
        out[name] = int(idx[0]) if len(idx) else None
    return out


def draw_frame(ax, robot, q, q_ref, obs_c, obs_g, start_ee, goal_ee, title):
    for c, g in zip(obs_c.reshape(-1, 3), obs_g.reshape(-1, 3, 3)):
        half = np.abs(g).sum(axis=1)
        R = None
        n = np.linalg.norm(g, axis=0)
        if np.any(n > 0):
            R = g / np.where(n > 0, n, 1.0)
            half = n
        for a, b in box_edges(c, half, R):
            ax.plot(*zip(a, b), color="tab:red", lw=0.5, alpha=0.6)
    for qq, style, color in ((q, "-", "tab:blue"), (q_ref, "--", "tab:gray")):
        _, p_w, _ = forward_kinematics(robot, jnp.asarray(qq))
        pts = np.vstack([[0, 0, 0], np.asarray(p_w)])
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], style, color=color, lw=2,
                marker="o", ms=2)
    ax.scatter(*start_ee, color="tab:green", s=25, label="start")
    ax.scatter(*goal_ee, color="tab:purple", s=40, marker="*", label="goal")
    ax.set_title(title, fontsize=8)
    ax.set_xlim(-0.9, 0.9); ax.set_ylim(-0.9, 0.9); ax.set_zlim(0, 1.4)
    ax.set_box_aspect((1, 1, 0.8))
    ax.tick_params(labelsize=5)


def main():
    path = sys.argv[1]
    prefix = sys.argv[2] if len(sys.argv) > 2 else os.path.splitext(path)[0]
    n_frames = int(sys.argv[3]) if len(sys.argv) > 3 else 12

    tr = np.load(path, allow_pickle=False)
    robot = load_robot(str(tr["robot_name"]))
    cfg = ArmourConfig.for_robot(robot)
    I, S, F = tr["q"].shape
    q = tr["q"].reshape(I * S, F)
    qd = tr["qd"].reshape(I * S, F)
    u = tr["u"].reshape(I * S, F)
    q_des = tr["q_des"].reshape(I * S, F)
    qd_des = tr["qd_des"].reshape(I * S, F)
    dt = float(tr["trace_dt"])
    t = np.arange(I * S) * dt

    viol = first_violations(robot, cfg, q, qd, u, q_des, qd_des,
                            tr["obstacle_centers"], tr["obstacle_generators"])
    for name, idx in viol.items():
        print(f"{name}: " + (f"FIRST VIOLATION at t={idx * dt:.2f}s (sample {idx})"
                             if idx is not None else "clean"))

    # frame selection: uniform, plus the violating instant if any
    first = min([v for v in viol.values() if v is not None], default=None)
    sel = list(np.linspace(0, I * S - 1, n_frames).astype(int))
    if first is not None:
        sel[min(range(len(sel)), key=lambda i: abs(sel[i] - first))] = first

    _, p_w_s, _ = forward_kinematics(robot, jnp.asarray(tr["start"]))
    _, p_w_g, _ = forward_kinematics(robot, jnp.asarray(tr["goal"]))
    start_ee, goal_ee = np.asarray(p_w_s)[-1], np.asarray(p_w_g)[-1]

    rows = int(np.ceil(len(sel) / 4))
    fig = plt.figure(figsize=(3.2 * 4, 2.8 * rows))
    for fi, si in enumerate(sel):
        ax = fig.add_subplot(rows, 4, fi + 1, projection="3d")
        mark = " [VIOLATION]" if first is not None and si == first else ""
        draw_frame(ax, robot, q[si], q_des[si], tr["obstacle_centers"],
                   tr["obstacle_generators"], start_ee, goal_ee,
                   f"t={t[si]:.2f}s{mark}")
        if mark:
            ax.set_facecolor((1.0, 0.9, 0.9))
    fig.tight_layout()
    fig.savefig(f"{prefix}_replay.png", dpi=110)
    print(f"wrote {prefix}_replay.png")

    fig2, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    axes[0].plot(t, np.abs(q - q_des).max(axis=1), lw=1)
    axes[0].axhline(cfg.ub.qe, color="tab:red", ls="--", lw=1, label="qe bound")
    axes[0].set_ylabel("max |q - q_ref| (rad)"); axes[0].legend(fontsize=7)
    axes[1].plot(t, np.abs(qd - qd_des).max(axis=1), lw=1)
    axes[1].axhline(cfg.ub.qde, color="tab:red", ls="--", lw=1, label="qde bound")
    axes[1].set_ylabel("max |qd - qd_ref| (rad/s)"); axes[1].legend(fontsize=7)
    tl = np.asarray(robot.torque_limits)[: robot.num_factors]
    axes[2].plot(t, (np.abs(u) / tl[None, :]).max(axis=1), lw=1)
    axes[2].axhline(1.0, color="tab:red", ls="--", lw=1, label="torque limit")
    axes[2].set_ylabel("max |u| / limit"); axes[2].set_xlabel("t (s)")
    axes[2].legend(fontsize=7)
    for name, idx in viol.items():
        if idx is not None:
            for ax in axes:
                ax.axvline(idx * dt, color="tab:orange", lw=1, alpha=0.7)
    fig2.tight_layout()
    fig2.savefig(f"{prefix}_errors.png", dpi=110)
    print(f"wrote {prefix}_errors.png")

    if len(sys.argv) > 4 and sys.argv[4] == "gif":
        render_gif(f"{prefix}_replay.gif", robot, q, q_des, tr, t,
                   start_ee, goal_ee, first)


def render_gif(out_path, robot, q, q_des, tr, t, start_ee, goal_ee, first,
               max_frames: int = 60, fps: int = 10):
    """Animated replay (the reference's robot_arm_agent plotting/animation
    layer, robot_arm_agent.m:1146-1210 — MATLAB animates live; headless
    hosts export a GIF instead).  Pass 'gif' as the 4th CLI arg."""
    from matplotlib import animation

    sel = np.linspace(0, len(t) - 1, min(max_frames, len(t))).astype(int)
    fig = plt.figure(figsize=(5, 4.4))
    ax = fig.add_subplot(111, projection="3d")

    def update(fi):
        ax.cla()
        si = int(sel[fi])
        mark = " [VIOLATION]" if first is not None and si >= first else ""
        draw_frame(ax, robot, q[si], q_des[si], tr["obstacle_centers"],
                   tr["obstacle_generators"], start_ee, goal_ee,
                   f"t={t[si]:.2f}s{mark}")
        return []

    anim = animation.FuncAnimation(fig, update, frames=len(sel), blit=False)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
