"""Obstacle buffering, zonotope->H-polytope hyperplanes, collision constraints.

JAX equivalent of CollisionChecking.cu: for every (time, link,
obstacle) the obstacle box is buffered with the link's 6 k-independent
generators (3 rotated shape generators + 3 interval radii,
bufferObstaclesKernel, CollisionChecking.cu:136-167), the buffered zonotope's
H-representation is built from the 36 cross products of generator pairs
(polytope_PH, CollisionChecking.cu:169-228), and the constraint is the signed
distance of the k-sliced link center outside that polytope
(checkCollisionKernel, CollisionChecking.cu:230-299):

    g = -max_c ( +-(A_c . p(k) - d_c) - delta_c )  <= 0   (safe)

The reference launches CUDA kernels over a (128 x n_obs) grid with 36
threads; here the whole thing is batched dense tensor arithmetic, and the
per-iteration evaluation is a single contraction of the link k-polynomials
with phi(k).

Layout notes:
- every array keeps the huge fused (T*J*O) axis LAST; the coordinate axis
  (3) leads so the trailing two dims are (C=36, N) / (9, N), and no
  trailing size-3 axis is padded out.  This layout was chosen for another
  accelerator's tiling; whether it suits the GPU is not measured yet.
- all contractions over the tiny axes (3 coords, 9 generators) are written
  as unrolled elementwise multiply-adds, not einsum/dot, so XLA fuses them
  with the surrounding elementwise work and no small dot_general can run
  at reduced matmul precision.
- the solver hot loop shares the T*J distinct link-center polynomials
  across all screened rows via a row->link gather (ScreenedCollision.row)
  instead of copying the [3, B] coefficients into every row, cutting the
  per-iteration HBM traffic ~B/3-fold.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np

from .kinematics import LinkFRS
from .pz.basis import KBasis

BIG = 1e8
# 9 buffered generators -> C(9,2) = 36 combinations (CollisionChecking.h:6-7)
N_BUF_GEN = 9
_COMBS = np.array(list(itertools.combinations(range(N_BUF_GEN), 2)), dtype=np.int32)
N_COMB = len(_COMBS)  # 36


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ObstacleSet:
    """Padded box-obstacle zonotopes.  centers [O, 3], generators [O, 3, 3]
    (columns = generators), mask [O] (True = real obstacle)."""

    centers: jnp.ndarray
    generators: jnp.ndarray
    mask: jnp.ndarray


def pad_obstacles(centers, generators, max_obstacles: int, dtype=jnp.float32) -> ObstacleSet:
    centers = np.asarray(centers, dtype=np.float64).reshape(-1, 3)
    generators = np.asarray(generators, dtype=np.float64).reshape(-1, 3, 3)
    n = centers.shape[0]
    assert n <= max_obstacles
    c = np.zeros((max_obstacles, 3))
    g = np.zeros((max_obstacles, 3, 3))
    m = np.zeros(max_obstacles, dtype=bool)
    c[:n] = centers
    g[:n] = generators
    m[:n] = True
    return ObstacleSet(
        centers=jnp.asarray(c, dtype),
        generators=jnp.asarray(g, dtype),
        mask=jnp.asarray(m),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Hyperplanes:
    """Precomputed polytope data; N = T*J*O flattened, C = 36 combos."""

    A: jnp.ndarray      # [3, C, N] unit normals (0 for degenerate pairs)
    d: jnp.ndarray      # [C, N]
    delta: jnp.ndarray  # [C, N]
    dims: tuple = dataclasses.field(metadata=dict(static=True))  # (T, J, O)


def _dot3(a, b):
    """Unrolled 3-coordinate dot product: a, b [3, ...] -> [...]."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def buffered_generators(frs: LinkFRS, obs: ObstacleSet) -> jnp.ndarray:
    """The 9 generators of every buffered obstacle (3 obstacle, 3 rotated
    link-shape, 3 interval radii), [3, 9, N] with N = T*J*O flattened
    (bufferObstaclesKernel, CollisionChecking.cu:136-167)."""
    T, J = frs.radius.shape[:2]
    O = obs.centers.shape[0]
    N = T * J * O
    dt = frs.radius.dtype
    obs_g = jnp.broadcast_to(obs.generators[None, None], (T, J, O, 3, 3))
    shape_g = jnp.broadcast_to(frs.shape_gens[:, :, None], (T, J, O, 3, 3))
    rad_diag = frs.radius[:, :, None, :, None] * jnp.eye(3, dtype=dt)
    rad_g = jnp.broadcast_to(rad_diag, (T, J, O, 3, 3))
    # [T,J,O,3,9] -> [3, 9, N] (huge axis last)
    G = jnp.concatenate([obs_g, shape_g, rad_g], axis=-1)
    return jnp.moveaxis(G.reshape(N, 3, N_BUF_GEN), 0, -1)


def pair_cross(G: jnp.ndarray) -> jnp.ndarray:
    """Cross products of the 36 generator pairs: [3, 9, N] -> [3, C, N]."""
    ga = G[:, _COMBS[:, 0], :]          # [3, C, N]
    gb = G[:, _COMBS[:, 1], :]
    return jnp.stack([
        ga[1] * gb[2] - ga[2] * gb[1],
        ga[2] * gb[0] - ga[0] * gb[2],
        ga[0] * gb[1] - ga[1] * gb[0],
    ])


def build_hyperplanes(frs: LinkFRS, obs: ObstacleSet) -> Hyperplanes:
    """Buffer + polytope construction, once per plan
    (CollisionChecking.cu:74-228)."""
    T, J = frs.radius.shape[:2]
    O = obs.centers.shape[0]
    N = T * J * O
    G = buffered_generators(frs, obs)                        # [3, 9, N]
    cr = pair_cross(G)                                       # [3, C, N]
    n2 = _dot3(cr, cr)
    inv = jnp.where(n2 > 0, jax.lax.rsqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)
    A = cr * inv[None]                  # [3, C, N] unit normals
    # delta[c, n] = sum_g |sum_a A[a,c,n] G[a,g,n]|  (fused reduce over g)
    AG = (A[0][:, None] * G[0][None] + A[1][:, None] * G[1][None]
          + A[2][:, None] * G[2][None])                      # [C, 9, N]
    delta = jnp.sum(jnp.abs(AG), axis=1)                     # [C, N]
    cb = jnp.broadcast_to(obs.centers.T[:, None, None, :], (3, T, J, O)).reshape(3, N)
    d = _dot3(A, cb[:, None, :])                             # [C, N]
    return Hyperplanes(A=A, d=d, delta=delta, dims=(T, J, O))


def eval_link_polys(frs: LinkFRS, phi: jnp.ndarray) -> jnp.ndarray:
    """Sliced link centers for all (time, link) cells: [3, T*J]
    (NLPclass.cu:304-315).  Written as an fp32 matmul (precision pinned:
    at default precision the GPU may evaluate it in TF32)."""
    T, J = frs.center_coef.shape[:2]
    B = frs.center_coef.shape[-1]
    p = frs.center_coef.reshape(T * J * 3, B) @ phi.astype(frs.center_coef.dtype)
    return jnp.moveaxis(p.reshape(T * J, 3), -1, 0)          # [3, TJ]


def eval_link_poly_grads(frs: LinkFRS, dphi: jnp.ndarray) -> jnp.ndarray:
    """d(link centers)/dk for all cells: [3, F, T*J]."""
    T, J = frs.center_coef.shape[:2]
    B = frs.center_coef.shape[-1]
    F = dphi.shape[-1]
    dp = frs.center_coef.reshape(T * J * 3, B) @ dphi        # [TJ*3, F]
    return jnp.moveaxis(dp.reshape(T * J, 3, F), 0, -1)      # [3, F, TJ]


def collision_constraints(hyp: Hyperplanes, obs: ObstacleSet, p_all: jnp.ndarray):
    """Full constraint values g [T, J, O] (<= 0 safe) over every row, from
    the per-cell sliced centers p_all [3, T*J] (checkCollisionKernel
    semantics; used by the final feasibility re-check)."""
    T, J, O = hyp.dims
    N = T * J * O
    A = hyp.A                                              # [3, C, N]
    pb = jnp.broadcast_to(
        p_all.reshape(3, T, J, 1), (3, T, J, O)
    ).reshape(3, 1, N)
    Ap = _dot3(A, pb)                                      # [C, N]
    ok = jnp.abs(A[0]) + jnp.abs(A[1]) + jnp.abs(A[2]) > 0
    pos = jnp.where(ok, Ap - (hyp.d + hyp.delta), -BIG)
    neg = jnp.where(ok, -Ap - (-hyp.d + hyp.delta), -BIG)
    m = jnp.maximum(jnp.max(pos, axis=0), jnp.max(neg, axis=0))   # [N]
    mask = jnp.broadcast_to(obs.mask[None, None, :], (T, J, O)).reshape(N)
    g = jnp.where(mask, -m, -BIG)
    return g.reshape(T, J, O)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ScreenedCollision:
    """Top-K candidate collision constraint rows for the solver hot loop.

    The reference evaluates all T*J*O constraints on the GPU every Ipopt
    iteration (CollisionChecking.cu:230-299).  Almost all rows are provably
    inactive over the whole k-box; we rank rows by an upper bound of their
    constraint value over k in [-1,1]^F and keep the K worst.  SOUNDNESS: the
    final feasibility check (nlp.max_violations) still evaluates the FULL
    set, so a dropped-but-active row can only turn a claimed-feasible plan
    into an infeasible verdict (-> braking), never an unsafe plan.
    """

    A: jnp.ndarray        # [3, C, K]
    d: jnp.ndarray        # [C, K]
    delta: jnp.ndarray    # [C, K]
    row: jnp.ndarray      # [K] int32 index into the T*J link-center cells
    mask: jnp.ndarray     # [K] real-obstacle mask


def screen_collision(hyp: Hyperplanes, obs: ObstacleSet, frs: LinkFRS,
                     K: int, obstacle_quota: int = 0) -> ScreenedCollision:
    """Rank all rows by sup_k g(k) upper bound; gather the K worst.

    obstacle_quota > 0 reserves that many best rows for EVERY obstacle
    before the remaining K - quota*O budget is filled globally (the global
    top-K concentrates its budget on the obstacles nearest the current
    state in clutter, starving the ones along the waypoint direction whose
    rows become active mid-descent).  Padded obstacles' quota rows rank at
    -BIG and arrive masked-inert."""
    T, J, O = hyp.dims
    N = T * J * O
    A = hyp.A                                                 # [3, C, N]

    # constant term and per-cell monomial envelope of the link centers
    p0 = jnp.broadcast_to(
        jnp.moveaxis(frs.center_coef[..., 0], -1, 0).reshape(3, T, J, 1),
        (3, T, J, O),
    ).reshape(3, 1, N)
    Apc = _dot3(A, p0)                                        # [C, N]
    # sup_k |A . (p(k) - p0)| bounded per coordinate first: the exact
    # directional bound sum_b |A . coef_b| materializes a [C, B-1, N]
    # intermediate, B-1 times the size of the rows; the coordinate-box bound
    # r = sum_a |A_a| * (sum_b |coef_ab|) is a VALID over-bound but its
    # tightness vs the exact directional bound is not uniformly bounded
    # (cancellation across coordinates can make the exact bound arbitrarily
    # smaller).  That only loosens WHICH rows are screened in; the final
    # feasibility check stays exact on all rows.
    env = jnp.sum(jnp.abs(frs.center_coef[..., 1:]), axis=-1)  # [T, J, 3]
    env = jnp.broadcast_to(
        jnp.moveaxis(env, -1, 0).reshape(3, T, J, 1), (3, T, J, O)
    ).reshape(3, 1, N)
    r = (jnp.abs(A[0]) * env[0] + jnp.abs(A[1]) * env[1]
         + jnp.abs(A[2]) * env[2])                            # [C, N]
    ok = jnp.abs(A[0]) + jnp.abs(A[1]) + jnp.abs(A[2]) > 0
    pos_lb = jnp.where(ok, Apc - r - (hyp.d + hyp.delta), -BIG)
    neg_lb = jnp.where(ok, -Apc - r - (-hyp.d + hyp.delta), -BIG)
    m_lb = jnp.maximum(jnp.max(pos_lb, axis=0), jnp.max(neg_lb, axis=0))
    mask = jnp.broadcast_to(obs.mask[None, None, :], (T, J, O)).reshape(N)
    g_up = jnp.where(mask, -m_lb, -BIG)                       # upper bnd of g

    if obstacle_quota > 0 and obstacle_quota * O < min(K, N):
        q = obstacle_quota
        # per-obstacle quota: top-q rows of each obstacle's [T*J] column
        gu_o = g_up.reshape(T * J, O).T                       # [O, T*J]
        _, idx_o = jax.lax.top_k(gu_o, q)                     # [O, q]
        quota_idx = (idx_o * O + jnp.arange(O)[:, None]).reshape(-1)
        # fill the remainder globally, excluding the quota rows
        g_fill = g_up.at[quota_idx].set(-jnp.inf)
        _, idx_g = jax.lax.top_k(g_fill, min(K, N) - q * O)
        idx = jnp.concatenate([quota_idx, idx_g])
    else:
        _, idx = jax.lax.top_k(g_up, min(K, N))               # worst K rows
    return ScreenedCollision(
        A=jnp.take(A, idx, axis=-1),
        d=jnp.take(hyp.d, idx, axis=-1),
        delta=jnp.take(hyp.delta, idx, axis=-1),
        row=(idx // O).astype(jnp.int32),
        mask=jnp.take(mask, idx),
    )


def screened_constraints(sc: ScreenedCollision, p_all: jnp.ndarray,
                         smooth_tau: float = 0.0):
    """g [K] (<= 0 safe) and dg/dp [3, K] for the screened rows, given the
    per-cell sliced link centers p_all [3, T*J].

    smooth_tau > 0 switches to the SMOOTH ablation (the dense
    counterpart of the reference's duality/lambda obstacle constraints,
    uarmtd_planner.m:711-731): the hard max over hyperplanes is replaced by
    a shifted log-sum-exp m_s = tau*logsumexp(x/tau) - tau*log(2C) <= max(x),
    so the smoothed separation UNDER-approximates the true one and
    g_s = -m_s >= g stays a sound (conservative) C^1 constraint.  The
    reference introduces dual lambda variables to the same end (smooth
    constraints for the NLP); here the dual is eliminated in closed form —
    the softmax weights ARE the optimal lambda direction."""
    p = p_all[:, sc.row]                                      # [3, K]
    Ap = _dot3(sc.A, p[:, None, :])                           # [C, K]
    ok = jnp.abs(sc.A[0]) + jnp.abs(sc.A[1]) + jnp.abs(sc.A[2]) > 0
    pos = jnp.where(ok, Ap - (sc.d + sc.delta), -BIG)
    neg = jnp.where(ok, -Ap - (-sc.d + sc.delta), -BIG)
    both = jnp.concatenate([pos, neg], axis=0)                # [2C, K]
    C = sc.A.shape[1]

    if smooth_tau > 0:
        tau = smooth_tau
        mx = jnp.max(both, axis=0)
        w = jnp.exp((both - mx[None]) / tau)                  # softmax weights
        Z = jnp.sum(w, axis=0)
        m = mx + tau * jnp.log(Z) - tau * jnp.log(2.0 * C)
        g = jnp.where(sc.mask, -m, -BIG)
        # dg/dp = -sum_c softmax_c * sign_c * A_c (smooth blend of normals)
        wn = w / Z[None]                                      # [2C, K]
        w_pos, w_neg = wn[:C], wn[C:]
        A_blend = (
            (sc.A * w_pos[None]).sum(axis=1)
            - (sc.A * w_neg[None]).sum(axis=1)
        )                                                     # [3, K]
        grad_p = jnp.where(sc.mask[None, :], -A_blend, 0.0)
        return g, grad_p

    m = jnp.max(both, axis=0)
    g = jnp.where(sc.mask, -m, -BIG)

    idx = jnp.argmax(both, axis=0)
    sign = jnp.where(idx < C, -1.0, 1.0)
    comb = jnp.where(idx < C, idx, idx - C)
    A_sel = jnp.take_along_axis(sc.A, comb[None, None, :], axis=1)[:, 0]  # [3, K]
    grad_p = jnp.where(sc.mask[None, :], sign[None, :] * A_sel, 0.0)
    return g, grad_p


def screened_constraint_grads(sc: ScreenedCollision, grad_p: jnp.ndarray,
                              dp_all: jnp.ndarray) -> jnp.ndarray:
    """dg/dk [K, F]: grad_p [3, K] chained with dp/dk [3, F, T*J]
    (CollisionChecking.cu:286-297)."""
    dp = dp_all[:, :, sc.row]                                 # [3, F, K]
    dg = (grad_p[0][None] * dp[0] + grad_p[1][None] * dp[1]
          + grad_p[2][None] * dp[2])                          # [F, K]
    return dg.T
