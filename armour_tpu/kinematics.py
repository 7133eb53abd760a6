"""PZ forward kinematics and link forward-occupancy sets.

JAX equivalent of KinematicsDynamics::fk (Dynamics.cu:69-81): a serial
chain accumulation

    FK_T <- FK_T + FK_R @ P_i ;  FK_R <- FK_R @ R_i ;
    links_i = FK_R @ link_box_i + FK_T

done entirely in batched BPZ tensors over all time steps at once.  The link
box zonotopes carry their 3 shape generators in dedicated error slots so that
`reduce_links` can extract them for obstacle buffering, exactly like
reduce_link_PZ (PZsparse.cu:370-402, Dynamics.cu:51-66).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .config import ArmourConfig
from .jrs import JRS
from .pz import bpz
from .pz.basis import KBasis, error_layout
from .pz.bpz import BPZ
from .robot import RobotModel


@dataclasses.dataclass
class LinkFRS:
    """Reduced link forward reachable sets, ready for collision buffering.

    center_coef: k-polynomial of each link center (sliced in the NLP).
    shape_gens:  3 rotated box generators (k-independent).
    radius:      per-axis independent interval radii.
    Together (shape_gens | diag(radius)) is the reference's [3, 6]
    link_independent_generators matrix (armour_main.cu:115-127).
    """

    center_coef: jnp.ndarray  # [T, J, 3, B]
    shape_gens: jnp.ndarray   # [T, J, 3, 3]  (columns = generators)
    radius: jnp.ndarray       # [T, J, 3]


jax.tree_util.register_dataclass(
    LinkFRS, data_fields=["center_coef", "shape_gens", "radius"], meta_fields=[]
)


def link_box_pz(robot: RobotModel, basis: KBasis, dtype) -> BPZ:
    """Link bounding boxes as BPZ [J, 3] with shape-slot generators
    (Dynamics.cu:51-66)."""
    lay = error_layout(basis.nf)
    J = robot.num_joints
    E = lay["size"]
    coef = jnp.zeros((J, 3, basis.size), dtype).at[..., 0].set(
        jnp.asarray(robot.link_center, dtype)
    )
    egen = jnp.zeros((J, 3, E), dtype)
    for j in range(3):
        egen = egen.at[:, j, lay["shape"].start + j].set(
            jnp.asarray(robot.link_generators[:, j], dtype)
        )
    return BPZ(coef=coef, egen=egen, rad=jnp.zeros((J, 3), dtype))


def forward_occupancy(jrs: JRS, robot: RobotModel, cfg: ArmourConfig,
                      basis: KBasis) -> BPZ:
    """Forward kinematics: link PZs [T, J, 3] (Dynamics.cu:69-81).

    Scanned over the joint chain (one traced body instead of J unrolled
    copies) with the accumulated rotation/translation as carry.
    """
    dt = cfg.dtype
    T = cfg.num_time_steps
    J = robot.num_joints
    E = error_layout(basis.nf)["size"]
    boxes = link_box_pz(robot, basis, dt)                 # [J, 3]
    trans = jnp.asarray(robot.trans, dt)

    fk_r0 = BPZ(
        coef=jnp.zeros((T, 3, 3, basis.size), dt).at[..., 0].set(
            jnp.broadcast_to(jnp.eye(3, dtype=dt), (T, 3, 3))
        ),
        egen=jnp.zeros((T, 3, 3, E), dt),
        rad=jnp.zeros((T, 3, 3), dt),
    )
    fk_t0 = bpz.zeros((T, 3), basis, dt)

    R_j = BPZ(
        coef=jnp.moveaxis(jrs.R.coef[:, :J], 1, 0),
        egen=jnp.moveaxis(jrs.R.egen[:, :J], 1, 0),
        rad=jnp.moveaxis(jrs.R.rad[:, :J], 1, 0),
    )

    def body(carry, inp):
        fk_r, fk_t = carry
        r_i, box_i, trans_i = inp
        fk_t = bpz.add(fk_t, bpz.matvec_cvec(fk_r, trans_i))
        # R_i is a degree<=1 rotation PZ; the box has constant-only k-coefs
        # (shape generators live in dedicated error slots) -> fast paths
        fk_r = bpz.matmul_linear_right(fk_r, r_i, basis, cfg.float_slop)
        link = bpz.add(bpz.matvec_const_coef(fk_r, box_i, cfg.float_slop), fk_t)
        return (fk_r, fk_t), link

    _, links = jax.lax.scan(body, (fk_r0, fk_t0), (R_j, boxes, trans[:J]))
    return BPZ(
        coef=jnp.moveaxis(links.coef, 0, 1),
        egen=jnp.moveaxis(links.egen, 0, 1),
        rad=jnp.moveaxis(links.rad, 0, 1),
    )


def reduce_links(links: BPZ, basis: KBasis) -> LinkFRS:
    """Split link PZs into sliceable k-poly + shape generators + radii
    (reduce_link_PZ, PZsparse.cu:370-402)."""
    lay = error_layout(basis.nf)
    sh = lay["shape"]
    shape_gens = jnp.moveaxis(links.egen[..., sh], -1, -1)  # [T, J, 3, 3gen]
    other = jnp.concatenate(
        [links.egen[..., : sh.start], links.egen[..., sh.stop:]], axis=-1
    )
    radius = links.rad + jnp.sum(jnp.abs(other), axis=-1)
    return LinkFRS(center_coef=links.coef, shape_gens=shape_gens, radius=radius)
