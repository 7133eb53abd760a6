"""Batched polynomial zonotopes (BPZ) as dense JAX tensors.

A BPZ represents, per tensor entry, the set

    { coef[0] + sum_m coef[m] * phi_m(k) + sum_e egen[e] * eps_e + rad * eps
      : k in [-1,1]^nf, eps_e in [-1,1], eps in [-1,1] }

with phi_m the static k-monomial basis (basis.KBasis), egen the linear
error-generator block and rad an independent interval radius.  This is the
JAX equivalent of the reference's PZsparse (PZsparse.h:63-211): the
k-polynomial part is what slice()/gradient-slice evaluate in the NLP, the
error block is what reduce()/reduce_link_PZ() extract, and rad is the
`independent` matrix.

All ops broadcast over arbitrary leading batch dims (time steps, worlds, ...)
so the whole reachable-set pipeline is expressed as a handful of fused
batched tensor contractions instead of per-monomial list manipulation.

Semantics of each op mirror the reference implementation cited in the
docstrings; conservative outward rounding happens exactly where the
reference's simplify()/reduce() would move coefficients into `independent`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .basis import KBasis, error_layout, make_basis


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BPZ:
    coef: jnp.ndarray  # [..., B]   k-poly coefficients; index 0 = center
    egen: jnp.ndarray  # [..., E]   linear error-generator coefficients
    rad: jnp.ndarray   # [...]      independent radius (>= 0)

    @property
    def center(self) -> jnp.ndarray:
        return self.coef[..., 0]

    @property
    def shape(self):
        return self.rad.shape


def _nf_from(coef_B: int, basis: KBasis) -> int:
    assert coef_B == basis.size
    return basis.nf


def zeros(shape, basis: KBasis, dtype=jnp.float32) -> BPZ:
    E = error_layout(basis.nf)["size"]
    return BPZ(
        coef=jnp.zeros((*shape, basis.size), dtype=dtype),
        egen=jnp.zeros((*shape, E), dtype=dtype),
        rad=jnp.zeros(shape, dtype=dtype),
    )


def const(x: jnp.ndarray, basis: KBasis) -> BPZ:
    x = jnp.asarray(x)
    z = zeros(x.shape, basis, x.dtype)
    return BPZ(coef=z.coef.at[..., 0].set(x), egen=z.egen, rad=z.rad)


def from_interval(center: jnp.ndarray, radius: jnp.ndarray, basis: KBasis) -> BPZ:
    """PZ with only an independent interval part (PZsparse.cu:108-117)."""
    p = const(center, basis)
    return BPZ(coef=p.coef, egen=p.egen, rad=jnp.broadcast_to(jnp.asarray(radius, p.rad.dtype), p.rad.shape))


def add(a: BPZ, b: BPZ) -> BPZ:
    """PZsparse.cu:164-186 — concatenate + merge; dense rep just adds."""
    return BPZ(coef=a.coef + b.coef, egen=a.egen + b.egen, rad=a.rad + b.rad)


def add_const(a: BPZ, x) -> BPZ:
    return BPZ(coef=a.coef.at[..., 0].add(x), egen=a.egen, rad=a.rad)


def neg(a: BPZ) -> BPZ:
    return BPZ(coef=-a.coef, egen=-a.egen, rad=a.rad)


def sub(a: BPZ, b: BPZ) -> BPZ:
    return add(a, neg(b))


def scale(a: BPZ, s) -> BPZ:
    """Multiply by an exact scalar/array (PZsparse.cu:417-433)."""
    s = jnp.asarray(s, a.coef.dtype)
    return BPZ(
        coef=a.coef * s[..., None],
        egen=a.egen * s[..., None],
        rad=a.rad * jnp.abs(s),
    )


# ---------------------------------------------------------------------------
# Bilinear core.
#
# prod(x, y):    pairing of coefficient tensors carrying a trailing aligned
#                axis t (basis-pair axis or error axis), contracting any
#                matrix dims:   [..., amat, t] x [..., bmat, t] -> [..., omat, t]
# absprod(x, y): same pairing on nonnegative magnitudes without the trailing
#                axis (interval-radius propagation).
# ---------------------------------------------------------------------------


def _bc_last(x: jnp.ndarray, n: int) -> jnp.ndarray:
    return jnp.broadcast_to(x[..., None], (*x.shape, n))


def bilinear(a: BPZ, b: BPZ, prod: Callable, absprod: Callable, basis: KBasis,
             slop: float = 0.0, absprod_t: Callable | None = None) -> BPZ:
    """Generic PZ x PZ bilinear product (PZsparse.cu:864-994 semantics).

    k-poly x k-poly products that stay within the basis are tracked exactly
    via the static pair table; everything else is outward-rounded into rad
    exactly where the reference's reduce() would eventually put it.
    """
    dt = a.coef.dtype
    TI = jnp.asarray(basis.pair_i)
    TJ = jnp.asarray(basis.pair_j)
    S = jnp.asarray(basis.scatter, dtype=dt)

    gA = jnp.take(a.coef, TI, axis=-1)          # [..., amat, P]
    gB = jnp.take(b.coef, TJ, axis=-1)          # [..., bmat, P]
    pp = prod(gA, gB)                           # [..., omat, P]
    coef = pp @ S                               # [..., omat, B]
    # sum of |a_i||b_j| over in-table pairs (abs BEFORE any contraction, so
    # legitimate in-basis cancellation is not charged to the radius)
    abs_pair = absprod_t if absprod_t is not None else prod
    in_abs = jnp.sum(abs_pair(jnp.abs(gA), jnp.abs(gB)), axis=-1)  # [..., omat]

    Sa = jnp.sum(jnp.abs(a.coef), axis=-1)
    Sb = jnp.sum(jnp.abs(b.coef), axis=-1)
    overflow = jnp.maximum(absprod(Sa, Sb) - in_abs, 0.0)

    a0 = a.coef[..., 0]
    b0 = b.coef[..., 0]
    E = a.egen.shape[-1]
    egen = prod(a.egen, _bc_last(b0, E)) + prod(_bc_last(a0, E), b.egen)

    Ea = jnp.sum(jnp.abs(a.egen), axis=-1)
    Eb = jnp.sum(jnp.abs(b.egen), axis=-1)
    Ta = Sa + Ea
    Tb = Sb + Eb

    rad = (
        absprod(Ta, b.rad)
        + absprod(a.rad, Tb)
        + absprod(a.rad, b.rad)
        + absprod(Ea, Sb - jnp.abs(b0))
        + absprod(Sa - jnp.abs(a0), Eb)
        + absprod(Ea, Eb)
        + overflow
    )
    if slop:
        rad = rad + slop * (jnp.sum(jnp.abs(coef), axis=-1) + jnp.sum(jnp.abs(egen), axis=-1) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def mul(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """Elementwise (Hadamard) product with broadcasting."""
    return bilinear(a, b, lambda x, y: x * y, lambda x, y: x * y, basis, slop)


def interval_operand(p: BPZ):
    """Sound (center, radius) interval enclosure of a PZ, for use as the
    interval operand of mul_interval/matmul_interval: every non-constant
    k-coefficient and every error generator is folded into the radius.  For
    the inertial-parameter PZs built by from_interval (coef only at the
    constant monomial, egen = 0 — Dynamics.cu:30-41) this is exact and the
    folds are sums of zeros; for any other operand it degrades gracefully to
    the interval hull instead of silently dropping uncertainty (the hazard
    of decomposing the operand by hand with p.coef[..., 0] / p.rad)."""
    rad = (p.rad + jnp.sum(jnp.abs(p.egen), axis=-1)
           + jnp.sum(jnp.abs(p.coef[..., 1:]), axis=-1))
    return p.coef[..., 0], rad


def mul_interval(c: jnp.ndarray, r: jnp.ndarray, b: BPZ,
                 slop: float = 0.0) -> BPZ:
    """(c + r*[-1,1]) * b elementwise — the EXACT bilinear result when the
    left operand is a pure interval PZ (coef only at the constant monomial,
    no error generators), without the 680-entry pair-table expansion.  The
    inertial-parameter PZs (mass/inertia/COM, Dynamics.cu:30-41) have
    exactly this structure, and their products dominate the PZ-RNEA cost.
    c, r broadcast against b's element shape.

    CONTRACT: (c, r) must ENCLOSE the left operand.  Build them with
    interval_operand(p), which is exact for from_interval PZs and a sound
    interval hull for everything else — do not hand-decompose a BPZ here
    (p.coef[..., 0]/p.rad drops egen and non-constant coefs unsoundly)."""
    cc = c[..., None]
    coef = cc * b.coef
    egen = cc * b.egen
    Tb = (jnp.sum(jnp.abs(b.coef), axis=-1) + jnp.sum(jnp.abs(b.egen), axis=-1)
          + b.rad)
    rad = jnp.abs(c) * b.rad + r * Tb
    if slop:
        rad = rad + slop * (jnp.sum(jnp.abs(coef), axis=-1)
                            + jnp.sum(jnp.abs(egen), axis=-1) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def matmul_linear(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """a @ b where a is a matrix PZ whose k-coefficients are DEGREE <= 1
    (rotation PZs; Trajectory.cu:63-254 builds them from one linear
    cos/sin monomial per joint).  Exactly the generic bilinear result for
    such operands — nonexistent higher-degree a-coefficients contribute
    nothing — but via an [nf, B] shift-gather instead of the 680-pair
    expansion + scatter matmul, which dominated the PZ-RNEA profile.

    a [..., n, m, :], b [..., m, p, :] -> [..., n, p, :]."""
    from .basis import linear_tables

    dt = a.coef.dtype
    SRC, OVF = linear_tables(basis.nf, basis.max_degree)
    SRC = jnp.asarray(SRC)                              # [F, B]
    ovf_mask = jnp.asarray(OVF, dt)                     # [B]
    lin = jnp.asarray(basis.lin_idx)                    # [F]

    n, m = a.coef.shape[-3], a.coef.shape[-2]
    p = b.coef.shape[-2]
    B = b.coef.shape[-1]

    a0 = a.coef[..., 0]                                 # [..., n, m]
    a_lin = a.coef[..., lin]                            # [..., n, m, F]
    b0 = b.coef[..., 0]                                 # [..., m, p]
    # shift-gather: gath[..., m, p, f, :] = coef of mono/k_f (0 if absent)
    b_pad = jnp.concatenate(
        [b.coef, jnp.zeros(b.coef.shape[:-1] + (1,), dt)], axis=-1)
    gath = b_pad[..., SRC]                              # [..., m, p, F, B]

    Sa = jnp.sum(jnp.abs(a.coef), axis=-1)
    Ea = jnp.sum(jnp.abs(a.egen), axis=-1)
    Sb = jnp.sum(jnp.abs(b.coef), axis=-1)
    Eb = jnp.sum(jnp.abs(b.egen), axis=-1)
    Ta = Sa + Ea
    Tb = Sb + Eb
    A1 = jnp.sum(jnp.abs(a_lin), axis=-1)               # [..., n, m]
    ovfsum = jnp.sum(jnp.abs(b.coef) * ovf_mask, axis=-1)   # [..., m, p]

    rows_c, rows_e, rows_r = [], [], []
    for i in range(n):
        cols_c, cols_e, cols_r = [], [], []
        for k in range(p):
            cacc = eacc = None
            racc = None
            for j in range(m):
                c_j = (a0[..., i, j, None] * b.coef[..., j, k, :]
                       + jnp.sum(a_lin[..., i, j, :, None]
                                 * gath[..., j, k, :, :], axis=-2))
                e_j = (a0[..., i, j, None] * b.egen[..., j, k, :]
                       + a.egen[..., i, j, :] * b0[..., j, k, None])
                r_j = (Ta[..., i, j] * b.rad[..., j, k]
                       + a.rad[..., i, j] * (Tb[..., j, k] + b.rad[..., j, k])
                       + Ea[..., i, j] * (Sb[..., j, k]
                                          - jnp.abs(b0[..., j, k]) + Eb[..., j, k])
                       + (Sa[..., i, j] - jnp.abs(a0[..., i, j])) * Eb[..., j, k]
                       + A1[..., i, j] * ovfsum[..., j, k])
                cacc = c_j if cacc is None else cacc + c_j
                eacc = e_j if eacc is None else eacc + e_j
                racc = r_j if racc is None else racc + r_j
            cols_c.append(cacc)
            cols_e.append(eacc)
            cols_r.append(racc)
        rows_c.append(jnp.stack(cols_c, axis=-2))
        rows_e.append(jnp.stack(cols_e, axis=-2))
        rows_r.append(jnp.stack(cols_r, axis=-1))
    coef = jnp.stack(rows_c, axis=-3)
    egen = jnp.stack(rows_e, axis=-3)
    rad = jnp.stack(rows_r, axis=-2)
    if slop:
        rad = rad + slop * (jnp.sum(jnp.abs(coef), axis=-1)
                            + jnp.sum(jnp.abs(egen), axis=-1) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def _transpose_mat(p: BPZ) -> BPZ:
    return BPZ(coef=jnp.swapaxes(p.coef, -3, -2),
               egen=jnp.swapaxes(p.egen, -3, -2),
               rad=jnp.swapaxes(p.rad, -2, -1))


def matmul_linear_right(a: BPZ, b_lin: BPZ, basis: KBasis,
                        slop: float = 0.0) -> BPZ:
    """a @ b where the RIGHT operand is the degree<=1 rotation PZ (the FK
    chain accumulates fk_r @ R_i, Dynamics.cu:69-81): a @ b = (b^T @ a^T)^T
    with the transpose a free axis swap."""
    return _transpose_mat(
        matmul_linear(_transpose_mat(b_lin), _transpose_mat(a), basis, slop))


def matvec_const_coef(a: BPZ, b: BPZ, slop: float = 0.0) -> BPZ:
    """a [..., n, m, :] @ b [..., m, :] where b's k-coefficients live ONLY at
    the constant monomial (link box PZs: center + dedicated shape error
    generators, Dynamics.cu:51-66) — exact, no pair table."""
    n, m = a.coef.shape[-3], a.coef.shape[-2]
    b0 = b.coef[..., 0]                                  # [..., m]
    Sa = jnp.sum(jnp.abs(a.coef), axis=-1)
    Ea = jnp.sum(jnp.abs(a.egen), axis=-1)
    Eb = jnp.sum(jnp.abs(b.egen), axis=-1)
    Ta = Sa + Ea

    rows_c, rows_e, rows_r = [], [], []
    for i in range(n):
        cacc = eacc = racc = None
        for j in range(m):
            c_j = a.coef[..., i, j, :] * b0[..., j, None]
            e_j = (a.coef[..., i, j, 0, None] * b.egen[..., j, :]
                   + a.egen[..., i, j, :] * b0[..., j, None])
            r_j = (Ta[..., i, j] * b.rad[..., j]
                   + a.rad[..., i, j] * (jnp.abs(b0[..., j]) + Eb[..., j]
                                         + b.rad[..., j])
                   + (Sa[..., i, j] - jnp.abs(a.coef[..., i, j, 0])
                      + Ea[..., i, j]) * Eb[..., j])
            cacc = c_j if cacc is None else cacc + c_j
            eacc = e_j if eacc is None else eacc + e_j
            racc = r_j if racc is None else racc + r_j
        rows_c.append(cacc)
        rows_e.append(eacc)
        rows_r.append(racc)
    coef = jnp.stack(rows_c, axis=-2)
    egen = jnp.stack(rows_e, axis=-2)
    rad = jnp.stack(rows_r, axis=-1)
    if slop:
        rad = rad + slop * (jnp.sum(jnp.abs(coef), axis=-1)
                            + jnp.sum(jnp.abs(egen), axis=-1) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def matmul_interval(C: jnp.ndarray, R: jnp.ndarray, b: BPZ,
                    slop: float = 0.0) -> BPZ:
    """(C + R*[-1,1]) @ b for an interval MATRIX (C, R [..., n, m]) and a
    matrix PZ b [..., m, p, :] — same exactness argument as mul_interval."""
    n, m = C.shape[-2], C.shape[-1]
    p = b.coef.shape[-2]

    Tb = (jnp.sum(jnp.abs(b.coef), axis=-1) + jnp.sum(jnp.abs(b.egen), axis=-1)
          + b.rad)                                          # [..., m, p]

    def rowcol(x, M, i, k):
        acc = M[..., i, 0, None] * x[..., 0, k, :]
        for j in range(1, m):
            acc = acc + M[..., i, j, None] * x[..., j, k, :]
        return acc

    rows_c, rows_e, rows_r = [], [], []
    absC, absR = jnp.abs(C), jnp.abs(R)
    for i in range(n):
        cols_c, cols_e, cols_r = [], [], []
        for k in range(p):
            cols_c.append(rowcol(b.coef, C, i, k))
            cols_e.append(rowcol(b.egen, C, i, k))
            acc = absC[..., i, 0] * b.rad[..., 0, k] + absR[..., i, 0] * Tb[..., 0, k]
            for j in range(1, m):
                acc = acc + (absC[..., i, j] * b.rad[..., j, k]
                             + absR[..., i, j] * Tb[..., j, k])
            cols_r.append(acc)
        rows_c.append(jnp.stack(cols_c, axis=-2))
        rows_e.append(jnp.stack(cols_e, axis=-2))
        rows_r.append(jnp.stack(cols_r, axis=-1))
    coef = jnp.stack(rows_c, axis=-3)
    egen = jnp.stack(rows_e, axis=-3)
    rad = jnp.stack(rows_r, axis=-2)
    if slop:
        rad = rad + slop * (jnp.sum(jnp.abs(coef), axis=-1)
                            + jnp.sum(jnp.abs(egen), axis=-1) + rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def _matmul_pair(x, y):
    """Unrolled 3x3 (or small) matrix product keeping the huge trailing axis
    innermost: 27 fused elementwise multiply-adds on [..., t] slices instead
    of a batched tiny-matmul dot_general over the size-3 dims."""
    n, m = x.shape[-3], x.shape[-2]
    p = y.shape[-2]
    rows = []
    for i in range(n):
        cols = []
        for k in range(p):
            acc = x[..., i, 0, :] * y[..., 0, k, :]
            for j in range(1, m):
                acc = acc + x[..., i, j, :] * y[..., j, k, :]
            cols.append(acc)
        rows.append(jnp.stack(cols, axis=-2))
    return jnp.stack(rows, axis=-3)


def _matmul_abs(x, y):
    n, m = x.shape[-2], x.shape[-1]
    p = y.shape[-1]
    rows = []
    for i in range(n):
        cols = []
        for k in range(p):
            acc = x[..., i, 0] * y[..., 0, k]
            for j in range(1, m):
                acc = acc + x[..., i, j] * y[..., j, k]
            cols.append(acc)
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


def matmul(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """Matrix product: a [..., n, m, :], b [..., m, p, :] -> [..., n, p, :]."""
    return bilinear(a, b, _matmul_pair, _matmul_abs, basis, slop)


def _matvec_pair(x, y):
    n, m = x.shape[-3], x.shape[-2]
    rows = []
    for i in range(n):
        acc = x[..., i, 0, :] * y[..., 0, :]
        for j in range(1, m):
            acc = acc + x[..., i, j, :] * y[..., j, :]
        rows.append(acc)
    return jnp.stack(rows, axis=-2)


def _matvec_abs(x, y):
    n, m = x.shape[-2], x.shape[-1]
    rows = []
    for i in range(n):
        acc = x[..., i, 0] * y[..., 0]
        for j in range(1, m):
            acc = acc + x[..., i, j] * y[..., j]
        rows.append(acc)
    return jnp.stack(rows, axis=-1)


def matvec(a: BPZ, v: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """a [..., n, m, :] @ v [..., m, :] -> [..., n, :]."""
    return bilinear(a, v, _matvec_pair, _matvec_abs, basis, slop)


def _cross_pair(x, y):
    # x, y: [..., 3, t]
    return jnp.stack(
        [
            x[..., 1, :] * y[..., 2, :] - x[..., 2, :] * y[..., 1, :],
            x[..., 2, :] * y[..., 0, :] - x[..., 0, :] * y[..., 2, :],
            x[..., 0, :] * y[..., 1, :] - x[..., 1, :] * y[..., 0, :],
        ],
        axis=-2,
    )


def _cross_abs(x, y):
    return jnp.stack(
        [
            x[..., 1] * y[..., 2] + x[..., 2] * y[..., 1],
            x[..., 2] * y[..., 0] + x[..., 0] * y[..., 2],
            x[..., 0] * y[..., 1] + x[..., 1] * y[..., 0],
        ],
        axis=-1,
    )


def _cross_abs_t(x, y):
    return jnp.stack(
        [
            x[..., 1, :] * y[..., 2, :] + x[..., 2, :] * y[..., 1, :],
            x[..., 2, :] * y[..., 0, :] + x[..., 0, :] * y[..., 2, :],
            x[..., 0, :] * y[..., 1, :] + x[..., 1, :] * y[..., 0, :],
        ],
        axis=-2,
    )


def cross(a: BPZ, b: BPZ, basis: KBasis, slop: float = 0.0) -> BPZ:
    """3-vector cross product (PZsparse.cu:1087-1167)."""
    return bilinear(a, b, _cross_pair, _cross_abs, basis, slop,
                    absprod_t=_cross_abs_t)


def cross_const(m: jnp.ndarray, b: BPZ) -> BPZ:
    """cross(constant vector, PZ vector) — exact, no rounding
    (PZsparse.cu:539-553)."""
    def cr(x, y):
        return jnp.stack(
            [
                x[..., 1, None] * y[..., 2, :] - x[..., 2, None] * y[..., 1, :],
                x[..., 2, None] * y[..., 0, :] - x[..., 0, None] * y[..., 2, :],
                x[..., 0, None] * y[..., 1, :] - x[..., 1, None] * y[..., 0, :],
            ],
            axis=-2,
        )

    mm = jnp.asarray(m)
    coef = cr(mm, b.coef)
    egen = cr(mm, b.egen)
    rad = _cross_abs(jnp.abs(mm), b.rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def matvec_cvec(a: BPZ, v: jnp.ndarray) -> BPZ:
    """PZ matrix [..., n, m, :] times exact constant vector [..., m] — exact,
    no rounding."""
    vv = jnp.asarray(v)
    coef = jnp.einsum("...ijt,...j->...it", a.coef, vv)
    egen = jnp.einsum("...ijt,...j->...it", a.egen, vv)
    rad = jnp.einsum("...ij,...j->...i", a.rad, jnp.abs(vv))
    return BPZ(coef=coef, egen=egen, rad=rad)


def cross_pz_const(a: BPZ, v: jnp.ndarray) -> BPZ:
    """cross(PZ vector, constant vector) — exact (PZsparse.cu:574-592)."""
    vv = jnp.asarray(v)

    def cr(x):
        return jnp.stack(
            [
                x[..., 1, :] * vv[..., 2, None] - x[..., 2, :] * vv[..., 1, None],
                x[..., 2, :] * vv[..., 0, None] - x[..., 0, :] * vv[..., 2, None],
                x[..., 0, :] * vv[..., 1, None] - x[..., 1, :] * vv[..., 0, None],
            ],
            axis=-2,
        )

    rad = _cross_abs(a.rad, jnp.abs(vv))
    return BPZ(coef=cr(a.coef), egen=cr(a.egen), rad=rad)


def matvec_const(m: jnp.ndarray, b: BPZ) -> BPZ:
    """Exact constant-matrix times PZ vector."""
    mm = jnp.asarray(m)
    coef = jnp.einsum("...ij,...jt->...it", mm, b.coef)
    egen = jnp.einsum("...ij,...jt->...it", mm, b.egen)
    rad = jnp.einsum("...ij,...j->...i", jnp.abs(mm), b.rad)
    return BPZ(coef=coef, egen=egen, rad=rad)


def stack(pzs) -> BPZ:
    """Stack scalar PZs into a vector PZ along a new trailing value axis
    (reference `stack`, PZsparse.cu:508-537)."""
    coef = jnp.stack([p.coef for p in pzs], axis=-2)
    egen = jnp.stack([p.egen for p in pzs], axis=-2)
    rad = jnp.stack([p.rad for p in pzs], axis=-1)
    return BPZ(coef=coef, egen=egen, rad=rad)


def axis_embed(a: BPZ, axis: int, dim: int = 3) -> BPZ:
    """Embed a scalar PZ as a vector PZ with value on `axis`
    (reference addOneDimPZ, PZsparse.cu:489-506)."""
    e = jnp.zeros((dim,), dtype=a.coef.dtype).at[axis].set(1.0)
    return BPZ(
        coef=e[:, None] * a.coef[..., None, :],
        egen=e[:, None] * a.egen[..., None, :],
        rad=e * a.rad[..., None],
    )


def reduce_(a: BPZ) -> BPZ:
    """Move every error generator into the independent radius
    (reference reduce(), PZsparse.cu:352-368: everything not k-only)."""
    return BPZ(
        coef=a.coef,
        egen=jnp.zeros_like(a.egen),
        rad=a.rad + jnp.sum(jnp.abs(a.egen), axis=-1),
    )


def to_interval(a: BPZ):
    """(center, radius) interval hull (PZsparse.cu:557-576)."""
    radius = (
        jnp.sum(jnp.abs(a.coef[..., 1:]), axis=-1)
        + jnp.sum(jnp.abs(a.egen), axis=-1)
        + a.rad
    )
    return a.coef[..., 0], radius


def slice_at(a: BPZ, phi_k: jnp.ndarray):
    """Evaluate k-monomials at a point (PZsparse.cu:404-435).

    phi_k = basis.phi(k), shape [..., B].  Returns (center, radius): the
    sliced center plus the untouched non-k radius.
    """
    c = jnp.einsum("...m,...m->...", a.coef, phi_k)
    r = jnp.sum(jnp.abs(a.egen), axis=-1) + a.rad
    return c, r
