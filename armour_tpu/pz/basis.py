"""Static monomial basis over the trajectory parameters k.

The reference tracks monomials of 42 variables in dynamic sparse lists with
bit-packed degree hashes (PZsparse.h:6-40, PZsparse.cu:864-994).  Under jit we
need static shapes, so we fix the basis up front:

  * k-monomials: all monomials in the NF trajectory parameters k_1..k_NF with
    total degree <= max_degree (default 3).  These are the only monomials the
    NLP ever slices (PZsparse.cu:404-435 treats everything else as radius), so
    they are tracked exactly as a dense coefficient vector.  Products whose
    degree exceeds the cap fall into the interval radius — the reference
    achieves the same effect implicitly via SIMPLIFY_THRESHOLD pruning
    (coefficients at total degree 4+ are ~1e-4 and below the 5e-4 threshold).
  * error generators (tracking error qde/qdae/qddae/cosqe/sinqe per joint and
    the 3 link-shape generators) are tracked as *linear* coefficients; any
    product of an error generator with a non-constant term is outward-rounded
    into the radius, mirroring what reduce()/reduce_link_PZ ultimately do to
    every such monomial (PZsparse.cu:352-402).

Degree-hash addition (PZsparse.cu:940) becomes a precomputed static pair
table (pair_i, pair_j) -> pair_m realized as a 0/1 matrix so the scatter-add
is a single dense matmul (in float32 at `highest` precision, see
armour_tpu/__init__.py).
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp


@dataclass(frozen=True)
class KBasis:
    nf: int                       # number of trajectory factors (joints)
    max_degree: int               # total-degree cap
    degs: np.ndarray              # [B, nf] int degree vectors; index 0 == constant
    index: dict = field(repr=False)   # tuple(deg) -> basis index
    pair_i: np.ndarray            # [P] ordered pair tables: basis product
    pair_j: np.ndarray            # [P]
    pair_m: np.ndarray            # [P]
    scatter: np.ndarray           # [P, B] 0/1 matrix: one-hot of pair_m

    @property
    def size(self) -> int:
        return self.degs.shape[0]

    @property
    def lin_idx(self) -> np.ndarray:
        """Basis index of the linear monomial k_i, for each factor i."""
        eye = np.eye(self.nf, dtype=np.int64)
        return np.array([self.index[tuple(row)] for row in eye])

    def phi(self, k):
        """Evaluate all basis monomials at k.  k: [..., nf] -> [..., B]."""
        degs = jnp.asarray(self.degs, dtype=k.dtype)  # [B, nf]
        # prod_i k_i^deg —  use exp/log? no: k can be <=0. Use power via where.
        # degrees are small ints; compute k^d by repeated multiply.
        maxd = int(self.degs.max())
        pows = [jnp.ones_like(k)]
        for _ in range(maxd):
            pows.append(pows[-1] * k)
        pows = jnp.stack(pows, axis=-1)  # [..., nf, maxd+1]
        # gather pows[..., i, degs[m, i]] and prod over i
        take = jnp.take_along_axis(
            pows[..., None, :, :],                      # [..., 1, nf, D]
            jnp.asarray(self.degs, dtype=jnp.int32)[..., None],  # [B, nf, 1]
            axis=-1,
        )[..., 0]                                       # [..., B, nf]
        return jnp.prod(take, axis=-1)

    def dphi(self, k):
        """Jacobian of phi: [..., nf] -> [..., B, nf]."""
        maxd = int(self.degs.max())
        pows = [jnp.ones_like(k)]
        for _ in range(maxd):
            pows.append(pows[-1] * k)
        pows = jnp.stack(pows, axis=-1)  # [..., nf, D]
        degs = jnp.asarray(self.degs, dtype=jnp.int32)  # [B, nf]
        take = jnp.take_along_axis(
            pows[..., None, :, :], degs[..., None], axis=-1
        )[..., 0]                                       # [..., B, nf] = k_i^{d_mi}
        dm1 = jnp.maximum(degs - 1, 0)
        take_dm1 = jnp.take_along_axis(
            pows[..., None, :, :], dm1[..., None], axis=-1
        )[..., 0]                                       # [..., B, nf] = k_i^{d_mi - 1}
        dcol = degs.astype(k.dtype) * take_dm1          # d * k^{d-1}
        # d(phi_m)/dk_j = dcol[..., m, j] * prod_{i != j} take[..., m, i]
        out = []
        for j in range(self.nf):
            others = jnp.prod(
                jnp.concatenate([take[..., :, :j], take[..., :, j + 1:]], axis=-1),
                axis=-1,
            )
            out.append(dcol[..., j] * others)
        return jnp.stack(out, axis=-1)                  # [..., B, nf]


@functools.lru_cache(maxsize=8)
def make_basis(nf: int = 7, max_degree: int = 3) -> KBasis:
    degs = []
    for total in range(max_degree + 1):
        for c in itertools.combinations_with_replacement(range(nf), total):
            d = [0] * nf
            for i in c:
                d[i] += 1
            degs.append(tuple(d))
    # sort by (total degree, lex) for a stable, readable order; constant first
    degs = sorted(set(degs), key=lambda d: (sum(d), d))
    index = {d: m for m, d in enumerate(degs)}
    degs_arr = np.array(degs, dtype=np.int64)
    B = len(degs)

    pi, pj, pm = [], [], []
    for i, di in enumerate(degs):
        for j, dj in enumerate(degs):
            s = tuple(a + b for a, b in zip(di, dj))
            if sum(s) <= max_degree:
                pi.append(i)
                pj.append(j)
                pm.append(index[s])
    pi = np.array(pi, dtype=np.int32)
    pj = np.array(pj, dtype=np.int32)
    pm = np.array(pm, dtype=np.int32)
    scatter = np.zeros((len(pm), B), dtype=np.float64)
    scatter[np.arange(len(pm)), pm] = 1.0
    return KBasis(
        nf=nf, max_degree=max_degree, degs=degs_arr, index=index,
        pair_i=pi, pair_j=pj, pair_m=pm, scatter=scatter,
    )


def error_layout(nf: int = 7):
    """Slot layout of the linear error-generator block (size 5*nf + 3).

    Groups follow the reference variable groups (PZsparse.h:6-20):
    qde, qdae, qddae, cosqe, sinqe — each nf wide — plus 3 dedicated
    link-shape slots (the reference reuses joint-0 error slots for these,
    Dynamics.cu:56-60; we give them their own ids).
    """
    return {
        "qde": slice(0 * nf, 1 * nf),
        "qdae": slice(1 * nf, 2 * nf),
        "qddae": slice(2 * nf, 3 * nf),
        "cosqe": slice(3 * nf, 4 * nf),
        "sinqe": slice(4 * nf, 5 * nf),
        "shape": slice(5 * nf, 5 * nf + 3),
        "size": 5 * nf + 3,
    }


@functools.lru_cache(maxsize=8)
def linear_tables(nf: int = 7, max_degree: int = 3):
    """Static tables for products with a DEGREE<=1 left/right operand
    (rotation PZs: cos/sin carry one linear k-monomial each,
    Trajectory.cu:63-254), bypassing the full pair-table expansion:

      src[i, m]  : basis index s with mono(m) = k_i * mono(s), or B (the
                   zero-pad sentinel) when degs[m][i] == 0;
      ovf[m]     : True when k_i * mono(m) leaves the basis for every i
                   (total degree == cap) — |coef| mass that must be
                   outward-rounded into the radius.
    """
    basis = make_basis(nf, max_degree)
    B = basis.size
    src = np.full((nf, B), B, dtype=np.int32)
    for m, d in enumerate(map(tuple, basis.degs)):
        for i in range(nf):
            if d[i] >= 1:
                d2 = list(d)
                d2[i] -= 1
                src[i, m] = basis.index[tuple(d2)]
    ovf = (basis.degs.sum(axis=1) == max_degree)
    return src, ovf
