"""Reference-faithful sparse polynomial zonotope oracle (numpy, float64).

A slow, exact re-implementation of the reference's PZsparse semantics
(PZsparse.h/.cu) used ONLY in tests: monomials over named variables held in a
dict, full symbolic tracking of every variable group (k, qde, qdae, qddae,
cosqe, sinqe, link-shape), optional SIMPLIFY_THRESHOLD pruning.  The dense BPZ
pipeline is validated against this oracle: k-poly coefficients must match to
float tolerance and BPZ radii must be >= oracle radii (conservatism) while
staying close (tightness).

This is an independent implementation written from the documented semantics
(see SURVEY.md section 2.1 and citations below), not a translation of the
CUDA code.
"""

from __future__ import annotations

import numpy as np

# variable naming: ('k', i), ('qde', i), ('qdae', i), ('qddae', i),
# ('cosqe', i), ('sinqe', i), ('shape', 0..2)
K_GROUP = "k"


def _merge_key(da: tuple, db: tuple) -> tuple:
    d = dict(da)
    for v, e in db:
        d[v] = d.get(v, 0) + e
    return tuple(sorted(d.items()))


def _is_k_only(key: tuple) -> bool:
    return all(v[0] == K_GROUP for v, _ in key)


def _is_shape_only(key: tuple) -> bool:
    return all(v[0] == "shape" for v, _ in key)


class SparsePZ:
    """center + sum_key poly[key] * prod(vars^degs) + [-indep, indep]."""

    def __init__(self, center, poly=None, indep=None):
        self.center = np.asarray(center, dtype=np.float64)
        self.poly = dict(poly or {})
        self.indep = (
            np.zeros_like(self.center) if indep is None
            else np.asarray(indep, dtype=np.float64)
        )

    @property
    def shape(self):
        return self.center.shape

    def copy(self):
        return SparsePZ(self.center.copy(), {k: v.copy() for k, v in self.poly.items()}, self.indep.copy())

    # -- construction helpers ------------------------------------------------
    @staticmethod
    def from_terms(center, terms, indep=None):
        """terms: list of (coeff, {var: deg})."""
        poly = {}
        for coeff, degs in terms:
            key = tuple(sorted(degs.items()))
            c = np.asarray(coeff, dtype=np.float64)
            poly[key] = poly.get(key, 0) + c
        return SparsePZ(center, poly, indep)

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other):
        if not isinstance(other, SparsePZ):
            return SparsePZ(self.center + other, self.poly, self.indep)
        out = SparsePZ(self.center + other.center, dict(self.poly), self.indep + other.indep)
        for k, v in other.poly.items():
            out.poly[k] = out.poly.get(k, 0) + v
        return out

    __radd__ = __add__

    def __neg__(self):
        return SparsePZ(-self.center, {k: -v for k, v in self.poly.items()}, self.indep)

    def __sub__(self, other):
        if not isinstance(other, SparsePZ):
            return SparsePZ(self.center - other, self.poly, self.indep)
        return self + (-other)

    def scale(self, s):
        s = float(s)
        return SparsePZ(self.center * s, {k: v * s for k, v in self.poly.items()}, self.indep * abs(s))

    def _pairing(self, other, prod, absprod):
        """Generic bilinear op with reference independent-part propagation
        (PZsparse.cu:864-994)."""
        out = SparsePZ(prod(self.center, other.center))
        poly = {}
        for k, v in self.poly.items():
            poly[k] = poly.get(k, 0) + prod(v, other.center)
        for k, v in other.poly.items():
            poly[k] = poly.get(k, 0) + prod(self.center, v)
        for ka, va in self.poly.items():
            for kb, vb in other.poly.items():
                k = _merge_key(ka, kb)
                poly[k] = poly.get(k, 0) + prod(va, vb)
        out.poly = poly

        sum_a = np.abs(self.center) + sum((np.abs(v) for v in self.poly.values()), 0)
        sum_b = np.abs(other.center) + sum((np.abs(v) for v in other.poly.values()), 0)
        out.indep = (
            absprod(sum_a, other.indep)
            + absprod(self.indep, sum_b)
            + absprod(self.indep, other.indep)
        )
        return out

    def __mul__(self, other):
        """Scalar*matrix or matrix@matrix product following the reference's
        operator* shape rules (PZsparse.cu:864-886)."""
        if not isinstance(other, SparsePZ):
            return self.scale(other)
        a_scalar = self.center.ndim == 0 or self.center.size == 1
        b_scalar = other.center.ndim == 0 or other.center.size == 1

        if a_scalar or b_scalar:
            prod = lambda x, y: x * y
            absprod = prod
        else:
            prod = lambda x, y: x @ y
            absprod = prod
        return self._pairing(other, prod, absprod)

    def matvec(self, other):
        prod = lambda x, y: x @ y
        return self._pairing(other, prod, prod)

    def transpose(self):
        return SparsePZ(self.center.T, {k: v.T for k, v in self.poly.items()}, self.indep.T)

    def cross(self, other):
        """3-vector cross product (PZsparse.cu:1087-1167)."""
        def cr(x, y):
            return np.array(
                [
                    x[1] * y[2] - x[2] * y[1],
                    x[2] * y[0] - x[0] * y[2],
                    x[0] * y[1] - x[1] * y[0],
                ]
            )

        def cr_abs(x, y):
            return np.array(
                [
                    x[1] * y[2] + x[2] * y[1],
                    x[2] * y[0] + x[0] * y[2],
                    x[0] * y[1] + x[1] * y[0],
                ]
            )

        return self._pairing(other, cr, cr_abs)

    # -- reduction / evaluation ---------------------------------------------
    def simplify(self, threshold: float = 0.0):
        """Merge (automatic in dict form) + threshold-prune small coefficients
        into indep (PZsparse.cu:284-350)."""
        if threshold <= 0:
            return self
        keep = {}
        for k, v in self.poly.items():
            if np.linalg.norm(np.ravel(v)) <= threshold:
                self.indep = self.indep + np.abs(v)
            else:
                keep[k] = v
        self.poly = keep
        return self

    def reduce(self):
        """Move all non-k-only monomials into indep (PZsparse.cu:352-368)."""
        keep = {}
        for k, v in self.poly.items():
            if _is_k_only(k):
                keep[k] = v
            else:
                self.indep = self.indep + np.abs(v)
        self.poly = keep
        return self

    def reduce_link_pz(self):
        """Extract the 3 link-shape generators; everything else non-k goes to
        indep (PZsparse.cu:370-402).  Returns [3, 6] generator matrix."""
        gens = np.zeros((3, 6))
        keep = {}
        j = 0
        for k, v in sorted(self.poly.items()):
            if _is_k_only(k):
                keep[k] = v
            elif _is_shape_only(k):
                assert j < 3
                gens[:, j] = v
                j += 1
            else:
                self.indep = self.indep + np.abs(v)
        self.poly = keep
        gens[0, 3] = self.indep[0]
        gens[1, 4] = self.indep[1]
        gens[2, 5] = self.indep[2]
        return gens

    def k_poly(self):
        """{k-degree-tuple(nf): coeff} of k-only monomials, center included."""
        out = {}
        for k, v in self.poly.items():
            if _is_k_only(k):
                out[k] = v
        return out

    def slice_at(self, kvec):
        """Evaluate k monomials; non-k monomials -> radius
        (PZsparse.cu:404-435)."""
        c = self.center.copy()
        r = self.indep.copy()
        for key, v in self.poly.items():
            if _is_k_only(key):
                f = 1.0
                for (g, i), e in key:
                    f *= kvec[i] ** e
                c = c + v * f
            else:
                r = r + np.abs(v)
        return c, r

    def to_interval(self):
        r = self.indep.copy()
        for v in self.poly.values():
            r = r + np.abs(v)
        return self.center, r

    def sample(self, rng, kvec=None, nf: int = 7):
        """Random member of the set (for Monte-Carlo containment tests)."""
        vals = {}
        x = self.center.copy()
        for key, v in self.poly.items():
            f = 1.0
            for var, e in key:
                if var not in vals:
                    if var[0] == K_GROUP and kvec is not None:
                        vals[var] = kvec[var[1]]
                    else:
                        vals[var] = rng.uniform(-1, 1)
                f *= vals[var] ** e
            x = x + v * f
        x = x + self.indep * rng.uniform(-1, 1, size=self.indep.shape)
        return x
