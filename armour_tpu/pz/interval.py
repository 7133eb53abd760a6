"""Elementwise interval arithmetic on (lo, hi) array pairs.

Stands in for the reference's Boost interval usage in the JRS remainder
bounds (Trajectory.cu:104-134).  No directed rounding in XLA; tests run in
f64 and the planner can budget outward slop (config.float_slop).
"""

from __future__ import annotations

import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


def make(lo, hi):
    return jnp.asarray(lo), jnp.asarray(hi)


def sym(r):
    """[-r, r] for r >= 0."""
    r = jnp.asarray(r)
    return -r, r


def add(a, b):
    return a[0] + b[0], a[1] + b[1]


def neg(a):
    return -a[1], -a[0]


def scale(a, s):
    lo = jnp.where(s >= 0, a[0] * s, a[1] * s)
    hi = jnp.where(s >= 0, a[1] * s, a[0] * s)
    return lo, hi


def mul(a, b):
    p1 = a[0] * b[0]
    p2 = a[0] * b[1]
    p3 = a[1] * b[0]
    p4 = a[1] * b[1]
    return (
        jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
        jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)),
    )


def square(a):
    lo2 = a[0] * a[0]
    hi2 = a[1] * a[1]
    contains_zero = (a[0] <= 0) & (a[1] >= 0)
    return (
        jnp.where(contains_zero, 0.0, jnp.minimum(lo2, hi2)),
        jnp.maximum(lo2, hi2),
    )


def _contains_multiple(lo, hi, period, offset):
    """Does [lo, hi] contain offset + period * n for some integer n?"""
    n = jnp.ceil((lo - offset) / period)
    return offset + n * period <= hi


def cos(a):
    lo, hi = a
    clo = jnp.cos(lo)
    chi = jnp.cos(hi)
    cmax = jnp.where(_contains_multiple(lo, hi, TWO_PI, 0.0), 1.0, jnp.maximum(clo, chi))
    cmin = jnp.where(_contains_multiple(lo, hi, TWO_PI, jnp.pi), -1.0, jnp.minimum(clo, chi))
    return cmin, cmax


def sin(a):
    lo, hi = a
    slo = jnp.sin(lo)
    shi = jnp.sin(hi)
    smax = jnp.where(_contains_multiple(lo, hi, TWO_PI, jnp.pi / 2), 1.0, jnp.maximum(slo, shi))
    smin = jnp.where(_contains_multiple(lo, hi, TWO_PI, -jnp.pi / 2), -1.0, jnp.minimum(slo, shi))
    return smin, smax


def center(a):
    return (a[0] + a[1]) * 0.5


def radius(a):
    return (a[1] - a[0]) * 0.5
