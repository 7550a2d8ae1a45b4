"""Planar vector math: xyz components on the LEADING axis.

All device-side vector math uses (3, ...) layouts with these helpers
(axis-0 component arithmetic): each component is a contiguous plane,
so the math is plain elementwise work over pixels or triangles.
"""
from __future__ import annotations

import jax.numpy as jnp


def dot3(a, b):
    """(3, ...) · (3, ...) -> (...)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return jnp.stack([a[1] * b[2] - a[2] * b[1],
                      a[2] * b[0] - a[0] * b[2],
                      a[0] * b[1] - a[1] * b[0]])


def norm3(a, eps=0.0):
    return jnp.sqrt(jnp.maximum(dot3(a, a), eps))


def normalize3(a, eps=1e-8):
    return a / jnp.maximum(norm3(a), eps)


def mat_vec3(m, v, translate=None):
    """m: (3, 3) @ v: (3, ...) (+ translate (3,))."""
    out = jnp.stack([m[0, 0] * v[0] + m[0, 1] * v[1] + m[0, 2] * v[2],
                     m[1, 0] * v[0] + m[1, 1] * v[1] + m[1, 2] * v[2],
                     m[2, 0] * v[0] + m[2, 1] * v[1] + m[2, 2] * v[2]])
    if translate is not None:
        out = out + translate.reshape(3, *([1] * (v.ndim - 1)))
    return out


def mat4_point3(m, v):
    """m: (4, 4) applied to points (3, ...) with w=1 -> ((3, ...), w)."""
    xyz = mat_vec3(m[:3, :3], v, m[:3, 3])
    w = m[3, 0] * v[0] + m[3, 1] * v[1] + m[3, 2] * v[2] + m[3, 3]
    return xyz, w
