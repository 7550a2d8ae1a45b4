"""Hierarchical-Z pyramids (min and max).

The reference builds both pyramids with a FidelityFX-SPD-style single
compute dispatch — 16x16 workgroups reducing 64x64 windows with a
global atomic counter electing the last workgroup for the top mips
(``generate_min_hiz.inl``, ``generate_hiz.glsl:17-99``; min/max differ
only by the OPERATION macro).  Here the cross-workgroup handoff is
unnecessary: the same pyramid is a ``reduce_window`` sweep — pure data
flow, no atomics (SURVEY.md §2.6 P2).

Matches the reference's sizing: half-resolution base,
``ceil(log2(max(w, h)))`` levels (``generate_min_hiz.inl:36-45``), each
level a 2x2 reduction of the previous with edge clamping for odd sizes.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _reduce2x2(x, op):
    """(H, W) -> (ceil(H/2), ceil(W/2)) by 2x2 min/max with clamping."""
    H, W = x.shape
    pad_h = H % 2
    pad_w = W % 2
    if pad_h or pad_w:
        x = jnp.pad(x, ((0, pad_h), (0, pad_w)), mode="edge")
        H, W = x.shape
    x = x.reshape(H // 2, 2, W // 2, 2)
    return (jnp.min(x, axis=(1, 3)) if op == "min"
            else jnp.max(x, axis=(1, 3)))


def build_hiz(depth, op: str = "min") -> list:
    """depth: (H, W) full-res -> list of levels starting at half res.

    Level 0 is a 2x2 reduction of the full-res depth (the transient R32F
    half-res image of generate_min_hiz.inl:36-45); subsequent levels
    halve until 1x1.
    """
    assert op in ("min", "max")
    levels = [_reduce2x2(depth, op)]
    while max(levels[-1].shape) > 1:
        levels.append(_reduce2x2(levels[-1], op))
    return levels
