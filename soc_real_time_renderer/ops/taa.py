"""Temporal anti-aliasing (planar, gather-minimal).

Port of ``temporal_antialiasing.inl:120-199``: 3x3 neighbourhood with
Gaussian-blurred colour and min/max colour AABB, closest-depth velocity
dilation, history reprojection at ``uv - velocity`` with AABB clamping,
blend ``accum = min(0.1, frame_counter)`` (1.0 when reprojected uv is
off-screen), and velocity-disocclusion fallback to the blurred colour.

The copy-image tasks T19 (``renderer.cpp:1182-1198``) become the
returned (color, velocity) carried in RenderHistory.

The 3x3 neighbourhood taps are constant-offset shifts (pad+slice — zero
gathers); the reprojected history fetch packs prev_color+prev_velocity
into ONE (5, H, W) bilinear gather set.

Reference off-by-one kept: the shader's "color = neighbors[5]" (:173)
is the (x=+1, y=0) texel, not the centre.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import sampling

GAUSS = [1 / 16, 1 / 8, 1 / 16,
         1 / 8, 1 / 4, 1 / 8,
         1 / 16, 1 / 8, 1 / 16]


def taa(color, depth, velocity, prev_color, prev_velocity, frame_counter):
    """color/prev_color: (3, H, W); depth: (H, W); velocity/prev_velocity:
    (2, H, W); frame_counter: () int32.  Returns resolved (3, H, W).
    The history fetch is an exact bilinear gather at uv - velocity."""
    H, W = depth.shape
    uv = sampling.grid_uv(H, W)                    # (2, H, W)

    blurred = jnp.zeros_like(color)
    min_c = jnp.full_like(color, 1e6)
    max_c = jnp.full_like(color, -1e6)
    closest_depth = jnp.ones_like(depth)
    dilate_dx = jnp.zeros_like(depth)
    dilate_dy = jnp.zeros_like(depth)
    center = None
    # loop order matches the shader (y: 1..-1, x: 1..-1): "closest ==
    # depth" favours the latest minimum
    for y in (1, 0, -1):
        for x in (1, 0, -1):
            index = (y + 1) * 3 + (x + 1)
            c = sampling.shift(color, x, y)
            d = sampling.shift(depth, x, y)
            upd = d <= closest_depth
            closest_depth = jnp.minimum(closest_depth, d)
            dilate_dx = jnp.where(upd, float(x), dilate_dx)
            dilate_dy = jnp.where(upd, float(y), dilate_dy)
            min_c = jnp.minimum(min_c, c)
            max_c = jnp.maximum(max_c, c)
            blurred = blurred + GAUSS[index] * c
            if index == 5:
                center = c   # reference quirk (see module docstring)

    # velocity at the dilated (closest-depth) neighbour: the offsets are
    # one of 9 constants, so select among shifted velocity fields
    velocity_s = jnp.zeros_like(velocity)
    for y in (1, 0, -1):
        for x in (1, 0, -1):
            m = (dilate_dx == float(x)) & (dilate_dy == float(y))
            velocity_s = jnp.where(m[None], sampling.shift(velocity, x, y),
                                   velocity_s)

    accum = jnp.minimum(0.1, frame_counter.astype(jnp.float32))
    shift_u = uv[0] - velocity_s[0]
    shift_v = uv[1] - velocity_s[1]
    off = (shift_u < 0) | (shift_v < 0) | (shift_u > 1) | (shift_v > 1)
    accum = jnp.where(off, 1.0, accum)

    # one packed history fetch: prev_color (3) + prev_velocity (2)
    packed = jnp.concatenate([prev_color, prev_velocity], axis=0)
    hist = sampling.sample_screen(packed, jnp.stack([shift_u, shift_v]))
    acc_color = jnp.clip(hist[:3], min_c, max_c)
    out = center * accum[None] + acc_color * (1.0 - accum[None])

    pv = hist[3:5]
    dv = pv - velocity_s
    vel_len = jnp.sqrt(dv[0] * dv[0] + dv[1] * dv[1])
    disocc = jnp.clip((vel_len - 0.001) * 10.0, 0.0, 1.0)
    return out + (blurred - out) * disocc[None]
