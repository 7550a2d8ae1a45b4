"""SSAO: 26-sample hemisphere occlusion + 4x4 box blur, half resolution.

Port of ``ssao_generation.inl:71-217`` and ``ssao_blur.inl:73-109``:
the exact hardcoded kernel, the procedural value-noise random vector
(``:184-192``), view-space depth comparison with smoothstep range check
and bias (``:194-211``), ``occlusion = 1 - sum/kernel_size``; the blur
averages the 4x4 neighbourhood with offsets in [-2, 1] (``:91-105``).
Rendered at half resolution like the reference (renderer.cpp:827-831).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import sampling

KERNEL = jnp.array([  # ssao_generation.inl:76-103 (26 samples)
    [0.2196607, 0.9032637, 0.2254677],
    [0.05916681, 0.2201506, 0.1430302],
    [-0.4152246, 0.1320857, 0.7036734],
    [-0.3790807, 0.1454145, 0.100605],
    [0.3149606, -0.1294581, 0.7044517],
    [-0.1108412, 0.2162839, 0.1336278],
    [0.658012, -0.4395972, 0.2919373],
    [0.5377914, 0.3112189, 0.426864],
    [-0.2752537, 0.07625949, 0.1273409],
    [-0.1915639, -0.4973421, 0.3129629],
    [-0.2634767, 0.5277923, 0.1107446],
    [0.8242752, 0.02434147, 0.06049098],
    [0.06262707, -0.2128643, 0.03671562],
    [-0.1795662, -0.3543862, 0.07924347],
    [0.06039629, 0.24629, 0.4501176],
    [-0.7786345, -0.3814852, 0.2391262],
    [0.2792919, 0.2487278, 0.05185341],
    [0.1841383, 0.1696993, 0.8936281],
    [-0.3479781, 0.4725766, 0.719685],
    [-0.1365018, -0.2513416, 0.470937],
    [0.1280388, -0.563242, 0.3419276],
    [-0.4800232, -0.1899473, 0.2398808],
    [0.6389147, 0.1191014, 0.5271206],
    [0.1932822, -0.3692099, 0.6060588],
    [-0.3465451, -0.1654651, 0.6746758],
    [0.2448421, -0.1610962, 0.1289366]], jnp.float32)


def _rand(cu, cv):
    """ssao_generation.inl:139-141 (planar components)."""
    return jnp.mod(jnp.sin(cu * 12.9898 + cv * 78.233) * 43758.5453, 1.0)


def _noise(u, v, freq):
    """Value noise, ssao_generation.inl:143-156 (planar components)."""
    unit = 2560.0 / freq
    iu = jnp.floor(u / unit)
    iv = jnp.floor(v / unit)
    xu = jnp.mod(u, unit) / unit
    xv = jnp.mod(v, unit) / unit
    xu = 0.5 * (1.0 - jnp.cos(jnp.pi * xu))
    xv = 0.5 * (1.0 - jnp.cos(jnp.pi * xv))
    a = _rand(iu, iv)
    b = _rand(iu + 1.0, iv)
    c = _rand(iu, iv + 1.0)
    d = _rand(iu + 1.0, iv + 1.0)
    x1 = a + (b - a) * xu
    x2 = c + (d - c) * xu
    return x1 + (x2 - x1) * xv


def _preamble(depth, normal, g):
    """Shared per-half-res-pixel setup (ssao_generation.inl:174-192):
    view-space fragment position + procedural-noise TBN."""
    from .composition import view_from_depth
    from ..utils.vec import dot3, normalize3, cross3
    H, W = depth.shape
    h, w = H // 2, W // 2
    uv = sampling.grid_uv(h, w)                          # (2, h, w)
    d = sampling.sample_screen(depth, uv)
    n_half = sampling.sample_screen(normal, uv)
    frag_pos = view_from_depth(uv, d, g.camera.inv_projection)  # (3, h, w)
    n_world = normalize3(n_half)
    vm = g.camera.view[:3, :3]
    normal_v = jnp.stack([
        vm[0, 0] * n_world[0] + vm[0, 1] * n_world[1] + vm[0, 2] * n_world[2],
        vm[1, 0] * n_world[0] + vm[1, 1] * n_world[1] + vm[1, 2] * n_world[2],
        vm[2, 0] * n_world[0] + vm[2, 1] * n_world[1] + vm[2, 2] * n_world[2]])

    # random vector (ssao_generation.inl:184-192); noise_dim = full width
    rx = _noise(uv[0], uv[1], W * 2.0)
    ry = _noise(uv[0] ** 1.1, uv[1] ** 1.1,
                jnp.power(W * 4.2, 1.5 + uv[0] / 10.0))
    rv = jnp.stack([rx, ry, jnp.zeros_like(rx)])
    rv = normalize3(rv)

    tangent = normalize3(rv - normal_v * dot3(rv, normal_v)[None])
    bitangent = cross3(tangent, normal_v)
    return frag_pos, tangent, bitangent, normal_v


def ssao_generate(depth, normal, g, kernel_size: int = 26):
    """depth: (H, W) full-res; normal: (3, H, W) full-res world normals;
    output: (H/2, W/2) occlusion (half-res like renderer.cpp:827-831).

    Planar port of ssao_generation.inl:174-214: view-space hemisphere
    sampling with the hardcoded kernel, procedural-noise random vector,
    smoothstep range check, occlusion = 1 - sum/kernel_size.
    """
    frag_pos, tangent, bitangent, normal_v = _preamble(depth, normal, g)
    proj = g.camera.projection

    # All 26 hemisphere taps vectorized into ONE flat (K, h, w) gather.
    k = KERNEL[:kernel_size]                                  # (K, 3)
    sp_x = (tangent[0][None] * k[:, 0, None, None]
            + bitangent[0][None] * k[:, 1, None, None]
            + normal_v[0][None] * k[:, 2, None, None])
    sp_y = (tangent[1][None] * k[:, 0, None, None]
            + bitangent[1][None] * k[:, 1, None, None]
            + normal_v[1][None] * k[:, 2, None, None])
    sp_z = (tangent[2][None] * k[:, 0, None, None]
            + bitangent[2][None] * k[:, 1, None, None]
            + normal_v[2][None] * k[:, 2, None, None])
    sx = frag_pos[0][None] + sp_x * g.ssao_radius             # (K, h, w)
    sy = frag_pos[1][None] + sp_y * g.ssao_radius
    sz = frag_pos[2][None] + sp_z * g.ssao_radius

    ox = proj[0, 0] * sx + proj[0, 1] * sy + proj[0, 2] * sz + proj[0, 3]
    oy = proj[1, 0] * sx + proj[1, 1] * sy + proj[1, 2] * sz + proj[1, 3]
    ow = proj[3, 0] * sx + proj[3, 1] * sy + proj[3, 2] * sz + proj[3, 3]
    ows = jnp.where(ow != 0, ow, 1.0)
    ou = ox / ows * 0.5 + 0.5
    ov = oy / ows * 0.5 + 0.5

    Hf, Wf = depth.shape
    xi = jnp.clip((ou * Wf - 0.5).astype(jnp.int32), 0, Wf - 1)
    yi = jnp.clip((ov * Hf - 0.5).astype(jnp.int32), 0, Hf - 1)
    # barrier: keep XLA from fusing the whole tap-position chain into
    # the gather
    idx = jax.lax.optimization_barrier(yi * Wf + xi)
    sd = depth.reshape(-1)[idx]                               # (K, h, w)

    # view-space z of the sampled depth (view_from_depth z-row inlined)
    P = g.camera.inv_projection
    nx = ou * 2.0 - 1.0
    ny = ov * 2.0 - 1.0
    vz = P[2, 0] * nx + P[2, 1] * ny + P[2, 2] * sd + P[2, 3]
    vw = P[3, 0] * nx + P[3, 1] * ny + P[3, 2] * sd + P[3, 3]
    sample_depth = vz / jnp.where(vw != 0, vw, 1.0)

    denom = jnp.maximum(jnp.abs(frag_pos[2][None] - sample_depth), 1e-8)
    t = jnp.clip(g.ssao_radius / denom, 0.0, 1.0)
    range_check = t * t * (3.0 - 2.0 * t)                     # smoothstep
    hit = sample_depth >= sz + g.ssao_bias
    occlusion = jnp.sum(hit.astype(jnp.float32) * range_check, axis=0)
    return 1.0 - occlusion / float(kernel_size)


def ssao_blur(ssao):
    """4x4 box blur, offsets [-2, 1] at own-res texel steps
    (ssao_blur.inl:91-105) — pure shifts."""
    acc = jnp.zeros_like(ssao)
    for x in range(-2, 2):
        for y in range(-2, 2):
            acc = acc + sampling.shift(ssao, x, y)
    return acc / 16.0
