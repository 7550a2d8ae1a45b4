"""Deferred lighting composition pass (planar layout).

Pure-function port of the reference's composition fragment shader
(``/root/reference/src/graphics/tasks/composition.inl:82-228``),
including its quirks (kept for pixel comparability):

* sun term is ``max(0, n·-sun_dir) * shadow`` with **no** intensity or
  albedo factor (``:203``); point/spot lights multiply albedo *inside*
  the light function (``:125,160``) and the total is multiplied by
  albedo again (``:213``) — i.e. albedo² for local lights;
* exponential shadow factor ``clamp(exp(k (z - d))^darkening, 0, 1)``
  with the shadow map read through a *linear* (not comparison) sampler
  (``:169-173``);
* the 2-step dithered volumetric march is computed then force-zeroed
  (``:176-196``) — implemented behind ``enable_volumetric``, default
  off like the reference;
* SSR mix is commented out (``:213-216``) — RenderConfig.composite_ssr;
* sky pixels (depth == 1) take the clouds image (``:220-222``).

All vectors ride the leading axis ((3, P) / (3, H, W)); the
128-slot light arrays run as a lax.scan, each step planar over pixels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import sampling
from ..config import ShaderGlobals
from ..utils.vec import dot3, mat_vec3, normalize3

DITHER_PATTERN = jnp.array([  # composition.inl:104-108 (row = x%4, col = y%4)
    [0.0, 0.5, 0.125, 0.625],
    [0.75, 0.22, 0.875, 0.375],
    [0.1875, 0.6875, 0.0625, 0.5625],
    [0.9375, 0.4375, 0.8125, 0.3125]], jnp.float32)

HG_G = 0.7  # composition.inl:102


def world_from_depth(uv, depth, inv_projection, inv_view):
    """composition.inl:114-122 planar: uv (2, ...), depth (...)."""
    view = view_from_depth(uv, depth, inv_projection)
    return mat_vec3(inv_view[:3, :3], view, inv_view[:3, 3])


def view_from_depth(uv, depth, inv_projection):
    ndc_x = uv[0] * 2.0 - 1.0
    ndc_y = uv[1] * 2.0 - 1.0
    P = inv_projection
    vx = P[0, 0] * ndc_x + P[0, 1] * ndc_y + P[0, 2] * depth + P[0, 3]
    vy = P[1, 0] * ndc_x + P[1, 1] * ndc_y + P[1, 2] * depth + P[1, 3]
    vz = P[2, 0] * ndc_x + P[2, 1] * ndc_y + P[2, 2] * depth + P[2, 3]
    vw = P[3, 0] * ndc_x + P[3, 1] * ndc_y + P[3, 2] * depth + P[3, 3]
    vw = jnp.where(vw != 0, vw, 1.0)
    return jnp.stack([vx / vw, vy / vw, vz / vw])


def _henyey_greenstein(cos_theta, g=HG_G):
    return (1.0 - g * g) / (4.0 * jnp.pi
                            * (1.0 + g * g - 2.0 * g * cos_theta) ** 1.5)


def _project(m, v):
    """(4,4) @ points (3, P) -> ((3, P) ndc, (P,) w)."""
    x = m[0, 0] * v[0] + m[0, 1] * v[1] + m[0, 2] * v[2] + m[0, 3]
    y = m[1, 0] * v[0] + m[1, 1] * v[1] + m[1, 2] * v[2] + m[1, 3]
    z = m[2, 0] * v[0] + m[2, 1] * v[1] + m[2, 2] * v[2] + m[2, 3]
    w = m[3, 0] * v[0] + m[3, 1] * v[1] + m[3, 2] * v[2] + m[3, 3]
    ws = jnp.where(w != 0, w, 1.0)
    return jnp.stack([x / ws, y / ws, z / ws]), w


def _local_lights(g: ShaderGlobals, albedo, normal, position,
                  max_point: int = 128, max_spot: int = 128):
    """Point + spot lights (composition.inl:124-160) over the fixed 128
    slots (shared.inl:84-85) as a lax.scan; masked by count.

    max_point/max_spot statically bound the scan (scenes pass their real
    light counts: a 256-step scan over empty slots costs ~50 ms/frame).
    """
    from jax import lax

    if max_point == 0 and max_spot == 0:
        return jnp.zeros_like(albedo)
    cam = g.camera.position
    vdir = normalize3(cam[:, None] - position)     # (3, P)

    def point_step(acc, light):
        lp, lc, li, on = light
        to_l = lp[:, None] - position
        d2 = jnp.maximum(dot3(to_l, to_l), 1e-12)
        ldir = to_l / jnp.sqrt(d2)
        half = normalize3(ldir + vdir)
        diffuse = jnp.maximum(dot3(ldir, normal), 0.0)
        nh = jnp.arccos(jnp.clip(dot3(half, normal), -1.0, 1.0))
        spec = jnp.exp(-(nh * nh))
        s = (diffuse + spec) / d2 * li * on
        return acc + albedo * (lc[:, None] * s[None, :]), None

    acc = jnp.zeros_like(albedo)
    if max_point > 0:
        pl_on = (jnp.arange(max_point)
                 < g.lights.point_count).astype(jnp.float32)
        acc, _ = lax.scan(point_step, acc,
                          (g.lights.point_position[:max_point],
                           g.lights.point_color[:max_point],
                           g.lights.point_intensity[:max_point], pl_on))

    def spot_step(a, light):
        lp, ld, lc, li, cut, ocut, on = light
        to_l = lp[:, None] - position
        d2 = jnp.maximum(dot3(to_l, to_l), 1e-12)
        ldir = to_l / jnp.sqrt(d2)
        sd = normalize3(-ld)
        theta = dot3(ldir, sd[:, None])
        eps = jnp.where(cut - ocut != 0, cut - ocut, 1e-6)
        cone = jnp.clip((theta - ocut) / eps, 0.0, 1.0)
        half = normalize3(ldir + vdir)
        diffuse = jnp.maximum(dot3(ldir, normal), 0.0)
        nh = jnp.arccos(jnp.clip(dot3(half, normal), -1.0, 1.0))
        spec = jnp.exp(-(nh * nh))
        s = (diffuse + spec) / d2 * li * cone * on
        return a + albedo * (lc[:, None] * s[None, :]), None

    if max_spot > 0:
        sl_on = (jnp.arange(max_spot)
                 < g.lights.spot_count).astype(jnp.float32)
        acc, _ = lax.scan(spot_step, acc,
                          (g.lights.spot_position[:max_spot],
                           g.lights.spot_direction[:max_spot],
                           g.lights.spot_color[:max_spot],
                           g.lights.spot_intensity[:max_spot],
                           g.lights.spot_cut_off[:max_spot],
                           g.lights.spot_outer_cut_off[:max_spot], sl_on))
    return acc


def compose(g: ShaderGlobals, depth, albedo, emissive, normal, ssao,
            shadow_map, clouds, *, enable_volumetric: bool = False,
            enable_shadow: bool = True, max_point_lights: int = 128,
            max_spot_lights: int = 128, empty_shadow_map: bool = False,
            shadow_crop: tuple | None = None):
    """Full composition pass (planar).

    depth: (H, W); albedo/emissive/normal: (3, H, W); ssao: (H, W);
    shadow_map: (S, S) or None; clouds: (3, H, W) or None.
    empty_shadow_map: shadow_map is statically proven to be all-1.0
    (no geometry enters the sun clip volume — the reference's actual
    state, see FramePlan.shadow_statically_empty); the ESM factor is
    computed against the constant 1.0 (bilinear of an all-1.0 map is
    exactly 1.0 incl. clamp-to-edge), skipping the 2.1M-index gather.
    shadow_crop: static (x0, y0, w, h) texel window proved at build to
    contain every non-1.0 texel with >= 1 texel of 1.0 ring inside it
    (FramePlan.shadow_crop): the ESM bilinear samples the crop slice
    with shifted texel coords — clamping to the crop edge lands on the
    proved-1.0 ring, exactly what the full-map tap (a bilinear of 1.0
    texels, or the map-edge clamp where the crop reaches the edge)
    returns, so output is bit-identical while the gather table shrinks
    from the full map to the geometry's footprint.
    Returns (3, H, W) HDR colour.
    """
    H, W = depth.shape
    uv = sampling.grid_uv(H, W).reshape(2, -1)

    d = depth.reshape(-1)
    position = world_from_depth(uv, d, g.camera.inv_projection,
                                g.camera.inv_view)          # (3, P)
    alb = albedo.reshape(3, -1)
    emi = emissive.reshape(3, -1) * g.emissive_bloom_strength
    nrm = normal.reshape(3, -1)
    occ = jnp.power(jnp.maximum(ssao.reshape(-1), 0.0),
                    g.ambient_occlussion_strength)

    # --- sun shadow (composition.inl:164-173)
    if enable_shadow and (shadow_map is not None or empty_shadow_map):
        spv = g.sun.projection_view
        sp, _ = _project(spv, position)
        if empty_shadow_map:
            sdepth = jnp.float32(1.0)   # all-1.0 map sampled bilinearly
        elif shadow_crop is not None:
            S = shadow_map.shape[-1]
            x0, y0, cw, ch = shadow_crop
            sub = shadow_map[y0:y0 + ch, x0:x0 + cw]
            # crop-local TEXEL coords: the full-map tap coordinate
            # (u*S - 0.5) shifted by the integer crop origin — exact in
            # fp (integer subtraction of representable floats), so the
            # same texels are tapped; edge clamps land on the
            # proved-1.0 ring (see docstring)
            suv = jnp.stack([sp[0] * 0.5 + 0.5, sp[1] * 0.5 + 0.5])
            xy = jnp.stack([suv[0] * S - 0.5 - x0,
                            suv[1] * S - 0.5 - y0])
            sdepth = sampling.sample_screen(sub, xy, texel_coords=True)
        else:
            suv = jnp.stack([sp[0] * 0.5 + 0.5, sp[1] * 0.5 + 0.5])
            sdepth = sampling.sample_screen(shadow_map, suv)
        sun_shadow = jnp.clip(
            jnp.exp(g.sun.exponential_factor * (sp[2] - sdepth))
            ** g.sun.darkening_factor, 0.0, 1.0)
    else:
        sun_shadow = jnp.ones_like(d)

    direct_s = jnp.maximum(0.0, dot3(nrm, -g.sun.direction[:, None])) \
        * sun_shadow
    direct = jnp.broadcast_to(direct_s[None, :], alb.shape)
    direct = direct + _local_lights(g, alb, nrm, position,
                                    max_point_lights,
                                    max_spot_lights)

    # --- volumetric light (computed-then-zeroed in the reference)
    if enable_volumetric and (shadow_map is not None or empty_shadow_map):
        spv = g.sun.projection_view
        sp, _ = _project(spv, position)
        cam4 = jnp.concatenate([g.camera.position, jnp.ones(1)])
        scp4 = jnp.dot(spv, cam4, precision=jax.lax.Precision.HIGHEST)
        scp = scp4[:3] / jnp.where(scp4[3] != 0, scp4[3], 1.0)
        V = sp - scp[:, None]
        step_len = jnp.sqrt(jnp.maximum(dot3(V, V), 1e-12)) / 2.0
        Vn = normalize3(V)
        step = Vn * step_len[None, :]
        xi = (uv[0] * W).astype(jnp.int32) % 4
        yi = (uv[1] * H).astype(jnp.int32) % 4
        dither = DITHER_PATTERN.reshape(-1)[xi * 4 + yi]
        accum = jnp.zeros_like(d)
        for i in range(2):  # NUM_STEPS_INT = 2
            pstep = scp[:, None] + step * float(i) + dither[None, :] * step
            if empty_shadow_map:
                # comparison-sample of the all-1.0 map (border also
                # 1.0): bilinear of identical tests = the test itself
                accum += (pstep[2] < 1.0).astype(jnp.float32)
            else:
                accum += sampling.sample_shadow_cmp(
                    shadow_map,
                    jnp.stack([pstep[0] * 0.5 + 0.5, pstep[1] * 0.5 + 0.5]),
                    pstep[2])
        vdir = normalize3(position - g.camera.position[:, None])
        vol = (accum / 2.0) * _henyey_greenstein(
            dot3(vdir, -g.sun.direction[:, None]))
        volumetric = vol[None, :]
    else:
        volumetric = jnp.float32(0.0)

    color = ((direct + g.ambient[:, None]) * alb * occ[None, :]
             + volumetric + emi)

    if clouds is not None:
        sky = clouds.reshape(3, -1)
        color = jnp.where((d == 1.0)[None, :], sky, color)

    return color.reshape(3, H, W)
